// K14a shard_preempt_local: one preemptor's victim scan over the rows of
// every shard one device holds, each shard reduced to its candidate
// record, in one launch.
//
// Replaces the shard-local half of `sharded_preempt_fn`
// (kubernetes_tpu/parallel/sharding.py:354), where GSPMD keeps the node
// rows, the [N, P] victim planes, `feas_static` and `order_rank` of
// `_preempt_scan_core` (kubernetes_tpu/ops/kernels.py:1598) on each chip:
// per row, `_victim_select` (:1494) with this preemptor's slot mask (slot
// priority below its own) and the reprieve walk; then, instead of
// gathering every row's aggregates for the replicated `_pick_one_node`
// (:1570), each shard reduces its rows to one candidate record (`CR_*`,
// victim.cuh): whether any row is a candidate, its lowest-ranked
// zero-victim row, and the row of lowest (rank, row) among those at the
// shard's lexicographic minimum of the five criteria, with that row's
// criteria, counts and slot flags. K14b picks among the D records.
//
// Bound on the H100: bytes, as K7 (the seven [rows, P] victim planes and
// eight node rows read once). Design: K7's grid-wide scan and pick
// (`preempt_grid.cuh`) over a grid of (blocks, shards), the shards'
// argument structs in one `__grid_constant__` parameter, as the grouped
// locals K10a / K13a take theirs (`LOCAL_GROUP_SHARDS` a launch):
//   - inside a shard, K7's scan: a thread a node, 32 nodes a warp staged
//     through shared memory by cp.async, `PickRec`'s lexicographic minimum
//     by warp shuffles, then across the block's warps, then one record a
//     block carrying its best node's flags;
//   - each shard has its own ticket and its own part of the device's block
//     records: the last block of a shard to draw its ticket combines that
//     shard's block records into the shard's candidate record and puts the
//     ticket back to 0. No aggregate plane goes to global memory and no
//     row is walked twice;
//   - the record goes straight into row s of this call's half of the
//     device's gathered buffer (half round & 1, as a mesh step's records:
//     shard_scan.cuh's exchange), where K14b reads it. Under the "peer"
//     exchange the last block also copies it into every other card's
//     buffer and publishes the shard's stamp (the call's value, at
//     [round & 1, s] of every card's stamps) after a system-wide fence.
// The block records and tickets are the device's, allocated and zeroed
// once: launches on one stream run in turn, and each leaves its tickets
// at 0.
#include "preempt_grid.cuh"
#include "shard_scan.cuh"

// scalar slots, in the order of `_SPL_INTS`
// (kubernetes_tpu_torch/ops/kernels.py): the shard (its rows, its first
// row's global index, its index in the mesh, the peers it writes to), the
// pod, the exchange (the mesh's shards, the bytes between the buffer's
// halves, the call's round and stamp value) and the blocks a shard takes
enum {
  PLI_ROWS, PLI_OFFSET, PLI_INDEX, PLI_N_PEERS, PLI_P, PLI_N_REAL,
  PLI_MAX_PRIO, PLI_CR, PLI_HR, PLI_REQ_CPU, PLI_REQ_MEM, PLI_REQ_EPH,
  PLI_D, PLI_HALF, PLI_ROUND, PLI_STAMP, PLI_BLOCKS, PLI_COUNT
};
// pointer slots, in the order of `_SPL_PTRS`: the shard's node rows,
// victim planes, feas_static and order_rank slices, row s of the first
// half of the device's buffer, the device's stamps (NULL under the host's
// copies), block records and tickets, then row s of each peer's buffer
// (first half) and each peer's stamps
enum {
  PLP_ALLOC_CPU, PLP_ALLOC_MEM, PLP_ALLOC_EPH, PLP_ALLOWED, PLP_REQ_CPU,
  PLP_REQ_MEM, PLP_REQ_EPH, PLP_POD_COUNT, PLP_VIC_CPU, PLP_VIC_MEM,
  PLP_VIC_EPH, PLP_VIC_PRIO, PLP_VIC_START, PLP_VIC_VALID,
  PLP_VIC_VIOLATING, PLP_FEAS, PLP_RANK, PLP_REC, PLP_STAMPS, PLP_RECORDS,
  PLP_TICKETS, PLP_PEER_REC0, PLP_PEER_REC1, PLP_PEER_REC2, PLP_PEER_REC3,
  PLP_PEER_REC4, PLP_PEER_REC5, PLP_PEER_REC6, PLP_PEER_STAMPS0,
  PLP_PEER_STAMPS1, PLP_PEER_STAMPS2, PLP_PEER_STAMPS3, PLP_PEER_STAMPS4,
  PLP_PEER_STAMPS5, PLP_PEER_STAMPS6, PLP_COUNT
};

struct PreemptLocalArgs {
  i64 v[PLI_COUNT];
  void* p[PLP_COUNT];
};

// host words of one shard's struct: its scalars, then its pointers
constexpr int PL_WORDS = PLI_COUNT + PLP_COUNT;
static_assert(sizeof(PreemptLocalArgs) == 8 * PL_WORDS,
              "PreemptLocalArgs layout");
static_assert(PLP_PEER_STAMPS0 - PLP_PEER_REC0 == MAX_PEERS
                  && PLP_COUNT - PLP_PEER_STAMPS0 == MAX_PEERS,
              "a peer slot for every peer");

struct PreemptLocalGroup {
  PreemptLocalArgs s[LOCAL_GROUP_SHARDS];
};

__device__ __forceinline__ VictimRows lp_rows(const PreemptLocalArgs& a) {
  VictimRows r;
  r.alloc_cpu = (const i64*)a.p[PLP_ALLOC_CPU];
  r.alloc_mem = (const i64*)a.p[PLP_ALLOC_MEM];
  r.alloc_eph = (const i64*)a.p[PLP_ALLOC_EPH];
  r.allowed = (const i64*)a.p[PLP_ALLOWED];
  r.req_cpu = (const i64*)a.p[PLP_REQ_CPU];
  r.req_mem = (const i64*)a.p[PLP_REQ_MEM];
  r.req_eph = (const i64*)a.p[PLP_REQ_EPH];
  r.pod_count = (const i64*)a.p[PLP_POD_COUNT];
  r.g_cpu = r.g_mem = r.g_eph = r.g_cnt = 0;
  return r;
}

__device__ __forceinline__ VictimPlanes lp_planes(
    const PreemptLocalArgs& a) {
  VictimPlanes v;
  v.P = (int)a.v[PLI_P];
  v.cpu = (const i64*)a.p[PLP_VIC_CPU];
  v.mem = (const i64*)a.p[PLP_VIC_MEM];
  v.eph = (const i64*)a.p[PLP_VIC_EPH];
  v.prio = (const i64*)a.p[PLP_VIC_PRIO];
  v.start = (const double*)a.p[PLP_VIC_START];
  v.valid = (const unsigned char*)a.p[PLP_VIC_VALID];
  v.viol = (const unsigned char*)a.p[PLP_VIC_VIOLATING];
  return v;
}

__device__ __forceinline__ VictimPod lp_pod(const PreemptLocalArgs& a) {
  VictimPod p;
  p.req_cpu = a.v[PLI_REQ_CPU];
  p.req_mem = a.v[PLI_REQ_MEM];
  p.req_eph = a.v[PLI_REQ_EPH];
  p.max_prio = a.v[PLI_MAX_PRIO];
  p.cr = a.v[PLI_CR] != 0;
  p.hr = a.v[PLI_HR] != 0 && p.cr;
  return p;
}

// The head and criteria of shard `a`'s candidate record from its pick `r`
// (rows global, keys its order ranks). One thread.
__device__ __forceinline__ void cand_put(unsigned char* rec,
                                         const PickRec& r) {
  i64* h = (i64*)rec;
  double* c = (double*)(rec + CR_CRIT_BYTES);
  const bool best = r.w[PK_BROW] >= 0, zero = r.w[PK_ZROW] >= 0;
  h[CR_ANY_FEAS] = best;
  h[CR_ANY_ZERO] = zero;
  h[CR_ZKEY] = zero ? r.w[PK_ZKEY] : LLONG_MAX;
  h[CR_ZIDX] = zero ? r.w[PK_ZROW] : -1;
  h[CR_BKEY] = best ? r.w[PK_BKEY] : LLONG_MAX;
  h[CR_BIDX] = best ? r.w[PK_BROW] : -1;
  // the best row's counts, exact as float64 (at most K7_PMAX)
  h[CR_NV] = best ? (i64)r.crit(3) : 0;
  h[CR_VIOL] = best ? (i64)r.crit(0) : 0;
  h[CR_ANY_RES] = 0;
  for (int q = 0; q < 5; ++q) c[q] = best ? r.crit(q) : 0.0;
}

template <bool FULL>
__global__ void __launch_bounds__(K7_THREADS)
    shard_preempt_local_kernel(
        const __grid_constant__ PreemptLocalGroup grp) {
  __shared__ K7Shared sh;
  const PreemptLocalArgs& a = grp.s[blockIdx.y];
  const int G = (int)gridDim.x;
  // this shard's part of the device's block records, and its ticket
  i64* records = (i64*)a.p[PLP_RECORDS] + (size_t)blockIdx.y * K7_WORDS * G;
  unsigned int* ticket = (unsigned int*)a.p[PLP_TICKETS] + blockIdx.y;
  const i64 off = a.v[PLI_OFFSET];
  if (!k7_scan_block<FULL>(sh, lp_rows(a), lp_planes(a), lp_pod(a),
                           (const unsigned char*)a.p[PLP_FEAS],
                           (const i64*)a.p[PLP_RANK], (int)a.v[PLI_ROWS],
                           a.v[PLI_N_REAL] - off, off, (int)blockIdx.x, G,
                           records, ticket))
    return;
  // ---- the shard's last block: its candidate record, in place ------------
  const PickRec r = k7_last_pick(sh, records, G);
  const int P = (int)a.v[PLI_P], n_peers = (int)a.v[PLI_N_PEERS];
  const i64 round = a.v[PLI_ROUND];
  const size_t half = (size_t)(round & 1) * (size_t)a.v[PLI_HALF];
  unsigned char* rec = (unsigned char*)a.p[PLP_REC] + half;
  if (threadIdx.x == 0) {
    cand_put(rec, r);
    *ticket = 0u;  // for the next launch
  }
  __syncthreads();
  int* flags = (int*)(rec + CR_FLAG_BYTES);
  for (int q = threadIdx.x; q < P; q += K7_THREADS) flags[q] = k7_flag(sh, q);
  if (n_peers) {
    // the whole record, copied into every peer's buffer in 4-byte words
    __syncthreads();
    const int words = (CR_FLAG_BYTES + 4 * P) / 4;
    const int* src = (const int*)rec;
    for (int k = 0; k < n_peers; ++k) {
      int* dst = (int*)((unsigned char*)a.p[PLP_PEER_REC0 + k] + half);
      for (int w = threadIdx.x; w < words; w += K7_THREADS) dst[w] = src[w];
    }
    __threadfence_system();
  }
  __syncthreads();
  if (threadIdx.x == 0 && a.p[PLP_STAMPS])
    stamps_publish((i64*)a.p[PLP_STAMPS], a.p + PLP_PEER_STAMPS0, n_peers,
                   (size_t)(round & 1) * (size_t)a.v[PLI_D]
                       + (size_t)a.v[PLI_INDEX],
                   a.v[PLI_STAMP]);
}

// Launch K14a over the `n` shards whose structs lie in `words` (n x
// PL_WORDS), a grid of (blocks, shards) a launch, LOCAL_GROUP_SHARDS
// shards at most, on `stream` of `device`. Adds one to `*launched` for
// every launch it makes. -1: a shard of no block; -2: the device's block
// records or tickets missing; -3: more victim slots than a block record's
// flags hold.
extern "C" int shard_preempt_local_launch(const i64* words, int n,
                                          int device, void* stream,
                                          int* launched) {
  const DeviceScope on(device);
  cudaError_t e = on.err;
  for (int k0 = 0; e == cudaSuccess && k0 < n; k0 += LOCAL_GROUP_SHARDS) {
    PreemptLocalGroup g;
    const int m = n - k0 < LOCAL_GROUP_SHARDS ? n - k0 : LOCAL_GROUP_SHARDS;
    int blocks = 0;
    for (int k = 0; k < LOCAL_GROUP_SHARDS; ++k) {
      // slots past the m shards repeat the first; no block reads them
      const i64* w = words + (size_t)(k0 + (k < m ? k : 0)) * PL_WORDS;
      for (int i = 0; i < PLI_COUNT; ++i) g.s[k].v[i] = w[i];
      for (int i = 0; i < PLP_COUNT; ++i)
        g.s[k].p[i] = (void*)w[PLI_COUNT + i];
      if (k < m && (int)g.s[k].v[PLI_BLOCKS] > blocks)
        blocks = (int)g.s[k].v[PLI_BLOCKS];
    }
    const PreemptLocalArgs& a = g.s[0];
    if (blocks < 1) return -1;
    if (!a.p[PLP_RECORDS] || !a.p[PLP_TICKETS]) return -2;
    if (a.v[PLI_P] < 1 || a.v[PLI_P] > K7_PMAX) return -3;
    const dim3 grid(blocks, m);
    // the slot loops unroll where every chunk is whole (P 16, 128, ...)
    if (a.v[PLI_P] % K7_CS == 0)
      shard_preempt_local_kernel<true><<<grid, K7_THREADS, 0,
                                         (cudaStream_t)stream>>>(g);
    else
      shard_preempt_local_kernel<false><<<grid, K7_THREADS, 0,
                                          (cudaStream_t)stream>>>(g);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  return (int)e;
}

// The card's SM count and how many K14a blocks an SM holds at once (0:
// none; the fewer of the two instantiations') on the current device.
extern "C" int shard_preempt_local_occupancy(int* sms, int* per_sm) {
  int dev = 0, full = 0, part = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &full, shard_preempt_local_kernel<true>, K7_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &part, shard_preempt_local_kernel<false>, K7_THREADS, 0);
  *per_sm = full < part ? full : part;
  return (int)e;
}
