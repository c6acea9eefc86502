// K9a shard_cycle_local: the shard-local half of the sharded cycle, over
// the rows of every shard one device holds, in one launch, each shard's
// record written in place.
//
// Replaces the per-node phases of `sharded_cycle_fn`
// (kubernetes_tpu/parallel/sharding.py:115), which GSPMD keeps on each
// chip's rows: `_feasibility` (kubernetes_tpu/ops/kernels.py:296) and the
// row-local families of `_fit_scores` (:157), with the shard's slice of the
// nominated-ghost load in the filter when the serial cycle has one
// (`_cycle_core`'s ghost, :402-413). Per row it writes the feasible bit,
// the first failing predicate and the general bits (the host's FitError
// decode reads them) into the device's whole [n_pad] outputs, and the
// row's part of the shard's record: the row-local total (K1's four
// resource families, image locality, prefer-avoid), the raw inputs of the
// families normalized over the kept set (node affinity, taint toleration,
// selector spread with the zone, inter-pod counts and the tracked bit,
// each only when it runs dense) and the in-range feasible bit. The
// families that need the global kept set are finished by K9b, never per
// shard.
//
// Shared with K2/K5/K6/K8: `cycle_filter_row` and `cycle_row_local`
// (cycle.cuh), `local_total_one` (common.cuh); with K10a / K14a: the
// grouped launch's shape and the exchange (`stamps_publish`,
// shard_scan.cuh).
//
// Bound on the H100: bytes. It reads the shards' 14 node fields and the
// pod's dense per-node fields once (~150 B a row) and writes ~20 B a row,
// far below a launch's own cost at 4,096 rows a shard. Design, as K10a:
//   - one launch a device and cycle, a grid of (128-thread row blocks,
//     shards), the shards' argument structs in one `__grid_constant__`
//     parameter (LOCAL_GROUP_SHARDS a launch);
//   - one thread a row, no barrier past the weight row's but the one
//     before the ticket;
//   - the pod's per-node fields and the ghost are the device's whole
//     [n_pad] vectors, uploaded once a cycle in one staged copy; each
//     shard's pointers are the host's, at its offset;
//   - the record goes straight into row s of the cycle's half (round & 1)
//     of the device's gathered buffer, where K9b reads it, and under the
//     "peer" exchange into every other card's through peer pointers; the
//     shard's last row block, by its own ticket, then publishes the
//     cycle's stamp on every card (K9b waits for the D stamps).
#include "shard_scan.cuh"

// scalar slots, in the order of `_SCL_INTS`
// (kubernetes_tpu_torch/ops/kernels.py): the shard's rows, the scalar
// resources, its first row's global index, n_real, the families' gate,
// each record plane's byte offset (-1: absent), then the exchange: the
// shard's index, the mesh's shards, the bytes between the buffer's
// halves, the cycle's round and stamp value, the peers written to
enum {
  CL_ROWS, CL_S, CL_OFFSET, CL_N_REAL, CL_GATE, CL_OFF_LOCAL, CL_OFF_NA,
  CL_OFF_TT, CL_OFF_SC, CL_OFF_IC, CL_OFF_ZONE, CL_OFF_FEAS, CL_OFF_TRACKED,
  CL_INDEX, CL_D, CL_HALF, CL_ROUND, CL_STAMP, CL_N_PEERS, CL_COUNT
};
// pointer slots, in the order of `_SCL_PTRS`: the shard's node rows, the
// pod (its scalars, the device's whole per-node fields at the shard's
// offset), the weight row, the device's whole outputs at the offset, row
// s of the first half of the device's buffer, the device's stamps and the
// shard's ticket (NULL under the host's copies), row s of each peer's
// buffer (first half) and each peer's stamps, the ghost at the offset
enum {
  LP_VALID, LP_ALLOC_CPU, LP_ALLOC_MEM, LP_ALLOC_EPH, LP_ALLOWED, LP_REQ_CPU,
  LP_REQ_MEM, LP_REQ_EPH, LP_NZ_CPU, LP_NZ_MEM, LP_POD_COUNT,
  LP_ALLOC_SCALAR, LP_REQ_SCALAR, LP_ZONE_ID, LP_SCAL, LP_REQ_SCALAR_P,
  LP_SEL_OK, LP_TAINTS_OK, LP_UNSCHED_OK, LP_PORTS_OK, LP_HOST_OK,
  LP_DISK_OK, LP_MAXVOL_OK, LP_VOLBIND_OK, LP_VOLZONE_OK, LP_IPA_CODE,
  LP_NA, LP_TT, LP_SC, LP_IC, LP_IMG, LP_PA, LP_TRACKED, LP_W, LP_FEASIBLE,
  LP_FAIL_FIRST, LP_GENERAL_BITS, LP_REC, LP_STAMPS, LP_TICKET,
  LP_PEER_REC0, LP_PEER_REC1, LP_PEER_REC2, LP_PEER_REC3, LP_PEER_REC4,
  LP_PEER_REC5, LP_PEER_REC6, LP_PEER_STAMPS0, LP_PEER_STAMPS1,
  LP_PEER_STAMPS2, LP_PEER_STAMPS3, LP_PEER_STAMPS4, LP_PEER_STAMPS5,
  LP_PEER_STAMPS6, LP_GHOST_CPU, LP_GHOST_MEM, LP_GHOST_EPH, LP_GHOST_CNT,
  LP_COUNT
};

struct CycleLocalArgs {
  i64 v[CL_COUNT];
  void* p[LP_COUNT];
};

// host words of one shard's struct: its scalars, then its pointers
constexpr int CL_WORDS = CL_COUNT + LP_COUNT;
static_assert(sizeof(CycleLocalArgs) == 8 * CL_WORDS,
              "CycleLocalArgs layout");
static_assert(LP_PEER_STAMPS0 - LP_PEER_REC0 == MAX_PEERS
                  && LP_GHOST_CPU - LP_PEER_STAMPS0 == MAX_PEERS,
              "a peer slot for every peer");

struct CycleLocalGroup {
  CycleLocalArgs s[LOCAL_GROUP_SHARDS];
};
static_assert(sizeof(CycleLocalGroup) <= 4096, "the parameter bank");

// Row j's part of the record into the record `rec` (row s of this
// cycle's half on one device).
__device__ __forceinline__ void cycle_record_put(const CycleLocalArgs& a,
                                                 unsigned char* rec, int j,
                                                 i64 local, const CyclePod& pd,
                                                 int zone, bool feas) {
  const i64 o_na = a.v[CL_OFF_NA], o_tt = a.v[CL_OFF_TT],
            o_sc = a.v[CL_OFF_SC], o_ic = a.v[CL_OFF_IC],
            o_zone = a.v[CL_OFF_ZONE], o_tr = a.v[CL_OFF_TRACKED];
  ((i64*)(rec + a.v[CL_OFF_LOCAL]))[j] = local;
  if (o_na >= 0) ((i64*)(rec + o_na))[j] = pd.na[j];
  if (o_tt >= 0) ((i64*)(rec + o_tt))[j] = pd.tt[j];
  if (o_sc >= 0) ((i64*)(rec + o_sc))[j] = pd.sc[j];
  if (o_ic >= 0) ((i64*)(rec + o_ic))[j] = pd.ic[j];
  if (o_zone >= 0) ((int*)(rec + o_zone))[j] = zone;
  rec[a.v[CL_OFF_FEAS] + j] = feas;
  if (o_tr >= 0) rec[o_tr + j] = pd.tracked[j];
}

// Every thread of a row block calls it after its record stores. The last
// of the shard's `nblk` row blocks to get here (its ticket, reset for the
// next cycle) publishes the cycle's stamp at [round & 1, s] of every
// card's stamps. No-op under the host's copies (no stamps).
__device__ __forceinline__ void cycle_publish(const CycleLocalArgs& a,
                                              int nblk) {
  if (!a.p[LP_STAMPS]) return;
  const int n_peers = (int)a.v[CL_N_PEERS];
  if (n_peers) __threadfence_system();
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* ticket = (unsigned long long*)a.p[LP_TICKET];
  if (n_peers) __threadfence_system();
  if (atomicAdd(ticket, 1ull) != (unsigned long long)(nblk - 1)) return;
  *ticket = 0;  // for the next cycle's launch
  stamps_publish((i64*)a.p[LP_STAMPS], a.p + LP_PEER_STAMPS0, n_peers,
                 (size_t)(a.v[CL_ROUND] & 1) * (size_t)a.v[CL_D]
                     + (size_t)a.v[CL_INDEX],
                 a.v[CL_STAMP]);
}

__global__ void __launch_bounds__(LOCAL_GROUP_THREADS)
    shard_cycle_local_kernel(const __grid_constant__ CycleLocalGroup g) {
  typedef const unsigned char* B;
  typedef const i64* L;
  const CycleLocalArgs& a = g.s[blockIdx.y];
  const int rows = (int)a.v[CL_ROWS];
  const int nblk = (rows + LOCAL_GROUP_THREADS - 1) / LOCAL_GROUP_THREADS;
  if ((int)blockIdx.x >= nblk) return;  // past this shard's rows
  __shared__ i64 ws[W_K];
  if (threadIdx.x < W_K) ws[threadIdx.x] = ((L)a.p[LP_W])[threadIdx.x];
  __syncthreads();
  const int j = blockIdx.x * LOCAL_GROUP_THREADS + threadIdx.x;
  if (j < rows) {
    // n_real counted from this shard's first row: row j is in range iff
    // offset + j < n_real
    const CycleNodes nd{rows, (int)a.v[CL_S], a.v[CL_N_REAL] - a.v[CL_OFFSET],
                        0, (B)a.p[LP_VALID], (L)a.p[LP_ALLOC_CPU],
                        (L)a.p[LP_ALLOC_MEM], (L)a.p[LP_ALLOC_EPH],
                        (L)a.p[LP_ALLOWED], (L)a.p[LP_REQ_CPU],
                        (L)a.p[LP_REQ_MEM], (L)a.p[LP_REQ_EPH],
                        (L)a.p[LP_NZ_CPU], (L)a.p[LP_NZ_MEM],
                        (L)a.p[LP_POD_COUNT], (L)a.p[LP_ALLOC_SCALAR],
                        (L)a.p[LP_REQ_SCALAR], (const int*)a.p[LP_ZONE_ID]};
    const CyclePod pd{(L)a.p[LP_SCAL], (L)a.p[LP_REQ_SCALAR_P],
                      (B)a.p[LP_SEL_OK], (B)a.p[LP_TAINTS_OK],
                      (B)a.p[LP_UNSCHED_OK], (B)a.p[LP_PORTS_OK],
                      (B)a.p[LP_HOST_OK], (B)a.p[LP_DISK_OK],
                      (B)a.p[LP_MAXVOL_OK], (B)a.p[LP_VOLBIND_OK],
                      (B)a.p[LP_VOLZONE_OK],
                      (const signed char*)a.p[LP_IPA_CODE], (L)a.p[LP_NA],
                      (L)a.p[LP_TT], (L)a.p[LP_SC], (L)a.p[LP_IC],
                      (L)a.p[LP_IMG], (L)a.p[LP_PA], (B)a.p[LP_TRACKED], 0,
                      0, 0, 0};
    const bool skip = pd.scal[8] != 0;
    // the shard's slice of the nominated-ghost load (NULL: none)
    const CycleGhost ghost{(L)a.p[LP_GHOST_CPU], (L)a.p[LP_GHOST_MEM],
                           (L)a.p[LP_GHOST_EPH], (L)a.p[LP_GHOST_CNT]};
    const CycleGhost* gp = ghost.cpu ? &ghost : nullptr;
    const int gate = (int)a.v[CL_GATE];
    i64 bits;
    int ff;
    const bool feasible = cycle_filter_row(nd, pd, skip, j, gp, &bits, &ff);
    ((i64*)a.p[LP_GENERAL_BITS])[j] = bits;
    ((signed char*)a.p[LP_FAIL_FIRST])[j] = (signed char)ff;
    ((unsigned char*)a.p[LP_FEASIBLE])[j] = feasible;
    const i64 local = local_total_one(gate, ws, pd.scal[3] + nd.nz_cpu[j],
                                      pd.scal[4] + nd.nz_mem[j],
                                      nd.alloc_cpu[j], nd.alloc_mem[j])
                      + cycle_row_local(pd, gate, ws, j);
    const bool feas = feasible && (i64)j < nd.n_real;
    const int zone = nd.zone_id[j];
    const size_t half = (size_t)(a.v[CL_ROUND] & 1) * (size_t)a.v[CL_HALF];
    const int n_peers = (int)a.v[CL_N_PEERS];
    for (int k = 0; k <= n_peers; ++k)
      cycle_record_put(
          a, (unsigned char*)a.p[k == 0 ? LP_REC : LP_PEER_REC0 + k - 1]
                 + half,
          j, local, pd, zone, feas);
  }
  cycle_publish(a, nblk);
}

// Launch K9a over the `n` shards whose structs lie in `words` (n x
// CL_WORDS), a grid of (row blocks, shards) a launch, LOCAL_GROUP_SHARDS
// shards at most, on `stream` of `device`. Adds one to `*launched` for
// every launch it makes.
extern "C" int shard_cycle_local_launch(const i64* words, int n, int device,
                                        void* stream, int* launched) {
  const DeviceScope on(device);
  cudaError_t e = on.err;
  for (int k0 = 0; e == cudaSuccess && k0 < n; k0 += LOCAL_GROUP_SHARDS) {
    CycleLocalGroup g;
    const int m = n - k0 < LOCAL_GROUP_SHARDS ? n - k0 : LOCAL_GROUP_SHARDS;
    int rows = 1;
    for (int k = 0; k < LOCAL_GROUP_SHARDS; ++k) {
      // slots past the m shards repeat the first; no block reads them
      const i64* w = words + (size_t)(k0 + (k < m ? k : 0)) * CL_WORDS;
      for (int i = 0; i < CL_COUNT; ++i) g.s[k].v[i] = w[i];
      for (int i = 0; i < LP_COUNT; ++i)
        g.s[k].p[i] = (void*)w[CL_COUNT + i];
      if (k < m && (int)g.s[k].v[CL_ROWS] > rows)
        rows = (int)g.s[k].v[CL_ROWS];
    }
    const dim3 grid((rows + LOCAL_GROUP_THREADS - 1) / LOCAL_GROUP_THREADS,
                    m);
    shard_cycle_local_kernel<<<grid, LOCAL_GROUP_THREADS, 0,
                               (cudaStream_t)stream>>>(g);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  return (int)e;
}
