// K7 preempt_scan: one preemptor's victim scan over every node at once,
// then the node pick, in one launch over the whole card.
//
// Replaces `_victim_select` + `_pick_one_node` + `_preempt_scan_core` ->
// `preemption_scan` (kubernetes_tpu/ops/kernels.py:1494, :1570, :1598,
// :1627): per node, remove every victim slot of priority below the
// preemptor's, check the fit, run the reprieve loop over the P slots in
// the host's sorted order; then the per-node aggregates and the staged
// five-criteria pick with a zero-victim instant win and ties to the lowest
// order_rank; the winner's row packed into [3+P] int32.
//
// Bound on the H100: bytes. The scan reads the seven [n_pad, P] victim
// planes and eight node rows once (about 11 MB at n_pad 16,384 and P 16,
// 88 MB at P 128) and does ~20 integer operations per slot step, far
// below the card's operation rate. Design: ONE grid-wide launch that
// fills the card (`preempt_grid` on the host: the SM count times the
// blocks an SM holds, fewer when the nodes run out):
//   - scan: a warp takes 32 consecutive nodes (a grid stride over such
//     groups), a thread a node. It stages their rows of the five wide
//     planes through shared memory, K7_CS slots at a time, by asynchronous
//     copies (cp.async) that the lanes issue on consecutive elements
//     (coalesced) to slot-major places, all in flight at once; meanwhile
//     each lane loads its own row's valid and violating bytes (16 at a
//     time). Each lane then walks its node's slots (`victim_node`'s
//     arithmetic) from shared memory without a bank conflict. Each plane
//     element is read once from global memory (once a pass past K7_CS
//     slots);
//   - pick: the pick is a lexicographic minimum, which splits over any
//     partition of the rows (`PickRec`: the lowest (rank, row) among the
//     zero-victim candidates, and the candidate at the minimum of (the five
//     criteria, rank, row)). Each lane folds its nodes and keeps its best
//     node's slot flags (P <= 128 bits); the warp combines its lanes by
//     shuffles, the block its warps, and writes one record with the
//     best's flags;
//   - the last block: each block then fences and draws a ticket; the block
//     that draws the last one reads every record past L1, combines them
//     and writes the packed block from the winning record (a zero-victim
//     winner, or none, has no victim: (w, 0, 0, zeros)), then puts the
//     ticket back to 0 for the next launch. No aggregate plane goes to
//     global memory and no row is walked twice.
// A warp a node (`victim_node_warp` for the scan) ran the reprieve chain in
// all 32 lanes and took longer than the two kernels it replaced.
// The ticket and the records are the wrapper's, one of each a device,
// zeroed once when allocated: launches on one stream run in turn, and
// each leaves the ticket at 0.
#include "victim.cuh"

#include <cuda_pipeline.h>

enum {
  PI_N_PAD, PI_P, PI_N_REAL, PI_MAX_PRIO, PI_CR, PI_HR, PI_REQ_CPU,
  PI_REQ_MEM, PI_REQ_EPH, PI_BLOCKS, PI_COUNT
};
// pointer slots, in the order of `_PREEMPT_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum {
  PP_ALLOC_CPU, PP_ALLOC_MEM, PP_ALLOC_EPH, PP_ALLOWED, PP_REQ_CPU,
  PP_REQ_MEM, PP_REQ_EPH, PP_POD_COUNT, PP_VCPU, PP_VMEM, PP_VEPH, PP_VPRIO,
  PP_VSTART, PP_VVALID, PP_VVIOL, PP_FEAS, PP_RANK, PP_RECORDS, PP_TICKET,
  PP_OUT, PP_COUNT
};

// warps of a block, threads of a block (`PREEMPT_THREADS` in kernels.py),
// slots of a staged chunk, the words of a staged slot (32 nodes and one
// more, so that the staging copies meet no bank twice), the victim slots
// a record's flags hold, and the int64 words of a block's record (the
// pick, then its best node's flags; `PREEMPT_RECORD_WORDS` in kernels.py)
constexpr int K7_WARPS = 2;
constexpr int K7_THREADS = 32 * K7_WARPS;
constexpr int K7_CS = 16;
constexpr int K7_LD = 33;
constexpr int K7_PMAX = 128;
constexpr int K7_FLAG_WORDS = K7_PMAX / 64;
constexpr int K7_WORDS = PK_WORDS + K7_FLAG_WORDS;

// a warp's 32 nodes x K7_CS slots of the five wide victim planes,
// slot-major: a lane reads its node's slot s from a row of its own bank
struct K7Tile {
  i64 cpu[K7_CS][K7_LD], mem[K7_CS][K7_LD], eph[K7_CS][K7_LD],
      prio[K7_CS][K7_LD];
  double start[K7_CS][K7_LD];
};

// a node's victim flags, one bit a slot (two words, held in registers)
struct K7Flags {
  unsigned long long w[K7_FLAG_WORDS];
};
static_assert(K7_FLAG_WORDS == 2, "a node's flags are two words");

struct PreemptArgs {
  i64 v[PI_COUNT];
  void* p[PP_COUNT];
};

__device__ __forceinline__ VictimRows preempt_rows(const PreemptArgs& a) {
  VictimRows r;
  r.alloc_cpu = (const i64*)a.p[PP_ALLOC_CPU];
  r.alloc_mem = (const i64*)a.p[PP_ALLOC_MEM];
  r.alloc_eph = (const i64*)a.p[PP_ALLOC_EPH];
  r.allowed = (const i64*)a.p[PP_ALLOWED];
  r.req_cpu = (const i64*)a.p[PP_REQ_CPU];
  r.req_mem = (const i64*)a.p[PP_REQ_MEM];
  r.req_eph = (const i64*)a.p[PP_REQ_EPH];
  r.pod_count = (const i64*)a.p[PP_POD_COUNT];
  r.g_cpu = r.g_mem = r.g_eph = r.g_cnt = 0;
  return r;
}

__device__ __forceinline__ VictimPlanes preempt_planes(const PreemptArgs& a) {
  VictimPlanes v;
  v.P = (int)a.v[PI_P];
  v.cpu = (const i64*)a.p[PP_VCPU];
  v.mem = (const i64*)a.p[PP_VMEM];
  v.eph = (const i64*)a.p[PP_VEPH];
  v.prio = (const i64*)a.p[PP_VPRIO];
  v.start = (const double*)a.p[PP_VSTART];
  v.valid = (const unsigned char*)a.p[PP_VVALID];
  v.viol = (const unsigned char*)a.p[PP_VVIOL];
  return v;
}

__device__ __forceinline__ VictimPod preempt_pod(const PreemptArgs& a) {
  VictimPod p;
  p.req_cpu = a.v[PI_REQ_CPU];
  p.req_mem = a.v[PI_REQ_MEM];
  p.req_eph = a.v[PI_REQ_EPH];
  p.max_prio = a.v[PI_MAX_PRIO];
  p.cr = a.v[PI_CR] != 0;
  p.hr = a.v[PI_HR] != 0 && p.cr;
  return p;
}

// candidate node j: feas_static and in range
__device__ __forceinline__ bool preempt_static(const PreemptArgs& a, int j) {
  return ((const unsigned char*)a.p[PP_FEAS])[j] && (i64)j < a.v[PI_N_REAL];
}

// Slots [c0, c0 + cs) of the warp's nodes [j0, j0 + 32) into its tile:
// the lanes copy consecutive elements of each plane (asynchronously, to
// their slot-major places). Every lane of the warp calls it; `k7_wait`
// ends the copies. FULL: every chunk holds K7_CS slots (P a multiple of
// it), known to the compiler.
template <bool FULL>
__device__ __forceinline__ void k7_stage(K7Tile& t, const VictimPlanes& v,
                                         int n, int j0, int c0, int cs,
                                         int lane) {
  if (FULL) cs = K7_CS;
  __syncwarp();  // every lane is done with the previous chunk
#pragma unroll 4
  for (int e = lane; e < 32 * cs; e += 32) {
    const int row = e / cs, s = e - row * cs;
    if (j0 + row >= n) continue;
    const size_t g = (size_t)(j0 + row) * v.P + c0 + s;
    __pipeline_memcpy_async(&t.cpu[s][row], v.cpu + g, 8);
    __pipeline_memcpy_async(&t.mem[s][row], v.mem + g, 8);
    __pipeline_memcpy_async(&t.eph[s][row], v.eph + g, 8);
    __pipeline_memcpy_async(&t.prio[s][row], v.prio + g, 8);
    __pipeline_memcpy_async(&t.start[s][row], v.start + g, 8);
  }
  __pipeline_commit();
}

__device__ __forceinline__ void k7_wait() {
  __pipeline_wait_prior(0);
  __syncwarp();  // every lane's copies have landed
}

// one bit a nonzero byte of the 16 bytes in x
__device__ __forceinline__ unsigned k7_byte_bits(uint4 x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  unsigned b = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    b |= ((w[k >> 2] >> (8 * (k & 3))) & 0xffu ? 1u : 0u) << k;
  return b;
}

// the bits of slots [c0, c0 + cs) of byte plane `p`'s row j: one 16-byte
// load where aligned, else a byte at a time
__device__ __forceinline__ unsigned k7_bits(const unsigned char* p, int P,
                                            int j, int c0, int cs) {
  const unsigned char* q = p + (size_t)j * P + c0;
  if (cs == 16 && ((size_t)q & 15) == 0)
    return k7_byte_bits(*(const uint4*)q);
  unsigned b = 0;
  for (int s = 0; s < cs; ++s) b |= (q[s] ? 1u : 0u) << s;
  return b;
}

// selectVictimsOnNode for node j0 + lane (`victim_node`, victim.cuh, on
// the slots the warp stages; no nominated ghost), and its victim flags.
// Every lane of the warp calls it; a lane past the node axis returns no
// candidate. FULL as `k7_stage`: the slot loops unroll.
template <bool FULL>
__device__ __forceinline__ VictimAgg k7_node(K7Tile& t, const VictimRows& r,
                                             const VictimPlanes& v,
                                             const VictimPod& p,
                                             bool feas_static, int n,
                                             int j0, int lane,
                                             K7Flags* flags) {
  const int j = j0 + lane, P = v.P;
  const bool live = j < n, one = P <= K7_CS;
  // the node's rows, loaded while the first chunk's copies fly
  i64 rc = 0, rm = 0, re = 0, pc = 0, acpu = 0, amem = 0, aeph = 0,
      allowed = 0;
  if (live) {
    rc = r.req_cpu[j];
    rm = r.req_mem[j];
    re = r.req_eph[j];
    pc = r.pod_count[j];
    acpu = r.alloc_cpu[j];
    amem = r.alloc_mem[j];
    aeph = r.alloc_eph[j];
    allowed = r.allowed[j];
  }
  unsigned vb = 0, xb = 0;  // this chunk's valid and violating bits
  // pass 1: every potential victim removed
  i64 scpu = 0, smem = 0, seph = 0, nvic = 0, prio0 = 0;
  for (int c0 = 0; c0 < P; c0 += K7_CS) {
    const int cs = FULL ? K7_CS : min(K7_CS, P - c0);
    if (!one || c0 == 0) {
      k7_stage<FULL>(t, v, n, j0, c0, cs, lane);
      if (live) {
        vb = k7_bits(v.valid, P, j, c0, cs);
        xb = k7_bits(v.viol, P, j, c0, cs);
      }
      k7_wait();
    }
    if (c0 == 0) prio0 = t.prio[0][lane];
#pragma unroll
    for (int s = 0; s < cs; ++s)
      if (((vb >> s) & 1) && t.prio[s][lane] < p.max_prio) {
        scpu += t.cpu[s][lane];
        smem += t.mem[s][lane];
        seph += t.eph[s][lane];
        ++nvic;
      }
  }
  // the fit's running totals: the pod's request plus the node's load
  // (req + (rc + c) == (req + rc) + c in wrapping int64, so the request is
  // added once), the pod count plus one
  i64 tc = p.req_cpu + (rc - scpu), tm = p.req_mem + (rm - smem),
      te = p.req_eph + (re - seph), tk = pc - nvic + 1;
  auto fits = [&](i64 c, i64 m, i64 e, i64 k) -> bool {
    bool f = true;
    if (p.cr) f = f && k <= allowed;
    if (p.hr) f = f && acpu >= c && amem >= m && aeph >= e;
    return f;
  };
  VictimAgg a;
  a.feas0 = live && feas_static && fits(tc, tm, te, tk);
  a.nv = a.viol_ct = a.sum_prio = 0;
  a.earliest_high = dinf();
  a.first_prio = prio0;
  unsigned long long f0 = 0, f1 = 0;  // the victim flags, slots 0-63, 64-127
  i64 high = LLONG_MIN;
  bool found = false;
  // pass 2: the reprieve walk in the host's order
  for (int c0 = 0; c0 < P; c0 += K7_CS) {
    const int cs = FULL ? K7_CS : min(K7_CS, P - c0);
    if (!one) {
      k7_stage<FULL>(t, v, n, j0, c0, cs, lane);
      if (live) {
        vb = k7_bits(v.valid, P, j, c0, cs);
        xb = k7_bits(v.viol, P, j, c0, cs);
      }
      k7_wait();
    }
#pragma unroll
    for (int s = 0; s < cs; ++s) {
      const i64 pr = t.prio[s][lane];
      const bool vval = ((vb >> s) & 1) && pr < p.max_prio;
      const i64 nc = tc + t.cpu[s][lane],
                nm = tm + t.mem[s][lane],
                ne = te + t.eph[s][lane], nk = tk + (vval ? 1 : 0);
      const bool keep = vval && a.feas0 && fits(nc, nm, ne, nk);
      if (keep) {
        tc = nc;
        tm = nm;
        te = ne;
        tk = nk;
      }
      if (vval && !keep && a.feas0) {
        const double st = t.start[s][lane];
        const int slot = c0 + s;
        if (slot < 64)
          f0 |= 1ull << slot;
        else
          f1 |= 1ull << (slot - 64);
        ++a.nv;
        a.viol_ct += (xb >> s) & 1;
        if (!found) a.first_prio = pr;
        found = true;
        a.sum_prio += pr + (1LL << 31);
        // min start over the victims of the highest priority, kept online
        if (pr > high) {
          high = pr;
          a.earliest_high = st;
        } else if (pr == high && st < a.earliest_high) {
          a.earliest_high = st;
        }
      }
    }
  }
  flags->w[0] = f0;
  flags->w[1] = f1;
  return a;
}

// the lanes' records combined, in every lane (`pick_comb` is commutative:
// no two candidates share a row)
__device__ __forceinline__ PickRec warp_pick(PickRec v) {
  for (int o = 16; o > 0; o >>= 1) {
    PickRec u;
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w)
      u.w[w] = __shfl_xor_sync(0xffffffffu, v.w[w], o);
    v = pick_comb(v, u);
  }
  return v;
}

// The warps' picks and their best nodes' flags (in `wrec`, `wflags`)
// combined by one thread: the pick, and in `*src` the warp whose flags
// are its best's (-1: no candidate)
__device__ __forceinline__ PickRec block_pick(const PickRec* wrec,
                                              int* src) {
  PickRec r = wrec[0];
  *src = 0;
  for (int k = 1; k < K7_WARPS; ++k) {
    if (pick_before(wrec[k], r)) *src = k;
    r = pick_comb(r, wrec[k]);
  }
  if (r.w[PK_BROW] < 0) *src = -1;
  return r;
}

// A warp's pick of its lanes' (`r`, each lane's best node's flags
// `best`) into wrec[wid] and wflags[wid]
__device__ __forceinline__ void warp_record(PickRec r, const K7Flags& best,
                                            PickRec* wrec, K7Flags* wflags,
                                            int lane, int wid) {
  const i64 mine = r.w[PK_BROW];
  r = warp_pick(r);
  if (lane == 0) wrec[wid] = r;
  if (r.w[PK_BROW] >= 0 && r.w[PK_BROW] == mine) wflags[wid] = best;
}

template <bool FULL>
__global__ void __launch_bounds__(K7_THREADS)
    preempt_scan_kernel(PreemptArgs a) {
  __shared__ K7Tile tile[K7_WARPS];
  __shared__ PickRec wrec[K7_WARPS];
  __shared__ K7Flags wflags[K7_WARPS];
  __shared__ int last;
  const int n = (int)a.v[PI_N_PAD], G = (int)gridDim.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const VictimRows rows = preempt_rows(a);
  const VictimPlanes planes = preempt_planes(a);
  const VictimPod pod = preempt_pod(a);
  const i64* rank = (const i64*)a.p[PP_RANK];
  i64* records = (i64*)a.p[PP_RECORDS];  // [K7_WORDS][G]
  // ---- the scan: a thread a node, 32 nodes a warp, folded into its pick --
  PickRec r = pick_none();
  K7Flags best{};  // the flags of this lane's best candidate
  for (int g = blockIdx.x * K7_WARPS + wid; g * 32 < n; g += G * K7_WARPS) {
    const int j = g * 32 + lane;
    K7Flags f;
    const VictimAgg v = k7_node<FULL>(tile[wid], rows, planes, pod,
                                j < n && preempt_static(a, j), n, g * 32,
                                lane, &f);
    if (j < n && pick_add(r, v, rank[j], j)) best = f;
  }
  // ---- the block's record -------------------------------------------------
  warp_record(r, best, wrec, wflags, lane, wid);
  __syncthreads();
  if (threadIdx.x == 0) {
    int src;
    r = block_pick(wrec, &src);
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w)
      records[(size_t)w * G + blockIdx.x] = r.w[w];
#pragma unroll
    for (int w = 0; w < K7_FLAG_WORDS; ++w)
      records[(size_t)(PK_WORDS + w) * G + blockIdx.x] =
          src >= 0 ? (i64)wflags[src].w[w] : 0;
    // the record is visible to every block before the ticket is drawn
    __threadfence();
    last = atomicAdd((unsigned int*)a.p[PP_TICKET], 1u) == (unsigned)G - 1;
  }
  __syncthreads();
  if (!last) return;
  // ---- the last block: every record, the pick, the packed block ----------
  __threadfence();
  r = pick_none();
  for (int b = threadIdx.x; b < G; b += K7_THREADS) {
    PickRec u;
    K7Flags f;
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w)
      u.w[w] = __ldcg(records + (size_t)w * G + b);
#pragma unroll
    for (int w = 0; w < K7_FLAG_WORDS; ++w)
      f.w[w] = (unsigned long long)__ldcg(records
                                          + (size_t)(PK_WORDS + w) * G + b);
    if (pick_before(u, r)) best = f;
    r = pick_comb(r, u);
  }
  warp_record(r, best, wrec, wflags, lane, wid);
  __syncthreads();
  __shared__ int src;
  if (threadIdx.x == 0) {
    r = block_pick(wrec, &src);
    // no candidate, or a zero-victim winner: no victim, (w, 0, 0, zeros)
    const i64 w = pick_winner(r);
    if (r.w[PK_ZROW] >= 0) src = -1;
    int* out = (int*)a.p[PP_OUT];
    out[0] = (int)w;
    out[1] = src >= 0 ? wrap32((i64)r.crit(3)) : 0;  // its victim count
    out[2] = src >= 0 ? wrap32((i64)r.crit(0)) : 0;  // and PDB violations
    // the ticket back to 0 for the next launch
    *(unsigned int*)a.p[PP_TICKET] = 0u;
  }
  __syncthreads();
  int* flags = (int*)a.p[PP_OUT] + 3;
  for (int q = threadIdx.x; q < planes.P; q += K7_THREADS)
    flags[q] = src >= 0 ? (int)((wflags[src].w[q >> 6] >> (q & 63)) & 1)
                        : 0;
}

// -1: a grid of no block; -2: the grid's record array missing; -3: more
// victim slots than a record's flags hold.
extern "C" int preempt_scan_launch(const i64* iargs, void** ptrs,
                                   void* stream) {
  PreemptArgs a;
  for (int i = 0; i < PI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PP_COUNT; ++i) a.p[i] = ptrs[i];
  const int blocks = (int)a.v[PI_BLOCKS];
  if (blocks < 1) return -1;
  if (!a.p[PP_RECORDS] || !a.p[PP_TICKET]) return -2;
  if (a.v[PI_P] < 1 || a.v[PI_P] > K7_PMAX) return -3;
  // the slot loops unroll where every chunk is whole (P 16, 128, ...)
  if (a.v[PI_P] % K7_CS == 0)
    preempt_scan_kernel<true><<<blocks, K7_THREADS, 0,
                                (cudaStream_t)stream>>>(a);
  else
    preempt_scan_kernel<false><<<blocks, K7_THREADS, 0,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The card's SM count and how many K7 blocks an SM holds at once (0: none;
// the fewer of the two instantiations') on the current device.
extern "C" int preempt_scan_occupancy(int* sms, int* per_sm) {
  int dev = 0, full = 0, part = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &full, preempt_scan_kernel<true>, K7_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &part, preempt_scan_kernel<false>, K7_THREADS, 0);
  *per_sm = full < part ? full : part;
  return (int)e;
}
