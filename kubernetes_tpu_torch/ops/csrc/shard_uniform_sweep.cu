// K9c shard_uniform_sweep: one pass of the sharded uniform burst over the
// rows of every shard one device holds, in one launch.
//
// Replaces the per-pass O(N) sweep of `_uniform_core`
// (kubernetes_tpu/ops/kernels.py:1097-1320) that `sharded_uniform_fn`
// (kubernetes_tpu/parallel/sharding.py:151) keeps on each chip's rows
// with `constrain`. A pass, per shard:
//   0. init (the burst's first pass, read from the device's pass state:
//      ST_PASS 0): the ok mask and the scores;
//   1. fold: the lanes K9d accepted in the previous pass that name this
//      shard's rows add the class delta to the carried rows, rescore and
//      (with `ban`) ban their node; once per pass, by the pass counter;
//   2. sweep (while the burst is not done): the feasible rows, the
//      shard's max score and feasible count, and per row a tie bit
//      (feasible at the shard max) and a stay bit (after one more fold it
//      still fits and keeps that score: JAX's lane test, asked ahead for
//      every tie). A shard whose max is below the global one holds no tie
//      of the global max, and every tie of the global max is a tie of its
//      shard's max, so the gathered bits are exact.
// The record is `rows` bytes (bit 0 tie, bit 1 stay) and, at `hoff`, the
// int32 shard max and feasible count, written in place into row s of the
// device's gathered buffer, where K9d reads it.
//
// Shared with K3: `Ctx` (uniform.cuh), K3's per-node fit and score.
//
// Bound on the H100: latency. A pass reads R x 8 + ~30 B a row (about
// 0.3 MB for a 4,096-row shard, in L2) and writes 1 B a row. Design: ONE
// launch a device and pass over its shards (up to SWEEP_GROUP a launch,
// their argument structs in one `__grid_constant__` parameter), each shard
// a thread-block cluster of SWEEP_BLOCKS blocks (32 SMs busy for four
// shards, where one block a shard kept four). Block b of a shard owns the
// contiguous slice b of its rows: it folds the lanes that land there,
// sweeps them, and keeps its max and feasible count in shared memory. The
// tie bit needs the shard's max before any row's bit is final, so the
// stay bit is computed for every feasible row against its own score
// (equal to the shard max's test on a tie), one cluster barrier makes
// every block's max and count readable, and each block then keeps the bits
// of its ties. Block 0 writes the header and the pass it folded. No ticket
// and no second launch: the barrier is the cluster's.
#include "uniform.cuh"

#include <climits>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

enum {
  US_WIDTH, US_ROWS, US_OFFSET, US_N_REAL, US_R, US_NS, US_CHECK_RES,
  US_HAS_REQ, US_BAN, US_GATE, US_B, US_K, US_HOFF, US_COUNT
};
// pointer slots, in the order of `_SUS_PTRS`
enum {
  UP_W, UP_VALID, UP_EXTRA, UP_ALLOC_CPU, UP_ALLOC_MEM, UP_ALLOWED,
  UP_XALLOC, UP_SALLOC, UP_SUSED, UP_CLSV, UP_ST, UP_TOT, UP_FLAGS, UP_STATE,
  UP_FOLDED, UP_REC, UP_COUNT
};

struct SweepArgs {
  i64 v[US_COUNT];
  void* p[UP_COUNT];
};

// blocks of a shard's cluster, threads a block (`SWEEP_BLOCKS`,
// `SWEEP_THREADS` in kernels.py)
constexpr int SWEEP_BLOCKS = 8;
constexpr int SWEEP_THREADS = 512;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
// shards a launch covers; a device holding more takes one launch per as
// many (`SWEEP_GROUP`)
constexpr int SWEEP_GROUP = 4;
// host words of one shard's struct: its scalars, then its pointers
constexpr int SW_WORDS = US_COUNT + UP_COUNT;
static_assert(sizeof(SweepArgs) == 8 * SW_WORDS, "SweepArgs layout");

struct SweepGroup {
  SweepArgs s[SWEEP_GROUP];
};

__device__ __forceinline__ void sweep_reduce(int* mx, int* cnt, int* smx,
                                             int* scnt) {
  int m = *mx, c = *cnt;
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_down_sync(0xffffffffu, m, o));
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  if ((threadIdx.x & 31) == 0) {
    smx[threadIdx.x >> 5] = m;
    scnt[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  m = smx[0];
  c = scnt[0];
  for (int i = 1; i < SWEEP_WARPS; ++i) {
    m = max(m, smx[i]);
    c += scnt[i];
  }
  *mx = m;
  *cnt = c;
}

__global__ void __cluster_dims__(SWEEP_BLOCKS, 1, 1)
    __launch_bounds__(SWEEP_THREADS)
    shard_uniform_sweep_kernel(const __grid_constant__ SweepGroup grp) {
  __shared__ i64 ws[W_K];
  __shared__ int smx[SWEEP_WARPS], scnt[SWEEP_WARPS];
  __shared__ int part[2];  // this block's max and feasible count
  cg::cluster_group cl = cg::this_cluster();
  const SweepArgs& a = grp.s[blockIdx.y];
  const int rank = (int)cl.block_rank(), tid = threadIdx.x;
  const int wd = (int)a.v[US_WIDTH], rows = (int)a.v[US_ROWS];
  const int R = (int)a.v[US_R], NS = (int)a.v[US_NS];
  const i64 off = a.v[US_OFFSET];
  const bool ban = a.v[US_BAN] != 0;
  const i64* clsv = (const i64*)a.p[UP_CLSV];
  i64* st = (i64*)a.p[UP_ST];
  int* tot = (int*)a.p[UP_TOT];
  unsigned char* ok = (unsigned char*)a.p[UP_FLAGS];
  unsigned char* banned = ok + wd;
  unsigned char* feas = ok + 2 * (size_t)wd;
  const i64* state = (const i64*)a.p[UP_STATE];
  i64* folded = (i64*)a.p[UP_FOLDED];
  unsigned char* rec = (unsigned char*)a.p[UP_REC];
  if (tid < W_K) ws[tid] = ((const i64*)a.p[UP_W])[tid];
  const Ctx c{wd, R, (int)a.v[US_CHECK_RES], (int)a.v[US_HAS_REQ],
              (int)a.v[US_GATE], ok, st, (const i64*)a.p[UP_ALLOWED],
              (const i64*)a.p[UP_ALLOC_CPU], (const i64*)a.p[UP_ALLOC_MEM],
              (const i64*)a.p[UP_XALLOC], ws, clsv[0], clsv[1], clsv[2],
              clsv[3], clsv + 4, clsv + 4 + R, wd};
  const i64* sreq = c.xreq + (R - 5);
  // this block's slice [lo, hi) of the shard's columns
  const int chunk = (wd + SWEEP_BLOCKS - 1) / SWEEP_BLOCKS;
  const int lo = min(rank * chunk, wd), hi = min(lo + chunk, wd);
  const i64 pass = state[ST_PASS];
  const i64 folded_before = folded[0];
  __syncthreads();   // the weights are in
  if (pass == 0) {
    // 0. the burst's first pass: the ok mask and the scores (K1's
    // `_local_total` of the shard's carried rows, inline)
    const unsigned char* valid = (const unsigned char*)a.p[UP_VALID];
    const unsigned char* extra = (const unsigned char*)a.p[UP_EXTRA];
    const i64* salloc = (const i64*)a.p[UP_SALLOC];
    const i64* sused = (const i64*)a.p[UP_SUSED];
    for (int j = lo + tid; j < hi; j += SWEEP_THREADS) {
      bool o = false;
      int t = 0;
      if (j < rows) {
        o = valid[j] && off + j < a.v[US_N_REAL];
        if (extra) o = o && extra[j];
        for (int s = 0; s < NS; ++s)
          o = o && !(salloc[(size_t)s * wd + j]
                     < sreq[s] + sused[(size_t)s * wd + j]);
        t = c.score(j, 0);
      }
      ok[j] = o;
      banned[j] = 0;
      tot[j] = t;
    }
  }
  if (pass > folded_before && tid < (int)state[ST_VFOLD]) {
    // 1. fold the previous pass's accepted lanes that name this slice
    const i64 loc = state[ST_LANES + tid] - off;
    if (loc >= lo && loc < hi && loc < rows) {
      const int j = (int)loc;
      for (int r = 0; r < R; ++r) st[(size_t)r * wd + j] += c.delta[r];
      tot[j] = c.score(j, 0);
      if (ban) banned[j] = 1;
    }
  }
  // every block has read folded[0]
  cl.sync();
  if (rank == 0 && tid == 0 && pass > folded_before) folded[0] = pass;
  if (state[ST_DONE] >= a.v[US_B]) return;  // alike in every block
  // 2. sweep this slice: the feasible rows, their max and count, and per
  // feasible row the stay bit against its own score
  int lmax = INT_MIN, lF = 0;
  const int shi = min(hi, rows);
  for (int j = lo + tid; j < shi; j += SWEEP_THREADS) {
    const bool f = c.fit(j, 0) && !(ban && banned[j]);
    feas[j] = f;
    bool stay = false;
    if (f) {
      ++lF;
      lmax = max(lmax, tot[j]);
      stay = !ban && c.score(j, 1) == tot[j] && c.fit(j, 1);
    }
    rec[j] = (unsigned char)(stay << 1);
  }
  sweep_reduce(&lmax, &lF, smx, scnt);
  if (tid == 0) {
    part[0] = lmax;
    part[1] = lF;
  }
  // every block's max and count are in its shared memory
  cl.sync();
  int mx = INT_MIN, F = 0;
  for (int b = 0; b < SWEEP_BLOCKS; ++b) {
    const int* pb = cl.map_shared_rank(part, b);
    mx = max(mx, pb[0]);
    F += pb[1];
  }
  // the ties keep their stay bit; every other row's byte is 0
  for (int j = lo + tid; j < shi; j += SWEEP_THREADS) {
    const bool tie = feas[j] && tot[j] == mx;
    rec[j] = tie ? (unsigned char)(1 | rec[j]) : (unsigned char)0;
  }
  if (rank == 0 && tid == 0) {
    int* h = (int*)(rec + a.v[US_HOFF]);
    h[0] = mx;
    h[1] = F;
  }
  // no block leaves while a peer may still read its shared memory
  cl.sync();
}

// Launch K9c over the `n` shards whose structs lie in `words` (n x
// SW_WORDS), a grid of (SWEEP_BLOCKS, shards) a launch, on `stream` of
// `device`. Adds one to `*launched` for every launch it makes.
extern "C" int shard_uniform_sweep_launch(const i64* words, int n,
                                          int device, void* stream,
                                          int* launched) {
  const DeviceScope on(device);
  cudaError_t e = on.err;
  for (int k0 = 0; e == cudaSuccess && k0 < n; k0 += SWEEP_GROUP) {
    SweepGroup g;
    const int m = n - k0 < SWEEP_GROUP ? n - k0 : SWEEP_GROUP;
    for (int k = 0; k < SWEEP_GROUP; ++k) {
      // slots past the m shards repeat the first; no block reads them
      const i64* w = words + (size_t)(k0 + (k < m ? k : 0)) * SW_WORDS;
      for (int i = 0; i < US_COUNT; ++i) g.s[k].v[i] = w[i];
      for (int i = 0; i < UP_COUNT; ++i)
        g.s[k].p[i] = (void*)w[US_COUNT + i];
      if (k < m && g.s[k].v[US_K] > SWEEP_THREADS)
        return (int)cudaErrorInvalidValue;
    }
    shard_uniform_sweep_kernel<<<dim3(SWEEP_BLOCKS, m), SWEEP_THREADS, 0,
                                 (cudaStream_t)stream>>>(g);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  return (int)e;
}
