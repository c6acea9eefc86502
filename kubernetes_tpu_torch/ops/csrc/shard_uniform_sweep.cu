// K9c shard_uniform_sweep: one pass of the sharded uniform burst over the
// rows one shard owns, on the shard's own device.
//
// Replaces the per-pass O(N) sweep of `_uniform_core`
// (kubernetes_tpu/ops/kernels.py:1097-1320) that `sharded_uniform_fn`
// (kubernetes_tpu/parallel/sharding.py:151) keeps on each chip's rows
// with `constrain`. A pass:
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
// int32 shard max and feasible count.
//
// Shared with K3: `Ctx` (uniform.cuh), K3's per-node fit and score.
//
// Bound on the H100: latency. A pass reads R x 8 + ~30 B a row (about
// 0.3 MB for a 4,096-row shard, in L2) and writes 1 B a row. Design: ONE
// block of 1024 threads per shard; each thread owns a contiguous slice of
// the shard's rows, the max and the count are block reductions.
#include "uniform.cuh"

#include <climits>

enum {
  US_WIDTH, US_ROWS, US_OFFSET, US_N_REAL, US_R, US_NS, US_CHECK_RES,
  US_HAS_REQ, US_BAN, US_GATE, US_INIT, US_B, US_K, US_HOFF, US_COUNT
};
// pointer slots, in the order of `_SUS_PTRS`
enum {
  UP_W, UP_VALID, UP_EXTRA, UP_ALLOC_CPU, UP_ALLOC_MEM, UP_ALLOWED,
  UP_XALLOC, UP_SALLOC, UP_SUSED, UP_CLSV, UP_ST, UP_TOT0, UP_TOT, UP_FLAGS,
  UP_STATE, UP_FOLDED, UP_REC, UP_COUNT
};

struct SweepArgs {
  i64 v[US_COUNT];
  void* p[UP_COUNT];
};

__global__ void __launch_bounds__(NTHREADS)
    shard_uniform_sweep_kernel(SweepArgs a) {
  __shared__ i64 sh64[NWARPS];
  __shared__ i64 ws[W_K];
  const int wd = (int)a.v[US_WIDTH], rows = (int)a.v[US_ROWS];
  const int R = (int)a.v[US_R], NS = (int)a.v[US_NS], tid = threadIdx.x;
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
              clsv[3], clsv + 4, clsv + 4 + R};
  const i64* sreq = c.xreq + (R - 5);
  int lo, hi;
  if (a.v[US_INIT]) {
    const unsigned char* valid = (const unsigned char*)a.p[UP_VALID];
    const unsigned char* extra = (const unsigned char*)a.p[UP_EXTRA];
    const i64* salloc = (const i64*)a.p[UP_SALLOC];
    const i64* sused = (const i64*)a.p[UP_SUSED];
    const i64* tot0 = (const i64*)a.p[UP_TOT0];
    my_range(wd, &lo, &hi);
    for (int j = lo; j < hi; ++j) {
      bool o = false;
      int t = 0;
      if (j < rows) {
        o = valid[j] && off + j < a.v[US_N_REAL];
        if (extra) o = o && extra[j];
        for (int s = 0; s < NS; ++s)
          o = o && !(salloc[(size_t)s * wd + j]
                     < sreq[s] + sused[(size_t)s * wd + j]);
        t = (int)tot0[j];
      }
      ok[j] = o;
      banned[j] = 0;
      tot[j] = t;
    }
  }
  const i64 pass = state[ST_PASS];
  const i64 folded_before = folded[0];
  __syncthreads();   // the weights and the init are in; folded[0] was read
  if (pass > folded_before) {
    // 1. fold the previous pass's accepted lanes that name this shard
    if (tid < (int)state[ST_VFOLD]) {
      const i64 loc = state[ST_LANES + tid] - off;
      if (loc >= 0 && loc < rows) {
        const int j = (int)loc;
        for (int r = 0; r < R; ++r) st[(size_t)r * wd + j] += c.delta[r];
        tot[j] = c.score(j, 0);
        if (ban) banned[j] = 1;
      }
    }
    if (tid == 0) folded[0] = pass;
    __syncthreads();
  }
  if (state[ST_DONE] >= a.v[US_B]) return;
  // 2. sweep
  my_range(rows, &lo, &hi);
  int lmax = INT_MIN, lF = 0;
  for (int j = lo; j < hi; ++j) {
    const bool f = c.fit(j, 0) && !(ban && banned[j]);
    feas[j] = f;
    if (f) {
      ++lF;
      lmax = max(lmax, tot[j]);
    }
  }
  const int mx = (int)block_max64(lmax, sh64);
  const int F = (int)block_sum64(lF, sh64);
  for (int j = lo; j < hi; ++j) {
    const bool tie = feas[j] && tot[j] == mx;
    const bool stay = tie && !ban && c.score(j, 1) == mx && c.fit(j, 1);
    rec[j] = (unsigned char)(tie | (stay << 1));
  }
  if (tid == 0) {
    int* h = (int*)(rec + a.v[US_HOFF]);
    h[0] = mx;
    h[1] = F;
  }
}

extern "C" int shard_uniform_sweep_launch(const i64* iargs, void** ptrs,
                                          void* stream) {
  SweepArgs a;
  for (int i = 0; i < US_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < UP_COUNT; ++i) a.p[i] = ptrs[i];
  if (a.v[US_K] > NTHREADS) return (int)cudaErrorInvalidValue;
  shard_uniform_sweep_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
