// K9d shard_uniform_select: the replicated half of one sharded uniform
// pass, over the tie / stay bytes and shard maxima K9c wrote, gathered
// onto this device.
//
// Replaces the replicated tie-walk epilogue of `_uniform_core`
// (kubernetes_tpu/ops/kernels.py:1097-1320) inside `sharded_uniform_fn`
// (kubernetes_tpu/parallel/sharding.py:151): the global max (the largest
// shard max) and feasible count, the tie set (the tie bits of the shards
// at that max), the tie walk in each rotation order (JAX's
// `searchsorted` / `C_all[oid]`), the lane-0 STAY/ELIM probe, the K
// lanes' nodes, `first_bad`, the duplicate cut `first_dup` (a scatter-min
// on `owner` over the whole lane set, never per shard), the accept cut v,
// the emitted decisions and the pass state the shards fold from. A lane's
// fit and score after one more fold are its node's stay bit. Every
// distinct device runs it on the same bytes; a no-op once the burst is
// done.
//
// Shared with K3: the body of its pass loop (uniform_burst.cu steps 2-4),
// with the stay bits in place of its lane refold, and `block_*` helpers.
//
// Bound on the H100: latency, as K3's pass: n_pad bytes in (plus L x
// n_pad perm entries under rotation), K int32 out. Design: ONE block of
// 1024 threads; it unpacks the shard records into flat tie / stay bytes,
// then compacts the tie list(s) by a block prefix sum.
#include "uniform.cuh"

#include <climits>

enum {
  UD_N_PAD, UD_ROWS, UD_D, UD_STRIDE, UD_HOFF, UD_B, UD_K, UD_CAP, UD_L,
  UD_N_OID, UD_BAN, UD_COUNT
};
// pointer slots, in the order of `_SUD_PTRS`
enum {
  DP_GATHERED, DP_PERM, DP_OID_SEQ, DP_STATE, DP_OUT, DP_LNI_OUT, DP_FLAT,
  DP_TIES, DP_OWNER, DP_COUNT
};

struct PassArgs {
  i64 v[UD_COUNT];
  void* p[DP_COUNT];
};

__global__ void __launch_bounds__(NTHREADS)
    shard_uniform_select_kernel(PassArgs a) {
  __shared__ i64 sh64[NWARPS];
  __shared__ int sh32[NWARPS];
  const int n = (int)a.v[UD_N_PAD], rows = (int)a.v[UD_ROWS];
  const int D = (int)a.v[UD_D], K = (int)a.v[UD_K], L = (int)a.v[UD_L];
  const int tid = threadIdx.x;
  const size_t stride = (size_t)a.v[UD_STRIDE];
  const i64 hoff = a.v[UD_HOFF];
  const bool ban = a.v[UD_BAN] != 0, rotate = L > 0;
  i64* state = (i64*)a.p[DP_STATE];
  const i64 done = state[ST_DONE];
  if (done >= a.v[UD_B]) return;
  const i64 lni = state[ST_LNI];
  const unsigned char* g = (const unsigned char*)a.p[DP_GATHERED];
  const int* perm = (const int*)a.p[DP_PERM];
  const int* oid_seq = (const int*)a.p[DP_OID_SEQ];
  int* out = (int*)a.p[DP_OUT];
  int* ties = (int*)a.p[DP_TIES];
  int* owner = (int*)a.p[DP_OWNER];
  unsigned char* tie = (unsigned char*)a.p[DP_FLAT];
  unsigned char* stay = tie + n;
  // the global max and feasible count
  int mx = INT_MIN, F = 0;
  for (int s = 0; s < D; ++s) {
    const int* h = (const int*)(g + s * stride + hoff);
    mx = max(mx, h[0]);
    F += h[1];
  }
  for (int j = tid; j < n; j += NTHREADS) {
    const int s = j / rows, jj = j - s * rows;
    const unsigned char b = g[s * stride + jj];
    const int smax = ((const int*)(g + s * stride + hoff))[0];
    tie[j] = (b & 1) && smax == mx;
    stay[j] = (b >> 1) & 1;
  }
  __syncthreads();
  int lo, hi;
  my_range(n, &lo, &hi);
  // tie lists (one per rotation order), compacted in walk order
  int T = 0;
  if (!rotate) {
    int lT = 0;
    for (int j = lo; j < hi; ++j) lT += tie[j];
    int o = block_excl_scan(lT, sh32, &T);
    for (int j = lo; j < hi; ++j)
      if (tie[j]) ties[o++] = j;
  } else {
    for (int l = 0; l < L; ++l) {
      const int* pr = perm + (size_t)l * (n + 1);
      int lT = 0;
      for (int p = lo; p < hi; ++p) {
        const int q = pr[p];
        lT += q >= 0 && q < n && tie[q];
      }
      int o = block_excl_scan(lT, sh32, &T);
      for (int p = lo; p < hi; ++p) {
        const int q = pr[p];
        if (q >= 0 && q < n && tie[q]) ties[(size_t)l * n + o++] = q;
      }
    }
  }
  __syncthreads();
  const int remaining = (int)(a.v[UD_B] - done);
  const bool kbig = T >= 2 && F > 1;
  int oid_j = 0, oid0 = 0;
  if (rotate) {
    const int n_oid = (int)a.v[UD_N_OID];
    const int start = min(max((int)done, 0), max(n_oid - K, 0));
    oid0 = min(max(oid_seq[start], 0), L - 1);
    if (tid < K) oid_j = min(max(oid_seq[start + tid], 0), L - 1);
  }
  // lane-0 probe: STAY vs ELIM
  bool elim;
  if (ban) {
    elim = kbig;
  } else if (!kbig) {
    elim = false;
  } else {
    const int pos0 = (int)floormod(lni, (i64)max(T, 1));
    elim = !stay[ties[(size_t)oid0 * n + pos0]];
  }
  const int lim = min(remaining, K);
  const int m_stay = min(lim, T);
  const int max_elim = max((int)floordiv((i64)T - lni + 1, 2), 1);
  int m_elim = min(lim, min(max_elim, max(F - 1, 1)));
  if (rotate) {
    const int diff = (tid < K && oid_j != oid0) ? tid : K;
    const int same = (int)block_min64(diff, sh64);
    m_elim = min(m_elim, max(same, 1));
  }
  const int m = F == 0 ? lim : (elim ? m_elim : (kbig ? m_stay : 1));
  // lanes
  const bool active = tid < m && F > 0;
  int sel = n;
  bool fail = false;
  if (active) {
    const i64 p = (elim && m > 1)
                      ? imin64(lni + 2 * (i64)tid, (i64)max(T - 1, 0))
                      : floormod(lni + tid, (i64)max(T, 1));
    sel = ties[(size_t)(rotate ? oid_j : 0) * n + (int)p];
    const bool leaves = ban ? true : !stay[sel];
    fail = elim ? !leaves : leaves;
  }
  const int first_bad = (int)block_min64(fail ? tid : K, sh64);
  int v = F == 0 ? m : min(first_bad + 1, m);
  if (rotate) {
    if (active) atomicMin(&owner[sel], tid);
    __syncthreads();
    const bool dup = active && owner[sel] != tid;
    const int first_dup = (int)block_min64(dup ? tid : K, sh64);
    if (active) owner[sel] = K;
    v = min(v, first_dup);
    v = F == 0 ? m : max(v, 1);
  }
  // emit, and hand the accepted lanes to the shards
  if (tid < K) {
    out[done + tid] = (tid < v && F > 0) ? sel : -1;
    state[ST_LANES + tid] = sel;
  }
  if (tid == 0) {
    const i64 lni2 = lni + (F > 1 ? v : 0);
    state[ST_DONE] = done + v;
    state[ST_LNI] = lni2;
    state[ST_PASS] += 1;
    state[ST_VFOLD] = F > 0 ? v : 0;
    out[a.v[UD_CAP]] = (int)(lni2 - state[ST_LNI0]);
    ((i64*)a.p[DP_LNI_OUT])[0] = lni2;
  }
}

extern "C" int shard_uniform_select_launch(const i64* iargs, void** ptrs,
                                           void* stream) {
  PassArgs a;
  for (int i = 0; i < UD_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < DP_COUNT; ++i) a.p[i] = ptrs[i];
  if (a.v[UD_K] > NTHREADS) return (int)cudaErrorInvalidValue;
  shard_uniform_select_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
