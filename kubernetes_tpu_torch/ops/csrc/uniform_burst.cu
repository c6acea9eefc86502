// K3 uniform_burst: a burst of spec-identical pods, up to K (512) pods
// resolved per O(N) pass, the whole burst in one launch.
//
// Replaces `_uniform_core` -> `schedule_batch_uniform`
// (kubernetes_tpu/ops/kernels.py:1097, :1364), the headline burst's one
// device program: a lax.while_loop whose body sweeps the node axis, finds
// the max-score tie set, and resolves a batch of consecutive tie ranks in
// STAY mode (every fold leaves its node at max score) or ELIM mode (every
// fold removes its node), cut at the first lane that breaks the mode so the
// decisions equal the serial one-pod-per-cycle walk bit for bit.
//
// Bound on the H100: neither bytes nor operations but latency. A pass
// touches R x 8 + 12 bytes per node (about 0.9 MB at n_pad 16,384, which
// stays in the 50 MB L2) and the passes are serial: pass p+1 reads the
// folds of pass p. Design: ONE persistent block of 1024 threads runs the
// whole loop, as JAX runs it in one dispatch, so a pass costs block
// barriers instead of a kernel launch and a host round trip. Each thread
// owns a contiguous slice of the node axis; a pass is
//   1. sweep: feasibility of the carried rows, block max of the scores and
//      the feasible count F;
//   2. tie compaction: a block prefix sum over the tie mask writes the tie
//      list in node order (one list per rotation order in `rotate` mode) —
//      the list IS the searchsorted of JAX's cumsum;
//   3. lanes: thread j < K takes tie rank pos_j, refolds and rescores its
//      node, and the first failing lane (block min) cuts the batch; under
//      rotation a scatter-min (atomicMin) on `owner` cuts at the first
//      duplicate node;
//   4. the accepted lanes fold their deltas (distinct nodes, plain stores).
// The tie lists live in global memory (L2): 64 KB per order at n_pad
// 16,384. A multi-block or cluster design is later work.
//
// Hazard kept exact: when no node is feasible JAX's lane-0 probe reads
// column n_pad+1, clamped to the scratch column; the probe only decides
// the mode when T >= 2, so here it runs only then and never reads past the
// tie list.
#include "uniform.cuh"

#include <climits>

struct UArgs {
  int n_pad;
  i64 n_real, n_pods;
  int cap, K, R, NS, check_res, has_req, L, n_oid, ban, gate;
  const i64* w;
  const unsigned char* valid;
  const unsigned char* extra;   // nullable
  const i64 *alloc_cpu, *alloc_mem, *allowed;
  const i64* xalloc;            // [R-5, n_pad] alloc of carried rows >= 5
  const i64 *salloc, *sused;    // [NS, n_pad] static resource rows
  const i64* clsv;  // req_cpu, req_mem, nz_cpu, nz_mem, delta[R], xreq[R-5],
                    // sreq[NS]
  i64* st;          // [R, n_pad] carried rows, folded in place
  const i64* tot0;  // [n_pad] K1 scores at burst start
  const int* perm;  // [L, n_pad+1]
  const int* oid_seq;
  const i64* lni_in;
  int* out;         // [cap + K]
  i64* lni_out;
  int* tot;                 // [n_pad] carried int32 scores
  unsigned char* flags;     // [3, n_pad]: ok, banned, feasible
  int* ties;                // [max(L,1), n_pad] tie lists
  int* owner;               // [n_pad+1] scatter-min scratch
};

__global__ void __launch_bounds__(NTHREADS) uniform_burst_kernel(UArgs a) {
  __shared__ i64 sh64[NWARPS];
  __shared__ int sh32[NWARPS];
  __shared__ i64 ws[W_K];
  const int n = a.n_pad, K = a.K, tid = threadIdx.x;
  if (tid < W_K) ws[tid] = a.w[tid];
  Ctx c{n, a.R, a.check_res, a.has_req, a.gate, a.flags, a.st, a.allowed,
        a.alloc_cpu, a.alloc_mem, a.xalloc, ws, a.clsv[0], a.clsv[1],
        a.clsv[2], a.clsv[3], a.clsv + 4, a.clsv + 4 + a.R};
  const i64* sreq = c.xreq + (a.R - 5);
  unsigned char* ok = a.flags;
  unsigned char* banned = a.flags + n;
  unsigned char* feas = a.flags + 2 * n;
  const bool rotate = a.L > 0;
  int lo, hi;
  my_range(n, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    bool o = a.valid[j] && (i64)j < a.n_real;
    if (a.extra) o = o && a.extra[j];
    for (int s = 0; s < a.NS; ++s)
      o = o && !(a.salloc[(size_t)s * n + j]
                 < sreq[s] + a.sused[(size_t)s * n + j]);
    ok[j] = o;
    banned[j] = 0;
    a.tot[j] = (int)a.tot0[j];
  }
  for (int j = tid; j <= n; j += NTHREADS) a.owner[j] = K;
  for (int j = tid; j < a.cap + K; j += NTHREADS) a.out[j] = -1;
  const i64 lni0 = a.lni_in[0];
  i64 lni = lni0;
  const int B = (int)a.n_pods;
  int done = 0;
  __syncthreads();

  while (done < B) {
    // 1. sweep
    int lmax = INT_MIN, lF = 0;
    for (int j = lo; j < hi; ++j) {
      bool f = c.fit(j, 0) && !(a.ban && banned[j]);
      feas[j] = f;
      if (f) {
        ++lF;
        lmax = max(lmax, a.tot[j]);
      }
    }
    const int mx = (int)block_max64(lmax, sh64);
    const int F = (int)block_sum64(lF, sh64);
    // 2. tie lists
    int T = 0;
    if (!rotate) {
      int lT = 0;
      for (int j = lo; j < hi; ++j) lT += feas[j] && a.tot[j] == mx;
      int off = block_excl_scan(lT, sh32, &T);
      for (int j = lo; j < hi; ++j)
        if (feas[j] && a.tot[j] == mx) a.ties[off++] = j;
    } else {
      for (int l = 0; l < a.L; ++l) {
        const int* pr = a.perm + (size_t)l * (n + 1);
        int lT = 0;
        for (int p = lo; p < hi; ++p) {
          int q = pr[p];
          lT += q >= 0 && q < n && feas[q] && a.tot[q] == mx;
        }
        int off = block_excl_scan(lT, sh32, &T);
        for (int p = lo; p < hi; ++p) {
          int q = pr[p];
          if (q >= 0 && q < n && feas[q] && a.tot[q] == mx)
            a.ties[(size_t)l * n + off++] = q;
        }
      }
    }
    __syncthreads();
    const int remaining = B - done;
    const bool kbig = T >= 2 && F > 1;
    // this pass's rotation orders (dynamic_slice start clamps like JAX)
    int oid_j = 0, oid0 = 0;
    if (rotate) {
      int start = min(max(done, 0), max(a.n_oid - K, 0));
      oid0 = min(max(a.oid_seq[start], 0), a.L - 1);
      if (tid < K) oid_j = min(max(a.oid_seq[start + tid], 0), a.L - 1);
    }
    // lane-0 probe: STAY vs ELIM
    bool elim;
    if (a.ban) {
      elim = kbig;
    } else if (!kbig) {
      elim = false;
    } else {
      int pos0 = (int)floormod(lni, (i64)max(T, 1));
      int sel0 = a.ties[(size_t)oid0 * n + pos0];
      elim = (c.score(sel0, 1) != mx) || !c.fit(sel0, 1);
    }
    const int lim = min(remaining, K);
    const int m_stay = min(lim, T);
    const int max_elim = max((int)floordiv((i64)T - lni + 1, 2), 1);
    int m_elim = min(lim, min(max_elim, max(F - 1, 1)));
    if (rotate) {
      int diff = (tid < K && oid_j != oid0) ? tid : K;
      int same = (int)block_min64(diff, sh64);
      m_elim = min(m_elim, max(same, 1));
    }
    const int m = F == 0 ? lim : (elim ? m_elim : (kbig ? m_stay : 1));
    // 3. lanes
    const bool active = tid < m && F > 0;
    int sel = n, new_tot = 0;
    bool fail = false;
    if (active) {
      i64 p = (elim && m > 1)
                  ? imin64(lni + 2 * (i64)tid, (i64)max(T - 1, 0))
                  : floormod(lni + tid, (i64)max(T, 1));
      sel = a.ties[(size_t)(rotate ? oid_j : 0) * n + (int)p];
      new_tot = c.score(sel, 1);
      bool leaves = a.ban ? true : (new_tot != mx || !c.fit(sel, 1));
      fail = elim ? !leaves : leaves;
    }
    int first_bad = (int)block_min64(fail ? tid : K, sh64);
    int v = F == 0 ? m : min(first_bad + 1, m);
    if (rotate) {
      if (active) atomicMin(&a.owner[sel], tid);
      __syncthreads();
      bool dup = active && a.owner[sel] != tid;
      int first_dup = (int)block_min64(dup ? tid : K, sh64);
      if (active) a.owner[sel] = K;
      v = min(v, first_dup);
      v = F == 0 ? m : max(v, 1);
    }
    // 4. fold the accepted prefix, emit the pass's decisions
    if (active && tid < v) {
      for (int r = 0; r < a.R; ++r) a.st[(size_t)r * n + sel] += c.delta[r];
      a.tot[sel] = new_tot;
      if (a.ban) banned[sel] = 1;
    }
    if (tid < K) a.out[done + tid] = (tid < v && F > 0) ? sel : -1;
    lni += F > 1 ? v : 0;
    done += v;
    __syncthreads();
  }
  if (tid == 0) {
    a.out[a.cap] = (int)(lni - lni0);
    a.lni_out[0] = lni;
  }
}

extern "C" int uniform_burst_launch(
    int n_pad, i64 n_real, i64 n_pods, int cap, int K, int R, int NS,
    int check_res, int has_req, int L, int n_oid, int ban, int gate,
    const void* w, const void* valid, const void* extra,
    const void* alloc_cpu, const void* alloc_mem, const void* allowed,
    const void* xalloc, const void* salloc, const void* sused,
    const void* clsv, void* st, const void* tot0, const void* perm,
    const void* oid_seq, const void* lni_in, void* out, void* lni_out,
    void* tot, void* flags, void* ties, void* owner, void* stream) {
  if (K > NTHREADS) return (int)cudaErrorInvalidValue;
  UArgs a{n_pad, n_real, n_pods, cap, K, R, NS, check_res, has_req, L,
          n_oid, ban, gate, (const i64*)w, (const unsigned char*)valid,
          (const unsigned char*)extra, (const i64*)alloc_cpu,
          (const i64*)alloc_mem, (const i64*)allowed, (const i64*)xalloc,
          (const i64*)salloc, (const i64*)sused, (const i64*)clsv, (i64*)st,
          (const i64*)tot0, (const int*)perm, (const int*)oid_seq,
          (const i64*)lni_in, (int*)out, (i64*)lni_out, (int*)tot,
          (unsigned char*)flags, (int*)ties, (int*)owner};
  uniform_burst_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
