// K3 uniform_burst: a burst of spec-identical pods, up to K (512) pods
// resolved per O(N) pass, the whole burst in one launch of one
// thread-block cluster.
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
// folds of pass p. The one-block kernel this replaces ran the loop in ONE
// block of 1024 threads, 16 slots a thread at n_pad 16,384 and about ten
// block barriers and reductions a pass (1.72 ms of device time for the
// empty 15,000-node cluster's 20-pass burst on an H100). Design: the loop
// stays in one launch, as JAX runs it in one dispatch, on a cluster of up
// to 16 blocks x 1024 threads (`uniform_plan` on the host: the fewest node
// slots a thread, then only the blocks that own a node). Block q owns the
// node slice [q * span, (q + 1) * span): its carried rows stay resident in
// its shared memory for the whole burst (`resident`; else in global
// memory), and so do its int32 scores, its ok / banned / feasible bytes and
// its tie lists (past what shared memory holds, in a global workspace:
// `scratch`), so every n_pad has a plan. A pass is
//   1. sweep: each block fits its slice, and takes its max, its feasible
//      count and (axis order) its ties at its own max, which it lists in
//      node order; ONE cluster barrier makes every block's (max, F, ties)
//      readable through distributed shared memory. The blocks at the
//      cluster's max give each block's offset in the tie list, which in
//      node order IS the searchsorted of JAX's cumsum;
//   2. rotation (`L > 0`): each block lists, for every order, the ties among
//      the positions it owns, reading each named node's feasible byte and
//      score from the block that owns it, and a second cluster barrier
//      publishes the lists' lengths;
//   3. lanes, in block 0's threads tid < K: lane j finds the block that
//      lists its tie rank, reads the node from that list and the node's rows
//      from the block that owns it (into registers), and refits and
//      rescores it after one more fold (`Ctx`); the first failing lane, the
//      first lane of another order and the first duplicate node (a
//      scatter-min on `owner`, over the whole lane set) cut the batch as
//      in JAX. Block 0 publishes the accepted nodes and `done`, and a
//      cluster barrier ends the pass: no lane reads a fold of its own pass;
//   4. fold: every block adds the class delta to the accepted nodes it owns,
//      rescores and bans them, so no block writes another block's rows and
//      no SM reads a row another SM's cache may hold stale.
// Every block takes the same barriers: each loops until block 0's `done`
// reaches B. At the end each block writes its rows back to the burst's
// rows, and a last cluster barrier keeps every block's shared memory alive
// for the peers that still read block 0's.
//
// Hazard kept exact: when no node is feasible JAX's lane-0 probe reads
// column n_pad+1, clamped to the scratch column; the probe only decides
// the mode when T >= 2, so here it runs only then and never reads past the
// tie list.
#include "cluster_cycle.cuh"
#include "uniform.cuh"

// scalar slots, in the order of `_UNIFORM_INTS` (kernels.py)
enum {
  UBI_N_PAD, UBI_N_REAL, UBI_N_PODS, UBI_CAP, UBI_K, UBI_R, UBI_NS,
  UBI_CHECK_RES, UBI_HAS_REQ, UBI_L, UBI_N_OID, UBI_BAN, UBI_GATE,
  UBI_COUNT
};
// pointer slots, in the order of `_UNIFORM_PTRS`: the weight row, the node
// rows the burst only reads, the class vector, the carried rows (folded in
// place), K1's scores, the rotation, the outputs, the scatter-min scratch
// and the workspace (NULL while the scratch fits in shared memory)
enum {
  UBP_W, UBP_VALID, UBP_EXTRA, UBP_ALLOC_CPU, UBP_ALLOC_MEM, UBP_ALLOWED,
  UBP_XALLOC, UBP_SALLOC, UBP_SUSED, UBP_CLSV, UBP_ST, UBP_TOT0, UBP_PERM,
  UBP_OID_SEQ, UBP_LNI_IN, UBP_OUT, UBP_LNI_OUT, UBP_OWNER, UBP_WORKSPACE,
  UBP_COUNT
};

struct UArgs {
  i64 v[UBI_COUNT];
  void* p[UBP_COUNT];
};

// carried rows a lane holds in registers (`UNIFORM_ROWS_MAX` in kernels.py)
constexpr int UR_MAX = 16;
// lanes of a pass, at most: one a thread of block 0
constexpr int UK_MAX = NTHREADS;
// words of a block's control block: block 0's done and folds of the pass,
// then this block's copy of the cluster's max, F and T, the probe's mode
enum { UC_DONE, UC_FOLDS, UC_MAX, UC_F, UC_T, UC_ELIM, UC_N = 8 };

// Byte offsets of a block's dynamic shared memory at `span` node slots, R
// carried rows and L rotation orders, the rows resident or not, the
// per-node scratch (scores, ok / banned / feasible bytes, tie lists) in
// shared memory or in the workspace (`gscr`). `uniform_smem_bytes` in
// kernels.py mirrors `bytes`; the launch refuses a plan whose byte count
// differs.
struct UniformLayout {
  size_t ws, sh64, rec, ctl, rows, sh32, incl, cnt, lanes, tot, ties, flags,
      bytes;
};

__host__ __device__ inline UniformLayout uniform_layout(int span, int R,
                                                        int L, bool resident,
                                                        bool gscr) {
  UniformLayout U;
  const size_t sp = (size_t)span, lm = L > 0 ? (size_t)L : 1;
  size_t o = 0;
  U.ws = o;     o += 16 * 8;
  U.sh64 = o;   o += NWARPS * 8;
  U.rec = o;    o += 4 * 8;        // this block's max, F, ties at its max
  U.ctl = o;    o += UC_N * 8;
  U.rows = o;   if (resident) o += sp * 8 * (size_t)R;
  U.sh32 = o;   o += NWARPS * 4;
  U.incl = o;   o += (size_t)CLUSTER_MAX * 4 * lm;  // block 0: offsets
  U.cnt = o;    o += 4 * lm;       // this block's list length an order
  U.lanes = o;  o += UK_MAX * 4;   // block 0: the pass's accepted nodes
  U.tot = o;    if (!gscr) o += sp * 4;
  U.ties = o;   if (!gscr) o += sp * 4 * lm;
  U.flags = o;  if (!gscr) o += sp * 3;
  U.bytes = o;
  return U;
}

// Bytes of the global workspace (`gscr`): the tie lists [max(L, 1)] x
// [blocks x span] int32 (block q's at q * span), the scores [blocks x
// span] int32, then the ok, banned and feasible bytes [blocks x span] each
// (`uniform_plan`'s `scratch_slot_bytes` in kernels.py).
__host__ __device__ inline size_t uniform_scratch_bytes(int blocks, int span,
                                                        int L) {
  return (size_t)blocks * (size_t)span * (4 * (L > 0 ? L : 1) + 4 + 3);
}

// Node q's word of a per-node plane, from the block that owns it: through
// distributed shared memory (`base`: this block's slice in shared memory),
// or, GS, from the global plane `base` (indexed by node) past this SM's L1.
template <bool GS, typename T>
__device__ __forceinline__ T owner_word(cg::cluster_group& cl, T* base,
                                        int span, int q) {
  if constexpr (GS) {
    return __ldcg(base + q);
  } else {
    const int o = q / span;
    return at_rank(cl, base, o)[q - o * span];
  }
}

template <bool RES, bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    uniform_burst_kernel(UArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)a.v[UBI_N_PAD], K = (int)a.v[UBI_K];
  const int R = (int)a.v[UBI_R], NS = (int)a.v[UBI_NS];
  const int L = (int)a.v[UBI_L], B = (int)a.v[UBI_N_PODS];
  const bool rotate = L > 0, ban = a.v[UBI_BAN] != 0;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int span = g.npt * NTHREADS;
  const int lo = min(rank * span, n), hi = min(lo + span, n);
  const int tlo = min(lo + tid * g.npt, hi), thi = min(tlo + g.npt, hi);
  const UniformLayout U = uniform_layout(span, R, L, RES, GS);
  i64* ws = (i64*)(smem + U.ws);
  i64* sh64 = (i64*)(smem + U.sh64);
  i64* rec = (i64*)(smem + U.rec);
  i64* ctl = (i64*)(smem + U.ctl);
  int* sh32 = (int*)(smem + U.sh32);
  int* incl = (int*)(smem + U.incl);  // [order][block]: ties to block's end
  int* cnt = (int*)(smem + U.cnt);
  int* lanes = (int*)(smem + U.lanes);
  // the per-node planes: this block's slice in shared memory, or the
  // workspace's planes over the whole cluster (block q's slice at q * span)
  const size_t N = (size_t)C * span;
  const size_t lm = L > 0 ? (size_t)L : 1;
  unsigned char* wsp = (unsigned char*)a.p[UBP_WORKSPACE];
  int* ties = GS ? (int*)wsp : (int*)(smem + U.ties);
  int* tot_b = GS ? (int*)wsp + lm * N : (int*)(smem + U.tot);
  unsigned char* fl_b = GS ? wsp + (lm + 1) * N * 4 : smem + U.flags;
  const size_t fs = GS ? N : (size_t)span;   // between two byte planes
  unsigned char *ok_b = fl_b, *feas_b = fl_b + 2 * fs;
  const size_t ts = GS ? N : (size_t)span;   // between two orders' lists
  int* my_ties = GS ? ties + (size_t)rank * span : ties;
  // this block's own slots, indexed by global node
  const int shift = GS ? 0 : lo;
  int* tot = tot_b - shift;
  unsigned char* ok = ok_b - shift;
  unsigned char* banned = fl_b + fs - shift;
  unsigned char* feas = feas_b - shift;
  i64* st = (i64*)a.p[UBP_ST];
  i64* rows_sm = (i64*)(smem + U.rows);
  // the carried rows this block reads and folds: row r of node j at
  // rows[r * rs + j]
  i64* rows = RES ? rows_sm - lo : st;
  const int rs = RES ? span : n;
  const i64* clsv = (const i64*)a.p[UBP_CLSV];
  const Ctx c{n, R, (int)a.v[UBI_CHECK_RES], (int)a.v[UBI_HAS_REQ],
              (int)a.v[UBI_GATE], ok, rows, (const i64*)a.p[UBP_ALLOWED],
              (const i64*)a.p[UBP_ALLOC_CPU], (const i64*)a.p[UBP_ALLOC_MEM],
              (const i64*)a.p[UBP_XALLOC], ws, clsv[0], clsv[1], clsv[2],
              clsv[3], clsv + 4, clsv + 4 + R, rs};
  const i64* sreq = c.xreq + (R - 5);
  const int* perm = (const int*)a.p[UBP_PERM];
  const int* oid_seq = (const int*)a.p[UBP_OID_SEQ];
  int* owner = (int*)a.p[UBP_OWNER];
  int* out = (int*)a.p[UBP_OUT];
  const int cap = (int)a.v[UBI_CAP], n_oid = (int)a.v[UBI_N_OID];

  // ---- set-up: the ok mask, the scores, the rows in shared memory --------
  if (tid < W_K) ws[tid] = ((const i64*)a.p[UBP_W])[tid];
  if (RES)
    for (int r = 0; r < R; ++r)
      for (int l = tid; l < hi - lo; l += NTHREADS)
        rows_sm[(size_t)r * span + l] = st[(size_t)r * n + lo + l];
  {
    const unsigned char* valid = (const unsigned char*)a.p[UBP_VALID];
    const unsigned char* extra = (const unsigned char*)a.p[UBP_EXTRA];
    const i64* salloc = (const i64*)a.p[UBP_SALLOC];
    const i64* sused = (const i64*)a.p[UBP_SUSED];
    const i64* tot0 = (const i64*)a.p[UBP_TOT0];
    for (int j = tlo; j < thi; ++j) {
      bool o = valid[j] && (i64)j < a.v[UBI_N_REAL];
      if (extra) o = o && extra[j];
      for (int s = 0; s < NS; ++s)
        o = o && !(salloc[(size_t)s * n + j]
                   < sreq[s] + sused[(size_t)s * n + j]);
      ok[j] = o;
      banned[j] = 0;
      tot[j] = (int)tot0[j];
    }
  }
  if (rank == 0) {
    for (int j = tid; j <= n; j += NTHREADS) owner[j] = K;
    for (int j = tid; j < cap + K; j += NTHREADS) out[j] = -1;
  }
  const i64 lni0 = ((const i64*)a.p[UBP_LNI_IN])[0];
  i64 lni = lni0;  // block 0's
  // every block has started and set its slice up
  cl.sync();

  // The node that tie rank p of order l names (block 0, after the pass's
  // offsets): the first block whose ties reach past p lists it. A rank
  // past the order's list (a perm that is not a permutation of the nodes)
  // names the scratch column n.
  auto tie_at = [&](int l, int p) -> int {
    const int* in = incl + l * CLUSTER_MAX;
    if (p >= in[C - 1]) return n;
    int b = 0;
    for (int q = 0; q < C - 1; ++q) b += in[q] <= p;
    const int i = p - (b > 0 ? in[b - 1] : 0);
    if constexpr (GS)
      return __ldcg(ties + (size_t)l * ts + (size_t)b * span + i);
    else
      return at_rank(cl, ties, b)[(size_t)l * span + i];
  };
  // Node q after one more fold (`lane_fit`): its score and whether it still
  // fits, from its rows read from the block that owns it into registers.
  // The scratch column never fits.
  auto lane_fit = [&](int q, int* score) -> bool {
    *score = 0;
    if (q >= n) return false;
    i64 rb[UR_MAX];
    if constexpr (RES) {
      const int o = q / span;
      const i64* src = at_rank(cl, rows_sm, o) + (q - o * span);
      for (int r = 0; r < R; ++r) rb[r] = src[(size_t)r * span];
    } else {
      for (int r = 0; r < R; ++r) rb[r] = __ldcg(st + (size_t)r * n + q);
    }
    const unsigned char okq = owner_word<GS>(cl, ok_b, span, q);
    Ctx v = c;
    v.st = rb;
    v.sn = 1;
    v.ok = &okq;
    v.allowed += q;
    v.alloc_cpu += q;
    v.alloc_mem += q;
    if (v.xalloc) v.xalloc += q;
    *score = v.score(0, 1);
    return v.fit(0, 1);
  };
  auto is_tie = [&](int q, int mx) -> bool {
    return q >= 0 && q < n && owner_word<GS>(cl, feas_b, span, q)
           && owner_word<GS>(cl, tot_b, span, q) == mx;
  };

  int done = 0;
  while (done < B) {
    // ---- 1. sweep ----------------------------------------------------------
    int lmax = INT_MIN, lF = 0;
    for (int j = tlo; j < thi; ++j) {
      const bool f = c.fit(j, 0) && !(ban && banned[j]);
      feas[j] = f;
      if (f) {
        ++lF;
        lmax = max(lmax, tot[j]);
      }
    }
    const int bm = (int)block_max64(lmax, sh64);
    const int bF = (int)block_sum64(lF, sh64);
    // the block's ties at its own max; in axis order its part of the tie
    // list, in node order
    int lt = 0;
    for (int j = tlo; j < thi; ++j) lt += feas[j] && tot[j] == bm;
    int bT;
    int at = block_excl_scan(lt, sh32, &bT);
    if (!rotate)
      for (int j = tlo; j < thi; ++j)
        if (feas[j] && tot[j] == bm) my_ties[at++] = j;
    if (tid == 0) {
      rec[0] = bm;
      rec[1] = bF;
      rec[2] = bT;
    }
    cl.sync();  // every block's max, F and ties (and its list) are in
    // the cluster's max, F and T; the ties before each block's end (a block
    // below the max holds none of them)
    if (wid == 0) {
      i64 m = LLONG_MIN, f = 0, t = 0;
      if (lane < C) {
        const i64* r = at_rank(cl, rec, lane);
        m = r[0];
        f = r[1];
        t = r[2];
      }
      const i64 mxw = warp_allreduce(OP_MAX, m);
      const i64 Fw = warp_allreduce(OP_SUM, f);
      const i64 in = warp_incl_sum(lane < C && m == mxw ? t : 0);
      if (lane < C) incl[lane] = (int)in;
      if (lane == 31) {
        ctl[UC_MAX] = mxw;
        ctl[UC_F] = Fw;
        ctl[UC_T] = in;
      }
    }
    __syncthreads();
    const int mx = (int)ctl[UC_MAX], F = (int)ctl[UC_F], T = (int)ctl[UC_T];

    // ---- 2. rotation: each order's ties among this block's positions -------
    if (rotate) {
      for (int l = 0; l < L; ++l) {
        const int* pr = perm + (size_t)l * (n + 1);
        int lc = 0;
        for (int p = tlo; p < thi; ++p) lc += is_tie(pr[p], mx);
        int tl;
        int o = block_excl_scan(lc, sh32, &tl);
        for (int p = tlo; p < thi; ++p) {
          const int q = pr[p];
          if (is_tie(q, mx)) my_ties[(size_t)l * ts + o++] = q;
        }
        if (tid == 0) cnt[l] = tl;
      }
      cl.sync();  // every order's list and its length are in
      if (rank == 0) {
        for (int l = wid; l < L; l += NWARPS) {
          const i64 x = lane < C ? at_rank(cl, cnt, lane)[l] : 0;
          const i64 in = warp_incl_sum(x);
          if (lane < C) incl[l * CLUSTER_MAX + lane] = (int)in;
        }
        __syncthreads();
      }
    }

    // ---- 3. lanes (block 0) ------------------------------------------------
    if (rank == 0) {
      const int remaining = B - done;
      const bool kbig = T >= 2 && F > 1;
      // this pass's rotation orders (dynamic_slice start clamps like JAX)
      int oid_j = 0, oid0 = 0;
      if (rotate) {
        const int start = min(max(done, 0), max(n_oid - K, 0));
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
        if (tid == 0) {
          const int pos0 = (int)floormod(lni, (i64)max(T, 1));
          int s0;
          const bool fit0 = lane_fit(tie_at(rotate ? oid0 : 0, pos0), &s0);
          ctl[UC_ELIM] = (s0 != mx) || !fit0;
        }
        __syncthreads();
        elim = ctl[UC_ELIM] != 0;
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
      const bool active = tid < m && F > 0;
      int sel = n;
      bool fail = false;
      if (active) {
        const i64 p = (elim && m > 1)
                          ? imin64(lni + 2 * (i64)tid, (i64)max(T - 1, 0))
                          : floormod(lni + tid, (i64)max(T, 1));
        sel = tie_at(rotate ? oid_j : 0, (int)p);
        int new_tot;
        const bool fit1 = lane_fit(sel, &new_tot);
        const bool leaves = ban ? true : (new_tot != mx || !fit1);
        fail = elim ? !leaves : leaves;
      }
      const int first_bad = (int)block_min64(fail ? tid : K, sh64);
      int v = F == 0 ? m : min(first_bad + 1, m);
      if (rotate) {
        if (active) atomicMin(&owner[sel], tid);
        __syncthreads();
        const bool dup = active && __ldcg(&owner[sel]) != tid;
        const int first_dup = (int)block_min64(dup ? tid : K, sh64);
        if (active) owner[sel] = K;
        v = min(v, first_dup);
        v = F == 0 ? m : max(v, 1);
      }
      // the pass's decisions, and the nodes the owners fold
      if (tid < K) out[done + tid] = (tid < v && F > 0) ? sel : -1;
      if (active && tid < v) lanes[tid] = sel;
      lni += F > 1 ? v : 0;
      done += v;
      if (tid == 0) {
        ctl[UC_DONE] = done;
        ctl[UC_FOLDS] = F > 0 ? v : 0;
      }
    }
    // the pass's lanes have read every list and row they need, and block
    // 0's decisions are in
    cl.sync();

    // ---- 4. fold: each block the accepted nodes it owns --------------------
    const i64* c0 = at_rank(cl, ctl, 0);
    done = (int)c0[UC_DONE];
    if (tid < (int)c0[UC_FOLDS]) {
      const int q = at_rank(cl, lanes, 0)[tid];
      if (q >= lo && q < hi) {
        for (int r = 0; r < R; ++r) rows[(size_t)r * rs + q] += c.delta[r];
        tot[q] = c.score(q, 0);
        if (ban) banned[q] = 1;
      }
    }
    __syncthreads();  // the folds land before the next sweep reads them
  }

  // the folded rows back to the burst's rows
  if (RES)
    for (int r = 0; r < R; ++r)
      for (int l = tid; l < hi - lo; l += NTHREADS)
        st[(size_t)r * n + lo + l] = rows_sm[(size_t)r * span + l];
  if (rank == 0 && tid == 0) {
    out[cap] = (int)(lni - lni0);
    ((i64*)a.p[UBP_LNI_OUT])[0] = lni;
  }
  // no block exits while a peer may still read its shared memory
  cl.sync();
}

// ---- host side --------------------------------------------------------------
// -1: the plan's shared memory is not this layout's; -2: the plan does not
// cover the node axis or exceeds the cluster limit; -3: more lanes than
// block 0 has threads, or more carried rows than a lane holds; -4: the
// scratch in global memory without its workspace, or beside resident rows.
inline int uniform_check(const UArgs& a, const ClusterGeom& g) {
  const int R = (int)a.v[UBI_R], L = (int)a.v[UBI_L];
  if ((i64)uniform_layout(g.npt * NTHREADS, R, L, g.resident != 0,
                          g.scratch != 0).bytes != g.smem)
    return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[UBI_N_PAD])
    return -2;
  if (a.v[UBI_K] < 1 || a.v[UBI_K] > UK_MAX || R < 5 || R > UR_MAX) return -3;
  if (g.scratch && (g.resident || !a.p[UBP_WORKSPACE])) return -4;
  return 0;
}

inline void (*uniform_kernel(const ClusterGeom& g))(UArgs, ClusterGeom) {
  return cluster_pick(g, uniform_burst_kernel<true, false>,
                      uniform_burst_kernel<false, false>,
                      uniform_burst_kernel<false, true>);
}

// One burst: one cluster of g.blocks blocks on `stream`.
extern "C" int uniform_burst_launch(const i64* iargs, void** ptrs,
                                    const i64* geom, void* stream) {
  UArgs a;
  for (int i = 0; i < UBI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < UBP_COUNT; ++i) a.p[i] = ptrs[i];
  const ClusterGeom g = cluster_geom(geom);
  const int bad = uniform_check(a, g);
  if (bad) return bad;
  return cluster_launch(uniform_kernel(g), a, g, (cudaStream_t)stream);
}

extern "C" int uniform_burst_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(uniform_kernel(g), g, clusters);
}
