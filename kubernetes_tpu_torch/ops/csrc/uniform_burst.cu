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
// `scratch`), so every n_pad has a plan. A pass is (steps 1b-3 are the
// pass epilogue of `uniform_pass.cuh`, shared with K9d)
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
#include "uniform.cuh"
#include "uniform_pass.cuh"

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

template <bool RES, bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    uniform_burst_kernel(UArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)a.v[UBI_N_PAD], K = (int)a.v[UBI_K];
  const int R = (int)a.v[UBI_R], NS = (int)a.v[UBI_NS];
  const int L = (int)a.v[UBI_L], B = (int)a.v[UBI_N_PODS];
  const bool rotate = L > 0, ban = a.v[UBI_BAN] != 0;
  const int tid = threadIdx.x;
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int span = g.npt * NTHREADS;
  const int lo = min(rank * span, n), hi = min(lo + span, n);
  const int tlo = min(lo + tid * g.npt, hi), thi = min(tlo + g.npt, hi);
  const UniformLayout U = uniform_layout(span, R, L, RES, GS);
  const UniformPass P = uniform_pass<GS>(
      smem, U, (unsigned char*)a.p[UBP_WORKSPACE], n, K, L, ban, span, C,
      rank);
  i64* ws = (i64*)(smem + U.ws);
  i64* ctl = P.ctl;
  int* lanes = (int*)(smem + U.lanes);
  // the per-node planes: the scores and the ok / banned / feasible bytes
  unsigned char *ok_b = P.fl_b, *feas_b = P.fl_b + 2 * P.fs;
  // this block's own slots, indexed by global node
  const int shift = GS ? 0 : lo;
  int* tot = P.tot_b - shift;
  unsigned char* ok = ok_b - shift;
  unsigned char* banned = P.fl_b + P.fs - shift;
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
    const int bm = (int)block_max64(lmax, P.sh64);
    const int bF = (int)block_sum64(lF, P.sh64);
    // the block's ties at its own max; in axis order its part of the tie
    // list, in node order
    int lt = 0;
    for (int j = tlo; j < thi; ++j) lt += feas[j] && tot[j] == bm;
    int bT;
    int at = block_excl_scan(lt, P.sh32, &bT);
    if (!rotate)
      for (int j = tlo; j < thi; ++j)
        if (feas[j] && tot[j] == bm) P.my_ties[at++] = j;
    if (tid == 0) {
      P.rec[0] = bm;
      P.rec[1] = bF;
      P.rec[2] = bT;
    }
    cl.sync();  // every block's max, F and ties (and its list) are in
    pass_offsets(cl, P);
    const int mx = (int)ctl[UC_MAX], F = (int)ctl[UC_F];

    // ---- 2. rotation: each order's ties among this block's positions -------
    if (rotate)
      pass_orders(cl, P, perm, tlo, thi, [&](int q) -> bool {
        return q >= 0 && q < n && owner_word<GS>(cl, feas_b, span, q)
               && owner_word<GS>(cl, P.tot_b, span, q) == mx;
      });

    // ---- 3. lanes (block 0) ------------------------------------------------
    if (rank == 0) {
      const PassLanes r = pass_lanes<GS>(
          cl, P, done, B, lni, oid_seq, n_oid, owner, [&](int q) -> bool {
            int s;
            const bool f = lane_fit(q, &s);
            return s != mx || !f;
          });
      // the pass's decisions, and the nodes the owners fold
      if (tid < K) out[done + tid] = (tid < r.v && F > 0) ? r.sel : -1;
      if (r.active && tid < r.v) lanes[tid] = r.sel;
      lni += F > 1 ? r.v : 0;
      done += r.v;
      if (tid == 0) {
        ctl[UC_DONE] = done;
        ctl[UC_FOLDS] = F > 0 ? r.v : 0;
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
