// The epilogue of one uniform pass on a thread-block cluster, shared by K3
// (uniform_burst.cu: the whole burst in one launch) and K9d
// (shard_uniform_select.cu: one pass of the sharded burst a launch).
//
// Replaces the tie walk and the lane cut of `_uniform_core`
// (kubernetes_tpu/ops/kernels.py:1097-1320): the tie list in each rotation
// order (JAX's `searchsorted` / `C_all[oid]`), the lane-0 STAY / ELIM
// probe, the K lanes' nodes, `first_bad`, the rotation run `same`, the
// duplicate cut `first_dup` (a scatter-min on `owner` over the whole lane
// set) and the accept cut v.
//
// Block q owns the node slice [q * span, (q + 1) * span). Before the pass
// epilogue each block has written its record (`rec`: its max, its feasible
// count, its ties at that max) and, in axis order, listed its ties in node
// order; then
//   1b. `pass_offsets`: one cluster barrier later, every block's warp 0
//       reads the blocks' records through distributed shared memory: the
//       blocks at the cluster's max give each block's end in the tie list,
//       which in node order IS the searchsorted of JAX's cumsum;
//   2.  `pass_orders` (rotation, L > 0): each block lists, for every order,
//       the ties among the positions it owns, reading each named node's
//       tie test (`is_tie`) from the block that owns it; a second cluster
//       barrier publishes the lists' lengths;
//   3.  `pass_lanes`, in block 0's threads tid < K: lane j finds the block
//       that lists its tie rank and reads the node from that list. Whether
//       the node leaves the max after one more fold is the caller's
//       `leaves(q)`: K3 refits and rescores the node from its rows, K9d
//       reads the stay bit K9c wrote for it. The first failing lane, the
//       first lane of another order and the first duplicate node cut the
//       batch as in JAX.
// The per-node planes (tie lists, K3's scores, the byte planes) live in
// each block's shared memory, or past what it holds in a global workspace
// (GS), so every n_pad has a plan (`uniform_plan` in kernels.py).
#pragma once

#include "cluster_cycle.cuh"

// lanes of a pass, at most: one a thread of block 0
constexpr int UK_MAX = NTHREADS;
// words of a block's control block: block 0's done and folds of the pass,
// then this block's copy of the cluster's max, F and T, the probe's mode
enum { UC_DONE, UC_FOLDS, UC_MAX, UC_F, UC_T, UC_ELIM, UC_N = 8 };

// Byte offsets of a block's dynamic shared memory at `span` node slots, R
// carried rows and L rotation orders, the rows resident or not, the
// per-node scratch (scores, three byte planes, tie lists) in shared memory
// or in the workspace (`gscr`). K9d lays it out at R = 0 and uses the
// first two byte planes for its tie and stay bits. `uniform_smem_bytes` in
// kernels.py mirrors `bytes`; a launch refuses a plan whose byte count
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
// span] int32, then the three byte planes [blocks x span] each
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

// A block's handles on one pass: its layout's tables and the per-node
// planes, this block's slice in shared memory or the workspace's planes
// over the whole cluster (block q's slice at q * span).
struct UniformPass {
  int n, K, L, span, C, rank;
  bool ban;
  i64 *sh64, *rec, *ctl;
  int *sh32, *incl, *cnt;
  int* ties;     // order 0's lists: this block's, or the workspace's
  int* my_ties;  // where this block lists its ties
  size_t ts;     // elements between two orders' lists
  int* tot_b;    // K3's int32 scores (K9d: unused)
  unsigned char* fl_b;  // the first of the three byte planes
  size_t fs;     // elements between two byte planes
};

template <bool GS>
__device__ __forceinline__ UniformPass uniform_pass(unsigned char* smem,
                                                    const UniformLayout& U,
                                                    unsigned char* wsp, int n,
                                                    int K, int L, bool ban,
                                                    int span, int C,
                                                    int rank) {
  UniformPass P;
  P.n = n;
  P.K = K;
  P.L = L;
  P.span = span;
  P.C = C;
  P.rank = rank;
  P.ban = ban;
  P.sh64 = (i64*)(smem + U.sh64);
  P.rec = (i64*)(smem + U.rec);
  P.ctl = (i64*)(smem + U.ctl);
  P.sh32 = (int*)(smem + U.sh32);
  P.incl = (int*)(smem + U.incl);  // [order][block]: ties to block's end
  P.cnt = (int*)(smem + U.cnt);
  const size_t N = (size_t)C * span;
  const size_t lm = L > 0 ? (size_t)L : 1;
  P.ties = GS ? (int*)wsp : (int*)(smem + U.ties);
  P.tot_b = GS ? (int*)wsp + lm * N : (int*)(smem + U.tot);
  P.fl_b = GS ? wsp + (lm + 1) * N * 4 : smem + U.flags;
  P.fs = GS ? N : (size_t)span;
  P.ts = GS ? N : (size_t)span;
  P.my_ties = GS ? P.ties + (size_t)rank * span : P.ties;
  return P;
}

// 1b. After the cluster barrier that follows every block's record, in
// every block: the cluster's max, F and T into `ctl`, and the ties before
// each block's end (a block below the max holds none of them) into
// `incl`. Ends with a block barrier.
__device__ __forceinline__ void pass_offsets(cg::cluster_group& cl,
                                             const UniformPass& P) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) {
    i64 m = LLONG_MIN, f = 0, t = 0;
    if (lane < P.C) {
      const i64* r = at_rank(cl, P.rec, lane);
      m = r[0];
      f = r[1];
      t = r[2];
    }
    const i64 mxw = warp_allreduce(OP_MAX, m);
    const i64 Fw = warp_allreduce(OP_SUM, f);
    const i64 in = warp_incl_sum(lane < P.C && m == mxw ? t : 0);
    if (lane < P.C) P.incl[lane] = (int)in;
    if (lane == 31) {
      P.ctl[UC_MAX] = mxw;
      P.ctl[UC_F] = Fw;
      P.ctl[UC_T] = in;
    }
  }
  __syncthreads();
}

// The node that tie rank p of order l names (block 0, after the pass's
// offsets): the first block whose ties reach past p lists it. A rank past
// the order's list (a perm that is not a permutation of the nodes) names
// the scratch column n.
template <bool GS>
__device__ __forceinline__ int pass_tie_at(cg::cluster_group& cl,
                                           const UniformPass& P, int l,
                                           int p) {
  const int* in = P.incl + l * CLUSTER_MAX;
  if (p >= in[P.C - 1]) return P.n;
  int b = 0;
  for (int q = 0; q < P.C - 1; ++q) b += in[q] <= p;
  const int i = p - (b > 0 ? in[b - 1] : 0);
  if constexpr (GS)
    return __ldcg(P.ties + (size_t)l * P.ts + (size_t)b * P.span + i);
  else
    return at_rank(cl, P.ties, b)[(size_t)l * P.span + i];
}

// 2. Rotation: each order's ties among this block's positions [tlo, thi)
// (this thread's), `is_tie(q)` read from q's owner; one cluster barrier
// publishes the lengths, and block 0 takes each order's offsets.
template <typename IsTie>
__device__ __forceinline__ void pass_orders(cg::cluster_group& cl,
                                            const UniformPass& P,
                                            const int* perm, int tlo,
                                            int thi, IsTie is_tie) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int l = 0; l < P.L; ++l) {
    const int* pr = perm + (size_t)l * (P.n + 1);
    int lc = 0;
    for (int p = tlo; p < thi; ++p) lc += is_tie(pr[p]);
    int tl;
    int o = block_excl_scan(lc, P.sh32, &tl);
    for (int p = tlo; p < thi; ++p) {
      const int q = pr[p];
      if (is_tie(q)) P.my_ties[(size_t)l * P.ts + o++] = q;
    }
    if (threadIdx.x == 0) P.cnt[l] = tl;
  }
  cl.sync();  // every order's list and its length are in
  if (P.rank == 0) {
    for (int l = wid; l < P.L; l += NWARPS) {
      const i64 x = lane < P.C ? at_rank(cl, P.cnt, lane)[l] : 0;
      const i64 in = warp_incl_sum(x);
      if (lane < P.C) P.incl[l * CLUSTER_MAX + lane] = (int)in;
    }
    __syncthreads();
  }
}

// a lane's outcome: its node (n when inactive), the pass's accept cut v,
// and whether the lane took part
struct PassLanes {
  int sel, v;
  bool active;
};

// 3. The lanes, in block 0 (every thread calls it; tid < K are lanes):
// the probe, each lane's node and its `leaves(q)` (does node q leave the
// max after one more fold; `ban` makes every lane leave), the cuts.
// `done` pods of B are decided, `lni` the walk counter.
template <bool GS, typename Leaves>
__device__ __forceinline__ PassLanes pass_lanes(cg::cluster_group& cl,
                                                const UniformPass& P,
                                                int done, int B, i64 lni,
                                                const int* oid_seq,
                                                int n_oid, int* owner,
                                                Leaves leaves) {
  const int tid = threadIdx.x, K = P.K, L = P.L;
  const bool rotate = L > 0;
  const int F = (int)P.ctl[UC_F], T = (int)P.ctl[UC_T];
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
  if (P.ban) {
    elim = kbig;
  } else if (!kbig) {
    elim = false;
  } else {
    if (tid == 0) {
      const int pos0 = (int)floormod(lni, (i64)max(T, 1));
      P.ctl[UC_ELIM] = leaves(pass_tie_at<GS>(cl, P, rotate ? oid0 : 0,
                                              pos0));
    }
    __syncthreads();
    elim = P.ctl[UC_ELIM] != 0;
  }
  const int lim = min(remaining, K);
  const int m_stay = min(lim, T);
  const int max_elim = max((int)floordiv((i64)T - lni + 1, 2), 1);
  int m_elim = min(lim, min(max_elim, max(F - 1, 1)));
  if (rotate) {
    const int diff = (tid < K && oid_j != oid0) ? tid : K;
    const int same = (int)block_min64(diff, P.sh64);
    m_elim = min(m_elim, max(same, 1));
  }
  const int m = F == 0 ? lim : (elim ? m_elim : (kbig ? m_stay : 1));
  const bool active = tid < m && F > 0;
  int sel = P.n;
  bool fail = false;
  if (active) {
    const i64 p = (elim && m > 1)
                      ? imin64(lni + 2 * (i64)tid, (i64)max(T - 1, 0))
                      : floormod(lni + tid, (i64)max(T, 1));
    sel = pass_tie_at<GS>(cl, P, rotate ? oid_j : 0, (int)p);
    const bool lv = P.ban ? true : leaves(sel);
    fail = elim ? !lv : lv;
  }
  const int first_bad = (int)block_min64(fail ? tid : K, P.sh64);
  int v = F == 0 ? m : min(first_bad + 1, m);
  if (rotate) {
    if (active) atomicMin(&owner[sel], tid);
    __syncthreads();
    const bool dup = active && __ldcg(&owner[sel]) != tid;
    const int first_dup = (int)block_min64(dup ? tid : K, P.sh64);
    if (active) owner[sel] = K;
    v = min(v, first_dup);
    v = F == 0 ? m : max(v, 1);
  }
  return PassLanes{sel, v, active};
}
