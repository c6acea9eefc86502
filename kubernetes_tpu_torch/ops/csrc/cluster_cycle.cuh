// One pod's scheduling cycle across a thread-block cluster: the cycle of
// K5 (`schedule_batch.cu`) and K6 (`schedule_segments.cu`); of K2
// (`schedule_cycle.cu`), one pod with every per-node output written and,
// optionally, the nominated-ghost load in the filter; with the ghost in
// the filter and the preemption pick carried by its select round, of K8
// (`pressure_batch.cu`); and, fed by the gathered shard records instead of
// the node rows (REC), of the mesh selects K9b, K10b, K11b and K13b
// (`cluster_select.cuh`).
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core`
// (kubernetes_tpu/ops/kernels.py:296, :157, :359) for every cycle kernel.
// It reuses `cycle.cuh`'s per-node parts (`cycle_filter_row`,
// `cycle_score_one` with `cycle_row_local`, and K1's `local_total_one`)
// and keeps every index rule of `_cycle_core`: JAX's clamps, floordiv /
// floormod, first-index argmax, `sel == n -> 0`.
//
// Bound on the H100: the serial chain, not bytes or arithmetic. Each pod
// reads the rows the one before it folded, and its cycle is a chain of
// cluster rounds (1.3-2.9 us each on an H100, `scripts/cycle_phase_split.py`)
// between per-node passes that 1024 threads of each SM take in turns.
// Design:
//   - a cluster of up to 16 blocks x 1024 threads on neighbouring SMs; block
//     q owns the contiguous node slice [q * span, (q + 1) * span) and each
//     thread `npt` consecutive slots of it (one at n_pad 16,384);
//   - the rows a pod's filter, scores and fold read stay resident in the
//     blocks' shared memory for the whole window (`resident`), or in global
//     memory when they do not fit (the same code, a template flag);
//   - past that (n_pad above 131,072 on 16 blocks, 65,536 on 8) the
//     per-slot scratch (TOT, A, FL, JA: 20 B a slot) moves to a global
//     workspace of blocks x span slots too, block q's slice at q * span
//     (`scratch`, the template flag GS): a peer's plane is then read at its
//     slice through L2 (`__ldcg`) instead of through distributed shared
//     memory, and the rounds, their records and the zone tables stay in
//     shared memory, so any node count runs;
//   - a reduction or scan across the node axis is a ROUND: warp shuffles, a
//     block combine into this block's partial record, one cluster barrier,
//     and one warp per value combining the blocks' records read through
//     distributed shared memory (every warp reading them cost twice as
//     much), then a block barrier. Records alternate between two slots, so
//     one cluster barrier a round suffices. A round carries only the
//     values of the score families the pod runs. Independent reductions
//     share a round: the kept set's
//     maxima, the zone table and the walk's cutoff; the highest score and the
//     per-block tie counts (a block counts its ties at its own maximum,
//     which is the cluster's exactly when the block has ties);
//   - rounds a pod: 4 in axis order (walk, maxima, max + ties, select), 6
//     with perm / inv_perm (the filter bits and the tie bits cross blocks),
//     4 with positions (maxima, max + ties, the tie scatter, select);
//   - the block that owns the winner folds it, in the thread that owns the
//     node, so no block writes another block's rows.
// Every block takes the same rounds in the same order: a skip pod takes
// none, in every block alike. All sums are integer sums and the float64
// scores are per node, so any split of the node axis gives the same bits.
#pragma once

#include "cycle.cuh"
#include "victim.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

constexpr int CLUSTER_MAX = 16;  // H100's non-portable cluster size limit

// The cluster's geometry, chosen on the host (`cluster_plan`,
// kubernetes_tpu_torch/ops/kernels.py): blocks, node slots a thread, rows
// (a select: the step's records) resident in shared memory or not, dynamic
// shared memory of a block, and the per-slot scratch in shared memory (0) or
// in the launch's global workspace (1).
struct ClusterGeom {
  int blocks, npt, resident;
  i64 smem;
  int scratch;
};
enum { CG_BLOCKS, CG_NPT, CG_RESIDENT, CG_SMEM, CG_SCRATCH, CG_COUNT };

// node flags (node space)
enum { CF_FEAS = 1, CF_KEPT = 2 };
// fields of a block's partial record; the zone table follows them
enum { PR_NA, PR_TT, PR_SC, PR_ICMAX, PR_ICMIN, PR_ZONES, PR_PSTAR, PR_F,
       PR_N };
// K8's count of in-range nodes whose first failure preemption can resolve
// rides in the feasible count's slot: K8 walks in axis order, where the
// feasible count takes no part in the round
enum { PR_RES = PR_F };
enum { OP_SUM, OP_MAX, OP_MIN };
// the slot of a round's results that holds its fetched remote word
enum { RES_WORD = PR_N };

// resident i64 rows, in shared-memory order (the carried spread last)
enum { RW_REQ_CPU, RW_REQ_MEM, RW_REQ_EPH, RW_NZ_CPU, RW_NZ_MEM,
       RW_POD_COUNT, RW_ALLOC_CPU, RW_ALLOC_MEM, RW_ALLOC_EPH, RW_ALLOWED,
       RW_SPREAD };

// Byte offsets of a block's dynamic shared memory. `kernels.py`
// (`cluster_smem_bytes`) mirrors `bytes`; the launch refuses a plan whose
// byte count differs.
struct ClusterLayout {
  size_t ws, sh32, sh64, warp, slot, res, zsum, gz, hist, boff, bmax, misc, sv,
      tot, rows, scal_req, scal_alloc, a, fl, ja, zone, valid, rec, ghost, agg,
      bytes;
  int slot_len;  // i64 per partial record
};

// the i64 planes of a gathered record a select stages (`rec`), in order;
// the tracked byte and the feasible bit follow them
enum { RP_LOCAL, RP_NA, RP_TT, RP_SC, RP_IC, RP_N };

// `rec`: a select's layout (K10b, K11b): the step state, and, with
// `resident` (the records staged in shared memory), per slot the record's
// zone, RP_N int64 planes, tracked byte and feasible bit; no rows. A select
// whose records do not fit stages them in global memory (`select_setup`).
// `pressure` (K8): with resident rows also, per slot, the nominated-ghost
// load (four int64) and the victim scan's aggregates (four int64, one
// float64, the candidate byte); without, both stay in global memory.
// `gscr`: the per-slot scratch (tot, a, fl, ja) lives in the launch's global
// workspace (`scratch_bytes`) and takes no shared memory.
__host__ __device__ inline ClusterLayout cluster_layout(
    int span, int S, int z_pad, bool spread, bool resident, bool rec = false,
    bool pressure = false, bool gscr = false) {
  ClusterLayout L;
  const size_t sp = (size_t)span, ss = gscr ? 0 : sp;
  const bool rows = resident && !rec;  // K5 / K6's node rows
  size_t o = 0;
  L.slot_len = PR_N + 2 * z_pad;
  L.ws = o;    o += 16 * 8;
  L.sh32 = o;  o += NWARPS * 4;
  L.sh64 = o;  o += NWARPS * 8;
  L.warp = o;  o += (size_t)PR_N * NWARPS * 8;
  L.slot = o;  o += 2 * (size_t)L.slot_len * 8;
  L.res = o;   o += 16 * 8;
  L.zsum = o;  o += 2 * (size_t)z_pad * 8;
  L.gz = o;    o += (size_t)z_pad * 8;
  L.hist = o;  o += CLUSTER_MAX * 4;
  L.boff = o;  o += CLUSTER_MAX * 8;
  L.bmax = o;  o += CLUSTER_MAX * 8;
  L.misc = o;  o += 8 * 4;
  L.sv = o;   // a select's step state, SS_WORDS <= 16 (shard_scan.cuh)
  if (rec) o += 16 * 8;
  L.tot = o;   o += ss * 8;
  L.rows = o;
  if (rows) o += sp * 8 * (RW_SPREAD + (spread ? 1 : 0));
  L.scal_req = o;
  if (rows) o += sp * 8 * (size_t)S;
  L.scal_alloc = o;
  if (rows) o += sp * 8 * (size_t)S;
  L.a = o;     o += ss * 4;
  L.fl = o;    o += ss * 4;
  L.ja = o;    o += ss * 4;
  L.zone = o;
  if (resident) o += sp * 4;
  L.valid = o;
  if (rows) o += sp;
  L.rec = o;
  if (rec && resident) o += sp * (RP_N * 8 + 2);
  L.ghost = o;
  if (pressure && rows) o += sp * 8 * 4;
  L.agg = o;
  if (pressure && rows) o += sp * (8 * 5 + 1);
  L.bytes = o;
  return L;
}

// Bytes of a launch's global scratch workspace (`gscr`): per slot of the
// cluster's blocks x span, TOT (int64) then A, FL and JA (int32), each plane
// over the whole cluster so block q's slice starts at q * span.
__host__ __device__ inline size_t scratch_bytes(int blocks, int span) {
  return (size_t)blocks * (size_t)span * (8 + 3 * 4);
}

// What one thread of the cluster knows of it.
struct ClusterCtx {
  int rank, C, span, npt;
  int lo, hi;    // this block's node slice
  int tlo, thi;  // this thread's slots (global node indices)
  int z_pad, round;
  i64* ws;       // the pod's weight row
  int* sh32;
  i64 *sh64, *warp, *slots, *res, *zsum, *gz, *boff, *bmax;
  int *hist, *misc;
  i64* TOT;      // kept ? score : LLONG_MIN, by local slot
  int *A, *FL, *JA;
  i64* sv;       // a select's copy of the step state
  // a select's staged records, indexed by global node: the local totals
  // (K1 and the row-local families) and the in-range feasible bits
  const i64* rloc;
  const unsigned char* rfeas;
  // the rows the cycle reads, indexed by global node: shared memory shifted
  // by -lo (resident) or the window's global rows; spread NULL without
  CycleNodes nd;
  i64* spread;
};

__device__ __forceinline__ i64 op_comb(int op, i64 a, i64 b) {
  return op == OP_SUM ? a + b : op == OP_MAX ? imax64(a, b) : imin64(a, b);
}

__device__ __forceinline__ i64 op_identity(int op) {
  return op == OP_SUM ? 0 : op == OP_MAX ? LLONG_MIN : LLONG_MAX;
}

__device__ __forceinline__ i64 warp_allreduce(int op, i64 v) {
  for (int o = 16; o > 0; o >>= 1)
    v = op_comb(op, v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Inclusive prefix sum over the lanes of a warp.
__device__ __forceinline__ i64 warp_incl_sum(i64 v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    i64 y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The partial record this round writes (slots alternate between rounds).
__device__ __forceinline__ i64* cur_slot(const ClusterCtx& cx) {
  return cx.slots + (size_t)(cx.round & 1) * (size_t)(PR_N + 2 * cx.z_pad);
}

template <typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cl, T* p, int q) {
  return cl.map_shared_rank(p, (unsigned int)q);
}

// The block that owns node (or position) j.
__device__ __forceinline__ int owner_of(const ClusterCtx& cx, i64 j) {
  return (int)(j / cx.span);
}

// Block q's copy of this block's scratch plane `p` (TOT, A, FL or JA):
// through distributed shared memory, or, with the scratch in the global
// workspace (GS), block q's slice of the plane.
template <bool GS, typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cl, const ClusterCtx& cx,
                                   T* p, int q) {
  if constexpr (GS)
    return p + (i64)(q - cx.rank) * cx.span;
  else
    return at_rank(cl, p, q);
}

// A read of a scratch word another block may have written (a peer's plane,
// or this block's after the peers' atomics): from L2, past this SM's L1,
// when the scratch is global.
template <bool GS, typename T>
__device__ __forceinline__ T ld_scratch(const T* p) {
  if constexpr (GS)
    return __ldcg(p);
  else
    return *p;
}

// A word of block q's int array `arr` at global index j (the same j in
// every thread), fetched by one thread beside a round's own reads, into
// res[RES_WORD]; `arr` NULL: none. GS: `arr` is this block's slice of a
// global scratch plane.
struct RemoteWord {
  int* arr;
  i64 j;
};

template <bool GS = false>
__device__ __forceinline__ void fetch_word(cg::cluster_group& cl,
                                           const ClusterCtx& cx,
                                           const RemoteWord& rw, int wid) {
  if (rw.arr && threadIdx.x == 32 * wid) {
    const int q = owner_of(cx, rw.j);
    cx.res[RES_WORD] = ld_scratch<GS>(peer<GS>(cl, cx, rw.arr, q)
                                      + (rw.j - (i64)q * cx.span));
  }
}

// One round: the NV values of every thread are combined with op[k] over
// the block into its partial record (warp k combines value k), then over
// the cluster: after the barrier warp k alone reads value k of the C
// records through distributed shared memory, and every thread returns the
// cluster's values in `v`. Only the values whose bit is set in `live` (the
// same in every thread) take part; the others come back as op[k]'s
// identity. The record's zone table, when used, is filled by the caller
// before the call.
template <int NV>
__device__ __forceinline__ void cluster_round(ClusterCtx& cx,
                                              cg::cluster_group& cl,
                                              i64 (&v)[NV],
                                              const int (&op)[NV],
                                              unsigned live = ~0u,
                                              RemoteWord rw = {nullptr, 0}) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  i64* slot = cur_slot(cx);
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if ((live >> k) & 1) {
      for (int o = 16; o > 0; o >>= 1)
        v[k] = op_comb(op[k], v[k], __shfl_down_sync(0xffffffffu, v[k], o));
      if (lane == 0) cx.warp[k * NWARPS + wid] = v[k];
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (((live >> k) & 1) && wid == k) {
      const i64 x = warp_allreduce(
          op[k], lane < NWARPS ? cx.warp[k * NWARPS + lane]
                               : op_identity(op[k]));
      if (lane == 0) slot[k] = x;
    }
  cl.sync();
  ++cx.round;
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (((live >> k) & 1) && wid == k) {
      i64 x = op_identity(op[k]);
      if (lane < cx.C) x = at_rank(cl, slot, lane)[k];
      x = warp_allreduce(op[k], x);
      if (lane == 0) cx.res[k] = x;
    }
  fetch_word(cl, cx, rw, NV);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k)
    v[k] = ((live >> k) & 1) ? cx.res[k] : op_identity(op[k]);
}

// A scan round: `total` (the block's count, the same in every thread) is
// published; warp 0 reads the C totals and writes each block's exclusive
// offset to boff; returns the cluster total. GS: `rw` reads a global
// scratch plane.
template <bool GS = false>
__device__ __forceinline__ i64 cluster_scan_round(ClusterCtx& cx,
                                                  cg::cluster_group& cl,
                                                  i64 total,
                                                  RemoteWord rw = {nullptr,
                                                                   0}) {
  const int lane = threadIdx.x & 31;
  i64* slot = cur_slot(cx);
  if (threadIdx.x == 0) slot[0] = total;
  cl.sync();
  ++cx.round;
  if (threadIdx.x < 32) {
    const i64 x = lane < cx.C ? at_rank(cl, slot, lane)[0] : 0;
    const i64 incl = warp_incl_sum(x);
    if (lane < cx.C) cx.boff[lane] = incl - x;
    if (lane == 31) cx.res[0] = incl;
  }
  fetch_word<GS>(cl, cx, rw, 1);
  __syncthreads();
  return cx.res[0];
}

// The highest score and the ties in one round: `bm` is this block's
// highest kept score (the same in every thread) and `lt` the thread's
// ties at it. A block's ties count when its maximum is the cluster's.
// Returns the cluster's maximum; bmax[q] gets block q's maximum, boff[q]
// the ties before block q, res[1] all the ties. GS: `rw` reads a global
// scratch plane.
template <bool GS = false>
__device__ __forceinline__ i64 cluster_max_ties_round(ClusterCtx& cx,
                                                      cg::cluster_group& cl,
                                                      i64 bm, int lt,
                                                      RemoteWord rw) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  i64* slot = cur_slot(cx);
  i64 t = lt;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  if (lane == 0) cx.warp[wid] = t;
  __syncthreads();
  if (wid == 0) {
    const i64 x = warp_allreduce(OP_SUM, lane < NWARPS ? cx.warp[lane] : 0);
    if (lane == 0) {
      slot[0] = bm;
      slot[1] = x;
    }
  }
  cl.sync();
  ++cx.round;
  if (wid == 0) {
    i64 m = LLONG_MIN, c = 0;
    if (lane < cx.C) {
      const i64* rs = at_rank(cl, slot, lane);
      m = rs[0];
      c = rs[1];
    }
    const i64 g = warp_allreduce(OP_MAX, m);
    const i64 tq = m == g ? c : 0;
    const i64 incl = warp_incl_sum(tq);
    if (lane < cx.C) {
      cx.boff[lane] = incl - tq;
      cx.bmax[lane] = m;
    }
    if (lane == 31) {
      cx.res[0] = g;
      cx.res[1] = incl;
    }
  }
  fetch_word<GS>(cl, cx, rw, 1);
  __syncthreads();
  return cx.res[0];
}

// The select round of a K8 pod, carrying the preemption pick: each thread
// reduces its own nodes' aggregates in `ps` to its victim candidate, read
// here so that no candidate stays live through the cycle; the threads'
// `l_sel` (min) and candidates combine over the block (warp shuffles, then
// warp 0 over the warps' partials) into this block's partial record;
// after the one cluster barrier warp 0 takes the minimum of the C blocks'
// l_sel and warp 1 combines their C candidates, read through distributed
// shared memory. Every thread returns the cluster's l_sel, and the
// cluster's candidate in `ps.best`. A skip pod runs this round alone (its
// l_sel unused).
__device__ __forceinline__ void pick_round(ClusterCtx& cx,
                                           cg::cluster_group& cl, i64& l_sel,
                                           PickScan& ps) {
  static_assert(1 + VB_WORDS <= PR_N, "a partial record holds the pick");
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  i64* slot = cur_slot(cx);
  i64 s = l_sel;
  for (int o = 16; o > 0; o >>= 1)
    s = imin64(s, __shfl_down_sync(0xffffffffu, s, o));
  VicBest vb = vic_none();
  for (int j = cx.tlo; j < cx.thi; ++j)
    vic_add(vb, load_agg(ps.g, ps.n, j), j);
  const VicBest w = warp_vic(vb);
  if (lane == 0) {
    cx.warp[wid] = s;
    vic_store(cx.warp + NWARPS + wid, w, NWARPS);
  }
  __syncthreads();
  if (wid == 0) {
    const i64 x = warp_allreduce(
        OP_MIN, lane < NWARPS ? cx.warp[lane] : LLONG_MAX);
    const VicBest b = warp_vic(lane < NWARPS
                                   ? vic_load(cx.warp + NWARPS + lane, NWARPS)
                                   : vic_none());
    if (lane == 0) {
      slot[0] = x;
      vic_store(slot + 1, b, 1);
    }
  }
  cl.sync();
  ++cx.round;
  if (wid == 0) {
    const i64 x = warp_allreduce(
        OP_MIN, lane < cx.C ? at_rank(cl, slot, lane)[0] : LLONG_MAX);
    if (lane == 0) cx.res[0] = x;
  } else if (wid == 1) {
    const VicBest b = warp_vic(
        lane < cx.C ? vic_load(at_rank(cl, slot, lane) + 1, 1) : vic_none());
    if (lane == 0) vic_store(cx.res + 1, b, 1);
  }
  __syncthreads();
  l_sel = cx.res[0];
  ps.best = vic_load(cx.res + 1, 1);
}

// The filter, the walk, the scores and the select of one pod's cycle
// (`_cycle_core`). `w` is the pod's weight row, `gz` (NULL = off) the
// gang's zone counts and `gmember` whether the pod is a gang member. REC
// (the mesh selects): the staged records' feasible bits replace the filter
// and their local totals K1 and the row-local families
// (`pd.local_in_base`). `ghost` (NULL = off; K2, K8) adds the nominated
// load to the rows the filter reads. K8: `pick` (NULL = none) is the pod's
// victim scan, whose pick the select round makes over the cluster
// (`pick_round`) into `pick->best`, and the result then also says whether
// some in-range node's first failure preemption can resolve (the maxima
// round carries it; the walk must be axis order). K2: `skip` (a skip pod:
// no node feasible, none evaluated) and `out` (NULL = none), the per-node
// outputs, each written by the thread that owns the node: the filter's
// feasible bit (before the n_real mask), first failure and predicate
// bits, the total and the kept bit. Every thread of every block returns
// the same result. GS: the scratch planes are the global workspace's
// (`cluster_view`).
template <bool REC = false, bool GS = false>
__device__ __forceinline__ CycleResult cluster_cycle(
    ClusterCtx& cx, cg::cluster_group& cl, const CyclePod& pd,
    const CycleWalk& wk, int gate, const i64* w, const i64* gz,
    bool gmember, const CycleGhost* ghost = nullptr,
    PickScan* pick = nullptr, bool skip = false,
    const CycleScratch* out = nullptr) {
  const CycleNodes& nd = cx.nd;
  const int n = nd.n_pad, tid = threadIdx.x, lo = cx.lo, span = cx.span;
  const int mode = wk.mode;
  const i64 nr = nd.n_real, n_safe = imax64(nr, 1);
  const i64 li = floormod(wk.last_index, n_safe), ntf = wk.num_to_find;
  int *A = cx.A, *FL = cx.FL, *JA = cx.JA;
  i64* TOT = cx.TOT;
  // ---- filter --------------------------------------------------------------
  if (mode == 2) {
    // the tie scatter's targets, published by the first round
    for (int j = cx.tlo; j < cx.thi; ++j) {
      A[j - lo] = 0;
      JA[j - lo] = INT_MAX;
    }
    if (tid < CLUSTER_MAX) cx.hist[tid] = 0;
    if (tid == 0) cx.misc[0] = 0;
  }
  int lF = 0, lres = 0;
  for (int j = cx.tlo; j < cx.thi; ++j) {
    bool feas;
    if constexpr (REC) {
      feas = cx.rfeas[j] != 0;
    } else {
      i64 bits;
      int ff;
      feas = cycle_filter_row(nd, pd, skip, j, ghost, &bits, &ff);
      if (out) {
        out->general_bits[j] = bits;
        out->fail_first[j] = (signed char)ff;
        out->feasible[j] = feas;
      }
      feas = feas && (i64)j < nr;
      if (pick && (i64)j < nr && !cycle_unresolvable(ff, bits)) lres = 1;
    }
    // with positions every feasible node is kept
    FL[j - lo] = feas ? (mode == 2 ? CF_FEAS | CF_KEPT : CF_FEAS) : 0;
    lF += feas;
  }
  // ---- rotation walk -------------------------------------------------------
  i64 F = 0, lstar = n;
  if (mode != 2) {
    if (mode == 1) cl.sync();  // the filter bits cross blocks
    // position space: feas_p[p] = feas[perm[p]] (identity when mode 0)
    int lFp = 0;
    for (int p = cx.tlo; p < cx.thi; ++p) {
      int fp;
      if (mode == 0) {
        fp = FL[p - lo] & CF_FEAS;
      } else {
        const int q = min(max(wk.perm[p], 0), n - 1);
        const int o = owner_of(cx, q);
        fp = ld_scratch<GS>(peer<GS>(cl, cx, FL, o) + (q - o * span))
             & CF_FEAS;
      }
      A[p - lo] = fp;
      lFp += fp;
    }
    int bF;
    int run = block_excl_scan(lFp, cx.sh32, &bF);
    for (int p = cx.tlo; p < cx.thi; ++p) {
      const int fp = A[p - lo];
      run += fp;
      A[p - lo] = (run << 1) | fp;  // block-inclusive cumsum, feasible bit
    }
    // the block totals, and the prefix before li where it lives
    F = cluster_scan_round<GS>(cx, cl, bF,
                               RemoteWord{li > 0 ? A : nullptr, li - 1});
    const i64 off = cx.boff[cx.rank];
    const i64 pre = li > 0 ? (cx.res[RES_WORD] >> 1)
                                 + cx.boff[owner_of(cx, li - 1)]
                           : 0;
    for (int p = cx.tlo; p < cx.thi; ++p) {
      const int wd = A[p - lo];
      const i64 Ap = (wd >> 1) + off;
      const i64 rank = p >= li ? Ap - pre : F - pre + Ap;
      if ((wd & 1) && rank <= ntf) {
        if (mode == 0) FL[p - lo] |= CF_KEPT;
        if (rank == ntf && p < lstar) lstar = p;
      }
    }
    if (mode == 1)
      for (int j = cx.tlo; j < cx.thi; ++j) {
        const int p = min(max(wk.inv_perm[j], 0), n - 1);
        const int o = owner_of(cx, p);
        const int wd =
            ld_scratch<GS>(peer<GS>(cl, cx, A, o) + (p - o * span));
        const i64 Ap = (wd >> 1) + cx.boff[o];
        const i64 rank = p >= li ? Ap - pre : F - pre + Ap;
        if ((wd & 1) && rank <= ntf) FL[j - lo] |= CF_KEPT;
      }
  }
  // ---- scores: reductions over the kept set --------------------------------
  CycleNorm nm = cycle_norm_families(pd, gate, w, gz, gmember);
  const int z_pad = cx.z_pad;
  i64* slot = cur_slot(cx);
  if (nm.do_sc) {
    for (int z = tid; z < 2 * z_pad; z += NTHREADS) slot[PR_N + z] = 0;
    __syncthreads();
  }
  i64 v[PR_N] = {LLONG_MIN, LLONG_MIN, LLONG_MIN, LLONG_MIN, LLONG_MAX, 0,
                 lstar, mode == 2 ? lF : lres};
  for (int j = cx.tlo; j < cx.thi; ++j) {
    const bool k = (FL[j - lo] & CF_KEPT) != 0;
    if (nm.do_na) v[PR_NA] = imax64(v[PR_NA], k ? pd.na[j] : 0);
    if (nm.do_tt) v[PR_TT] = imax64(v[PR_TT], k ? pd.tt[j] : 0);
    if (nm.do_sc) {
      const i64 scj = pd.sc[j];
      v[PR_SC] = imax64(v[PR_SC], k ? scj : 0);
      const int z = nd.zone_id[j];
      if (k && z > 0) {
        v[PR_ZONES] = 1;
        if (z < z_pad) {
          atomicAdd((unsigned long long*)&slot[PR_N + z],
                    (unsigned long long)scj);
          slot[PR_N + z_pad + z] = 1;
        }
      }
    }
    if (nm.do_ic) {
      const bool tr = pd.tracked[pd.tr_inert ? 0 : j];
      const i64 icv = pd.ic[pd.ic_inert ? 0 : j];
      if (k && tr) {
        v[PR_ICMAX] = imax64(v[PR_ICMAX], icv);
        v[PR_ICMIN] = imin64(v[PR_ICMIN], icv);
      }
    }
  }
  {
    // the maxima of the families that run, and the walk's cutoff or the
    // feasible count
    const int ops[PR_N] = {OP_MAX, OP_MAX, OP_MAX, OP_MAX, OP_MIN, OP_MAX,
                           OP_MIN, OP_SUM};
    const unsigned live =
        (nm.do_na ? 1u << PR_NA : 0) | (nm.do_tt ? 1u << PR_TT : 0)
        | (nm.do_sc ? (1u << PR_SC) | (1u << PR_ZONES) : 0)
        | (nm.do_ic ? (1u << PR_ICMAX) | (1u << PR_ICMIN) : 0)
        | (mode == 2 ? 1u << PR_F : 1u << PR_PSTAR)
        | (pick ? 1u << PR_RES : 0);
    cluster_round(cx, cl, v, ops, live);
  }
  const bool any_res = pick && v[PR_RES] > 0;
  nm.na_max = v[PR_NA];
  nm.tt_max = v[PR_TT];
  nm.mbn = v[PR_SC];
  nm.ic_max = imax64(v[PR_ICMAX], 0);
  nm.ic_min = imin64(v[PR_ICMIN], 0);
  nm.have_zones = v[PR_ZONES] > 0;
  i64 found, evaluated;
  if (mode == 2) {
    F = v[PR_F];
    found = imin64(F, ntf);
    evaluated = skip ? 0 : nr;
  } else {
    i64 pstar = v[PR_PSTAR];
    if (pstar == n) pstar = 0;  // argmax of an all-false mask
    found = imin64(F, ntf);
    const i64 stop_pos = pstar >= li ? pstar - li : nr - li + pstar;
    evaluated = skip ? 0 : F >= ntf ? stop_pos + 1 : nr;
  }
  if (nm.do_sc) {
    // the cluster's zone table from the blocks' records
    for (int z = tid; z < z_pad; z += NTHREADS) {
      i64 s = 0, pr = 0;
      for (int q = 0; q < cx.C; ++q) {
        const i64* rs = at_rank(cl, slot, q);
        s += rs[PR_N + z];
        pr |= rs[PR_N + z_pad + z];
      }
      cx.zsum[z] = s;
      cx.zsum[z_pad + z] = pr;
    }
    __syncthreads();
    nm.mbz = cycle_zone_max(cx.zsum, z_pad);
  }
  i64 l_max = LLONG_MIN;
  for (int j = cx.tlo; j < cx.thi; ++j) {
    i64 t;
    if constexpr (REC)
      t = cx.rloc[j];
    else
      t = local_total_one(gate, w, pd.scal[3] + nd.nz_cpu[j],
                          pd.scal[4] + nd.nz_mem[j], nd.alloc_cpu[j],
                          nd.alloc_mem[j]);
    t = cycle_score_one(pd, gate, w, nm, j, t, nm.do_sc ? pd.sc[j] : 0,
                        nm.do_gang || nm.do_sc ? nd.zone_id[j] : 0, z_pad,
                        cx.zsum, gz);
    const bool k = (FL[j - lo] & CF_KEPT) != 0;
    TOT[j - lo] = k ? t : LLONG_MIN;
    if (k) l_max = imax64(l_max, t);
    if (out) {
      out->total[j] = t;
      out->kept[j] = k;
    }
  }
  // ---- select: round-robin k-th tie in rotation order ----------------------
  // the highest score, and (axis order, positions) each block's ties at its
  // own maximum with, in axis order, their block-inclusive prefix in A
  i64 bm = l_max;
  int lt = 0;
  if (mode != 1) {
    bm = block_max64(l_max, cx.sh64);
    for (int j = cx.tlo; j < cx.thi; ++j)
      lt += bm != LLONG_MIN && TOT[j - lo] == bm;
    if (mode == 0) {
      int bt;
      int run = block_excl_scan(lt, cx.sh32, &bt);
      for (int j = cx.tlo; j < cx.thi; ++j) {
        run += bm != LLONG_MIN && TOT[j - lo] == bm;
        A[j - lo] = run;
      }
    }
  }
  const bool tie_blocks = mode != 1;
  i64 max_score, Ttot, preT = 0;
  if (tie_blocks) {
    max_score = cluster_max_ties_round<GS>(
        cx, cl, bm, lt, RemoteWord{mode == 0 && li > 0 ? A : nullptr,
                                   li - 1});
    Ttot = cx.res[1];
    if (mode == 0 && li > 0) {
      const int o = owner_of(cx, li - 1);
      preT = (cx.bmax[o] == max_score ? cx.res[RES_WORD] : 0) + cx.boff[o];
    }
  } else {
    i64 mx[1] = {l_max};
    const int ops[1] = {OP_MAX};
    cluster_round(cx, cl, mx, ops);
    max_score = mx[0];
    // position space: tie_p = tie[perm[p]], from the node owner's scores
    int ltp = 0;
    for (int p = cx.tlo; p < cx.thi; ++p) {
      const int q = min(max(wk.perm[p], 0), n - 1);
      const int o = owner_of(cx, q);
      const int tie = max_score != LLONG_MIN
                      && ld_scratch<GS>(peer<GS>(cl, cx, TOT, o)
                                        + (q - o * span)) == max_score;
      A[p - lo] = tie;
      ltp += tie;
    }
    int bt;
    int run = block_excl_scan(ltp, cx.sh32, &bt);
    for (int p = cx.tlo; p < cx.thi; ++p) {
      const int tie = A[p - lo];
      run += tie;
      A[p - lo] = (run << 1) | tie;
    }
    Ttot = cluster_scan_round<GS>(cx, cl, bt,
                                  RemoteWord{li > 0 ? A : nullptr, li - 1});
    if (li > 0)
      preT = (cx.res[RES_WORD] >> 1) + cx.boff[owner_of(cx, li - 1)];
  }
  const bool any_kept = max_score != LLONG_MIN;
  const i64 num_ties = imax64(Ttot, 1);
  const i64 kk = floormod(wk.lni, num_ties);
  i64 l_sel = n;
  if (mode == 0) {
    const i64 toff = cx.boff[cx.rank];
    if (cx.bmax[cx.rank] == max_score && any_kept)
      for (int j = cx.tlo; j < cx.thi; ++j) {
        if (TOT[j - lo] != max_score) continue;
        const i64 Ag = A[j - lo] + toff;
        const i64 trank = j >= li ? Ag - preT : Ttot - preT + Ag;
        if (trank == kk + 1 && j < l_sel) l_sel = j;
      }
  } else if (mode == 1) {
    const i64 toff = cx.boff[cx.rank];
    for (int p = cx.tlo; p < cx.thi; ++p) {
      const int wd = A[p - lo];
      if (!(wd & 1)) continue;
      const i64 Ag = (wd >> 1) + toff;
      const i64 trank = p >= li ? Ag - preT : Ttot - preT + Ag;
      if (trank == kk + 1 && p < l_sel) l_sel = p;
    }
  } else {
    // k-th smallest walk-relative position among the ties: each tie adds
    // one to the count of its relative position (and its node to the
    // position's smallest node) in the block that owns the position
    const int lane = tid & 31;
    for (int it = 0; it < cx.npt; ++it) {
      const int j = cx.tlo + it;
      int dest = -1;
      if (j < cx.thi && any_kept && TOT[j - lo] == max_score) {
        const i64 pj = wk.pos[j];
        const i64 rel = pj >= li ? pj - li : nr - li + pj;
        if (rel >= 0 && rel < n) {
          dest = owner_of(cx, rel);
          const int r = (int)(rel - (i64)dest * span);
          atomicAdd(peer<GS>(cl, cx, A, dest) + r, 1);
          atomicMin(peer<GS>(cl, cx, JA, dest) + r, j);
        }
      }
      int mine = 0;
      for (int q = 0; q < cx.C; ++q) {
        const int c = __popc(__ballot_sync(0xffffffffu, dest == q));
        if (lane == q) mine = c;
      }
      if (lane < cx.C && mine > 0) atomicAdd(&cx.hist[lane], mine);
    }
    __syncthreads();
    if (tid < cx.C && cx.hist[tid] > 0)
      atomicAdd(at_rank(cl, cx.misc, tid), cx.hist[tid]);
    cl.sync();  // every tie is counted where its position lives
    if (tid < 32) {
      const i64 c = lane < cx.C ? at_rank(cl, cx.misc, lane)[0] : 0;
      const i64 incl = warp_incl_sum(c);
      if (lane < cx.C) cx.boff[lane] = incl - c;
    }
    __syncthreads();
    int lc = 0;
    for (int r = cx.tlo; r < cx.thi; ++r) lc += ld_scratch<GS>(A + (r - lo));
    int tot;
    i64 run = block_excl_scan(lc, cx.sh32, &tot) + cx.boff[cx.rank];
    for (int r = cx.tlo; r < cx.thi; ++r) {
      const int c = ld_scratch<GS>(A + (r - lo));
      if (run <= kk && kk < run + c && ld_scratch<GS>(JA + (r - lo)) < l_sel)
        l_sel = ld_scratch<GS>(JA + (r - lo));
      run += c;
    }
  }
  {
    i64 s[1] = {l_sel};
    const int ops[1] = {OP_MIN};
    if (pick)
      pick_round(cx, cl, s[0], *pick);
    else
      cluster_round(cx, cl, s, ops);
    l_sel = s[0];
  }
  i64 sel = l_sel == n ? 0 : l_sel;  // argmax of an all-false mask
  if (mode == 1) sel = wk.perm[sel];
  CycleResult r;
  r.sel = found > 0 ? sel : -1;
  r.found = found;
  r.evaluated = evaluated;
  r.max_score = found > 0 ? max_score : 0;
  r.next_li = floormod(wk.last_index + evaluated, n_safe);
  r.next_lni = wk.lni + (found > 1 ? 1 : 0);
  r.any_resolvable = any_res;
  return r;
}

// ---- the window around the cycles -----------------------------------------
// This thread's view of the cluster over `n` node slots: its block's slice
// and slots, and the block's tables in the shared memory `sm` laid out as
// `L`, its scratch planes there or, GS, its slices of the global workspace
// `scratch` (`scratch_bytes`). The caller fills `nd` (and, a select, the
// staged records).
template <bool GS>
__device__ __forceinline__ ClusterCtx cluster_view(const ClusterGeom& g, int n,
                                                   int z_pad,
                                                   const ClusterLayout& L,
                                                   unsigned char* sm,
                                                   cg::cluster_group& cl,
                                                   void* scratch) {
  ClusterCtx cx;
  cx.rank = (int)cl.block_rank();
  cx.C = (int)cl.num_blocks();
  cx.npt = g.npt;
  cx.span = g.npt * NTHREADS;
  cx.z_pad = z_pad;
  cx.round = 0;
  cx.lo = min(cx.rank * cx.span, n);
  cx.hi = min(cx.lo + cx.span, n);
  cx.tlo = min(cx.lo + (int)threadIdx.x * g.npt, cx.hi);
  cx.thi = min(cx.tlo + g.npt, cx.hi);
  cx.ws = (i64*)(sm + L.ws);
  cx.sh32 = (int*)(sm + L.sh32);
  cx.sh64 = (i64*)(sm + L.sh64);
  cx.warp = (i64*)(sm + L.warp);
  cx.slots = (i64*)(sm + L.slot);
  cx.res = (i64*)(sm + L.res);
  cx.zsum = (i64*)(sm + L.zsum);
  cx.gz = (i64*)(sm + L.gz);
  cx.hist = (int*)(sm + L.hist);
  cx.boff = (i64*)(sm + L.boff);
  cx.bmax = (i64*)(sm + L.bmax);
  cx.misc = (int*)(sm + L.misc);
  if constexpr (GS) {
    const size_t N = (size_t)cx.C * cx.span, mine = (size_t)cx.rank * cx.span;
    int* planes = (int*)((i64*)scratch + N);
    cx.TOT = (i64*)scratch + mine;
    cx.A = planes + mine;
    cx.FL = planes + N + mine;
    cx.JA = planes + 2 * N + mine;
  } else {
    cx.TOT = (i64*)(sm + L.tot);
    cx.A = (int*)(sm + L.a);
    cx.FL = (int*)(sm + L.fl);
    cx.JA = (int*)(sm + L.ja);
  }
  cx.sv = (i64*)(sm + L.sv);
  cx.rloc = nullptr;
  cx.rfeas = nullptr;
  cx.spread = nullptr;
  return cx;
}

// Set up this thread's view of the cluster and, with resident rows, copy
// this block's slice of the rows into shared memory (GS: the scratch in the
// launch's global workspace, P_WORKSPACE). Ends with a cluster barrier: no
// block touches another's shared memory before all have started.
template <bool RES, bool GS>
__device__ __forceinline__ ClusterCtx cluster_setup(const ScanArgs& a,
                                                    const ClusterGeom& g,
                                                    unsigned char* sm,
                                                    cg::cluster_group& cl) {
  const int n = (int)a.v[I_N_PAD], S = (int)a.v[I_S];
  const bool spread = a.v[I_CARRY_SPREAD] != 0;
  const ClusterLayout L = cluster_layout(g.npt * NTHREADS, S,
                                         (int)a.v[I_Z_PAD], spread, RES,
                                         false, false, GS);
  ClusterCtx cx = cluster_view<GS>(g, n, (int)a.v[I_Z_PAD], L, sm, cl,
                                   a.p[P_WORKSPACE]);
  cx.nd = scan_nodes(a);
  cx.spread = spread ? mptr<i64>(a, P_SPREAD) : nullptr;
  if (RES) {
    const int len = cx.hi - cx.lo, lo = cx.lo;
    i64* rows = (i64*)(sm + L.rows);
    const i64* src[RW_SPREAD + 1] = {
        cx.nd.req_cpu, cx.nd.req_mem, cx.nd.req_eph, cx.nd.nz_cpu,
        cx.nd.nz_mem, cx.nd.pod_count, cx.nd.alloc_cpu, cx.nd.alloc_mem,
        cx.nd.alloc_eph, cx.nd.allowed, cx.spread};
    const int nrows = RW_SPREAD + (spread ? 1 : 0);
    for (int k = 0; k < nrows; ++k)
      for (int l = threadIdx.x; l < len; l += NTHREADS)
        rows[(size_t)k * cx.span + l] = src[k][lo + l];
    i64* sreq = (i64*)(sm + L.scal_req);
    i64* salloc = (i64*)(sm + L.scal_alloc);
    for (int l = threadIdx.x; l < len * S; l += NTHREADS) {
      sreq[l] = cx.nd.req_scalar_n[(size_t)lo * S + l];
      salloc[l] = cx.nd.alloc_scalar[(size_t)lo * S + l];
    }
    int* zone = (int*)(sm + L.zone);
    unsigned char* valid = sm + L.valid;
    for (int l = threadIdx.x; l < len; l += NTHREADS) {
      zone[l] = cx.nd.zone_id[lo + l];
      valid[l] = cx.nd.valid[lo + l];
    }
    // index the shared rows by global node: row k of node j at [j - lo]
#define SHIFT(k) (rows + (size_t)(k) * cx.span - lo)
    cx.nd.req_cpu = SHIFT(RW_REQ_CPU);
    cx.nd.req_mem = SHIFT(RW_REQ_MEM);
    cx.nd.req_eph = SHIFT(RW_REQ_EPH);
    cx.nd.nz_cpu = SHIFT(RW_NZ_CPU);
    cx.nd.nz_mem = SHIFT(RW_NZ_MEM);
    cx.nd.pod_count = SHIFT(RW_POD_COUNT);
    cx.nd.alloc_cpu = SHIFT(RW_ALLOC_CPU);
    cx.nd.alloc_mem = SHIFT(RW_ALLOC_MEM);
    cx.nd.alloc_eph = SHIFT(RW_ALLOC_EPH);
    cx.nd.allowed = SHIFT(RW_ALLOWED);
    if (spread) cx.spread = SHIFT(RW_SPREAD);
#undef SHIFT
    cx.nd.req_scalar_n = sreq - (size_t)lo * S;
    cx.nd.alloc_scalar = salloc - (size_t)lo * S;
    cx.nd.zone_id = zone - lo;
    cx.nd.valid = valid - lo;
  }
  cl.sync();
  return cx;
}

// Write this block's slice of the folded rows back to the window's rows
// (resident only: otherwise the folds landed there already).
template <bool RES>
__device__ __forceinline__ void cluster_store(const ClusterCtx& cx,
                                              const ScanArgs& a) {
  if (!RES) return;
  __syncthreads();  // every owner thread's folds land first
  const int len = cx.hi - cx.lo, lo = cx.lo, S = (int)a.v[I_S];
  const i64* from[RW_POD_COUNT + 1] = {cx.nd.req_cpu, cx.nd.req_mem,
                                       cx.nd.req_eph, cx.nd.nz_cpu,
                                       cx.nd.nz_mem, cx.nd.pod_count};
  i64* to[RW_POD_COUNT + 1] = {mptr<i64>(a, P_REQ_CPU), mptr<i64>(a, P_REQ_MEM),
                               mptr<i64>(a, P_REQ_EPH), mptr<i64>(a, P_NZ_CPU),
                               mptr<i64>(a, P_NZ_MEM),
                               mptr<i64>(a, P_POD_COUNT)};
  for (int k = 0; k <= RW_POD_COUNT; ++k)
    for (int l = threadIdx.x; l < len; l += NTHREADS)
      to[k][lo + l] = from[k][lo + l];
  if (cx.spread)
    for (int l = threadIdx.x; l < len; l += NTHREADS)
      mptr<i64>(a, P_SPREAD)[lo + l] = cx.spread[lo + l];
  for (int l = threadIdx.x; l < len * S; l += NTHREADS)
    mptr<i64>(a, P_REQ_SCALAR)[(size_t)lo * S + l] =
        cx.nd.req_scalar_n[(size_t)lo * S + l];
}

// Whether this thread owns node j (and so folds it).
__device__ __forceinline__ bool cluster_owns(const ClusterCtx& cx, i64 j) {
  return j >= cx.tlo && j < cx.thi;
}

// Add (sign +1) or take back (sign -1) the fold of pod spec `r` on node
// `sel` (`_fold_state`, kubernetes_tpu/ops/kernels.py:549) in this block's
// rows; one thread.
__device__ __forceinline__ void cluster_fold(const ClusterCtx& cx,
                                             const ScanArgs& a, int r,
                                             i64 sel, i64 sign) {
  const i64* sc = cptr<i64>(a, P_SCAL) + (size_t)r * NSCAL;
  const int S = (int)a.v[I_S];
  const CycleNodes& nd = cx.nd;
  const_cast<i64*>(nd.req_cpu)[sel] += sign * sc[SC_UPD_CPU];
  const_cast<i64*>(nd.req_mem)[sel] += sign * sc[SC_UPD_MEM];
  const_cast<i64*>(nd.req_eph)[sel] += sign * sc[SC_UPD_EPH];
  const i64* upd_s = cptr<i64>(a, P_UPD_SCALAR_P) + (size_t)r * S;
  i64* req_s = const_cast<i64*>(nd.req_scalar_n) + (size_t)sel * S;
  for (int s = 0; s < S; ++s) req_s[s] += sign * upd_s[s];
  const_cast<i64*>(nd.nz_cpu)[sel] += sign * sc[3];
  const_cast<i64*>(nd.nz_mem)[sel] += sign * sc[4];
  const_cast<i64*>(nd.pod_count)[sel] += sign;
  if (cx.spread) cx.spread[sel] += sign;
}


// ---- host side --------------------------------------------------------------
// -1: the plan's shared memory is not this layout's (`pressure`: K8's);
// -2: the plan does not cover the node axis or exceeds the cluster limit;
// -4: the scratch in global memory without its workspace, or beside
// resident rows.
inline int cluster_check(const ScanArgs& a, const ClusterGeom& g,
                         bool pressure = false) {
  const ClusterLayout L = cluster_layout(
      g.npt * NTHREADS, (int)a.v[I_S], (int)a.v[I_Z_PAD],
      a.v[I_CARRY_SPREAD] != 0, g.resident != 0, false, pressure,
      g.scratch != 0);
  if ((i64)L.bytes != g.smem) return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[I_N_PAD])
    return -2;
  if (g.scratch && (g.resident || !a.p[P_WORKSPACE])) return -4;
  return 0;
}

inline ClusterGeom cluster_geom(const i64* geom) {
  return ClusterGeom{(int)geom[CG_BLOCKS], (int)geom[CG_NPT],
                     (int)geom[CG_RESIDENT], geom[CG_SMEM],
                     (int)geom[CG_SCRATCH]};
}

// The instantiation of a cluster kernel that geometry g runs: rows
// resident (`res`), rows in global memory (`rows`), or rows and scratch in
// global memory (`all`).
template <typename Kernel>
inline Kernel cluster_pick(const ClusterGeom& g, Kernel res, Kernel rows,
                           Kernel all) {
  return g.resident ? res : g.scratch ? all : rows;
}

// The launch attributes of a cluster kernel on the current device: the
// most dynamic shared memory the device lets it take (the opt-in limit less
// its static shared memory), so that any geometry's launch fits whichever
// geometry set them, and the non-portable cluster size. The occupancy query
// (`cluster_occupancy`) sets them; the host runs it on a device before the
// kernel's first launch there.
template <typename Kernel>
inline cudaError_t cluster_attrs(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

inline void cluster_config(const ClusterGeom& g, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(g.blocks, 1, 1);
  cfg->blockDim = dim3(NTHREADS, 1, 1);
  cfg->dynamicSmemBytes = (size_t)g.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = g.blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// One cluster of g.blocks blocks running `kernel(a, g)` (K5 / K6 a window,
// K8 a chunk, K2 a cycle, K10b / K11b / K13b a step), its launch
// attributes set by the occupancy query.
template <typename Kernel, typename Args>
inline int cluster_launch(Kernel kernel, const Args& a, const ClusterGeom& g,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(g, stream, &cfg, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this geometry the card can hold at once (0: none).
// Sets the kernel's launch attributes on the current device.
template <typename Kernel>
inline int cluster_occupancy(Kernel kernel, const ClusterGeom& g,
                             int* clusters) {
  const cudaError_t e = cluster_attrs(kernel);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(g, 0, &cfg, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}
