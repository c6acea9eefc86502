// K8 pressure_batch: schedule-else-preempt a chunk of failed pods in one
// launch of one thread-block cluster.
//
// Replaces `_resolvable_candidates` + `_pressure_core` -> `pressure_batch`
// (kubernetes_tpu/ops/kernels.py:1675, :1690, :1768): a lax.scan over the
// chunk whose step, per pod in queue order, is
//   1. the K2 cycle with the carried nominated-ghost load in the filter
//      (identity walk; the host refuses rotating trees);
//   2. the victim scan of every node (`victim_node`, victim.cuh) on the
//      rows BEFORE this pod's fold, with this pod's slot mask (priority
//      below its own), the ghost, and its static masks;
//   3. the pick by axis index (`_pick_one_node`, :1570);
//   4. the fold of a hit into the rows, or the fold of a preemption's
//      request into the ghost load of the winner;
//   5. `any_cand` from the cycle's first failures.
// Every pod, bound and skip ones too, emits the victim flags of row
// max(winner_raw, 0), as JAX does, so the packed block equals the plain
// version's and JAX's outputs bit for bit.
//
// Bound on the H100: the serial chain, as K5. Pod b+1 reads the rows and
// the ghost that pod b folded, so the pods run one after another; each
// pays K5's cycle (4 cluster rounds) and a victim scan of n_pad x P slot
// steps over the seven victim planes (~11 MB at n_pad 16,384 and P 16).
// Design: K5's cluster (`cluster_cycle.cuh`): up to 16 blocks x 1024
// threads, block q owning the node slice [q * span, (q + 1) * span), the
// rows, the ghost load and the scan's aggregates resident in the blocks'
// shared memory for the whole chunk (in global memory when they do not
// fit: the same code, a template flag), and:
//   - the cycle is `cluster_cycle` with the ghost in the filter; the
//     resolvable flag rides its maxima round;
//   - each thread scans its own nodes, on the rows it already holds for the
//     cycle, so no barrier precedes the scan, into their aggregates; the
//     cycle's select round reduces each thread's nodes to its candidate
//     (`vic_add`: the zero-victim key and the lexicographic minimum of the
//     five criteria and the key, which equals the staged pick) and carries
//     the candidates, combined over the block and then over the cluster
//     through distributed shared memory (`pick_round`), so the pick costs
//     no round of its own and no block reduces all n_pad nodes; a skip pod
//     runs that round alone;
//   - a node's aggregates are a pure function of its rows, its ghost, its
//     victim planes and the pod's spec row, so while the spec repeats each
//     block rescans only the node the previous pod folded or nominated and
//     keeps the rest; a new spec rescans every node;
//   - one node's walk (that rescan, and the winner's flags) is a chain of
//     P dependent slot steps, which one thread would pay in full latency on
//     the pod's critical path: the owner's warp walks it instead
//     (`victim_node_warp`: each lane loads its slots, the keep chain runs
//     over shuffles);
//   - the winner's warp walks its slots once more for the flags, then its
//     owner thread folds a nomination into the ghost; the thread that owns
//     a hit folds it into the rows; no block writes another block's rows;
//   - li and lni live in registers and come from and go back to a device
//     carry (`carry_in` / `carry_out`), so the chunks of a wave chain on
//     the card with no host round trip.
//
// Output: a [B, 5+P] int32 block, per pod: selected (-1 unless bound),
// winner (-2 bound, -1 no preemption, else the nominated row), any_cand,
// li after the pod, lni after minus lni before (0 or 1), then the slot
// flags.
#include "cluster_cycle.cuh"

template <bool RES, bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    pressure_batch_kernel(ScanArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  ClusterCtx cx = cluster_setup<RES, GS>(a, g, smem, cl);
  const CycleNodes& nd = cx.nd;
  const int n = nd.n_pad, B = (int)a.v[I_B], gate = (int)a.v[I_GATE];
  const int span = cx.span, lo = cx.lo, len = cx.hi - cx.lo;
  // the nodes this thread's warp owns
  const int lane = threadIdx.x & 31;
  const int wlo = min(lo + ((int)threadIdx.x - lane) * cx.npt, cx.hi);
  const int whi = min(wlo + 32 * cx.npt, cx.hi);
  const i64 n_safe = imax64(nd.n_real, 1);
  const bool lead = cx.rank == 0 && threadIdx.x == 0;
  const int* row = cptr<int>(a, P_ROW);
  const i64* scal = cptr<i64>(a, P_SCAL);
  const i64* pprio = cptr<i64>(a, P_PPRIO);
  int* out = mptr<int>(a, P_PACKED);
  // the ghost load and the aggregates, indexed by global node: this
  // block's slices in shared memory (RES) or the chunk's global vectors
  const int gslot[4] = {P_GHOST_CPU, P_GHOST_MEM, P_GHOST_EPH, P_GHOST_CNT};
  i64* gh[4];
  for (int k = 0; k < 4; ++k) gh[k] = mptr<i64>(a, gslot[k]);
  PickScan ps;  // the victim scan: its aggregates' planes, their stride
  ps.g = VictimAggPlanes{mptr<i64>(a, P_AGG_I64), mptr<double>(a, P_AGG_F64),
                         mptr<unsigned char>(a, P_AGG_U8)};
  ps.n = n;
  if (RES) {
    const ClusterLayout L = cluster_layout(span, nd.S, cx.z_pad, false, true,
                                           false, true);
    i64* sg = (i64*)(smem + L.ghost);
    for (int k = 0; k < 4; ++k) {
      for (int l = threadIdx.x; l < len; l += NTHREADS)
        sg[(size_t)k * span + l] = gh[k][lo + l];
      gh[k] = sg + (size_t)k * span - lo;
    }
    ps.g.i = (i64*)(smem + L.agg) - lo;
    ps.g.f = (double*)(smem + L.agg + (size_t)span * 32) - lo;
    ps.g.u = smem + L.agg + (size_t)span * 40 - lo;
    ps.n = span;
    __syncthreads();  // the copies land before any owner reads its slots
  }
  const CycleGhost ghost{gh[0], gh[1], gh[2], gh[3]};
  const VictimRows vr{nd.alloc_cpu, nd.alloc_mem, nd.alloc_eph, nd.allowed,
                      nd.req_cpu,   nd.req_mem,   nd.req_eph,   nd.pod_count,
                      gh[0],        gh[1],        gh[2],        gh[3]};
  VictimPlanes vp;
  vp.P = (int)a.v[I_VIC_P];
  vp.cpu = cptr<i64>(a, P_VIC_CPU);
  vp.mem = cptr<i64>(a, P_VIC_MEM);
  vp.eph = cptr<i64>(a, P_VIC_EPH);
  vp.prio = cptr<i64>(a, P_VIC_PRIO);
  vp.start = cptr<double>(a, P_VIC_START);
  vp.valid = cptr<unsigned char>(a, P_VIC_VALID);
  vp.viol = cptr<unsigned char>(a, P_VIC_VIOL);
  const int stride = 5 + vp.P;
  i64 li = cptr<i64>(a, P_CARRY_IN)[0], lni = cptr<i64>(a, P_CARRY_IN)[1];
  int r_prev = -1;
  i64 changed = -1;  // the node the previous pod folded or nominated
  for (int b = 0; b < B; ++b) {
    const int r = row[b];
    const i64* sc = scal + (size_t)r * NSCAL;
    const bool skip = sc[SC_SKIP] != 0;
    const CyclePod pd = scan_pod(a, r);
    const VictimPod vpod{sc[0], sc[1], sc[2], pprio[r], sc[6] != 0,
                         sc[5] != 0 && sc[6] != 0};
    // the victim scan, on the rows before this pod's fold: every node of
    // the thread when the spec changed, else the node that changed, by
    // its owner's warp
    if (r != r_prev) {
      for (int j = cx.tlo; j < cx.thi; ++j)
        store_agg(ps.g, ps.n, j, victim_node(j, vr, vp, vpod,
                                             pressure_static(nd, pd, j),
                                             nullptr));
    } else if (changed >= wlo && changed < whi) {
      __syncwarp();  // the owner lane's fold is visible to every lane
      const VictimAgg ag = victim_node_warp(
          (int)changed, vr, vp, vpod, pressure_static(nd, pd, (int)changed),
          nullptr);
      if (cluster_owns(cx, changed)) store_agg(ps.g, ps.n, (int)changed, ag);
    }
    CycleResult res{-1, 0, 0, 0, floormod(li, n_safe), lni, false};
    if (skip) {
      i64 unused = n;
      pick_round(cx, cl, unused, ps);
    } else {
      scan_weights(a, b, cx.ws);
      res = cluster_cycle<false, GS>(cx, cl, pd, scan_walk(a, li, lni, b),
                                     gate, cx.ws, nullptr, false, &ghost,
                                     &ps);
    }
    const i64 winner_raw = vic_winner(ps.best);
    const bool hit = res.found > 0;
    const bool preempted = !hit && !skip && winner_raw >= 0;
    const i64 w = winner_raw > 0 ? winner_raw : 0;
    int* o = out + (size_t)b * stride;
    if (lead) {
      o[0] = hit ? wrap32(res.sel) : -1;
      o[1] = hit ? -2 : (skip ? -1 : wrap32(winner_raw));
      o[2] = (res.any_resolvable && !hit && !skip) ? 1 : 0;
      o[3] = wrap32(res.next_li);
      o[4] = wrap32(res.next_lni - lni);
    }
    if (w >= wlo && w < whi) {
      // the winner's flags: its slots walked once more by its owner's
      // warp, before any fold
      victim_node_warp((int)w, vr, vp, vpod,
                       pressure_static(nd, pd, (int)w), o + 5);
      __syncwarp();  // every lane has read the winner's rows and ghost
      if (preempted && cluster_owns(cx, w)) {
        gh[0][w] += sc[SC_UPD_CPU];
        gh[1][w] += sc[SC_UPD_MEM];
        gh[2][w] += sc[SC_UPD_EPH];
        gh[3][w] += 1;
      }
    }
    if (hit && cluster_owns(cx, res.sel)) cluster_fold(cx, a, r, res.sel, 1);
    changed = hit ? res.sel : (preempted ? w : -1);
    r_prev = r;
    li = res.next_li;
    lni = res.next_lni;
  }
  cluster_store<RES>(cx, a);
  if (RES)
    for (int k = 0; k < 4; ++k)
      for (int l = threadIdx.x; l < len; l += NTHREADS)
        mptr<i64>(a, gslot[k])[lo + l] = gh[k][lo + l];
  if (lead) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
  cl.sync();  // no block exits while another may read its shared memory
}

// -3: a walk other than axis order, or a carried spread vector (K8 runs
// neither)
extern "C" int pressure_batch_launch(const i64* iargs, void** ptrs,
                                     const i64* geom, void* stream) {
  const ScanArgs a = scan_args(iargs, ptrs);
  const ClusterGeom g = cluster_geom(geom);
  const int bad = cluster_check(a, g, true);
  if (bad) return bad;
  if (a.v[I_MODE] != 0 || a.v[I_CARRY_SPREAD] != 0) return -3;
  return cluster_launch(
      cluster_pick(g, pressure_batch_kernel<true, false>,
                   pressure_batch_kernel<false, false>,
                   pressure_batch_kernel<false, true>),
      a, g, (cudaStream_t)stream);
}

extern "C" int pressure_batch_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(
      cluster_pick(g, pressure_batch_kernel<true, false>,
                   pressure_batch_kernel<false, false>,
                   pressure_batch_kernel<false, true>),
      g, clusters);
}
