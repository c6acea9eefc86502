// K5 schedule_batch: the generic burst scan, a whole window of pods in one
// launch of one thread-block cluster.
//
// Replaces `_fold_state` + `_batch_core` -> `schedule_batch`
// (kubernetes_tpu/ops/kernels.py:549, :569, :668): a lax.scan over the
// window whose step is the K2 cycle of one pod followed by the fold of its
// decision into the seven mutable node rows; the walk counters (li, lni)
// and the optional selector-spread vector ride the carry. Pods may differ
// in spec (each reads its row of the per-spec tables), in weight row
// (wtab[profile_id]) and in rotation order (identity, perm/inv_perm or the
// gather-free positions, chosen per pod by oid_seq).
//
// Bound on the H100: neither bytes nor arithmetic but the serial chain.
// Pod b+1's cycle reads the rows pod b folded, so the B cycles run one
// after another, and each is a chain of rounds across the node axis. The
// one-block kernel this replaces ran the window in ONE block of 1024
// threads on one SM, 16 node slots a thread in global memory and ~30 block
// barriers a pod (0.234 ms a pod at 15,000 nodes on an H100). Now one
// cluster of up to 16 blocks runs it (`cluster_cycle.cuh`): the rows stay
// in the blocks' shared memory for the whole window, a pod takes 4-6
// cluster rounds, and:
//   - li and lni live in registers (every thread holds the same values);
//   - the K1 totals are recomputed inline per node (`local_total_one`):
//     the folded row and the pod's weight row change from pod to pod;
//   - a skip pod (bucket padding) consumes nothing, so its cycle is not
//     run, in any block: sel -1, li reduced mod n, lni unchanged, exactly
//     as JAX's;
//   - the thread that owns the winner folds it (only on a hit: JAX's zero
//     add at max(sel, 0) is a no-op), and every block writes its slice of
//     the folded rows back at the end;
//   - block 0 writes the decision block as it goes: packed [3B] int32 (sel,
//     li after the pod, lni - lni0 wrapped to int32) and the per-pod stats
//     [5, B] int64 (selected, found, evaluated, max_score, lni after).
#include "cluster_cycle.cuh"

template <bool RES, bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    schedule_batch_kernel(ScanArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  ClusterCtx cx = cluster_setup<RES, GS>(a, g, smem, cl);
  const int B = (int)a.v[I_B];
  const int gate = (int)a.v[I_GATE];
  const i64 n_safe = imax64(a.v[I_N_REAL], 1);
  const i64 lni0 = a.v[I_LNI0];
  const bool lead = cx.rank == 0 && threadIdx.x == 0;
  const int* row = cptr<int>(a, P_ROW);
  i64* stats = mptr<i64>(a, P_STATS);
  int* packed = mptr<int>(a, P_PACKED);
  const i64* scal = cptr<i64>(a, P_SCAL);
  i64 li = a.v[I_LAST_INDEX], lni = lni0;
  int r_next = B > 0 ? row[0] : 0;
  for (int b = 0; b < B; ++b) {
    // the next pod's spec row is loaded while this pod's cycle runs
    const int r = r_next;
    if (b + 1 < B) r_next = row[b + 1];
    const bool skip = scal[(size_t)r * NSCAL + SC_SKIP] != 0;
    CycleResult res;
    if (skip) {
      res = CycleResult{-1, 0, 0, 0, floormod(li, n_safe), lni};
    } else {
      scan_weights(a, b, cx.ws);
      CyclePod pd = scan_pod(a, r);
      if (cx.spread) pd.sc = cx.spread;
      res = cluster_cycle<false, GS>(cx, cl, pd, scan_walk(a, li, lni, b),
                                     gate, cx.ws, nullptr, false);
      if (res.found > 0 && cluster_owns(cx, res.sel))
        cluster_fold(cx, a, r, res.sel, 1);
    }
    if (lead) {
      stats[b] = res.sel;
      stats[B + b] = res.found;
      stats[2 * B + b] = res.evaluated;
      stats[3 * B + b] = res.max_score;
      stats[4 * B + b] = res.next_lni;
      packed[b] = wrap32(res.sel);
      packed[B + b] = wrap32(res.next_li);
      packed[2 * B + b] = wrap32(res.next_lni - lni0);
    }
    li = res.next_li;
    lni = res.next_lni;
  }
  cluster_store<RES>(cx, a);
  if (lead) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
  cl.sync();  // no block exits while another may read its shared memory
}

extern "C" int schedule_batch_launch(const i64* iargs, void** ptrs,
                                     const i64* geom, void* stream) {
  const ScanArgs a = scan_args(iargs, ptrs);
  const ClusterGeom g = cluster_geom(geom);
  const int bad = cluster_check(a, g);
  if (bad) return bad;
  return cluster_launch(
      cluster_pick(g, schedule_batch_kernel<true, false>,
                   schedule_batch_kernel<false, false>,
                   schedule_batch_kernel<false, true>),
      a, g, (cudaStream_t)stream);
}

extern "C" int schedule_batch_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(
      cluster_pick(g, schedule_batch_kernel<true, false>,
                   schedule_batch_kernel<false, false>,
                   schedule_batch_kernel<false, true>),
      g, clusters);
}
