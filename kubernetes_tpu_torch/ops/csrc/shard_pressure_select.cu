// K13b shard_pressure_select: the replicated half of one step of the
// sharded pressure wave, over the records every shard's K13a wrote,
// gathered onto this device, as one thread-block cluster.
//
// Replaces the replicated epilogue of `sharded_pressure_fn`
// (kubernetes_tpu/parallel/sharding.py:330): per pod of `_pressure_core`
// (kubernetes_tpu/ops/kernels.py:1690), `_cycle_core`'s walk from the
// carried li (axis order: the wave refuses a rotating tree), the families
// normalized over the kept set and the round-robin tie pick, over the
// ghost-aware filter bits of the records (a skip pod takes `_skip_cycle`'s
// known result); the pick of `_pick_one_node` (:1570) by axis order over
// the D candidate records (`pick_records`, victim.cuh: exact, as a
// lexicographic minimum decomposes over shards); `any_cand` from the OR
// of the shards' resolvable flags. It writes the pod's packed [5+P] row in
// `PRESSURE_HEAD` order (selected or -1; winner: -2 bound, -1 skip or no
// candidate, else the nominated row; any_cand; li after; lni after minus
// before; the slot flags of row max(winner_raw, 0), every pod, as JAX
// does) and the step state: li, lni, and the fold the shards owe, a bind
// at the selected node or the nomination's ghost at the winner. Every
// distinct device runs it on the same bytes and advances its own state.
// One step a pod, skip pods included: K13a reads the step state that
// step wrote.
//
// It reads the records K13a wrote into its step's half of the device's
// gathered buffer (this device's shards in place, the other cards' through
// peer stores, or the host's copies), after their stamps.
//
// Bound on the H100: latency, a chain of reductions over n_pad slots. The
// one-block select this replaces unpacked every record into global planes
// and ran `cycle_select` in ONE block of 1024 threads, 16 slots a thread at
// n_pad 16,384 (0.119 ms of device time a step on an H100). Design: K10b's
// cluster select (`cluster_select.cuh`): up to 16 blocks x 1024 threads,
// each block staging its slice of the records in shared memory (past
// what it holds, in the global staging area `recs`; past 180,224 slots the
// scratch in the global workspace too) and running `cluster_cycle<true>`
// in axis order (4 cluster rounds). After the cluster barrier that ends
// every block's reads of the step state and of its peers' shared memory,
// block 0 alone picks: one thread runs `pick_records`, a lexicographic
// minimum over the D <= a few shard records (a dozen loads, no reduction
// worth a warp), then block 0's threads copy the winner's P slot flags and
// thread 0 writes the head of the packed row and the step state.
//
// Shared with K10b / K11b: `cluster_select.cuh` and the argument tables;
// with K14b: `pick_records`, `pick_flags` (victim.cuh).
#include "cluster_select.cuh"

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    shard_pressure_select_kernel(ScanSelectArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  CyclePod pd;
  ClusterCtx cx = select_setup<GS>(a, g, smem, cl, &pd);
  const int tid = threadIdx.x;
  const i64 b = cx.sv[SS_STEP];
  // past the wave: every block returns before touching a peer; the round
  // still advances, after every block's read of the step state
  if (b >= a.v[SSI_N_STEPS]) {
    cl.sync();
    if (cx.rank == 0 && tid == 0)
      ssp<i64>(a, SSP_STATE)[SS_ROUND] = cx.sv[SS_ROUND] + 1;
    return;
  }
  const int r = ssp<const int>(a, SSP_ROW)[b];
  const bool skip = scan_skip(a, b);
  const i64 li = cx.sv[SS_LI], lni = cx.sv[SS_LNI];
  CycleResult res{-1, 0, 0, 0, floormod(li, imax64(a.v[SSI_N_REAL], 1)),
                  lni, false};
  if (!skip) {
    select_pod_row(a, r, &pd);
    select_weights(a, b, cx.ws);
    __syncthreads();  // the weight row lands before the cycle reads it
    res = cluster_cycle<true, GS>(cx, cl, pd, select_walk(a, li, lni, b),
                                  (int)a.v[SSI_GATE], cx.ws, nullptr, false);
  }
  // every block has read the step state, and no block reads another's
  // shared memory past this point
  cl.sync();
  if (cx.rank != 0) return;
  const unsigned char* gath = select_records(a, cx.sv[SS_ROUND]);
  const size_t chunk = (size_t)a.v[SSI_CHUNK];
  const size_t off = (size_t)a.v[SSI_CAND_OFF];
  const int P = (int)a.v[SSI_VIC_P];
  CandPick* pk = (CandPick*)cx.res;  // the rounds' results are spent
  if (tid == 0) *pk = pick_records(gath, chunk, off, (int)a.v[SSI_D]);
  __syncthreads();
  int* o = ssp<int>(a, SSP_PACKED) + (size_t)b * (5 + P);
  pick_flags(gath, chunk, off, *pk, P, o + 5);
  if (tid == 0) {
    const bool hit = res.found > 0;
    const bool preempted = !hit && !skip && pk->winner >= 0;
    i64* st = ssp<i64>(a, SSP_STATE);
    o[0] = hit ? wrap32(res.sel) : -1;
    o[1] = hit ? -2 : (skip ? -1 : wrap32(pk->winner));
    o[2] = (pk->any_res && !hit && !skip) ? 1 : 0;
    o[3] = wrap32(res.next_li);
    o[4] = wrap32(res.next_lni - lni);
    st[SS_STEP] = b + 1;
    st[SS_NEXT] = b + 1;
    st[SS_LI] = res.next_li;
    st[SS_LNI] = res.next_lni;
    st[SS_FOLD_SEL] = hit ? res.sel : -1;
    st[SS_FOLD_ROW] = r;
    st[SS_GHOST_SEL] = preempted ? pk->winner : -1;
    st[SS_ROUND] = cx.sv[SS_ROUND] + 1;
  }
}

// The step's launch on `stream` of `device`; adds one to `*launched` when
// it launched.
extern "C" int shard_pressure_select_launch(
    const i64* iargs, void** ptrs, const i64* geom,
    int device, void* stream, int* launched) {
  return select_launch(shard_pressure_select_kernel<false>,
                       shard_pressure_select_kernel<true>, iargs, ptrs, geom,
                       device, stream, launched);
}

extern "C" int shard_pressure_select_clusters(const i64* geom,
                                              int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(g.scratch ? shard_pressure_select_kernel<true>
                                     : shard_pressure_select_kernel<false>,
                           g, clusters);
}
