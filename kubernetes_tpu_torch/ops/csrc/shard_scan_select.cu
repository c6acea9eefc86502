// K10b shard_scan_select: the replicated half of one step of the sharded
// generic scan, over the records every shard's K10a wrote, gathered onto
// this device, as one thread-block cluster.
//
// Replaces the replicated select of `sharded_scan_fn`
// (kubernetes_tpu/parallel/sharding.py:233): per pod of `_batch_core`
// (kubernetes_tpu/ops/kernels.py:569), `_cycle_core`'s walk from the
// carried li (identity, perm / inv_perm or positions, row oid_seq[b]), the
// families normalized over the kept set, the first-index argmax and the
// round-robin tie pick, with the pod's wtab row; a skip pod takes its
// known result (`_skip_cycle`). It writes column b of the packed [3B]
// block (selected, li after, lni - lni0 wrapped to int32) and of the
// stats, and the step state (li, lni, the fold for the shards, the next
// step, the exchange round). One launch decides the skip pods before the step's live pod and
// those after it, so the window's padding costs no launch. Every distinct
// device runs it on the same bytes and advances its own step state.
//
// Bound on the H100: latency, a chain of reductions over n_pad slots.
// Design (`cluster_select.cuh`): a cluster of up to 16 blocks x 1024
// threads, each block staging its slice of the records into shared memory
// and running `cluster_cycle` over it; every block runs the skip runs
// alike, block 0 alone writes, after the last cluster barrier.
//
// Shared with K11b: `cluster_select.cuh`; with K5 / K6: `cluster_cycle`.
#include "cluster_select.cuh"

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    shard_scan_select_kernel(ScanSelectArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  CyclePod pd;
  ClusterCtx cx = select_setup<GS>(a, g, smem, cl, &pd);
  i64* sv = cx.sv;
  const int tid = threadIdx.x;
  const bool lead = cx.rank == 0 && tid == 0;
  const i64 lni0 = sv[SS_LNI0];
  if (tid == 0) {
    // the skip pods before the live step (block 0 writes their columns)
    i64 li = sv[SS_LI];
    sv[SS_STEP] = scan_skip_run(a, sv[SS_STEP], &li, sv[SS_LNI], lni0, lead);
    sv[SS_LI] = li;
  }
  __syncthreads();
  i64 i = sv[SS_STEP], li = sv[SS_LI], lni = sv[SS_LNI];
  const bool live = i < a.v[SSI_N_STEPS];
  CycleResult res{-1, 0, 0, 0, li, lni, false};
  int r = 0;
  if (live) {
    r = ssp<const int>(a, SSP_ROW)[i];
    select_pod_row(a, r, &pd);
    select_weights(a, i, cx.ws);
    __syncthreads();  // the weight row lands before the cycle reads it
    res = cluster_cycle<true, GS>(cx, cl, pd, select_walk(a, li, lni, i),
                                  (int)a.v[SSI_GATE], cx.ws, nullptr, false);
  }
  // every block has read the step state, and no block reads another's
  // shared memory past this point
  cl.sync();
  if (!lead) return;
  i64 fold = -1;
  if (live) {
    fold = res.found > 0 ? res.sel : -1;
    li = res.next_li;
    lni = res.next_lni;
    scan_write(a, i, res, lni0);
    i = scan_skip_run(a, i + 1, &li, lni, lni0, true);
  }
  i64* st = ssp<i64>(a, SSP_STATE);
  st[SS_STEP] = i;
  st[SS_NEXT] = i;
  st[SS_LI] = li;
  st[SS_LNI] = lni;
  st[SS_FOLD_SEL] = fold;
  st[SS_FOLD_ROW] = r;
  st[SS_ROUND] = sv[SS_ROUND] + 1;
}

extern "C" int shard_scan_select_launch(const i64* iargs, void** ptrs,
                                        const i64* geom, int device,
                                        void* stream, int* launched) {
  return select_launch(shard_scan_select_kernel<false>,
                       shard_scan_select_kernel<true>, iargs, ptrs, geom,
                       device, stream, launched);
}

extern "C" int shard_scan_select_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(g.scratch ? shard_scan_select_kernel<true>
                                     : shard_scan_select_kernel<false>,
                           g, clusters);
}
