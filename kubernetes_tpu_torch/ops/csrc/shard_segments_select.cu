// K11b shard_segments_select: the replicated half of one step of the
// sharded fused drain window, over the gathered K11a records, as one
// thread-block cluster.
//
// Replaces the replicated part of `sharded_segments_fn`
// (kubernetes_tpu/parallel/sharding.py:279) inside `_segments_core`
// (kubernetes_tpu/ops/kernels.py:785): the segment state every device
// keeps (enumerations consumed t, the checkpoint of li / lni / t, the
// failure flag), the effective skip `skip | (gang & failed)`, K10b's cycle
// at enumeration t with the rank-aware gang zone counts gz, the zone of a
// placed member folded into gz (zone 0 excepted), and on a gang member
// that finds no node the rewind of li / lni / t / gz plus the flag that
// makes every shard restore its checkpoint at the next K11a. It writes
// column i of the packed [4B] block (selected or -1, li after, lni - lni0,
// t). One pod a launch: the host enqueues exactly n_pods steps, since a
// rewind moves t and never the step.
//
// Bound on the H100: latency, as K10b. Design (`cluster_select.cuh`):
// K10b's cluster; every block keeps its own copy of gz in shared memory
// (read at the start, reset at a segment start) and runs the segment logic
// alike; block 0 alone adds the placed member's zone, writes gz back
// (zeros after a rewind) and the step state, after the last cluster
// barrier.
//
// Shared with K10b: `cluster_select.cuh`; with K5 / K6: `cluster_cycle`.
#include "cluster_select.cuh"

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    shard_segments_select_kernel(ScanSelectArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  CyclePod pd;
  ClusterCtx cx = select_setup<GS>(a, g, smem, cl, &pd);
  const i64* sv = cx.sv;
  const int tid = threadIdx.x;
  const i64 i = sv[SS_STEP];
  // past the window: every block alike, before any remote access; the
  // round still advances, after every block's read of the step state
  if (i >= a.v[SSI_N_STEPS]) {
    cl.sync();
    if (cx.rank == 0 && tid == 0)
      ssp<i64>(a, SSP_STATE)[SS_ROUND] = sv[SS_ROUND] + 1;
    return;
  }
  const i64 B = a.v[SSI_B];
  const int z_pad = (int)a.v[SSI_Z_PAD];
  const i64 n_safe = imax64(a.v[SSI_N_REAL], 1);
  const i64 lni0 = sv[SS_LNI0];
  i64 li = sv[SS_LI], lni = sv[SS_LNI], t = sv[SS_T];
  i64 chk_li = sv[SS_CHK_LI], chk_lni = sv[SS_CHK_LNI], chk_t = sv[SS_CHK_T];
  bool failed = sv[SS_FAILED] != 0;
  i64* gz = a.v[SSI_GANG_SCORE] ? cx.gz : nullptr;
  const int r = ssp<const int>(a, SSP_ROW)[i];
  const bool sflag = ssp<const unsigned char>(a, SSP_SEG_START)[i] != 0;
  const bool gflag = ssp<const unsigned char>(a, SSP_GANG)[i] != 0;
  if (sflag) {
    // gz resets BEFORE the checkpoint, so a rewind restores zeros
    if (gz)
      for (int z = tid; z < z_pad; z += NTHREADS) gz[z] = 0;
    chk_li = li;
    chk_lni = lni;
    chk_t = t;
    failed = false;
  }
  const bool eskip = scan_skip(a, i) || (gflag && failed);
  CycleResult res{-1, 0, 0, 0, floormod(li, n_safe), lni, false};
  if (!eskip) {
    select_pod_row(a, r, &pd);
    select_weights(a, i, cx.ws);
    __syncthreads();  // the weight row and the gz reset land first
    res = cluster_cycle<true, GS>(cx, cl, pd, select_walk(a, li, lni, t),
                                  (int)a.v[SSI_GATE], cx.ws, gz, gflag);
  }
  const bool hit = res.found > 0;
  const bool fail_now = gflag && !hit && !eskip;
  if (fail_now) {
    li = chk_li;
    lni = chk_lni;
    t = chk_t;
  } else {
    li = res.next_li;
    lni = res.next_lni;
    t += eskip ? 0 : 1;
  }
  failed = failed || fail_now;
  // every block has read the step state and gz, and no block reads
  // another's shared memory past this point
  cl.sync();
  if (cx.rank != 0) return;
  if (gz) {
    if (tid == 0 && hit && gflag) {
      const int z = record_zone(a, sv[SS_ROUND], res.sel);
      if (z > 0 && z < z_pad) gz[z] += 1;
    }
    __syncthreads();
    i64* out = ssp<i64>(a, SSP_GZ);
    for (int z = tid; z < z_pad; z += NTHREADS) out[z] = fail_now ? 0 : gz[z];
  }
  if (tid != 0) return;
  int* packed = ssp<int>(a, SSP_PACKED);
  packed[i] = hit ? wrap32(res.sel) : -1;
  packed[B + i] = wrap32(li);
  packed[2 * B + i] = wrap32(lni - lni0);
  packed[3 * B + i] = wrap32(t);
  i64* st = ssp<i64>(a, SSP_STATE);
  st[SS_STEP] = i + 1;
  st[SS_NEXT] = i + 1;
  st[SS_LI] = li;
  st[SS_LNI] = lni;
  st[SS_FOLD_SEL] = hit ? res.sel : -1;
  st[SS_FOLD_ROW] = r;
  st[SS_REWIND] = fail_now;
  st[SS_T] = t;
  st[SS_CHK_T] = chk_t;
  st[SS_CHK_LI] = chk_li;
  st[SS_CHK_LNI] = chk_lni;
  st[SS_FAILED] = failed;
  st[SS_ROUND] = sv[SS_ROUND] + 1;
}

extern "C" int shard_segments_select_launch(const i64* iargs, void** ptrs,
                                            const i64* geom, int device,
                                            void* stream, int* launched) {
  return select_launch(shard_segments_select_kernel<false>,
                       shard_segments_select_kernel<true>, iargs, ptrs, geom,
                       device, stream, launched);
}

extern "C" int shard_segments_select_clusters(const i64* geom,
                                              int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(g.scratch ? shard_segments_select_kernel<true>
                                     : shard_segments_select_kernel<false>,
                           g, clusters);
}
