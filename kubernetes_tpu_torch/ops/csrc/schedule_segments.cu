// K6 schedule_segments: the fused drain window — singleton runs and
// all-or-nothing gangs — in one launch of one thread-block cluster.
//
// Replaces `_segments_core` -> `schedule_batch_segments`
// (kubernetes_tpu/ops/kernels.py:785, :949): a while_loop over the first
// n_pods pods of the K5 step, where every segment start checkpoints the
// live carry (rows, li, lni, spread, the enumerations consumed t, the gang
// zone counts gz) and a gang member that finds no node rewinds the carry
// to that checkpoint and skips the rest of its segment. Rotation orders
// are looked up by t (oid_seq[t]), so a rejected gang leaves the walk where
// it found it. With gang_score, each placed gang member adds its node's
// zone to gz and later members of the gang score nodes by
// min(members in the zone, 10) x the gang weight.
//
// Bound on the H100: the serial chain, as K5 (one cycle per pod, each
// reading the previous folds). The one-block kernel this replaces ran the
// window in ONE block on one SM (0.232 ms a pod on an H100). Design: K5's
// cluster loop (`cluster_cycle.cuh`: one cluster of up to 16 blocks, the
// rows resident in their shared memory, 4-6 cluster rounds a pod), plus
// the checkpoint. JAX's checkpoint is a zero-copy pick between immutable
// arrays; copying the mutable rows at every segment start would be the
// naive equivalent. Every fold is an integer add, so an UNDO LOG is exact
// and costs O(members): each block logs (node, spec row) of the folds it
// owns since the segment start (its own region of log_node / log_row), and
// a rewind subtracts them in reverse order in that block; li, lni and t
// are restored from registers. gz is replicated in every block's shared
// memory and updated identically by each; it is reset to zero at every
// segment start before the checkpoint, so a rewind resets it to zero. A
// member behind its segment's failure, and any padding pod, consumes
// nothing and skips its cycle in every block. The packed [4B] block (sel,
// li after, lni - lni0, t after; -1 past n_pods) keeps the selections of
// a rewound gang's placed members, which the host reads as a rejected
// gang.
#include "cluster_cycle.cuh"

template <bool RES, bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    schedule_segments_kernel(ScanArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  ClusterCtx cx = cluster_setup<RES, GS>(a, g, smem, cl);
  const int B = (int)a.v[I_B];
  const int n_pods = (int)a.v[I_N_PODS];
  const int gate = (int)a.v[I_GATE];
  const int z_pad = (int)a.v[I_Z_PAD];
  const bool gang_score = a.v[I_GANG_SCORE] != 0;
  const i64 n_safe = imax64(a.v[I_N_REAL], 1);
  const i64 lni0 = a.v[I_LNI0];
  const bool lead = cx.rank == 0 && threadIdx.x == 0;
  const int* row = cptr<int>(a, P_ROW);
  const int* zone_id = cptr<int>(a, P_ZONE_ID);
  const unsigned char* seg_start = cptr<unsigned char>(a, P_SEG_START);
  const unsigned char* gang = cptr<unsigned char>(a, P_GANG);
  // this block's undo log: B entries at most
  int* log_node = mptr<int>(a, P_LOG_NODE) + (size_t)cx.rank * B;
  int* log_row = mptr<int>(a, P_LOG_ROW) + (size_t)cx.rank * B;
  int* packed = mptr<int>(a, P_PACKED);
  i64* gz = cx.gz;
  if (cx.rank == 0) {
    for (int i = threadIdx.x; i < 4 * B; i += NTHREADS) packed[i] = -1;
    __syncthreads();  // the filler lands before block 0's pods overwrite it
  }
  if (gang_score && threadIdx.x == 0)
    for (int z = 0; z < z_pad; ++z) gz[z] = 0;
  i64 li = a.v[I_LAST_INDEX], lni = lni0, t = 0;
  i64 chk_li = li, chk_lni = lni, chk_t = 0;
  bool failed = false;
  int log_len = 0;  // the same in every thread of the block
  int r_next = n_pods > 0 ? row[0] : 0;
  for (int i = 0; i < n_pods; ++i) {
    // the next pod's spec row is loaded while this pod's cycle runs
    const int r = r_next;
    if (i + 1 < n_pods) r_next = row[i + 1];
    const bool sflag = seg_start[i] != 0, gflag = gang[i] != 0;
    if (sflag) {
      // gz resets BEFORE the checkpoint, so a rewind restores zeros
      if (gang_score && threadIdx.x == 0)
        for (int z = 0; z < z_pad; ++z) gz[z] = 0;
      chk_li = li;
      chk_lni = lni;
      chk_t = t;
      failed = false;
      log_len = 0;
    }
    const bool skip =
        cptr<i64>(a, P_SCAL)[(size_t)r * NSCAL + SC_SKIP] != 0;
    const bool eskip = skip || (gflag && failed);
    CycleResult res;
    if (eskip) {
      res = CycleResult{-1, 0, 0, 0, floormod(li, n_safe), lni};
    } else {
      scan_weights(a, i, cx.ws);  // its barrier also publishes gz
      CyclePod pd = scan_pod(a, r);
      if (cx.spread) pd.sc = cx.spread;
      res = cluster_cycle<false, GS>(cx, cl, pd, scan_walk(a, li, lni, t),
                                     gate, cx.ws, gang_score ? gz : nullptr,
                                     gflag);
    }
    const bool hit = res.found > 0;
    const bool fail_now = gflag && !hit && !eskip;
    if (hit) {
      if (cluster_owns(cx, res.sel)) {
        cluster_fold(cx, a, r, res.sel, 1);
        log_node[log_len] = (int)res.sel;
        log_row[log_len] = r;
      }
      if (owner_of(cx, res.sel) == cx.rank) ++log_len;
      if (gang_score && gflag && threadIdx.x == 0) {
        const int z = zone_id[res.sel];
        if (z > 0 && z < z_pad) gz[z] += 1;
      }
    }
    if (fail_now) {
      // the in-kernel gang_rewind: undo this block's folds, newest first
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int k = log_len - 1; k >= 0; --k)
          cluster_fold(cx, a, log_row[k], log_node[k], -1);
        if (gang_score)
          for (int z = 0; z < z_pad; ++z) gz[z] = 0;
      }
      __syncthreads();
      log_len = 0;
      li = chk_li;
      lni = chk_lni;
      t = chk_t;
    } else {
      li = res.next_li;
      lni = res.next_lni;
      t += eskip ? 0 : 1;
    }
    failed = failed || fail_now;
    if (lead) {
      packed[i] = (hit && !eskip) ? wrap32(res.sel) : -1;
      packed[B + i] = wrap32(li);
      packed[2 * B + i] = wrap32(lni - lni0);
      packed[3 * B + i] = wrap32(t);
    }
  }
  cluster_store<RES>(cx, a);
  if (lead) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
  cl.sync();  // no block exits while another may read its shared memory
}

extern "C" int schedule_segments_launch(const i64* iargs, void** ptrs,
                                        const i64* geom, void* stream) {
  const ScanArgs a = scan_args(iargs, ptrs);
  const ClusterGeom g = cluster_geom(geom);
  const int bad = cluster_check(a, g);
  if (bad) return bad;
  return cluster_launch(
      cluster_pick(g, schedule_segments_kernel<true, false>,
                   schedule_segments_kernel<false, false>,
                   schedule_segments_kernel<false, true>),
      a, g, (cudaStream_t)stream);
}

extern "C" int schedule_segments_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(
      cluster_pick(g, schedule_segments_kernel<true, false>,
                   schedule_segments_kernel<false, false>,
                   schedule_segments_kernel<false, true>),
      g, clusters);
}
