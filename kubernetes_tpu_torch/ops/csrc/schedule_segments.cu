// K6 schedule_segments: the fused drain window — singleton runs and
// all-or-nothing gangs — in one launch.
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
// reading the previous folds). Design: the persistent one-block loop of K5,
// plus the checkpoint. JAX's checkpoint is a zero-copy pick between
// immutable arrays; copying the ~1 MB of mutable rows at every segment
// start would be the naive equivalent. Every fold is an integer add, so an
// UNDO LOG is exact and costs O(members): thread 0 records (node, spec row)
// for each fold since the segment start, and a rewind subtracts them in
// reverse order; li, lni and t are restored from registers, and gz is reset
// to zero (it is reset at every segment start before the checkpoint, so the
// checkpointed counts are always zero). A member behind its segment's
// failure, and any padding pod, consumes nothing and skips its cycle. The
// packed [4B] block (sel, li after, lni - lni0, t after; -1 past n_pods)
// keeps the selections of a rewound gang's placed members, which the host
// reads as a rejected gang.
#include "cycle.cuh"

__global__ void __launch_bounds__(NTHREADS)
    schedule_segments_kernel(ScanArgs a) {
  __shared__ i64 ws[W_K];
  const CycleNodes nd = scan_nodes(a);
  const CycleScratch cs = scan_scratch(a);
  const int B = (int)a.v[I_B];
  const int n_pods = (int)a.v[I_N_PODS];
  const int gate = (int)a.v[I_GATE];
  const int z_pad = (int)a.v[I_Z_PAD];
  const bool gang_score = a.v[I_GANG_SCORE] != 0;
  const i64 n_safe = imax64(a.v[I_N_REAL], 1);
  const i64 lni0 = a.v[I_LNI0];
  const int* row = cptr<int>(a, P_ROW);
  const unsigned char* seg_start = cptr<unsigned char>(a, P_SEG_START);
  const unsigned char* gang = cptr<unsigned char>(a, P_GANG);
  i64* gz = mptr<i64>(a, P_GZ);
  int* log_node = mptr<int>(a, P_LOG_NODE);
  int* log_row = mptr<int>(a, P_LOG_ROW);
  int* packed = mptr<int>(a, P_PACKED);
  for (int i = threadIdx.x; i < 4 * B; i += NTHREADS) packed[i] = -1;
  if (gang_score)
    for (int z = threadIdx.x; z < z_pad; z += NTHREADS) gz[z] = 0;
  __syncthreads();
  i64 li = a.v[I_LAST_INDEX], lni = lni0, t = 0;
  i64 chk_li = li, chk_lni = lni, chk_t = 0;
  bool failed = false;
  int log_len = 0;  // meaningful in thread 0, which owns the log
  for (int i = 0; i < n_pods; ++i) {
    const int r = row[i];
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
      scan_weights(a, i, ws);  // its barrier also publishes the gz reset
      res = cycle_run(nd, scan_pod(a, r), false, scan_walk(a, li, lni, t),
                      gate, ws, 0, gang_score ? gz : 0, gflag, cs);
    }
    const bool hit = res.found > 0;
    const bool fail_now = gflag && !hit && !eskip;
    if (threadIdx.x == 0) {
      if (hit) {
        scan_fold(a, r, res.sel, 1);
        log_node[log_len] = (int)res.sel;
        log_row[log_len] = r;
        ++log_len;
        if (gang_score && gflag) {
          int z = nd.zone_id[res.sel];
          if (z > 0 && z < z_pad) gz[z] += 1;
        }
      }
      if (fail_now) {
        // the in-kernel gang_rewind: undo the segment's folds, newest first
        for (int k = log_len - 1; k >= 0; --k)
          scan_fold(a, log_row[k], log_node[k], -1);
        log_len = 0;
        if (gang_score)
          for (int z = 0; z < z_pad; ++z) gz[z] = 0;
      }
    }
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
    if (threadIdx.x == 0) {
      packed[i] = (hit && !eskip) ? wrap32(res.sel) : -1;
      packed[B + i] = wrap32(li);
      packed[2 * B + i] = wrap32(lni - lni0);
      packed[3 * B + i] = wrap32(t);
    }
    __syncthreads();  // folds, rewinds and gz land before the next pod
  }
  if (threadIdx.x == 0) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
}

extern "C" int schedule_segments_launch(const i64* iargs, void** ptrs,
                                        void* stream) {
  ScanArgs a = scan_args(iargs, ptrs);
  schedule_segments_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
