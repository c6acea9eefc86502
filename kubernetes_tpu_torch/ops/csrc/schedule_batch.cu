// K5 schedule_batch: the generic burst scan, a whole window of pods in one
// launch.
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
// after another, and each is itself a chain of ~15 block-wide reductions
// and scans over n_pad nodes. Design: ONE persistent block of 1024
// threads (as K2 and K3) runs the whole scan, so a pod costs block
// barriers and no launch or host round trip:
//   - the carried rows are a fresh copy of the resident ones, folded in
//     place (only on a hit: JAX's zero add at max(sel, 0) is a no-op);
//   - li and lni live in registers (every thread holds the same values);
//   - the K1 totals are recomputed inline per node (`local_total_one`):
//     the folded row and the pod's weight row change from pod to pod;
//   - a skip pod (bucket padding) consumes nothing, so its cycle is not
//     run: sel -1, li reduced mod n, lni unchanged, exactly as JAX's;
//   - the decision block is written as it goes: packed [3B] int32 (sel,
//     li after the pod, lni - lni0 wrapped to int32) and the per-pod stats
//     [5, B] int64 (selected, found, evaluated, max_score, lni after).
// A grid-wide design (one pod's sweep over many SMs) is later work.
#include "cycle.cuh"

__global__ void __launch_bounds__(NTHREADS)
    schedule_batch_kernel(ScanArgs a) {
  __shared__ i64 ws[W_K];
  const CycleNodes nd = scan_nodes(a);
  const CycleScratch cs = scan_scratch(a);
  const int B = (int)a.v[I_B];
  const int gate = (int)a.v[I_GATE];
  const i64 n_safe = imax64(a.v[I_N_REAL], 1);
  const i64 lni0 = a.v[I_LNI0];
  const int* row = cptr<int>(a, P_ROW);
  i64* stats = mptr<i64>(a, P_STATS);
  int* packed = mptr<int>(a, P_PACKED);
  i64 li = a.v[I_LAST_INDEX], lni = lni0;
  for (int b = 0; b < B; ++b) {
    const int r = row[b];
    const bool skip = cptr<i64>(a, P_SCAL)[(size_t)r * NSCAL + SC_SKIP] != 0;
    CycleResult res;
    if (skip) {
      res = CycleResult{-1, 0, 0, 0, floormod(li, n_safe), lni};
    } else {
      scan_weights(a, b, ws);
      res = cycle_run(nd, scan_pod(a, r), false, scan_walk(a, li, lni, b),
                      gate, ws, 0, 0, false, cs);
    }
    if (threadIdx.x == 0) {
      if (res.found > 0) scan_fold(a, r, res.sel, 1);
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
    __syncthreads();  // the fold lands before the next pod's sweep
  }
  if (threadIdx.x == 0) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
}

extern "C" int schedule_batch_launch(const i64* iargs, void** ptrs,
                                     void* stream) {
  ScanArgs a = scan_args(iargs, ptrs);
  schedule_batch_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
