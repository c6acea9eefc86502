// K10a shard_scan_local: the shard-local half of one step of the sharded
// generic scan, over the rows one shard owns, on the shard's own device.
//
// Replaces the per-node part of `sharded_scan_fn`
// (kubernetes_tpu/parallel/sharding.py:233), which GSPMD keeps on each
// chip's rows inside `_batch_core` (kubernetes_tpu/ops/kernels.py:569):
// the fold of the previous pod's winner into the rows the shard owns
// (`_fold_state`, :549, and the carried spread), then `_feasibility`
// (:296) and the row-local families of `_fit_scores` (:157) for the step's
// pod, into the record the all-gather copies (K9a's planes; the `sc` plane
// is the shard's carried spread when the scan carries one). The step index
// and the fold come from the step state K10b wrote on this device; the
// pod's fields from the per-spec tables (row[t], wtab[profile_id[t]]).
// After the window's last step one more launch only folds.
//
// Shared with K11a: `scan_local_step` (shard_scan.cuh); with K2/K5/K6/K8/
// K9a: `cycle_filter_row`, `cycle_row_local` (cycle.cuh).
//
// Bound on the H100: bytes, as K9a (~150 B a row read, ~20 B written).
// Design: one thread per row, 256-thread blocks over the shard; the fold
// of row j runs in the thread that then filters row j, so no barrier.
#include "shard_scan.cuh"

__global__ void shard_scan_local_kernel(ScanLocalArgs a) {
  scan_local_step<false>(a);
}

extern "C" int shard_scan_local_launch(const i64* iargs, void** ptrs,
                                       void* stream) {
  const ScanLocalArgs a = scan_local_args(iargs, ptrs);
  shard_scan_local_kernel<<<scan_local_blocks(a), LOCAL_THREADS, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
