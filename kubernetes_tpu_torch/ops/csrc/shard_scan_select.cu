// K10b shard_scan_select: the replicated half of one step of the sharded
// generic scan, over the records every shard's K10a wrote, gathered onto
// this device.
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
// step). One launch decides the skip pods before the step's live pod and
// those after it, so the window's padding costs no launch. Every distinct
// device runs it on the same bytes and advances its own step state.
//
// Shared with K11b: `select_cycle` (shard_scan.cuh); with K9b:
// `unpack_records`, `cycle_select` (cycle.cuh).
//
// Bound on the H100: latency, as K9b: a chain of block-wide reductions
// and scans over n_pad rows. Design: ONE block of 1024 threads.
#include "shard_scan.cuh"

__global__ void __launch_bounds__(NTHREADS)
    shard_scan_select_kernel(ScanSelectArgs a) {
  scan_select_step(a);
}

extern "C" int shard_scan_select_launch(const i64* iargs, void** ptrs,
                                        void* stream) {
  const ScanSelectArgs a = scan_select_args(iargs, ptrs);
  shard_scan_select_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
