// K11a shard_segments_local: the shard-local half of one step of the
// sharded fused drain window, over the rows one shard owns.
//
// Replaces the per-node part of `sharded_segments_fn`
// (kubernetes_tpu/parallel/sharding.py:279) inside `_segments_core`
// (kubernetes_tpu/ops/kernels.py:785): K10a's fold and filter, plus the
// shard's slice of the gang checkpoint. After a gang member found no node
// (the step state's rewind flag) the shard's live rows and spread slice
// are restored from its checkpoint before anything else; at a segment
// start the checkpoint is taken (after the previous step's fold or
// rewind, as `_segments_core` snapshots the carry). Every shard reads the
// same flag, written by its device's K11b, so all of them rewind on the
// same step. A member behind its gang's failure computes nothing.
//
// Shared with K10a: `scan_local_step` (shard_scan.cuh).
//
// Bound on the H100: bytes, as K10a; a checkpoint or a restore adds one
// read and one write of the shard's ~9 mutable words a row. Design: as
// K10a. The checkpoint is a copy of the rows rather than K6's undo log:
// every row's copy runs in its own thread, with no serial replay.
#include "shard_scan.cuh"

__global__ void shard_segments_local_kernel(ScanLocalArgs a) {
  scan_local_step<true>(a);
}

extern "C" int shard_segments_local_launch(const i64* iargs, void** ptrs,
                                           void* stream) {
  const ScanLocalArgs a = scan_local_args(iargs, ptrs);
  shard_segments_local_kernel<<<scan_local_blocks(a), LOCAL_THREADS, 0,
                                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
