// K11a shard_segments_local: the shard-local half of one step of the
// sharded fused drain window, over every shard one device holds, in one
// launch.
//
// Replaces the per-node part of `sharded_segments_fn`
// (kubernetes_tpu/parallel/sharding.py:279) inside `_segments_core`
// (kubernetes_tpu/ops/kernels.py:785): K10a's fold and filter, plus each
// shard's slice of the gang checkpoint. After a gang member found no node
// (the step state's rewind flag) the shard's live rows and spread slice
// are restored from its checkpoint before anything else; at a segment
// start the checkpoint is taken (after the previous step's fold or
// rewind, as `_segments_core` snapshots the carry). Every shard of the
// launch reads the same flag, from the one step state its device's K11b
// wrote, so all of them rewind on the same step. A member behind its
// gang's failure computes nothing.
//
// Shared with K10a: `scan_local_row`, `scan_local_group_launch`
// (shard_scan.cuh).
//
// Bound on the H100: bytes, as K10a; a checkpoint or a restore adds one
// read and one write of the shard's ~9 mutable words a row. Design: as
// K10a. The checkpoint is a copy of the rows rather than K6's undo log:
// every row's copy runs in its own thread, from the registers that hold
// the row, with no serial replay.
#include "shard_scan.cuh"

__global__ void __launch_bounds__(LOCAL_GROUP_THREADS)
    shard_segments_local_kernel(const __grid_constant__ ScanLocalGroup g) {
  const ScanLocalArgs& a = g.s[blockIdx.y];
  const int nblk = local_blocks(a);
  if ((int)blockIdx.x >= nblk) return;  // past this shard's rows
  scan_local_row<true>(a, blockIdx.x * LOCAL_GROUP_THREADS + threadIdx.x);
  local_publish(a, nblk);
}

extern "C" int shard_segments_local_launch(const i64* words, int n,
                                           int device, void* stream,
                                           int* launched) {
  return scan_local_group_launch(shard_segments_local_kernel, words, n,
                                 device, stream, launched);
}
