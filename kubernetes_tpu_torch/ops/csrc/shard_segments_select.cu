// K11b shard_segments_select: the replicated half of one step of the
// sharded fused drain window, over the gathered K11a records.
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
// Shared with K10b: `select_cycle` (shard_scan.cuh).
//
// Bound on the H100: latency, as K10b. Design: ONE block of 1024 threads.
#include "shard_scan.cuh"

__global__ void __launch_bounds__(NTHREADS)
    shard_segments_select_kernel(ScanSelectArgs a) {
  segments_select_step(a);
}

extern "C" int shard_segments_select_launch(const i64* iargs, void** ptrs,
                                            void* stream) {
  const ScanSelectArgs a = scan_select_args(iargs, ptrs);
  shard_segments_select_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
