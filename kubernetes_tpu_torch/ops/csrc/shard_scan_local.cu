// K10a shard_scan_local: the shard-local half of one step of the sharded
// generic scan, over every shard one device holds, in one launch.
//
// Replaces the per-node part of `sharded_scan_fn`
// (kubernetes_tpu/parallel/sharding.py:233), which GSPMD runs as one
// program per chip over that chip's rows inside `_batch_core`
// (kubernetes_tpu/ops/kernels.py:569): the fold of the previous pod's
// winner into the rows the shard owns (`_fold_state`, :549, and the
// carried spread), then `_feasibility` (:296) and the row-local families
// of `_fit_scores` (:157) for the step's pod, into K9a's record (the `sc`
// plane is the shard's carried spread when the scan carries one), written
// straight into row s of this step's half of the device's gathered
// buffer, where the select reads it, and of every other card's buffer
// through peer pointers; the shard's last row block to finish then
// publishes the step's stamp on every card (`local_publish`,
// shard_scan.cuh). The step index and the fold come from the step state K10b
// wrote on this device; the pod's fields from the per-spec tables
// (row[t], wtab[profile_id[t]]). After the window's last step one more
// launch only folds.
//
// Shared with K11a: `scan_local_row`, `scan_local_group_launch`
// (shard_scan.cuh); with K2/K5/K6/K8/K9a: `cycle_filter_res`,
// `cycle_row_local` (cycle.cuh).
//
// Bound on the H100: bytes (~150 B a row read, ~20 B written), far below a
// launch's own cost at 4,096 rows a shard. Design: one launch a device
// and step, a grid of (128-thread row blocks, shards), the shards' argument
// structs in one `__grid_constant__` parameter; one thread a row, whose
// node fields are loaded before the dependent loads that find the step's
// pod, and whose fold runs in the thread that then filters it, so no
// barrier past the weight row but the one before the stamp's ticket.
#include "shard_scan.cuh"

__global__ void __launch_bounds__(LOCAL_GROUP_THREADS)
    shard_scan_local_kernel(const __grid_constant__ ScanLocalGroup g) {
  const ScanLocalArgs& a = g.s[blockIdx.y];
  const int nblk = local_blocks(a);
  if ((int)blockIdx.x >= nblk) return;  // past this shard's rows
  scan_local_row<false>(a, blockIdx.x * LOCAL_GROUP_THREADS + threadIdx.x);
  local_publish(a, nblk);
}

extern "C" int shard_scan_local_launch(const i64* words, int n, int device,
                                       void* stream, int* launched) {
  return scan_local_group_launch(shard_scan_local_kernel, words, n, device,
                                 stream, launched);
}

// Peer access for every ordered pair of the `n` cards in `devices` (a
// mesh's, once): each card may then write into the others' memory, as the
// local steps write their records and stamps. An already enabled pair is
// accepted; a pair without peer access, or any other failure, returns its
// error.
extern "C" int mesh_enable_peers(const int* devices, int n) {
  for (int i = 0; i < n; ++i) {
    const DeviceScope on(devices[i]);
    if (on.err != cudaSuccess) return (int)on.err;
    for (int k = 0; k < n; ++k) {
      if (k == i || devices[k] == devices[i]) continue;
      int can = 0;
      cudaError_t e = cudaDeviceCanAccessPeer(&can, devices[i], devices[k]);
      if (e != cudaSuccess) return (int)e;
      if (!can) return (int)cudaErrorPeerAccessUnsupported;
      e = cudaDeviceEnablePeerAccess(devices[k], 0);
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear it: the pair is enabled
        e = cudaSuccess;
      }
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
