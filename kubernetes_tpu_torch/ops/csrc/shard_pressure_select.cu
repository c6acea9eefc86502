// K13b shard_pressure_select: the replicated half of one step of the
// sharded pressure wave, over the records every shard's K13a wrote,
// gathered onto this device.
//
// Replaces the replicated epilogue of `sharded_pressure_fn`
// (kubernetes_tpu/parallel/sharding.py:330): per pod of `_pressure_core`
// (kubernetes_tpu/ops/kernels.py:1690), `_cycle_core`'s walk from the
// carried li (axis order: the wave refuses a rotating tree), the families
// normalized over the kept set and the round-robin tie pick, over the
// ghost-aware filter bits of the records (a skip pod takes `_skip_cycle`'s
// known result); the pick of `_pick_one_node` (:1570) by axis order over
// the D candidate records (`pick_records`, victim.cuh: exact, as a
// lexicographic minimum decomposes over shards); `any_cand` from the OR
// of the shards' resolvable flags. It writes the pod's packed [5+P] row in
// `PRESSURE_HEAD` order (selected or -1; winner: -2 bound, -1 skip or no
// candidate, else the nominated row; any_cand; li after; lni after minus
// before; the slot flags of row max(winner_raw, 0), every pod, as JAX
// does) and the step state: li, lni, and the fold the shards owe, a bind
// at the selected node or the nomination's ghost at the winner. Every
// distinct device runs it on the same bytes and advances its own state.
//
// It reads the records K13a wrote in place into the device's gathered
// buffer (and the copies of other devices' rows).
//
// Shared with K10b/K11b: the argument tables, `select_walk` and
// `select_weights` (shard_scan.cuh); with K9b: `unpack_records`,
// `cycle_select` (cycle.cuh); with K14b: `pick_records`, `pick_flags`
// (victim.cuh).
//
// Bound on the H100: latency (a chain of block-wide reductions and scans
// over n_pad rows). Design: ONE block of 1024 threads, its launch bound
// once a wave (`kernels.Relaunch`).
#include "shard_scan.cuh"
#include "victim.cuh"

__global__ void __launch_bounds__(NTHREADS)
    shard_pressure_select_kernel(ScanSelectArgs a) {
  __shared__ i64 ws[W_K];
  __shared__ i64 no_scal[16];  // the pod scalars the select never reads
  __shared__ i64 sv[SS_COUNT];
  __shared__ CandPick pk;
  const int tid = threadIdx.x;
  i64* st = ssp<i64>(a, SSP_STATE);
  if (tid < 16) no_scal[tid] = 0;
  if (tid < SS_COUNT) sv[tid] = st[tid];
  __syncthreads();
  const i64 b = sv[SS_STEP];
  if (b >= a.v[SSI_N_STEPS]) return;
  const int r = ssp<const int>(a, SSP_ROW)[b];
  const bool skip = scan_skip(a, b);
  const i64 li = sv[SS_LI], lni = sv[SS_LNI];
  CycleResult res{-1, 0, 0, 0, floormod(li, imax64(a.v[SSI_N_REAL], 1)),
                  lni, false};
  if (!skip)
    res = select_cycle(a, b, r, li, lni, ws, no_scal);
  const unsigned char* g = ssp<const unsigned char>(a, SSP_GATHERED);
  const size_t chunk = (size_t)a.v[SSI_CHUNK];
  const size_t off = (size_t)a.v[SSI_CAND_OFF];
  const int P = (int)a.v[SSI_VIC_P];
  if (tid == 0) pk = pick_records(g, chunk, off, (int)a.v[SSI_D]);
  __syncthreads();
  int* o = ssp<int>(a, SSP_PACKED) + (size_t)b * (5 + P);
  pick_flags(g, chunk, off, pk, P, o + 5);
  if (tid == 0) {
    const bool hit = res.found > 0;
    const bool preempted = !hit && !skip && pk.winner >= 0;
    o[0] = hit ? wrap32(res.sel) : -1;
    o[1] = hit ? -2 : (skip ? -1 : wrap32(pk.winner));
    o[2] = (pk.any_res && !hit && !skip) ? 1 : 0;
    o[3] = wrap32(res.next_li);
    o[4] = wrap32(res.next_lni - lni);
    st[SS_STEP] = b + 1;
    st[SS_NEXT] = b + 1;
    st[SS_LI] = res.next_li;
    st[SS_LNI] = res.next_lni;
    st[SS_FOLD_SEL] = hit ? res.sel : -1;
    st[SS_FOLD_ROW] = r;
    st[SS_GHOST_SEL] = preempted ? pk.winner : -1;
  }
}

// The step's launch on `stream` of `device`; adds one to `*launched` when
// it launched.
extern "C" int shard_pressure_select_launch(const i64* iargs, void** ptrs,
                                            int device, void* stream,
                                            int* launched) {
  const DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const ScanSelectArgs a = scan_select_args(iargs, ptrs);
  shard_pressure_select_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  const int e = (int)cudaGetLastError();
  if (e == 0) ++*launched;
  return e;
}
