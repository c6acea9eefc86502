// K9b shard_cycle_select: the replicated half of the sharded cycle, over
// the records every shard's K9a wrote, gathered onto this device.
//
// Replaces the replicated select epilogue of `_cycle_core`
// (kubernetes_tpu/ops/kernels.py:359) inside `sharded_cycle_fn`
// (kubernetes_tpu/parallel/sharding.py:115): the rotation walk from
// last_index with the num_to_find cutoff (identity, perm and pos modes),
// the families normalized over the kept (evaluated) set, the first-index
// argmax and the round-robin tie pick, with K2's six scalars. Every
// distinct device of the mesh runs it on the same gathered bytes, so all
// of them decide alike.
//
// `cycle_select` (cycle.cuh) is the walk, the scores and the select of
// `_cycle_core`, over the per-node parts K2's cluster cycle shares; here
// its `base` is the gathered row-local total (`local_in_base`).
//
// Bound on the H100: latency: a chain of block-wide reductions and
// scans over n_pad rows (~9 B a row in, 9 B a row out on the default
// families). Design: ONE block of 1024 threads; it first unpacks the D
// shard records into flat [n_pad] planes (scratch in L2), then runs
// `cycle_select` on them.
#include "cycle.cuh"

enum {
  CS_N_PAD, CS_ROWS, CS_D, CS_CHUNK, CS_N_REAL, CS_Z_PAD, CS_LAST_INDEX,
  CS_LNI, CS_NUM_TO_FIND, CS_MODE, CS_GATE, CS_SKIP, CS_IPA_ON, CS_IC_INERT,
  CS_TR_INERT, CS_OFF_LOCAL, CS_OFF_NA, CS_OFF_TT, CS_OFF_SC, CS_OFF_IC,
  CS_OFF_ZONE, CS_OFF_FEAS, CS_OFF_TRACKED, CS_COUNT
};
// pointer slots, in the order of `_SCS_PTRS`
enum {
  SP_GATHERED, SP_W, SP_IC_B, SP_TR_B, SP_PERM, SP_INV_PERM, SP_POS, SP_P64,
  SP_ZONE, SP_TRACKED, SP_TOTAL, SP_KEPT, SP_FLAGS, SP_ZS, SP_OUT, SP_COUNT
};

struct SelectArgs {
  i64 v[CS_COUNT];
  void* p[SP_COUNT];
};

__global__ void __launch_bounds__(NTHREADS)
    shard_cycle_select_kernel(SelectArgs a) {
  __shared__ i64 ws[W_K];
  __shared__ i64 no_scal[16];   // the pod scalars the select never reads
  const int n = (int)a.v[CS_N_PAD], rows = (int)a.v[CS_ROWS];
  const int tid = threadIdx.x;
  const size_t chunk = (size_t)a.v[CS_CHUNK];
  const unsigned char* g = (const unsigned char*)a.p[SP_GATHERED];
  i64* p64 = (i64*)a.p[SP_P64];   // [5, n]: local, na, tt, sc, ic
  int* zone = (int*)a.p[SP_ZONE];
  unsigned char* trk = (unsigned char*)a.p[SP_TRACKED];
  int* FL = (int*)a.p[SP_FLAGS] + n;
  if (tid < W_K) ws[tid] = ((const i64*)a.p[SP_W])[tid];
  if (tid < 16) no_scal[tid] = 0;
  const RecLayout lay{a.v[CS_OFF_LOCAL], a.v[CS_OFF_NA], a.v[CS_OFF_TT],
                      a.v[CS_OFF_SC],    a.v[CS_OFF_IC], a.v[CS_OFF_ZONE],
                      a.v[CS_OFF_FEAS],  a.v[CS_OFF_TRACKED]};
  const i64 offs[5] = {lay.local, lay.na, lay.tt, lay.sc, lay.ic};
  const i64 o_zone = lay.zone, o_tr = lay.tracked;
  unpack_records(g, chunk, n, rows, lay, p64, zone, trk, FL);
  CycleNodes nd{};
  nd.n_pad = n;
  nd.n_real = a.v[CS_N_REAL];
  nd.z_pad = (int)a.v[CS_Z_PAD];
  nd.zone_id = o_zone >= 0 ? zone : nullptr;
  const bool ipa_on = a.v[CS_IPA_ON] != 0;
  CyclePod pd{};
  pd.scal = no_scal;
  pd.na = offs[1] >= 0 ? p64 + (size_t)n : nullptr;
  pd.tt = offs[2] >= 0 ? p64 + 2 * (size_t)n : nullptr;
  pd.sc = offs[3] >= 0 ? p64 + 3 * (size_t)n : nullptr;
  pd.ic = offs[4] >= 0 ? p64 + 4 * (size_t)n
                       : (ipa_on ? (const i64*)a.p[SP_IC_B] : nullptr);
  pd.tracked = o_tr >= 0 ? trk
                         : (ipa_on ? (const unsigned char*)a.p[SP_TR_B]
                                   : nullptr);
  pd.ipa_on = ipa_on;
  pd.ic_inert = (int)a.v[CS_IC_INERT];
  pd.tr_inert = (int)a.v[CS_TR_INERT];
  pd.local_in_base = 1;
  const CycleWalk wk{a.v[CS_LAST_INDEX], a.v[CS_LNI], a.v[CS_NUM_TO_FIND],
                     (int)a.v[CS_MODE], (const int*)a.p[SP_PERM],
                     (const int*)a.p[SP_INV_PERM], (const int*)a.p[SP_POS]};
  const CycleScratch cs{(i64*)a.p[SP_TOTAL], (unsigned char*)a.p[SP_KEPT],
                        nullptr, nullptr, nullptr, (int*)a.p[SP_FLAGS],
                        (i64*)a.p[SP_ZS]};
  const CycleResult r = cycle_select(nd, pd, a.v[CS_SKIP] != 0, wk,
                                     (int)a.v[CS_GATE], ws, p64, cs);
  if (tid == 0) {
    i64* out = (i64*)a.p[SP_OUT];
    out[0] = r.sel;
    out[1] = r.found;
    out[2] = r.evaluated;
    out[3] = r.max_score;
    out[4] = r.next_li;
    out[5] = r.next_lni;
  }
}

extern "C" int shard_cycle_select_launch(const i64* iargs, void** ptrs,
                                         void* stream) {
  SelectArgs a;
  for (int i = 0; i < CS_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SP_COUNT; ++i) a.p[i] = ptrs[i];
  shard_cycle_select_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
