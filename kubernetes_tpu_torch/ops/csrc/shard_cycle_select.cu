// K9b shard_cycle_select: the replicated half of the sharded cycle, over
// the records every shard's K9a wrote, gathered onto this device, as one
// thread-block cluster.
//
// Replaces the replicated select epilogue of `_cycle_core`
// (kubernetes_tpu/ops/kernels.py:359) inside `sharded_cycle_fn`
// (kubernetes_tpu/parallel/sharding.py:115): the rotation walk from
// last_index with the num_to_find cutoff (identity, perm and pos modes),
// the families normalized over the kept (evaluated) set, the first-index
// argmax and the round-robin tie pick, with K2's six scalars and every
// node's total and kept bit. Every distinct device of the mesh runs it on
// the same gathered bytes, so all of them decide alike.
//
// Bound on the H100: latency, a chain of reductions and scans over n_pad
// slots (~9 B a slot in, 9 B a slot out on the default families). The
// one-block select this replaces unpacked every record into flat global
// planes and ran the walk, scores and select in ONE block of 1024 threads,
// 16 slots a thread at n_pad 16,384 (0.145 ms of device time a cycle on an
// H100). Design: K10b's cluster select (`cluster_select.cuh`) without the
// step logic:
//   - up to 16 blocks x 1024 threads (`select_plan` on the host, 8 where
//     the card holds no 16-block cluster); block q owns the node slice
//     [q * span, (q + 1) * span);
//   - each block stages its slots' fields straight from the [D, chunk]
//     gathered records into its shared memory (`select_stage`: past what
//     shared memory holds, into the global staging area `recs`), and past
//     180,224 slots (16 blocks) the per-slot scratch moves to the global
//     workspace (GS);
//   - the cycle is `cluster_cycle<true>` over the staged records: 4 cluster
//     rounds in axis order and with positions, 6 with perm; the thread that
//     owns a node writes its total and kept bit, and block 0 the six
//     scalars after the cluster barrier that ends every block's reads of
//     its peers' shared memory.
// The records are K9a's, written in place into row s of the cycle's half
// of this device's buffer (and, under the "peer" exchange, of every other
// card's): block 0's first thread waits for the cycle's D stamps at
// [round & 1] of this device's stamps (`stamps_wait`, a lost stamp traps),
// then a cluster barrier lets every block stage them, as K10b's
// `select_setup` does. Under the host's copies there are no stamps: the
// stream orders the copies before the select.
#include "cluster_select.cuh"

// scalar slots, in the order of `_SCS_INTS` (kernels.py)
enum {
  CS_N_PAD, CS_ROWS, CS_D, CS_CHUNK, CS_N_REAL, CS_Z_PAD, CS_LAST_INDEX,
  CS_LNI, CS_NUM_TO_FIND, CS_MODE, CS_GATE, CS_SKIP, CS_IPA_ON, CS_IC_INERT,
  CS_TR_INERT, CS_OFF_LOCAL, CS_OFF_NA, CS_OFF_TT, CS_OFF_SC, CS_OFF_IC,
  CS_OFF_ZONE, CS_OFF_FEAS, CS_OFF_TRACKED, CS_ROUND, CS_STAMP, CS_COUNT
};
// pointer slots, in the order of `_SCS_PTRS`: the records, the weight row,
// the inter-pod fields an inert plane broadcasts, the walk, the outputs,
// the staging area (NULL while the records fit in shared memory), the
// workspace (NULL while the scratch does) and this device's [2, D] stamps
// (NULL under the host's copies)
enum {
  SP_GATHERED, SP_W, SP_IC_B, SP_TR_B, SP_PERM, SP_INV_PERM, SP_POS,
  SP_TOTAL, SP_KEPT, SP_OUT, SP_RECS, SP_WORKSPACE, SP_STAMPS, SP_COUNT
};

struct SelectArgs {
  i64 v[CS_COUNT];
  void* p[SP_COUNT];
};

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    shard_cycle_select_kernel(SelectArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)a.v[CS_N_PAD], z_pad = (int)a.v[CS_Z_PAD];
  const int tid = threadIdx.x;
  const ClusterLayout L = select_layout(g, z_pad, GS);
  ClusterCtx cx = cluster_view<GS>(g, n, z_pad, L, smem, cl,
                                   a.p[SP_WORKSPACE]);
  const RecLayout o{a.v[CS_OFF_LOCAL], a.v[CS_OFF_NA], a.v[CS_OFF_TT],
                    a.v[CS_OFF_SC],    a.v[CS_OFF_IC], a.v[CS_OFF_ZONE],
                    a.v[CS_OFF_FEAS],  a.v[CS_OFF_TRACKED]};
  if (cx.rank == 0 && tid == 0 && a.p[SP_STAMPS]) {
    const int D = (int)a.v[CS_D];
    stamps_wait((const i64*)a.p[SP_STAMPS]
                    + (size_t)(a.v[CS_ROUND] & 1) * D,
                D, a.v[CS_STAMP]);
  }
  cl.sync();  // every block reads the records after the stamps
  CyclePod pd;
  select_stage(cx, g, L, smem, n, a.v[CS_N_REAL],
               SelectRecs{(const unsigned char*)a.p[SP_GATHERED],
                          (size_t)a.v[CS_CHUNK], (int)a.v[CS_ROWS], o,
                          (unsigned char*)a.p[SP_RECS]},
               &pd);
  pd.ipa_on = a.v[CS_IPA_ON] != 0;
  pd.ic_inert = (int)a.v[CS_IC_INERT];
  pd.tr_inert = (int)a.v[CS_TR_INERT];
  if (pd.ipa_on && o.ic < 0) pd.ic = (const i64*)a.p[SP_IC_B];
  if (pd.ipa_on && o.tracked < 0)
    pd.tracked = (const unsigned char*)a.p[SP_TR_B];
  if (tid < W_K) cx.ws[tid] = ((const i64*)a.p[SP_W])[tid];
  __syncthreads();  // the staged slots and the weight row are in
  const CycleWalk wk{a.v[CS_LAST_INDEX], a.v[CS_LNI], a.v[CS_NUM_TO_FIND],
                     (int)a.v[CS_MODE], (const int*)a.p[SP_PERM],
                     (const int*)a.p[SP_INV_PERM], (const int*)a.p[SP_POS]};
  const CycleScratch out{(i64*)a.p[SP_TOTAL], (unsigned char*)a.p[SP_KEPT],
                         nullptr, nullptr, nullptr};
  const CycleResult r = cluster_cycle<true, GS>(
      cx, cl, pd, wk, (int)a.v[CS_GATE], cx.ws, nullptr, false, nullptr,
      nullptr, a.v[CS_SKIP] != 0, &out);
  // no block exits while another may read its shared memory
  cl.sync();
  if (cx.rank == 0 && tid == 0) {
    i64* res = (i64*)a.p[SP_OUT];
    res[0] = r.sel;
    res[1] = r.found;
    res[2] = r.evaluated;
    res[3] = r.max_score;
    res[4] = r.next_li;
    res[5] = r.next_lni;
  }
}

// ---- host side --------------------------------------------------------------
// -1: the plan's shared memory is not the select's layout; -2: the plan
// does not cover the node axis or exceeds the cluster limit; -3: records
// staged in global memory without the staging area; -4: the scratch in
// global memory without its workspace, or beside staged records.
inline int cycle_select_check(const SelectArgs& a, const ClusterGeom& g) {
  if ((i64)select_layout(g, (int)a.v[CS_Z_PAD], g.scratch != 0).bytes
      != g.smem)
    return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[CS_N_PAD])
    return -2;
  if (!g.resident && !a.p[SP_RECS]) return -3;
  if (g.scratch && (g.resident || !a.p[SP_WORKSPACE])) return -4;
  return 0;
}

// One cycle's select: one cluster of g.blocks blocks on `stream`.
extern "C" int shard_cycle_select_launch(const i64* iargs, void** ptrs,
                                         const i64* geom, void* stream) {
  SelectArgs a;
  for (int i = 0; i < CS_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SP_COUNT; ++i) a.p[i] = ptrs[i];
  const ClusterGeom g = cluster_geom(geom);
  const int bad = cycle_select_check(a, g);
  if (bad) return bad;
  return cluster_launch(g.scratch ? shard_cycle_select_kernel<true>
                                  : shard_cycle_select_kernel<false>,
                        a, g, (cudaStream_t)stream);
}

extern "C" int shard_cycle_select_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(g.scratch ? shard_cycle_select_kernel<true>
                                     : shard_cycle_select_kernel<false>,
                           g, clusters);
}
