// K2 schedule_cycle: one scheduling cycle of one pod over every node, as
// one thread-block cluster.
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core` ->
// `schedule_cycle` (kubernetes_tpu/ops/kernels.py:296, :157, :359, :509):
// the filter of every node (its predicate bits and first failing
// predicate), the rotation walk from last_index (identity, perm / inv_perm
// or positions), every family normalized over the kept set with the pod's
// weight row (the static weights or its wtab row), and the round-robin
// k-th tie select; a skip pod finds no feasible node and evaluates none, as
// JAX's. The optional nominated-ghost load (four [n_pad] vectors, NULL =
// none) enters the filter only: the serial cycle's two-pass fit with
// nominated pods (podFitsOnNode, generic_scheduler.go:598) for
// resource-only nominees.
//
// Bound on the H100: latency. The bytes are ~150 B per node (14 node
// fields in, five per-node outputs out), ~2.5 MB at n_pad 16,384, under
// 1 us at 3.35 TB/s; the work is a chain of whole-axis reductions and
// scans, each of which needs every node before the next can start. The
// one-block kernel this replaces ran that chain in ONE block of 1024
// threads on one SM, 16 slots a thread and ~30 block barriers, after a K1
// launch for the row-local totals (0.54 ms a cycle on an H100). Design:
// K5's cluster cycle (`cluster_cycle.cuh`) for one pod:
//   - up to 16 blocks x 1024 threads, block q owning the node slice
//     [q * span, (q + 1) * span), one slot a thread at n_pad 16,384, only
//     the blocks that own a node (`cycle_plan` on the host); 4 cluster
//     rounds in axis order and with positions, 6 with perm;
//   - the rows stay in global memory: one pod reads each row once, so
//     staging them in shared memory would only add a copy; the per-slot
//     scratch lives in shared memory, past 180,224 slots (16 blocks) in a
//     global workspace (GS);
//   - K1's totals are computed inline per node (`local_total_one`), so no
//     launch precedes the cycle;
//   - the thread that owns a node writes its five per-node outputs (the
//     filter's feasible bit, first failure and predicate bits, then its
//     total and kept bit), and block 0 writes the six scalars after the
//     last cluster barrier.
#include "cluster_cycle.cuh"

// scalar slots, in the order of `_CYCLE_INTS` (kernels.py)
enum {
  CYI_N_PAD, CYI_S, CYI_N_REAL, CYI_Z_PAD, CYI_LAST_INDEX, CYI_LNI,
  CYI_NUM_TO_FIND, CYI_MODE, CYI_GATE, CYI_IPA_ON, CYI_IC_INERT,
  CYI_TR_INERT, CYI_COUNT
};
// pointer slots, in the order of `_CYCLE_PTRS`: the node rows, the pod's
// scalars and fields (NULL = inert), its weight row, the walk, the ghost,
// the outputs and the workspace (NULL while the scratch fits in shared
// memory)
enum {
  CYP_VALID, CYP_ALLOC_CPU, CYP_ALLOC_MEM, CYP_ALLOC_EPH, CYP_ALLOWED,
  CYP_REQ_CPU, CYP_REQ_MEM, CYP_REQ_EPH, CYP_NZ_CPU, CYP_NZ_MEM,
  CYP_POD_COUNT, CYP_ALLOC_SCALAR, CYP_REQ_SCALAR, CYP_ZONE_ID, CYP_SCAL,
  CYP_REQ_SCALAR_P, CYP_SEL_OK, CYP_TAINTS_OK, CYP_UNSCHED_OK, CYP_PORTS_OK,
  CYP_HOST_OK, CYP_DISK_OK, CYP_MAXVOL_OK, CYP_VOLBIND_OK, CYP_VOLZONE_OK,
  CYP_IPA_CODE, CYP_NA, CYP_TT, CYP_SC, CYP_IC, CYP_IMG, CYP_PA,
  CYP_TRACKED, CYP_W, CYP_PERM, CYP_INV_PERM, CYP_POS, CYP_GHOST_CPU,
  CYP_GHOST_MEM, CYP_GHOST_EPH, CYP_GHOST_CNT, CYP_TOTAL, CYP_KEPT,
  CYP_FEASIBLE, CYP_FAIL_FIRST, CYP_GENERAL_BITS, CYP_OUT, CYP_WORKSPACE,
  CYP_COUNT
};
// slots of the six scalar outputs (CYP_OUT)
enum { CO_SELECTED, CO_FOUND, CO_EVALUATED, CO_MAX_SCORE, CO_NEXT_LI,
       CO_NEXT_LNI, CO_COUNT };

struct CycleArgs {
  i64 v[CYI_COUNT];
  void* p[CYP_COUNT];
};

template <typename T>
__device__ __forceinline__ T* cyp(const CycleArgs& a, int slot) {
  return (T*)a.p[slot];
}

// K2's shared-memory layout at geometry g: no rows, its scratch in shared
// memory or in the global workspace (`gscr`) (`cycle_plan` in kernels.py
// mirrors it).
__host__ __device__ inline ClusterLayout cycle_layout(const ClusterGeom& g,
                                                      int S, int z_pad,
                                                      bool gscr) {
  return cluster_layout(g.npt * NTHREADS, S, z_pad, false, false, false,
                        false, gscr);
}

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    schedule_cycle_kernel(CycleArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  typedef const unsigned char* B;
  typedef const i64* L;
  const int n = (int)a.v[CYI_N_PAD], S = (int)a.v[CYI_S];
  const int z_pad = (int)a.v[CYI_Z_PAD];
  ClusterCtx cx = cluster_view<GS>(g, n, z_pad, cycle_layout(g, S, z_pad, GS),
                                   smem, cl, a.p[CYP_WORKSPACE]);
  cx.nd = CycleNodes{n, S, a.v[CYI_N_REAL], z_pad, (B)a.p[CYP_VALID],
                     (L)a.p[CYP_ALLOC_CPU], (L)a.p[CYP_ALLOC_MEM],
                     (L)a.p[CYP_ALLOC_EPH], (L)a.p[CYP_ALLOWED],
                     (L)a.p[CYP_REQ_CPU], (L)a.p[CYP_REQ_MEM],
                     (L)a.p[CYP_REQ_EPH], (L)a.p[CYP_NZ_CPU],
                     (L)a.p[CYP_NZ_MEM], (L)a.p[CYP_POD_COUNT],
                     (L)a.p[CYP_ALLOC_SCALAR], (L)a.p[CYP_REQ_SCALAR],
                     (const int*)a.p[CYP_ZONE_ID]};
  const CyclePod pd{(L)a.p[CYP_SCAL], (L)a.p[CYP_REQ_SCALAR_P],
                    (B)a.p[CYP_SEL_OK], (B)a.p[CYP_TAINTS_OK],
                    (B)a.p[CYP_UNSCHED_OK], (B)a.p[CYP_PORTS_OK],
                    (B)a.p[CYP_HOST_OK], (B)a.p[CYP_DISK_OK],
                    (B)a.p[CYP_MAXVOL_OK], (B)a.p[CYP_VOLBIND_OK],
                    (B)a.p[CYP_VOLZONE_OK],
                    (const signed char*)a.p[CYP_IPA_CODE], (L)a.p[CYP_NA],
                    (L)a.p[CYP_TT], (L)a.p[CYP_SC], (L)a.p[CYP_IC],
                    (L)a.p[CYP_IMG], (L)a.p[CYP_PA], (B)a.p[CYP_TRACKED],
                    (int)a.v[CYI_IPA_ON], (int)a.v[CYI_IC_INERT],
                    (int)a.v[CYI_TR_INERT], 0};
  const CycleWalk wk{a.v[CYI_LAST_INDEX], a.v[CYI_LNI],
                     a.v[CYI_NUM_TO_FIND], (int)a.v[CYI_MODE],
                     cyp<const int>(a, CYP_PERM),
                     cyp<const int>(a, CYP_INV_PERM),
                     cyp<const int>(a, CYP_POS)};
  const CycleGhost ghost{(L)a.p[CYP_GHOST_CPU], (L)a.p[CYP_GHOST_MEM],
                         (L)a.p[CYP_GHOST_EPH], (L)a.p[CYP_GHOST_CNT]};
  const CycleScratch out{cyp<i64>(a, CYP_TOTAL),
                         cyp<unsigned char>(a, CYP_KEPT),
                         cyp<unsigned char>(a, CYP_FEASIBLE),
                         cyp<signed char>(a, CYP_FAIL_FIRST),
                         cyp<i64>(a, CYP_GENERAL_BITS)};
  if (threadIdx.x < W_K) cx.ws[threadIdx.x] = ((L)a.p[CYP_W])[threadIdx.x];
  __syncthreads();  // the weight row lands before the cycle reads it
  const CycleResult r = cluster_cycle<false, GS>(
      cx, cl, pd, wk, (int)a.v[CYI_GATE], cx.ws, nullptr, false,
      ghost.cpu ? &ghost : nullptr, nullptr, pd.scal[SC_SKIP] != 0, &out);
  // no block exits while another may read its shared memory
  cl.sync();
  if (cx.rank == 0 && threadIdx.x == 0) {
    i64* o = cyp<i64>(a, CYP_OUT);
    o[CO_SELECTED] = r.sel;
    o[CO_FOUND] = r.found;
    o[CO_EVALUATED] = r.evaluated;
    o[CO_MAX_SCORE] = r.max_score;
    o[CO_NEXT_LI] = r.next_li;
    o[CO_NEXT_LNI] = r.next_lni;
  }
}

// ---- host side --------------------------------------------------------------
// -1: the plan's shared memory is not K2's layout; -2: the plan does not
// cover the node axis or exceeds the cluster limit; -3: rows resident (K2
// reads them in place); -4: the scratch in global memory without its
// workspace.
inline int cycle_check(const CycleArgs& a, const ClusterGeom& g) {
  if ((i64)cycle_layout(g, (int)a.v[CYI_S], (int)a.v[CYI_Z_PAD],
                        g.scratch != 0).bytes != g.smem)
    return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[CYI_N_PAD])
    return -2;
  if (g.resident) return -3;
  if (g.scratch && !a.p[CYP_WORKSPACE]) return -4;
  return 0;
}

// One cycle: one cluster of g.blocks blocks on `stream`.
extern "C" int schedule_cycle_launch(const i64* iargs, void** ptrs,
                                     const i64* geom, void* stream) {
  CycleArgs a;
  for (int i = 0; i < CYI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < CYP_COUNT; ++i) a.p[i] = ptrs[i];
  const ClusterGeom g = cluster_geom(geom);
  const int bad = cycle_check(a, g);
  if (bad) return bad;
  return cluster_launch(g.scratch ? schedule_cycle_kernel<true>
                                  : schedule_cycle_kernel<false>,
                        a, g, (cudaStream_t)stream);
}

extern "C" int schedule_cycle_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(g.scratch ? schedule_cycle_kernel<true>
                                     : schedule_cycle_kernel<false>,
                           g, clusters);
}
