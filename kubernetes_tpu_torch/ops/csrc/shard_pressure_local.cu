// K13a shard_pressure_local: the shard-local half of one step of the
// sharded pressure wave, over the rows one shard owns, on the shard's own
// device.
//
// Replaces the per-node part of `sharded_pressure_fn`
// (kubernetes_tpu/parallel/sharding.py:330), where GSPMD keeps the
// mutable rows, the nominated-ghost load and the [N, P] victim planes of
// `_pressure_core` (kubernetes_tpu/ops/kernels.py:1690) on each chip's
// rows. One step is one pod of the wave (skip pods included: every pod
// emits the victim flags of its pick). Per row of the shard:
//   1. the previous step's outcome, when the shard owns its node: the
//      fold of a bind into the rows (`_fold_state`, :549) or of a
//      nomination into the ghost load (the pod's request delta, one pod);
//   2. unless the pod is a skip pod, the cycle's filter with the ghost
//      load added (`_cycle_core`'s ghost, :402-413) and the row-local
//      scores, into K10a's record, and whether the row is in range with a
//      first failure preemption can resolve (`_resolvable_candidates`,
//      :1675);
//   3. on the same rows, before this pod's own fold, the victim walk of
//      `_victim_select` (:1494) with the pod's slot mask (priority below
//      its own), the ghost base and its nine static masks.
// Then one block reduces the rows' aggregates to the shard's candidate
// record (`shard_candidate`, victim.cuh, keyed by the row index: the pick
// by axis order) and ORs the resolvable flags. The step index, the owed
// folds and li / lni live in the step state K13b wrote on this device;
// the pod's fields come from the per-spec tables (row[t]). After the last
// step one more launch only folds.
//
// Shared with K10a/K11a: `local_nodes`, `local_pod`, `local_weights`,
// `local_row`, `local_record`, `local_fold` (shard_scan.cuh); with K8:
// `victim_node`, `pressure_static`, `cycle_unresolvable`; with K14a:
// `shard_candidate`.
//
// Bound on the H100: bytes, as K10a plus the shard's victim planes (the
// seven [rows, P] planes read once a step). Design: two launches on the
// stream, as K7: `rows_kernel` one thread per row (the folds, filter,
// record and victim walk of row j in the thread that owns it, so no
// barrier), then `reduce_kernel`, one 1024-thread block.
#include "shard_scan.cuh"
#include "victim.cuh"

__device__ __forceinline__ CycleGhost lp_ghost(const ScanLocalArgs& a) {
  return CycleGhost{slp<const i64>(a, SLP_GHOST_CPU),
                    slp<const i64>(a, SLP_GHOST_MEM),
                    slp<const i64>(a, SLP_GHOST_EPH),
                    slp<const i64>(a, SLP_GHOST_CNT)};
}

// the rows a victim walk reads: the shard's rows and its ghost load
__device__ __forceinline__ VictimRows lp_rows(const CycleNodes& nd,
                                             const CycleGhost& gh) {
  VictimRows r;
  r.alloc_cpu = nd.alloc_cpu;
  r.alloc_mem = nd.alloc_mem;
  r.alloc_eph = nd.alloc_eph;
  r.allowed = nd.allowed;
  r.req_cpu = nd.req_cpu;
  r.req_mem = nd.req_mem;
  r.req_eph = nd.req_eph;
  r.pod_count = nd.pod_count;
  r.g_cpu = gh.cpu;
  r.g_mem = gh.mem;
  r.g_eph = gh.eph;
  r.g_cnt = gh.cnt;
  return r;
}

__device__ __forceinline__ VictimPlanes lp_planes(const ScanLocalArgs& a) {
  VictimPlanes v;
  v.P = (int)a.v[SLI_VIC_P];
  v.cpu = slp<const i64>(a, SLP_VIC_CPU);
  v.mem = slp<const i64>(a, SLP_VIC_MEM);
  v.eph = slp<const i64>(a, SLP_VIC_EPH);
  v.prio = slp<const i64>(a, SLP_VIC_PRIO);
  v.start = slp<const double>(a, SLP_VIC_START);
  v.valid = slp<const unsigned char>(a, SLP_VIC_VALID);
  v.viol = slp<const unsigned char>(a, SLP_VIC_VIOLATING);
  return v;
}

// pod-table row r as a preemptor: the filter's request, its priority
__device__ __forceinline__ VictimPod lp_pod(const ScanLocalArgs& a, int r) {
  const i64* sc = slp<const i64>(a, SLP_SCAL) + (size_t)r * NSCAL;
  VictimPod p;
  p.req_cpu = sc[0];
  p.req_mem = sc[1];
  p.req_eph = sc[2];
  p.max_prio = slp<const i64>(a, SLP_PPRIO)[r];
  p.cr = sc[6] != 0;
  p.hr = sc[5] != 0 && p.cr;
  return p;
}

// aggregate planes: i64 [4, rows], f64 [rows], u8 [3, rows] (feas0, the
// pick mask, the resolvable flag)
__device__ __forceinline__ VictimAggPlanes lp_agg(const ScanLocalArgs& a) {
  VictimAggPlanes g;
  g.i = slp<i64>(a, SLP_AGG_I64);
  g.f = slp<double>(a, SLP_AGG_F64);
  g.u = slp<unsigned char>(a, SLP_AGG_U8);
  return g;
}

__global__ void rows_kernel(ScanLocalArgs a) {
  __shared__ i64 ws[W_K];
  const i64* st = slp<const i64>(a, SLP_STATE);
  const int rows = (int)a.v[SLI_ROWS];
  const i64 off = a.v[SLI_OFFSET];
  const i64 t = st[SS_NEXT];
  const i64 fold = st[SS_FOLD_SEL] - off, gfold = st[SS_GHOST_SEL] - off;
  const int frow = (int)st[SS_FOLD_ROW];
  const bool live = t < a.v[SLI_N_STEPS];
  const int r = live ? slp<const int>(a, SLP_ROW)[t] : 0;
  const bool run = live
      && slp<const i64>(a, SLP_SCAL)[(size_t)r * NSCAL + SC_SKIP] == 0;
  local_weights(a, t, run, ws);
  const CycleNodes nd = local_nodes(a);
  const CyclePod pd = local_pod(a, r);
  const CycleGhost gh = lp_ghost(a);
  const VictimRows vr = lp_rows(nd, gh);
  const VictimPlanes vp = lp_planes(a);
  const VictimPod vpod = lp_pod(a, r);
  const VictimAggPlanes g = lp_agg(a);
  const i64* fsc = slp<const i64>(a, SLP_SCAL) + (size_t)frow * NSCAL;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < rows;
       j += gridDim.x * blockDim.x) {
    if (j == fold) local_fold(a, frow, j);
    if (j == gfold) {
      slp<i64>(a, SLP_GHOST_CPU)[j] += fsc[SC_UPD_CPU];
      slp<i64>(a, SLP_GHOST_MEM)[j] += fsc[SC_UPD_MEM];
      slp<i64>(a, SLP_GHOST_EPH)[j] += fsc[SC_UPD_EPH];
      slp<i64>(a, SLP_GHOST_CNT)[j] += 1;
    }
    if (!live) continue;
    unsigned char res = 0;
    if (run) {
      i64 bits;
      int ff;
      const bool feasible = cycle_filter_row(nd, pd, false, j, &gh, &bits,
                                             &ff);
      local_record(a, pd, ws, j, local_row(a, j), feasible);
      res = (i64)j < nd.n_real && !cycle_unresolvable(ff, bits);
    }
    g.u[2 * (size_t)rows + j] = res;
    store_agg(g, rows, j, victim_node(j, vr, vp, vpod,
                                      pressure_static(nd, pd, j), 0));
  }
}

__global__ void __launch_bounds__(NTHREADS) reduce_kernel(ScanLocalArgs a) {
  __shared__ i64 sh64[NWARPS];
  const i64* st = slp<const i64>(a, SLP_STATE);
  const i64 t = st[SS_NEXT];
  if (t >= a.v[SLI_N_STEPS]) return;
  const int rows = (int)a.v[SLI_ROWS];
  const int r = slp<const int>(a, SLP_ROW)[t];
  const VictimAggPlanes g = lp_agg(a);
  unsigned char* rec = slp<unsigned char>(a, SLP_REC) + a.v[SLI_CAND_OFF];
  const int best = shard_candidate(g, rows, nullptr, a.v[SLI_OFFSET], rec);
  int lo, hi;
  my_range(rows, &lo, &hi);
  int l_res = 0;
  for (int j = lo; j < hi; ++j) l_res |= g.u[2 * (size_t)rows + j];
  const bool any_res = block_sum64(l_res, sh64) > 0;
  if (threadIdx.x != 0) return;
  ((i64*)rec)[CR_ANY_RES] = any_res;
  int* flags = (int*)(rec + CR_FLAG_BYTES);
  const int P = (int)a.v[SLI_VIC_P];
  if (best < 0) {
    for (int s = 0; s < P; ++s) flags[s] = 0;
  } else {
    const CycleNodes nd = local_nodes(a);
    const CyclePod pd = local_pod(a, r);
    victim_node(best, lp_rows(nd, lp_ghost(a)), lp_planes(a), lp_pod(a, r),
                pressure_static(nd, pd, best), flags);
  }
}

extern "C" int shard_pressure_local_launch(const i64* iargs, void** ptrs,
                                           void* stream) {
  const ScanLocalArgs a = scan_local_args(iargs, ptrs);
  rows_kernel<<<scan_local_blocks(a), LOCAL_THREADS, 0,
                (cudaStream_t)stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  reduce_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
