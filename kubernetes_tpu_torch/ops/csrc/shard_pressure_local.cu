// K13a shard_pressure_local: the shard-local half of one step of the
// sharded pressure wave, over every shard one device holds, in one launch.
//
// Replaces the per-node part of `sharded_pressure_fn`
// (kubernetes_tpu/parallel/sharding.py:330), where GSPMD keeps the
// mutable rows, the nominated-ghost load and the [N, P] victim planes of
// `_pressure_core` (kubernetes_tpu/ops/kernels.py:1690) on each chip's
// rows. One step is one pod of the wave (skip pods included: every pod
// emits the victim flags of its pick). Per row of a shard:
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
// The rows' walks reduce to the shard's candidate record (the fields of
// `shard_candidate`, victim.cuh, keyed by the global row: the pick by
// axis order) and the OR of the resolvable flags. Both records go
// straight into row s of this step's half of the device's gathered
// buffer, where K13b reads them, and of every other card's buffer through
// peer pointers; the shard's last row block publishes the step's stamp on
// every card after both (shard_scan.cuh's exchange). The step index, the owed folds and li / lni live in the step state
// K13b wrote on this device; the pod's fields come from the per-spec
// tables (row[t]). After the last step one more launch only folds.
//
// Shared with K10a/K11a: the grouped launch `scan_local_group_launch`,
// `local_nodes`, `local_pod`, `local_weights`, `local_row`,
// `local_record`, `local_fold` (shard_scan.cuh); with K8: `victim_node`,
// `pressure_static`, `cycle_unresolvable`, the lexicographic pick
// (`vic_add`, `warp_vic`: it equals `shard_candidate`'s staged one).
//
// Bound on the H100: bytes, as K10a plus the shard's victim planes (the
// seven [rows, P] planes read once a step). Design: K10a's launch, a grid
// of (128-thread row blocks, shards) with the shards' argument structs in
// one `__grid_constant__` parameter; the folds, filter, record and victim
// walk of row j in the thread that owns it; each row block reduces its
// rows to a partial record (warp shuffles, one barrier), and the last row
// block of a shard to finish, found by a ticket counter after
// `__threadfence()` (system-wide when records go to peers), combines the
// partials into the shard's record and its first warp walks the best
// row's slots once more for its flags (`victim_node_warp`), copies the
// candidate record to the peers and publishes the stamps.
#include "shard_scan.cuh"
#include "victim.cuh"

// int64 words of a row block's partial record: its candidate, then the OR
// of its resolvable flags. The shard's `partials` hold one a row block,
// then the ticket counter (0 between launches).
constexpr int PARTIAL_WORDS = VB_WORDS + 1;

__device__ __forceinline__ CycleGhost lp_ghost(const ScanLocalArgs& a) {
  return CycleGhost{slp<const i64>(a, SLP_GHOST_CPU),
                    slp<const i64>(a, SLP_GHOST_MEM),
                    slp<const i64>(a, SLP_GHOST_EPH),
                    slp<const i64>(a, SLP_GHOST_CNT)};
}

// the rows a victim walk reads: the shard's rows and its ghost load
__device__ __forceinline__ VictimRows lp_rows(const CycleNodes& nd,
                                             const CycleGhost& gh) {
  return VictimRows{nd.alloc_cpu, nd.alloc_mem, nd.alloc_eph, nd.allowed,
                    nd.req_cpu,   nd.req_mem,   nd.req_eph,   nd.pod_count,
                    gh.cpu,       gh.mem,       gh.eph,       gh.cnt};
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
  return VictimPod{sc[0], sc[1], sc[2], slp<const i64>(a, SLP_PPRIO)[r],
                   sc[6] != 0, sc[5] != 0 && sc[6] != 0};
}

// The shard's candidate record from the best candidate `b` of its rows and
// the OR of their resolvable flags: the head (`CR_*`), the five criteria,
// the best row's slot flags (its slots walked once more), into this step's
// half of the device's buffer. One warp, every lane with the same
// arguments.
__device__ __forceinline__ void write_candidate(const ScanLocalArgs& a,
                                                const VicBest& b, i64 any_res,
                                                int r) {
  unsigned char* rec = local_dest(a, 0, local_half(a)) + a.v[SLI_CAND_OFF];
  i64* h = (i64*)rec;
  double* c = (double*)(rec + CR_CRIT_BYTES);
  int* flags = (int*)(rec + CR_FLAG_BYTES);
  const int P = (int)a.v[SLI_VIC_P];
  const bool best = b.bkey != LLONG_MAX, zero = b.zkey != LLONG_MAX;
  VictimAgg ag{};
  if (best) {
    const int j = (int)(b.bkey - a.v[SLI_OFFSET]);
    const CycleNodes nd = local_nodes(a);
    ag = victim_node_warp(j, lp_rows(nd, lp_ghost(a)), lp_planes(a),
                          lp_pod(a, r),
                          pressure_static(nd, local_pod(a, r), j), flags);
  } else {
    for (int s = threadIdx.x & 31; s < P; s += 32) flags[s] = 0;
  }
  if ((threadIdx.x & 31) != 0) return;
  h[CR_ANY_FEAS] = best;
  h[CR_ANY_ZERO] = zero;
  h[CR_ZKEY] = b.zkey;
  h[CR_ZIDX] = zero ? b.zkey : -1;
  h[CR_BKEY] = b.bkey;
  h[CR_BIDX] = best ? b.bkey : -1;
  h[CR_NV] = best ? ag.nv : 0;
  h[CR_VIOL] = best ? ag.viol_ct : 0;
  h[CR_ANY_RES] = any_res;
  for (int q = 0; q < 5; ++q) c[q] = best ? b.c[q] : 0.0;
}

// The candidate record the warp just wrote, copied into every peer's
// buffer (4-byte words, the lanes striding), then the shard's stamps. One
// warp; a no-op under the host's copies.
__device__ __forceinline__ void candidate_publish(const ScanLocalArgs& a) {
  if (!a.p[SLP_STAMPS]) return;
  const int lane = threadIdx.x & 31;
  const size_t half = local_half(a), off = (size_t)a.v[SLI_CAND_OFF];
  const int words = (CR_FLAG_BYTES + 4 * (int)a.v[SLI_VIC_P]) / 4;
  __syncwarp();  // the lanes' candidate stores are visible to the warp
  const int* src = (const int*)(local_dest(a, 0, half) + off);
  for (int k = 1; k <= (int)a.v[SLI_N_PEERS]; ++k) {
    int* dst = (int*)(local_dest(a, k, half) + off);
    for (int w = lane; w < words; w += 32) dst[w] = src[w];
  }
  local_fence(a);
  __syncwarp();
  if (lane == 0) publish_stamps(a);
}

__global__ void __launch_bounds__(LOCAL_GROUP_THREADS)
    shard_pressure_local_kernel(const __grid_constant__ ScanLocalGroup grp) {
  constexpr int NW = LOCAL_GROUP_THREADS / 32;
  __shared__ i64 ws[W_K];
  __shared__ i64 part_sh[VB_WORDS * NW];
  __shared__ int last;
  const ScanLocalArgs& a = grp.s[blockIdx.y];
  const int rows = (int)a.v[SLI_ROWS];
  const int nblk = (rows + LOCAL_GROUP_THREADS - 1) / LOCAL_GROUP_THREADS;
  if ((int)blockIdx.x >= nblk) return;  // past this shard's rows
  const int j = blockIdx.x * LOCAL_GROUP_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const bool mine = j < rows;
  const i64 off = a.v[SLI_OFFSET];
  const i64* st = slp<const i64>(a, SLP_STATE);
  const i64 t = st[SS_NEXT];
  const i64 fold = st[SS_FOLD_SEL] - off, gfold = st[SS_GHOST_SEL] - off;
  const int frow = (int)st[SS_FOLD_ROW];
  const bool live = t < a.v[SLI_N_STEPS];
  const int r = live ? slp<const int>(a, SLP_ROW)[t] : 0;
  const bool run = live
      && slp<const i64>(a, SLP_SCAL)[(size_t)r * NSCAL + SC_SKIP] == 0;
  local_weights(a, t, run, ws);
  if (mine && j == fold) local_fold(a, frow, j);
  if (mine && j == gfold) {
    const i64* fsc = slp<const i64>(a, SLP_SCAL) + (size_t)frow * NSCAL;
    slp<i64>(a, SLP_GHOST_CPU)[j] += fsc[SC_UPD_CPU];
    slp<i64>(a, SLP_GHOST_MEM)[j] += fsc[SC_UPD_MEM];
    slp<i64>(a, SLP_GHOST_EPH)[j] += fsc[SC_UPD_EPH];
    slp<i64>(a, SLP_GHOST_CNT)[j] += 1;
  }
  if (!live) return;  // the fold past the wave: the same in every block
  const CycleNodes nd = local_nodes(a);
  const CyclePod pd = local_pod(a, r);
  VicBest vb = vic_none();
  int res = 0;
  if (mine) {
    const CycleGhost gh = lp_ghost(a);
    if (run) {
      i64 bits;
      int ff;
      const bool feasible = cycle_filter_row(nd, pd, false, j, &gh, &bits,
                                             &ff);
      local_record(a, pd, ws, j, local_row(a, j), feasible);
      res = (i64)j < nd.n_real && !cycle_unresolvable(ff, bits);
      // the row's record lands before the ticket that leads to its stamp
      local_fence(a);
    }
    vic_add(vb, victim_node(j, lp_rows(nd, gh), lp_planes(a), lp_pod(a, r),
                            pressure_static(nd, pd, j), nullptr),
            off + j);
  }
  // this row block's partial record
  vb = warp_vic(vb);
  if (lane == 0) vic_store(part_sh + wid, vb, NW);
  const int any_res = __syncthreads_or(res);
  i64* part = slp<i64>(a, SLP_PARTIALS);
  unsigned long long* ticket =
      (unsigned long long*)(part + (size_t)nblk * PARTIAL_WORDS);
  if (wid == 0) {
    const VicBest b = warp_vic(lane < NW ? vic_load(part_sh + lane, NW)
                                         : vic_none());
    if (lane == 0) {
      i64* p = part + (size_t)blockIdx.x * PARTIAL_WORDS;
      vic_store(p, b, 1);
      p[VB_WORDS] = any_res;
      // the partial (and, with peers, every card's copy of this block's
      // records) is visible before the ticket
      if (a.v[SLI_N_PEERS]) __threadfence_system();
      else __threadfence();
      last = atomicAdd(ticket, 1ull) == (unsigned long long)(nblk - 1);
    }
  }
  __syncthreads();
  if (!last || wid != 0) return;
  // the shard's last row block: every partial is visible from here
  __threadfence();
  VicBest b = vic_none();
  int any = 0;
  for (int k = lane; k < nblk; k += 32) {
    i64 w[PARTIAL_WORDS];
    for (int q = 0; q < PARTIAL_WORDS; ++q)
      w[q] = __ldcg(part + (size_t)k * PARTIAL_WORDS + q);
    b = vic_comb(b, vic_load(w, 1));
    any |= w[VB_WORDS] != 0;
  }
  b = warp_vic(b);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) *ticket = 0;  // for the next step's launch
  write_candidate(a, b, any, r);
  candidate_publish(a);
}

extern "C" int shard_pressure_local_launch(const i64* words, int n,
                                           int device, void* stream,
                                           int* launched) {
  return scan_local_group_launch(shard_pressure_local_kernel, words, n,
                                 device, stream, launched);
}
