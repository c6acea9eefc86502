// K8 pressure_batch: schedule-else-preempt a chunk of failed pods in one
// launch.
//
// Replaces `_resolvable_candidates` + `_pressure_core` -> `pressure_batch`
// (kubernetes_tpu/ops/kernels.py:1675, :1690, :1768): a lax.scan over the
// chunk whose step, per pod in queue order, is
//   1. the K2 cycle with the carried nominated-ghost load in the filter
//      (identity walk; the host refuses rotating trees);
//   2. the victim scan of every node (`victim_node`, victim.cuh) on the
//      rows BEFORE this pod's fold, with this pod's slot mask (priority
//      below its own), the ghost, and its static masks;
//   3. the pick by axis index (`pick_block`);
//   4. the fold of a hit into the rows, or the fold of a preemption's
//      request into the ghost load of the winner;
//   5. `any_cand` from the cycle's first failures.
// Every pod, bound and skip ones too, emits the victim flags of row
// max(winner_raw, 0), as JAX does, so the packed block equals the plain
// version's and JAX's outputs bit for bit.
//
// Bound on the H100: the serial chain, as K5. Pod b+1 reads the rows and
// the ghost that pod b folded, so the pods run one after another; each
// pays a K2 cycle (~15 block-wide reductions and scans over n_pad nodes),
// a victim scan of n_pad x P slot steps over the seven victim planes
// (~11 MB at n_pad 16,384 and P 16), and ~10 block reductions for the
// pick. Design: a COOPERATIVE grid of 1024-thread blocks, one per SM,
// all resident for the whole chunk:
//   - block 0 runs the cycle, the pick and the folds, as K5's one block
//     does: the carried rows and ghost are fresh copies folded in place
//     by its thread 0; li and lni live in its registers and come from and
//     go back to a device carry (`carry_in` / `carry_out`), so the chunks
//     of a wave chain on the card with no host round trip;
//   - every block scans a contiguous share of the nodes (~128 at n_pad
//     16,384: one thread per node, whose rows then stay in the SM's L1
//     across the slot steps), between two grid barriers per pod.
// Scanning in block 0 alone was measured at 1.9 ms a pod (the planes of
// 1,024 threads' rows thrash one SM's L1 and every pod re-reads them
// through that SM's port to L2); spread over the grid the scan costs a
// few microseconds and the cycle's reductions bound a pod again.
//
// Output: a [B, 5+P] int32 block, per pod: selected (-1 unless bound),
// winner (-2 bound, -1 no preemption, else the nominated row), any_cand,
// li after the pod, lni after minus lni before (0 or 1), then the slot
// flags.
#include "cycle.cuh"
#include "victim.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

__global__ void __launch_bounds__(NTHREADS)
    pressure_batch_kernel(ScanArgs a) {
  __shared__ i64 ws[W_K];
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0;
  const CycleNodes nd = scan_nodes(a);
  const CycleScratch cs = scan_scratch(a);
  const int n = nd.n_pad;
  const int B = (int)a.v[I_B];
  const int gate = (int)a.v[I_GATE];
  const i64 nr = a.v[I_N_REAL];
  const i64 n_safe = imax64(nr, 1);
  const int* row = cptr<int>(a, P_ROW);
  const i64* scal_tab = cptr<i64>(a, P_SCAL);
  const i64* pprio = cptr<i64>(a, P_PPRIO);
  int* out = mptr<int>(a, P_PACKED);
  CycleGhost ghost;
  ghost.cpu = cptr<i64>(a, P_GHOST_CPU);
  ghost.mem = cptr<i64>(a, P_GHOST_MEM);
  ghost.eph = cptr<i64>(a, P_GHOST_EPH);
  ghost.cnt = cptr<i64>(a, P_GHOST_CNT);
  VictimPlanes vp;
  vp.P = (int)a.v[I_VIC_P];
  vp.cpu = cptr<i64>(a, P_VIC_CPU);
  vp.mem = cptr<i64>(a, P_VIC_MEM);
  vp.eph = cptr<i64>(a, P_VIC_EPH);
  vp.prio = cptr<i64>(a, P_VIC_PRIO);
  vp.start = cptr<double>(a, P_VIC_START);
  vp.valid = cptr<unsigned char>(a, P_VIC_VALID);
  vp.viol = cptr<unsigned char>(a, P_VIC_VIOL);
  VictimRows vr;
  vr.alloc_cpu = nd.alloc_cpu;
  vr.alloc_mem = nd.alloc_mem;
  vr.alloc_eph = nd.alloc_eph;
  vr.allowed = nd.allowed;
  vr.req_cpu = nd.req_cpu;
  vr.req_mem = nd.req_mem;
  vr.req_eph = nd.req_eph;
  vr.pod_count = nd.pod_count;
  vr.g_cpu = ghost.cpu;
  vr.g_mem = ghost.mem;
  vr.g_eph = ghost.eph;
  vr.g_cnt = ghost.cnt;
  VictimAggPlanes g;
  g.i = mptr<i64>(a, P_AGG_I64);
  g.f = mptr<double>(a, P_AGG_F64);
  g.u = mptr<unsigned char>(a, P_AGG_U8);
  const int stride = 5 + vp.P;
  // this block's share of the nodes for the victim scan
  const int share = (n + (int)gridDim.x - 1) / (int)gridDim.x;
  const int s_lo = (int)blockIdx.x * share;
  const int s_hi = min(n, s_lo + share);
  i64 li = cptr<i64>(a, P_CARRY_IN)[0], lni = cptr<i64>(a, P_CARRY_IN)[1];
  for (int b = 0; b < B; ++b) {
    const int r = row[b];
    const i64* sc = scal_tab + (size_t)r * NSCAL;
    const bool skip = sc[SC_SKIP] != 0;
    const CyclePod pd = scan_pod(a, r);
    CycleResult res = CycleResult{-1, 0, 0, 0, floormod(li, n_safe), lni,
                                  false};
    if (lead && !skip) {
      scan_weights(a, b, ws);
      res = cycle_run(nd, pd, false, scan_walk(a, li, lni, b), gate, ws, 0,
                      0, false, cs, &ghost);
    }
    // the previous pod's folds are visible to every block from here
    grid.sync();
    // the victim scan, on the rows before this pod's fold
    VictimPod vpod;
    vpod.req_cpu = sc[0];
    vpod.req_mem = sc[1];
    vpod.req_eph = sc[2];
    vpod.max_prio = pprio[r];
    vpod.cr = sc[6] != 0;
    vpod.hr = sc[5] != 0 && vpod.cr;
    for (int j = s_lo + (int)threadIdx.x; j < s_hi; j += blockDim.x)
      store_agg(g, n, j, victim_node(j, vr, vp, vpod,
                                     pressure_static(nd, pd, j), 0));
    // every node's aggregates are visible to block 0 from here
    grid.sync();
    if (!lead) continue;
    const int winner_raw = pick_block(g, n, 0);
    if (threadIdx.x == 0) {
      const bool hit = res.found > 0;
      const bool preempted = !hit && !skip && winner_raw >= 0;
      const int w = winner_raw > 0 ? winner_raw : 0;
      int* o = out + (size_t)b * stride;
      o[0] = hit ? wrap32(res.sel) : -1;
      o[1] = hit ? -2 : (skip ? -1 : winner_raw);
      o[2] = (res.any_resolvable && !hit && !skip) ? 1 : 0;
      o[3] = wrap32(res.next_li);
      o[4] = wrap32(res.next_lni - lni);
      // the winner's flags: its slots walked once more
      victim_node(w, vr, vp, vpod, pressure_static(nd, pd, w), o + 5);
      if (hit) scan_fold(a, r, res.sel, 1);
      if (preempted) {
        mptr<i64>(a, P_GHOST_CPU)[w] += sc[SC_UPD_CPU];
        mptr<i64>(a, P_GHOST_MEM)[w] += sc[SC_UPD_MEM];
        mptr<i64>(a, P_GHOST_EPH)[w] += sc[SC_UPD_EPH];
        mptr<i64>(a, P_GHOST_CNT)[w] += 1;
      }
    }
    li = res.next_li;
    lni = res.next_lni;
    __syncthreads();  // the folds land before block 0's next cycle
  }
  if (lead && threadIdx.x == 0) {
    mptr<i64>(a, P_CARRY_OUT)[0] = li;
    mptr<i64>(a, P_CARRY_OUT)[1] = lni;
  }
}

// One block per SM at most, and no more blocks than shares of ~128 nodes:
// a cooperative launch needs every block resident at once.
extern "C" int pressure_batch_launch(const i64* iargs, void** ptrs,
                                     void* stream) {
  ScanArgs a = scan_args(iargs, ptrs);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pressure_batch_kernel, NTHREADS, 0);
  if (rc != cudaSuccess) return (int)rc;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n = (int)a.v[I_N_PAD];
  int blocks = (n + 127) / 128;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks < 1) blocks = 1;
  void* args[] = {&a};
  rc = cudaLaunchCooperativeKernel((const void*)pressure_batch_kernel,
                                   dim3(blocks), dim3(NTHREADS), args, 0,
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
