// K2 schedule_cycle: one scheduling cycle of one pod over every node.
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core` ->
// `schedule_cycle` (kubernetes_tpu/ops/kernels.py:296, :157, :359, :509).
// The cycle itself is `cycle_run` (cycle.cuh), shared with the burst scans
// K5 and K6; this kernel runs it once, on the K1 totals computed by the
// launch before it, and writes every per-node output.
//
// Bound on the H100: latency. The bytes are ~150 B per node (14 node
// fields in, five per-node outputs), ~2.5 MB at n_pad 16,384, under 1 us
// at 3.35 TB/s; the work is a chain of whole-axis reductions and scans,
// each of which needs every node before the next can start. Design: ONE
// block of 1024 threads, each owning a contiguous slice of the axis, so a
// reduction or scan is a block barrier, not a launch.
#include "cycle.cuh"

struct CArgs {
  CycleNodes nd;
  CyclePod pd;
  CycleWalk wk;
  CycleScratch cs;
  int gate;
  const i64* w;
  const i64* base;
  i64* out;  // selected found evaluated max_score next_li next_lni
};

__global__ void __launch_bounds__(NTHREADS) schedule_cycle_kernel(CArgs a) {
  const bool skip = a.pd.scal[8] != 0;
  CycleResult r = cycle_run(a.nd, a.pd, skip, a.wk, a.gate, a.w, a.base,
                            0, false, a.cs);
  if (threadIdx.x == 0) {
    a.out[0] = r.sel;
    a.out[1] = r.found;
    a.out[2] = r.evaluated;
    a.out[3] = r.max_score;
    a.out[4] = r.next_li;
    a.out[5] = r.next_lni;
  }
}

extern "C" int schedule_cycle_launch(
    int n_pad, int S, i64 n_real, int z_pad, i64 last_index, i64 lni,
    i64 num_to_find, int mode, int ipa_on, int ic_inert, int tr_inert,
    void** p, const void* scal, const void* req_scalar_p, int gate,
    const void* w, const void* base, const void* perm, const void* inv_perm,
    const void* pos, void* total, void* kept, void* feasible,
    void* fail_first, void* general_bits, void* scratch, void* zs, void* out,
    void* stream) {
  typedef const unsigned char* B;
  typedef const i64* L;
  CArgs a;
  a.nd = CycleNodes{n_pad, S, n_real, z_pad, (B)p[0], (L)p[1], (L)p[2],
                    (L)p[3], (L)p[4], (L)p[5], (L)p[6], (L)p[7], (L)p[8],
                    (L)p[9], (L)p[10], (L)p[11], (L)p[12], (const int*)p[13]};
  a.pd = CyclePod{(L)scal, (L)req_scalar_p,
                  (B)p[14], (B)p[15], (B)p[16], (B)p[17], (B)p[18], (B)p[19],
                  (B)p[20], (B)p[21], (B)p[22], (const signed char*)p[23],
                  (L)p[24], (L)p[25], (L)p[26], (L)p[27], (L)p[28], (L)p[29],
                  (B)p[30], ipa_on, ic_inert, tr_inert};
  a.wk = CycleWalk{last_index, lni, num_to_find, mode, (const int*)perm,
                   (const int*)inv_perm, (const int*)pos};
  a.cs = CycleScratch{(i64*)total, (unsigned char*)kept,
                      (unsigned char*)feasible, (signed char*)fail_first,
                      (i64*)general_bits, (int*)scratch, (i64*)zs};
  a.gate = gate;
  a.w = (L)w;
  a.base = (L)base;
  a.out = (i64*)out;
  schedule_cycle_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
