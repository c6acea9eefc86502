// K7 preempt_scan: one preemptor's victim scan over every node at once,
// then the node pick, in one launch over the whole card.
//
// Replaces `_victim_select` + `_pick_one_node` + `_preempt_scan_core` ->
// `preemption_scan` (kubernetes_tpu/ops/kernels.py:1494, :1570, :1598,
// :1627): per node, remove every victim slot of priority below the
// preemptor's, check the fit, run the reprieve loop over the P slots in
// the host's sorted order; then the per-node aggregates and the staged
// five-criteria pick with a zero-victim instant win and ties to the lowest
// order_rank; the winner's row packed into [3+P] int32.
//
// Bound on the H100: bytes. The scan reads the seven [n_pad, P] victim
// planes and eight node rows once (about 11 MB at n_pad 16,384 and P 16,
// 88 MB at P 128) and does ~20 integer operations per slot step, far
// below the card's operation rate. Design: ONE grid-wide launch that
// fills the card (`preempt_grid` on the host: the SM count times the
// blocks an SM holds, fewer when the nodes run out), its device code
// `preempt_grid.cuh`'s, shared with K14a:
//   - scan: a warp takes 32 consecutive nodes (a grid stride over such
//     groups), a thread a node. It stages their rows of the five wide
//     planes through shared memory, K7_CS slots at a time, by asynchronous
//     copies (cp.async) that the lanes issue on consecutive elements
//     (coalesced) to slot-major places, all in flight at once; meanwhile
//     each lane loads its own row's valid and violating bytes (16 at a
//     time). Each lane then walks its node's slots (`victim_node`'s
//     arithmetic) from shared memory without a bank conflict. Each plane
//     element is read once from global memory (once a pass past K7_CS
//     slots);
//   - pick: the pick is a lexicographic minimum, which splits over any
//     partition of the rows (`PickRec`: the lowest (rank, row) among the
//     zero-victim candidates, and the candidate at the minimum of (the five
//     criteria, rank, row)). Each lane folds its nodes and keeps its best
//     node's slot flags (P <= 128 bits); the warp combines its lanes by
//     shuffles, the block its warps, and writes one record with the
//     best's flags;
//   - the last block: each block then fences and draws a ticket; the block
//     that draws the last one reads every record past L1, combines them
//     and writes the packed block from the winning record (a zero-victim
//     winner, or none, has no victim: (w, 0, 0, zeros)), then puts the
//     ticket back to 0 for the next launch. No aggregate plane goes to
//     global memory and no row is walked twice.
// A warp a node (`victim_node_warp` for the scan) ran the reprieve chain in
// all 32 lanes and took longer than the two kernels it replaced.
// The ticket and the records are the wrapper's, one of each a device,
// zeroed once when allocated: launches on one stream run in turn, and
// each leaves the ticket at 0.
#include "preempt_grid.cuh"

enum {
  PI_N_PAD, PI_P, PI_N_REAL, PI_MAX_PRIO, PI_CR, PI_HR, PI_REQ_CPU,
  PI_REQ_MEM, PI_REQ_EPH, PI_BLOCKS, PI_COUNT
};
// pointer slots, in the order of `_PREEMPT_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum {
  PP_ALLOC_CPU, PP_ALLOC_MEM, PP_ALLOC_EPH, PP_ALLOWED, PP_REQ_CPU,
  PP_REQ_MEM, PP_REQ_EPH, PP_POD_COUNT, PP_VCPU, PP_VMEM, PP_VEPH, PP_VPRIO,
  PP_VSTART, PP_VVALID, PP_VVIOL, PP_FEAS, PP_RANK, PP_RECORDS, PP_TICKET,
  PP_OUT, PP_COUNT
};

struct PreemptArgs {
  i64 v[PI_COUNT];
  void* p[PP_COUNT];
};

__device__ __forceinline__ VictimRows preempt_rows(const PreemptArgs& a) {
  VictimRows r;
  r.alloc_cpu = (const i64*)a.p[PP_ALLOC_CPU];
  r.alloc_mem = (const i64*)a.p[PP_ALLOC_MEM];
  r.alloc_eph = (const i64*)a.p[PP_ALLOC_EPH];
  r.allowed = (const i64*)a.p[PP_ALLOWED];
  r.req_cpu = (const i64*)a.p[PP_REQ_CPU];
  r.req_mem = (const i64*)a.p[PP_REQ_MEM];
  r.req_eph = (const i64*)a.p[PP_REQ_EPH];
  r.pod_count = (const i64*)a.p[PP_POD_COUNT];
  r.g_cpu = r.g_mem = r.g_eph = r.g_cnt = 0;
  return r;
}

__device__ __forceinline__ VictimPlanes preempt_planes(const PreemptArgs& a) {
  VictimPlanes v;
  v.P = (int)a.v[PI_P];
  v.cpu = (const i64*)a.p[PP_VCPU];
  v.mem = (const i64*)a.p[PP_VMEM];
  v.eph = (const i64*)a.p[PP_VEPH];
  v.prio = (const i64*)a.p[PP_VPRIO];
  v.start = (const double*)a.p[PP_VSTART];
  v.valid = (const unsigned char*)a.p[PP_VVALID];
  v.viol = (const unsigned char*)a.p[PP_VVIOL];
  return v;
}

__device__ __forceinline__ VictimPod preempt_pod(const PreemptArgs& a) {
  VictimPod p;
  p.req_cpu = a.v[PI_REQ_CPU];
  p.req_mem = a.v[PI_REQ_MEM];
  p.req_eph = a.v[PI_REQ_EPH];
  p.max_prio = a.v[PI_MAX_PRIO];
  p.cr = a.v[PI_CR] != 0;
  p.hr = a.v[PI_HR] != 0 && p.cr;
  return p;
}

template <bool FULL>
__global__ void __launch_bounds__(K7_THREADS)
    preempt_scan_kernel(PreemptArgs a) {
  __shared__ K7Shared sh;
  const int G = (int)gridDim.x;
  i64* records = (i64*)a.p[PP_RECORDS];  // [K7_WORDS][G]
  unsigned int* ticket = (unsigned int*)a.p[PP_TICKET];
  if (!k7_scan_block<FULL>(sh, preempt_rows(a), preempt_planes(a),
                           preempt_pod(a), (const unsigned char*)a.p[PP_FEAS],
                           (const i64*)a.p[PP_RANK], (int)a.v[PI_N_PAD],
                           a.v[PI_N_REAL], 0, (int)blockIdx.x, G, records,
                           ticket))
    return;
  // ---- the last block: every record, the pick, the packed block ----------
  const PickRec r = k7_last_pick(sh, records, G);
  int* out = (int*)a.p[PP_OUT];
  if (threadIdx.x == 0) {
    // no candidate, or a zero-victim winner: no victim, (w, 0, 0, zeros)
    if (r.w[PK_ZROW] >= 0) sh.src = -1;
    const bool best = sh.src >= 0;
    out[0] = (int)pick_winner(r);
    out[1] = best ? wrap32((i64)r.crit(3)) : 0;  // its victim count
    out[2] = best ? wrap32((i64)r.crit(0)) : 0;  // and PDB violations
    // the ticket back to 0 for the next launch
    *ticket = 0u;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < (int)a.v[PI_P]; q += K7_THREADS)
    out[3 + q] = k7_flag(sh, q);
}

// -1: a grid of no block; -2: the grid's record array missing; -3: more
// victim slots than a record's flags hold.
extern "C" int preempt_scan_launch(const i64* iargs, void** ptrs,
                                   void* stream) {
  PreemptArgs a;
  for (int i = 0; i < PI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PP_COUNT; ++i) a.p[i] = ptrs[i];
  const int blocks = (int)a.v[PI_BLOCKS];
  if (blocks < 1) return -1;
  if (!a.p[PP_RECORDS] || !a.p[PP_TICKET]) return -2;
  if (a.v[PI_P] < 1 || a.v[PI_P] > K7_PMAX) return -3;
  // the slot loops unroll where every chunk is whole (P 16, 128, ...)
  if (a.v[PI_P] % K7_CS == 0)
    preempt_scan_kernel<true><<<blocks, K7_THREADS, 0,
                                (cudaStream_t)stream>>>(a);
  else
    preempt_scan_kernel<false><<<blocks, K7_THREADS, 0,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The card's SM count and how many K7 blocks an SM holds at once (0: none;
// the fewer of the two instantiations') on the current device.
extern "C" int preempt_scan_occupancy(int* sms, int* per_sm) {
  int dev = 0, full = 0, part = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &full, preempt_scan_kernel<true>, K7_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &part, preempt_scan_kernel<false>, K7_THREADS, 0);
  *per_sm = full < part ? full : part;
  return (int)e;
}
