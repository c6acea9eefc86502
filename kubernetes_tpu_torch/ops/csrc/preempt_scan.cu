// K7 preempt_scan: one preemptor's victim scan over every node at once,
// then the node pick, in two launches on one stream.
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
// below the card's operation rate. Design:
//   - `victim_kernel`: ONE thread per node (each node's reprieve loop is
//     independent), 256-thread blocks over the whole grid; the thread
//     keeps the freed (cpu, mem, eph, pods) in registers while it walks
//     its P slots (`victim_node`, victim.cuh) and writes the node's six
//     aggregates to scratch planes. No [n_pad, P] victim plane is written.
//   - `pick_kernel`: one 1024-thread block runs the pick (`pick_block`)
//     over the aggregates, then thread 0 walks the winner's slots once
//     more to emit its flags. The two launches order on the stream; the
//     grid-wide reduction needs no atomics or cooperative launch.
// A thread's P slots lie in one row, so a warp's loads touch 32 rows per
// slot step; L1 serves the following slots of the same lines.
#include "victim.cuh"

enum {
  PI_N_PAD, PI_P, PI_N_REAL, PI_MAX_PRIO, PI_CR, PI_HR, PI_REQ_CPU,
  PI_REQ_MEM, PI_REQ_EPH, PI_COUNT
};
// pointer slots, in the order of `_PREEMPT_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum {
  PP_ALLOC_CPU, PP_ALLOC_MEM, PP_ALLOC_EPH, PP_ALLOWED, PP_REQ_CPU,
  PP_REQ_MEM, PP_REQ_EPH, PP_POD_COUNT, PP_VCPU, PP_VMEM, PP_VEPH, PP_VPRIO,
  PP_VSTART, PP_VVALID, PP_VVIOL, PP_FEAS, PP_RANK, PP_AGG_I64, PP_AGG_F64,
  PP_AGG_U8, PP_OUT, PP_COUNT
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

__device__ __forceinline__ VictimAggPlanes preempt_agg(const PreemptArgs& a) {
  VictimAggPlanes g;
  g.i = (i64*)a.p[PP_AGG_I64];
  g.f = (double*)a.p[PP_AGG_F64];
  g.u = (unsigned char*)a.p[PP_AGG_U8];
  return g;
}

// candidate node j: feas_static and in range
__device__ __forceinline__ bool preempt_static(const PreemptArgs& a, int j) {
  return ((const unsigned char*)a.p[PP_FEAS])[j] && (i64)j < a.v[PI_N_REAL];
}

__global__ void victim_kernel(PreemptArgs a) {
  const int n = (int)a.v[PI_N_PAD];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const VictimAgg agg = victim_node(j, preempt_rows(a), preempt_planes(a),
                                    preempt_pod(a), preempt_static(a, j), 0);
  store_agg(preempt_agg(a), n, j, agg);
}

__global__ void __launch_bounds__(NTHREADS) pick_kernel(PreemptArgs a) {
  const int n = (int)a.v[PI_N_PAD];
  const VictimAggPlanes g = preempt_agg(a);
  const int winner = pick_block(g, n, (const i64*)a.p[PP_RANK]);
  if (threadIdx.x == 0) {
    int* out = (int*)a.p[PP_OUT];
    const int w = winner > 0 ? winner : 0;
    out[0] = winner;
    out[1] = (int)g.i[w];
    out[2] = (int)g.i[n + w];
    victim_node(w, preempt_rows(a), preempt_planes(a), preempt_pod(a),
                preempt_static(a, w), out + 3);
  }
}

extern "C" int preempt_scan_launch(const i64* iargs, void** ptrs,
                                   void* stream) {
  PreemptArgs a;
  for (int i = 0; i < PI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PP_COUNT; ++i) a.p[i] = ptrs[i];
  const int n = (int)a.v[PI_N_PAD];
  const int threads = 256;
  victim_kernel<<<(n + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  pick_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
