// K14a shard_preempt_local: one preemptor's victim scan over the rows one
// shard owns, reduced to the shard's candidate record, on the shard's own
// device.
//
// Replaces the shard-local half of `sharded_preempt_fn`
// (kubernetes_tpu/parallel/sharding.py:354), where GSPMD keeps the node
// rows, the [N, P] victim planes, `feas_static` and `order_rank` of
// `_preempt_scan_core` (kubernetes_tpu/ops/kernels.py:1598) on each chip:
// per row, `_victim_select` (:1494) with this preemptor's slot mask (slot
// priority below its own) and the reprieve walk; then, instead of
// gathering every row's aggregates for the replicated `_pick_one_node`
// (:1570), the shard reduces them to one record (`shard_candidate`,
// victim.cuh): whether any row is a candidate, its lowest-ranked
// zero-victim row, and the row of lowest rank among those tied at the
// shard's lexicographic minimum of the five criteria, with that row's
// criteria, counts and slot flags. K14b picks among the D records.
//
// Shared with K8: `victim_node`, `store_agg` (victim.cuh); with K13a:
// `shard_candidate`.
//
// Bound on the H100: bytes, as K7 (the seven [rows, P] victim planes and
// eight node rows read once). Design: two launches on the stream (K7's
// before its one-launch redesign): `rows_kernel` one thread per row (256-thread blocks over the shard)
// walks the row's slots in registers and writes its aggregates; then
// `reduce_kernel`, one 1024-thread block, reduces them into the record
// and walks the best row's slots once more for its flags.
#include "victim.cuh"

enum {
  PLI_ROWS, PLI_P, PLI_OFFSET, PLI_N_REAL, PLI_MAX_PRIO, PLI_CR, PLI_HR,
  PLI_REQ_CPU, PLI_REQ_MEM, PLI_REQ_EPH, PLI_COUNT
};
// pointer slots, in the order of `_SPL_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum {
  PLP_ALLOC_CPU, PLP_ALLOC_MEM, PLP_ALLOC_EPH, PLP_ALLOWED, PLP_REQ_CPU,
  PLP_REQ_MEM, PLP_REQ_EPH, PLP_POD_COUNT, PLP_VIC_CPU, PLP_VIC_MEM,
  PLP_VIC_EPH, PLP_VIC_PRIO, PLP_VIC_START, PLP_VIC_VALID,
  PLP_VIC_VIOLATING, PLP_FEAS, PLP_RANK, PLP_AGG_I64, PLP_AGG_F64,
  PLP_AGG_U8, PLP_REC, PLP_COUNT
};

struct LocalPreemptArgs {
  i64 v[PLI_COUNT];
  void* p[PLP_COUNT];
};

__device__ __forceinline__ VictimRows lp_rows(const LocalPreemptArgs& a) {
  VictimRows r;
  r.alloc_cpu = (const i64*)a.p[PLP_ALLOC_CPU];
  r.alloc_mem = (const i64*)a.p[PLP_ALLOC_MEM];
  r.alloc_eph = (const i64*)a.p[PLP_ALLOC_EPH];
  r.allowed = (const i64*)a.p[PLP_ALLOWED];
  r.req_cpu = (const i64*)a.p[PLP_REQ_CPU];
  r.req_mem = (const i64*)a.p[PLP_REQ_MEM];
  r.req_eph = (const i64*)a.p[PLP_REQ_EPH];
  r.pod_count = (const i64*)a.p[PLP_POD_COUNT];
  r.g_cpu = r.g_mem = r.g_eph = r.g_cnt = 0;
  return r;
}

__device__ __forceinline__ VictimPlanes lp_planes(const LocalPreemptArgs& a) {
  VictimPlanes v;
  v.P = (int)a.v[PLI_P];
  v.cpu = (const i64*)a.p[PLP_VIC_CPU];
  v.mem = (const i64*)a.p[PLP_VIC_MEM];
  v.eph = (const i64*)a.p[PLP_VIC_EPH];
  v.prio = (const i64*)a.p[PLP_VIC_PRIO];
  v.start = (const double*)a.p[PLP_VIC_START];
  v.valid = (const unsigned char*)a.p[PLP_VIC_VALID];
  v.viol = (const unsigned char*)a.p[PLP_VIC_VIOLATING];
  return v;
}

__device__ __forceinline__ VictimPod lp_pod(const LocalPreemptArgs& a) {
  VictimPod p;
  p.req_cpu = a.v[PLI_REQ_CPU];
  p.req_mem = a.v[PLI_REQ_MEM];
  p.req_eph = a.v[PLI_REQ_EPH];
  p.max_prio = a.v[PLI_MAX_PRIO];
  p.cr = a.v[PLI_CR] != 0;
  p.hr = a.v[PLI_HR] != 0 && p.cr;
  return p;
}

__device__ __forceinline__ VictimAggPlanes lp_agg(const LocalPreemptArgs& a) {
  VictimAggPlanes g;
  g.i = (i64*)a.p[PLP_AGG_I64];
  g.f = (double*)a.p[PLP_AGG_F64];
  g.u = (unsigned char*)a.p[PLP_AGG_U8];
  return g;
}

// row j is a candidate of the scan: feas_static and in range
__device__ __forceinline__ bool lp_static(const LocalPreemptArgs& a, int j) {
  return ((const unsigned char*)a.p[PLP_FEAS])[j]
         && a.v[PLI_OFFSET] + j < a.v[PLI_N_REAL];
}

__global__ void rows_kernel(LocalPreemptArgs a) {
  const int rows = (int)a.v[PLI_ROWS];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= rows) return;
  store_agg(lp_agg(a), rows, j, victim_node(j, lp_rows(a), lp_planes(a),
                                            lp_pod(a), lp_static(a, j), 0));
}

__global__ void __launch_bounds__(NTHREADS) reduce_kernel(LocalPreemptArgs a) {
  const int rows = (int)a.v[PLI_ROWS];
  const int P = (int)a.v[PLI_P];
  unsigned char* rec = (unsigned char*)a.p[PLP_REC];
  const int best = shard_candidate(lp_agg(a), rows,
                                   (const i64*)a.p[PLP_RANK],
                                   a.v[PLI_OFFSET], rec);
  if (threadIdx.x != 0) return;
  ((i64*)rec)[CR_ANY_RES] = 0;
  int* flags = (int*)(rec + CR_FLAG_BYTES);
  if (best < 0) {
    for (int s = 0; s < P; ++s) flags[s] = 0;
  } else {
    victim_node(best, lp_rows(a), lp_planes(a), lp_pod(a),
                lp_static(a, best), flags);
  }
}

extern "C" int shard_preempt_local_launch(const i64* iargs, void** ptrs,
                                          void* stream) {
  LocalPreemptArgs a;
  for (int i = 0; i < PLI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PLP_COUNT; ++i) a.p[i] = ptrs[i];
  const int rows = (int)a.v[PLI_ROWS];
  const int threads = 256;
  rows_kernel<<<(rows + threads - 1) / threads, threads, 0,
                (cudaStream_t)stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  reduce_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
