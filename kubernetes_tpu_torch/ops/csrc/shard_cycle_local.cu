// K9a shard_cycle_local: the shard-local half of the sharded cycle, over
// the rows one shard owns, on the shard's own device.
//
// Replaces the per-node phases of `sharded_cycle_fn`
// (kubernetes_tpu/parallel/sharding.py:115), which GSPMD keeps on each
// chip's rows: `_feasibility` (kubernetes_tpu/ops/kernels.py:296) and the
// row-local families of `_fit_scores` (:157). Per row it writes the
// feasible bit, the first failing predicate and the general bits (the
// host's FitError decode reads them), and a record for the all-gather:
// the row-local total (K1's four resource families, image locality,
// prefer-avoid), the raw inputs of the families normalized over the kept
// set (node affinity, taint toleration, selector spread with the zone,
// inter-pod counts and the tracked bit, each only when it runs dense) and
// the in-range feasible bit. The families that need the global kept set
// are finished after the gather by K9b, never per shard.
//
// Shared with K2/K5/K6/K8: `cycle_filter_row` and `cycle_row_local`
// (cycle.cuh), `local_total_one` (common.cuh).
//
// Bound on the H100: bytes. It reads the shard's 14 node fields and the
// pod's dense per-node fields once (~150 B a row) and writes ~20 B a row.
// Design: one thread per row, 256-thread blocks over the shard; no row
// reads another, so there is no reduction and no barrier.
#include "cycle.cuh"

enum {
  CL_ROWS, CL_S, CL_OFFSET, CL_N_REAL, CL_GATE, CL_OFF_LOCAL, CL_OFF_NA,
  CL_OFF_TT, CL_OFF_SC, CL_OFF_IC, CL_OFF_ZONE, CL_OFF_FEAS, CL_OFF_TRACKED,
  CL_COUNT
};
// pointer slots, in the order of `_SCL_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum {
  LP_VALID, LP_ALLOC_CPU, LP_ALLOC_MEM, LP_ALLOC_EPH, LP_ALLOWED, LP_REQ_CPU,
  LP_REQ_MEM, LP_REQ_EPH, LP_NZ_CPU, LP_NZ_MEM, LP_POD_COUNT,
  LP_ALLOC_SCALAR, LP_REQ_SCALAR, LP_ZONE_ID, LP_SCAL, LP_REQ_SCALAR_P,
  LP_SEL_OK, LP_TAINTS_OK, LP_UNSCHED_OK, LP_PORTS_OK, LP_HOST_OK,
  LP_DISK_OK, LP_MAXVOL_OK, LP_VOLBIND_OK, LP_VOLZONE_OK, LP_IPA_CODE,
  LP_NA, LP_TT, LP_SC, LP_IC, LP_IMG, LP_PA, LP_TRACKED, LP_W, LP_FEASIBLE,
  LP_FAIL_FIRST, LP_GENERAL_BITS, LP_REC, LP_COUNT
};

struct LocalArgs {
  i64 v[CL_COUNT];
  void* p[LP_COUNT];
};

__global__ void shard_cycle_local_kernel(LocalArgs a) {
  typedef const unsigned char* B;
  typedef const i64* L;
  __shared__ i64 ws[W_K];
  if (threadIdx.x < W_K) ws[threadIdx.x] = ((L)a.p[LP_W])[threadIdx.x];
  __syncthreads();
  const int rows = (int)a.v[CL_ROWS];
  // n_real counted from this shard's first row: row j is in range iff
  // offset + j < n_real
  const CycleNodes nd{rows, (int)a.v[CL_S], a.v[CL_N_REAL] - a.v[CL_OFFSET],
                      0, (B)a.p[LP_VALID], (L)a.p[LP_ALLOC_CPU],
                      (L)a.p[LP_ALLOC_MEM], (L)a.p[LP_ALLOC_EPH],
                      (L)a.p[LP_ALLOWED], (L)a.p[LP_REQ_CPU],
                      (L)a.p[LP_REQ_MEM], (L)a.p[LP_REQ_EPH],
                      (L)a.p[LP_NZ_CPU], (L)a.p[LP_NZ_MEM],
                      (L)a.p[LP_POD_COUNT], (L)a.p[LP_ALLOC_SCALAR],
                      (L)a.p[LP_REQ_SCALAR], (const int*)a.p[LP_ZONE_ID]};
  const CyclePod pd{(L)a.p[LP_SCAL], (L)a.p[LP_REQ_SCALAR_P],
                    (B)a.p[LP_SEL_OK], (B)a.p[LP_TAINTS_OK],
                    (B)a.p[LP_UNSCHED_OK], (B)a.p[LP_PORTS_OK],
                    (B)a.p[LP_HOST_OK], (B)a.p[LP_DISK_OK],
                    (B)a.p[LP_MAXVOL_OK], (B)a.p[LP_VOLBIND_OK],
                    (B)a.p[LP_VOLZONE_OK], (const signed char*)a.p[LP_IPA_CODE],
                    (L)a.p[LP_NA], (L)a.p[LP_TT], (L)a.p[LP_SC], (L)a.p[LP_IC],
                    (L)a.p[LP_IMG], (L)a.p[LP_PA], (B)a.p[LP_TRACKED], 0, 0, 0,
                    0};
  const bool skip = pd.scal[8] != 0;
  const int gate = (int)a.v[CL_GATE];
  unsigned char* rec = (unsigned char*)a.p[LP_REC];
  const i64 o_na = a.v[CL_OFF_NA], o_tt = a.v[CL_OFF_TT],
            o_sc = a.v[CL_OFF_SC], o_ic = a.v[CL_OFF_IC],
            o_zone = a.v[CL_OFF_ZONE], o_tr = a.v[CL_OFF_TRACKED];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < rows;
       j += gridDim.x * blockDim.x) {
    i64 bits;
    int ff;
    const bool feasible = cycle_filter_row(nd, pd, skip, j, nullptr, &bits,
                                           &ff);
    ((i64*)a.p[LP_GENERAL_BITS])[j] = bits;
    ((signed char*)a.p[LP_FAIL_FIRST])[j] = (signed char)ff;
    ((unsigned char*)a.p[LP_FEASIBLE])[j] = feasible;
    const i64 local = local_total_one(gate, ws, pd.scal[3] + nd.nz_cpu[j],
                                      pd.scal[4] + nd.nz_mem[j],
                                      nd.alloc_cpu[j], nd.alloc_mem[j])
                      + cycle_row_local(pd, gate, ws, j);
    ((i64*)(rec + a.v[CL_OFF_LOCAL]))[j] = local;
    if (o_na >= 0) ((i64*)(rec + o_na))[j] = pd.na[j];
    if (o_tt >= 0) ((i64*)(rec + o_tt))[j] = pd.tt[j];
    if (o_sc >= 0) ((i64*)(rec + o_sc))[j] = pd.sc[j];
    if (o_ic >= 0) ((i64*)(rec + o_ic))[j] = pd.ic[j];
    if (o_zone >= 0) ((int*)(rec + o_zone))[j] = nd.zone_id[j];
    rec[a.v[CL_OFF_FEAS] + j] = feasible && (i64)j < nd.n_real;
    if (o_tr >= 0) rec[o_tr + j] = pd.tracked[j];
  }
}

extern "C" int shard_cycle_local_launch(const i64* iargs, void** ptrs,
                                        void* stream) {
  LocalArgs a;
  for (int i = 0; i < CL_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < LP_COUNT; ++i) a.p[i] = ptrs[i];
  const int rows = (int)a.v[CL_ROWS];
  const int threads = 256;
  int blocks = (rows + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  shard_cycle_local_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
