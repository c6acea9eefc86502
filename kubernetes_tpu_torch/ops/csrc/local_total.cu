// K1 local_total: the four row-local resource priorities of every node.
//
// Replaces `_local_total` (kubernetes_tpu/ops/kernels.py:110), which XLA
// inlined into every cycle and burst program. Here the same formulas are a
// __device__ function (common.cuh, `local_total_one`) that every cycle and
// burst kernel calls inline per node (K2, K3, K5-K11, K13a; K3 and K9c for
// their pass-start scores too), so no path launches this kernel. It stays
// as K1's public entry over a whole [N] node axis (`kernels.local_total`)
// and as the check of `local_total_one` against `local_total_plain`.
//
// Bound on the H100: bytes. Per node it reads four int64 (the two request
// vectors and the two allocatable vectors) and writes one int64: 40 B/node,
// 655 KB at n_pad 16,384, 0.2 us at 3.35 TB/s. The int64 divisions cost
// more issue slots than the memory but stay far below the launch overhead
// at this size. Design: one thread per node, grid-stride, the weight row
// staged in shared memory.
#include "common.cuh"

__global__ void local_total_kernel(int n, const i64* req_cpu,
                                   const i64* req_mem, i64 add_cpu,
                                   i64 add_mem, const i64* alloc_cpu,
                                   const i64* alloc_mem, int gate,
                                   const i64* w, i64* out) {
  __shared__ i64 ws[W_K];
  if (threadIdx.x < W_K) ws[threadIdx.x] = w[threadIdx.x];
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = local_total_one(gate, ws, req_cpu[i] + add_cpu,
                             req_mem[i] + add_mem, alloc_cpu[i],
                             alloc_mem[i]);
}

extern "C" int local_total_launch(int n, const void* req_cpu,
                                  const void* req_mem, i64 add_cpu,
                                  i64 add_mem, const void* alloc_cpu,
                                  const void* alloc_mem, int gate,
                                  const void* w, void* out, void* stream) {
  const int threads = 256;
  int blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  local_total_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      n, (const i64*)req_cpu, (const i64*)req_mem, add_cpu, add_mem,
      (const i64*)alloc_cpu, (const i64*)alloc_mem, gate, (const i64*)w,
      (i64*)out);
  return (int)cudaGetLastError();
}
