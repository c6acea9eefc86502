// Shared device code of the port's kernels: JAX's integer semantics, the
// row-local resource scores (K1, `local_total_one`), and single-block
// reduction/scan helpers.
//
// Numeric contract (kubernetes_tpu/ops/kernels.py): int64 resource math,
// float64 only for balanced allocation / selector spread / inter-pod
// min-max, and floor division as JAX `//` (C `/` truncates toward zero).
// Float ops go through the _rn intrinsics so nvcc cannot contract a
// multiply and an add into one fused op: XLA and PyTorch round each.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;

#define NTHREADS 1024
#define NWARPS (NTHREADS / 32)

__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  i64 q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ i64 floormod(i64 a, i64 b) {
  i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// int64 -> int32 as JAX's astype(int32): keep the low 32 bits
__device__ __forceinline__ int wrap32(i64 x) {
  return (int)(unsigned int)(unsigned long long)x;
}

__device__ __forceinline__ i64 imax64(i64 a, i64 b) { return a > b ? a : b; }
__device__ __forceinline__ i64 imin64(i64 a, i64 b) { return a < b ? a : b; }

// PRIORITY_AXIS column order of the weight row
enum {
  W_SPREAD = 0, W_INTERPOD, W_LEAST, W_MOST, W_RTCR, W_BALANCED, W_AVOID,
  W_NODEAFF, W_TAINT, W_IMAGE, W_GANG, W_K
};
#define ON(gate, f) ((((gate) >> (f)) & 1) != 0)

constexpr i64 MAX_PRIORITY = 10;

__device__ __forceinline__ i64 least_one(i64 req, i64 cap) {
  return (cap > 0 && req <= cap)
             ? floordiv((cap - req) * MAX_PRIORITY, imax64(cap, 1)) : 0;
}

__device__ __forceinline__ i64 most_one(i64 req, i64 cap) {
  return (cap > 0 && req <= cap)
             ? floordiv(req * MAX_PRIORITY, imax64(cap, 1)) : 0;
}

// RequestedToCapacityRatio, default shape {0->10, 100->0}
__device__ __forceinline__ i64 rtcr_one(i64 req, i64 cap) {
  i64 p = (cap == 0 || req > cap)
              ? 100 : 100 - floordiv((cap - req) * 100, imax64(cap, 1));
  return 10 - floordiv(10 * p, 100);
}

// K1: LeastRequested + MostRequested + RTCR + BalancedAllocation of one
// node, weighted by the row `w` for the families `gate` turns on
// (`_local_total`, kubernetes_tpu/ops/kernels.py:110).
__device__ __forceinline__ i64 local_total_one(int gate, const i64* w,
                                               i64 req_cpu, i64 req_mem,
                                               i64 alloc_cpu, i64 alloc_mem) {
  i64 total = 0;
  if (ON(gate, W_LEAST))
    total += w[W_LEAST] * floordiv(least_one(req_cpu, alloc_cpu)
                                   + least_one(req_mem, alloc_mem), 2);
  if (ON(gate, W_MOST))
    total += w[W_MOST] * floordiv(most_one(req_cpu, alloc_cpu)
                                  + most_one(req_mem, alloc_mem), 2);
  if (ON(gate, W_RTCR))
    total += w[W_RTCR] * floordiv(rtcr_one(req_cpu, alloc_cpu)
                                  + rtcr_one(req_mem, alloc_mem), 2);
  if (ON(gate, W_BALANCED)) {
    double cf = alloc_cpu == 0
                    ? 1.0 : __ddiv_rn((double)req_cpu, (double)alloc_cpu);
    double mf = alloc_mem == 0
                    ? 1.0 : __ddiv_rn((double)req_mem, (double)alloc_mem);
    i64 bal = (cf >= 1.0 || mf >= 1.0)
                  ? 0
                  : (i64)__dmul_rn(__dsub_rn(1.0, fabs(__dsub_rn(cf, mf))),
                                   (double)MAX_PRIORITY);
    total += w[W_BALANCED] * bal;
  }
  return total;
}

// ---- single-block helpers (blockDim.x == NTHREADS) -------------------------
// Each returns the block-wide result to every thread. `sh` holds NWARPS
// entries; the leading barrier protects its reuse between calls.
__device__ __forceinline__ i64 block_max64(i64 v, i64* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = imax64(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  i64 r = sh[0];
  for (int i = 1; i < NWARPS; ++i) r = imax64(r, sh[i]);
  return r;
}

__device__ __forceinline__ i64 block_min64(i64 v, i64* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = imin64(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  i64 r = sh[0];
  for (int i = 1; i < NWARPS; ++i) r = imin64(r, sh[i]);
  return r;
}

__device__ __forceinline__ i64 block_sum64(i64 v, i64* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  i64 r = 0;
  for (int i = 0; i < NWARPS; ++i) r += sh[i];
  return r;
}

// Exclusive prefix sum of one int per thread, in thread order; `*total`
// gets the block sum.
__device__ __forceinline__ int block_excl_scan(int v, int* sh, int* total) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  int off = 0, tot = 0;
  for (int i = 0; i < NWARPS; ++i) {
    int s = sh[i];
    if (i < wid) off += s;
    tot += s;
  }
  *total = tot;
  return off + x - v;
}

// The contiguous slice [lo, hi) of [0, n) that this thread owns.
__device__ __forceinline__ void my_range(int n, int* lo, int* hi) {
  int chunk = (n + NTHREADS - 1) / NTHREADS;
  int a = threadIdx.x * chunk;
  *lo = a < n ? a : n;
  *hi = a + chunk < n ? a + chunk : n;
}
