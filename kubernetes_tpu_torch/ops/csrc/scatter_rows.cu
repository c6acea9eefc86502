// K4 scatter_rows: write the generation-dirty rows of every node field into
// the resident node matrix, all fields in one launch.
//
// Replaces `_scatter_rows` (kubernetes_tpu/core/tpu_scheduler.py:158), the
// jitted `dev[k].at[rows].set(v)` over the 14 node fields. Row lists are
// padded to a power of two by repeating row 0 with the same values, so
// duplicate writes carry identical bytes and their order does not matter.
// Index rules are JAX's: a negative row wraps once, and a row still outside
// [0, n) is dropped.
//
// Bound on the H100: bytes, and at the sizes the serial path sends (16 rows
// x 14 fields, about 2 KB) the launch itself. One thread per (field, row,
// element); a field's destination, source, row count, width and element
// size come from a small int64 table `meta` on the device.
#include "common.cuh"

__global__ void scatter_rows_kernel(int n_fields, int n_rows, i64 total,
                                    const int* rows, const i64* meta) {
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    i64 rem = t;
    int f = 0;
    for (; f < n_fields; ++f) {
      i64 cnt = (i64)n_rows * meta[f * 5 + 3];
      if (rem < cnt) break;
      rem -= cnt;
    }
    const i64* m = meta + f * 5;
    i64 width = m[3];
    i64 r = rem / width, k = rem % width;
    i64 row = rows[r];
    if (row < 0) row += m[2];  // JAX wraps a negative index once
    if (row < 0 || row >= m[2]) continue;
    i64 di = row * width + k, si = r * width + k;
    switch ((int)m[4]) {
      case 1: ((char*)m[0])[di] = ((const char*)m[1])[si]; break;
      case 2: ((short*)m[0])[di] = ((const short*)m[1])[si]; break;
      case 4: ((int*)m[0])[di] = ((const int*)m[1])[si]; break;
      default: ((i64*)m[0])[di] = ((const i64*)m[1])[si]; break;
    }
  }
}

extern "C" int scatter_rows_launch(int n_fields, int n_rows, i64 total,
                                   const void* rows, const void* meta,
                                   void* stream) {
  const int threads = 256;
  i64 blocks = (total + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  scatter_rows_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      n_fields, n_rows, total, (const int*)rows, (const i64*)meta);
  return (int)cudaGetLastError();
}
