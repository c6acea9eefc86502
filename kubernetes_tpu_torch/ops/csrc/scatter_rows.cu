// K4 scatter_rows: write the generation-dirty rows of every field of a
// resident table (the node matrix, the victim planes) on one device, from
// one staged buffer, in one launch over every shard the device holds.
//
// Replaces `_scatter_rows` (kubernetes_tpu/core/tpu_scheduler.py:158), the
// jitted `dev[k].at[rows].set(v)` over the table's fields. A shard's row
// list is padded to a power of two by repeating its first row with the
// same values, so duplicate writes carry identical bytes and their order
// does not matter. Index rules are JAX's: a negative row wraps once, and a
// row still outside [0, n) is dropped.
//
// Bound on the H100: bytes, and at the sizes the paths send (16 rows x 14
// fields, about 2 KB; a victim plane's rows of 16 or 128 slots) the
// launch itself and what the host does around it. Design:
//   - the host packs the call into one buffer (`kernels.ScatterLayout`):
//     for each shard with a dirty row, its padded row list (int32), then
//     each field's rows in field order, every segment 16-B aligned; one
//     HtoD copy brings it to the device;
//   - the field table (`FT_*`: destination, rows, row bytes, copy unit) is
//     the device's, built once per resident table (`kernels.ScatterTable`),
//     so a call uploads no table; the call's shards (their first table
//     row, padded row count and segment) ride in the kernel's parameter;
//   - a grid of (row chunks, fields, shards): a block finds its field's
//     source offset from the shard's row count, once; a thread copies one
//     unit of a row (16, 8, 4, 2 or 1 bytes, the widest the row's bytes and
//     the destination allow), so consecutive threads cover consecutive
//     bytes of a row and a warp covers 512 B of a wide victim-plane row.
#include "common.cuh"

// a row of the device field table
enum { FT_DST, FT_ROWS, FT_ROW_BYTES, FT_UNIT, FT_WORDS };
// shards one launch covers at most (`SCATTER_MAX_SHARDS` in
// kubernetes_tpu_torch/ops/kernels.py)
constexpr int SCATTER_MAX_SHARDS = 16;
constexpr int SCATTER_THREADS = 256;

// one shard of a call: its first row of the field table, its padded row
// count, and the byte offset of its segment in the staged buffer
struct ScatterPart {
  i64 entry, bucket, base;
};

struct ScatterCall {
  i64 n_fields, n_parts, blocks;
  ScatterPart p[SCATTER_MAX_SHARDS];
};
// host words of a call: its three counts, then three words a shard
constexpr int SCATTER_HEAD = 3;

__device__ __forceinline__ i64 align16(i64 n) { return (n + 15) & ~(i64)15; }

template <typename T>
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src) {
  *(T*)dst = *(const T*)src;
}

__global__ void __launch_bounds__(SCATTER_THREADS)
    scatter_rows_kernel(const __grid_constant__ ScatterCall c,
                        const i64* table, const unsigned char* staged) {
  const ScatterPart& part = c.p[blockIdx.z];
  const int f = blockIdx.y;
  const i64* ft = table + (size_t)(part.entry + f) * FT_WORDS;
  const i64 n = ft[FT_ROWS], row_bytes = ft[FT_ROW_BYTES], unit = ft[FT_UNIT];
  unsigned char* dst = (unsigned char*)ft[FT_DST];
  // the field's rows follow the row list and the fields before it
  i64 off = part.base + align16(4 * part.bucket);
  for (int g = 0; g < f; ++g)
    off += align16(part.bucket
                   * table[(size_t)(part.entry + g) * FT_WORDS
                           + FT_ROW_BYTES]);
  const int* rows = (const int*)(staged + part.base);
  const unsigned char* src = staged + off;
  const i64 per_row = row_bytes / unit, total = part.bucket * per_row;
  for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (i64)gridDim.x * blockDim.x) {
    const i64 r = t / per_row, k = t - r * per_row;
    i64 row = rows[r];
    if (row < 0) row += n;  // JAX wraps a negative index once
    if (row < 0 || row >= n) continue;
    unsigned char* d = dst + row * row_bytes + k * unit;
    const unsigned char* s = src + r * row_bytes + k * unit;
    switch ((int)unit) {
      case 16: copy_unit<int4>(d, s); break;
      case 8: copy_unit<i64>(d, s); break;
      case 4: copy_unit<int>(d, s); break;
      case 2: copy_unit<short>(d, s); break;
      default: *d = *s; break;
    }
  }
}

// One K4 call: `words` (host) holds the call (SCATTER_HEAD counts, then
// each shard's entry, bucket and base), `table` the device's field table,
// `staged` the call's staged buffer on the device. -1: no shard, more than
// SCATTER_MAX_SHARDS, or no field.
extern "C" int scatter_rows_launch(const i64* words, const void* table,
                                   const void* staged, void* stream) {
  ScatterCall c;
  c.n_fields = words[0];
  c.n_parts = words[1];
  c.blocks = words[2];
  if (c.n_parts < 1 || c.n_parts > SCATTER_MAX_SHARDS || c.n_fields < 1
      || c.blocks < 1)
    return -1;
  for (int k = 0; k < SCATTER_MAX_SHARDS; ++k) {
    // slots past the call's shards repeat the first; no block reads them
    const i64* w = words + SCATTER_HEAD + 3 * (k < c.n_parts ? k : 0);
    c.p[k] = ScatterPart{w[0], w[1], w[2]};
  }
  const dim3 grid((unsigned)c.blocks, (unsigned)c.n_fields,
                  (unsigned)c.n_parts);
  scatter_rows_kernel<<<grid, SCATTER_THREADS, 0, (cudaStream_t)stream>>>(
      c, (const i64*)table, (const unsigned char*)staged);
  return (int)cudaGetLastError();
}
