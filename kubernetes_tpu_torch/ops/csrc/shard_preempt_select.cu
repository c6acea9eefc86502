// K14b shard_preempt_select: the replicated pick of the sharded victim
// scan, over the D candidate records every shard's K14a wrote, gathered
// onto this device.
//
// Replaces the replicated epilogue of `sharded_preempt_fn`
// (kubernetes_tpu/parallel/sharding.py:354): `_pick_one_node`
// (kubernetes_tpu/ops/kernels.py:1570) and the packing of
// `_preempt_scan_core` (:1598). A lexicographic minimum decomposes over
// shards, so the pick over the records (`pick_records`, victim.cuh) equals
// the pick over every row: no candidate -> -1; a zero-victim row anywhere
// -> the lowest-ranked one; else the lowest-ranked row among the shards
// tied at the five criteria's minimum. Output: the packed [3+P] int32
// block of K7 (winner, its victim count, its PDB-violation count, its slot
// flags). Every distinct device runs it on the same bytes.
//
// Shared with K13b: `pick_records`, `pick_flags`.
//
// Bound on the H100: latency (D records of a few hundred bytes). Design:
// one block of 128 threads; thread 0 walks the records, the block copies
// the winner's flags.
#include "victim.cuh"

enum { PSI_D, PSI_CHUNK, PSI_P, PSI_COUNT };
// pointer slots, in the order of `_SPS_PTRS`
enum { PSP_GATHERED, PSP_OUT, PSP_COUNT };

struct SelectPreemptArgs {
  i64 v[PSI_COUNT];
  void* p[PSP_COUNT];
};

__global__ void select_kernel(SelectPreemptArgs a) {
  __shared__ CandPick pk;
  const unsigned char* g = (const unsigned char*)a.p[PSP_GATHERED];
  const size_t chunk = (size_t)a.v[PSI_CHUNK];
  int* out = (int*)a.p[PSP_OUT];
  if (threadIdx.x == 0) {
    pk = pick_records(g, chunk, 0, (int)a.v[PSI_D]);
    out[0] = wrap32(pk.winner);
    out[1] = wrap32(pk.nv);
    out[2] = wrap32(pk.viol);
  }
  __syncthreads();
  pick_flags(g, chunk, 0, pk, (int)a.v[PSI_P], out + 3);
}

extern "C" int shard_preempt_select_launch(const i64* iargs, void** ptrs,
                                           void* stream) {
  SelectPreemptArgs a;
  for (int i = 0; i < PSI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PSP_COUNT; ++i) a.p[i] = ptrs[i];
  select_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
