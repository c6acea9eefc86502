// K14b shard_preempt_select: the replicated pick of the sharded victim
// scan, over the D candidate records K14a wrote in place into this
// device's gathered buffer.
//
// Replaces the replicated epilogue of `sharded_preempt_fn`
// (kubernetes_tpu/parallel/sharding.py:354): `_pick_one_node`
// (kubernetes_tpu/ops/kernels.py:1570) and the packing of
// `_preempt_scan_core` (:1598). A lexicographic minimum decomposes over
// shards, so the pick over the records (`pick_records_warp`, victim.cuh)
// equals the pick over every row: no candidate -> -1; a zero-victim row
// anywhere -> the lowest-ranked one; else the lowest-ranked row among the
// shards tied at the five criteria's minimum. Output: the packed [3+P]
// int32 block of K7 (winner, its victim count, its PDB-violation count,
// its slot flags). Every distinct device runs it on the same bytes.
//
// Bound on the H100: latency (D records of a few hundred bytes). Design:
// one block of PS_THREADS threads. The records of call `round` lie in half
// round & 1 of the buffer. Under the "peer" exchange thread 0 first waits
// for their D stamps (`stamps_wait`, shard_scan.cuh: bounded by the
// global timer, so a lost stamp traps the launch and never hangs the
// stream); a barrier then releases the block. The first warp picks (each
// lane a record, combined by shuffles) and writes the head; the block
// copies the winner's flags. No host read or copy between K14a and K14b.
#include "shard_scan.cuh"
#include "victim.cuh"

// threads of the block: P <= 128 flags, one a thread
constexpr int PS_THREADS = 128;

// scalar slots, in the order of `_SPS_INTS`
// (kubernetes_tpu_torch/ops/kernels.py)
enum { PSI_D, PSI_CHUNK, PSI_P, PSI_ROUND, PSI_STAMP, PSI_COUNT };
// pointer slots, in the order of `_SPS_PTRS`: the buffer's first half,
// this device's [2, D] stamps (NULL: the host copied the records), the
// packed block
enum { PSP_GATHERED, PSP_STAMPS, PSP_OUT, PSP_COUNT };

struct SelectPreemptArgs {
  i64 v[PSI_COUNT];
  void* p[PSP_COUNT];
};

__global__ void __launch_bounds__(PS_THREADS)
    shard_preempt_select_kernel(SelectPreemptArgs a) {
  __shared__ CandPick pk;
  const int D = (int)a.v[PSI_D];
  const size_t chunk = (size_t)a.v[PSI_CHUNK];
  const i64 round = a.v[PSI_ROUND];
  const unsigned char* g = (const unsigned char*)a.p[PSP_GATHERED]
                           + (size_t)(round & 1) * (size_t)D * chunk;
  int* out = (int*)a.p[PSP_OUT];
  if (threadIdx.x == 0 && a.p[PSP_STAMPS])
    stamps_wait((const i64*)a.p[PSP_STAMPS] + (size_t)(round & 1) * D, D,
                a.v[PSI_STAMP]);
  __syncthreads();  // every thread reads the records after the stamps
  if (threadIdx.x < 32) {
    const CandPick p = pick_records_warp(g, chunk, 0, D);
    if (threadIdx.x == 0) {
      pk = p;
      out[0] = wrap32(p.winner);
      out[1] = wrap32(p.nv);
      out[2] = wrap32(p.viol);
    }
  }
  __syncthreads();
  pick_flags(g, chunk, 0, pk, (int)a.v[PSI_P], out + 3);
}

extern "C" int shard_preempt_select_launch(const i64* iargs, void** ptrs,
                                           void* stream) {
  SelectPreemptArgs a;
  for (int i = 0; i < PSI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < PSP_COUNT; ++i) a.p[i] = ptrs[i];
  shard_preempt_select_kernel<<<1, PS_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
