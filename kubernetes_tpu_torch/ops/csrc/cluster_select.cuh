// The replicated select of one step of the sharded generic scan (K10b,
// `shard_scan_select.cu`) and of the sharded fused window (K11b,
// `shard_segments_select.cu`) across a thread-block cluster, over the
// records every shard's local kernel wrote, gathered onto this device. The
// sharded cycle's select (K9b, `shard_cycle_select.cu`) stages the
// records K9a wrote in place with the same `select_stage` and runs the
// same cycle, without a step state, after its cycle's stamps.
//
// The step's records are its round's half of the buffer (`SS_ROUND`); a
// select first waits for the stamps every shard's local published with
// them (`stamp_wait`, one thread of block 0), and a cluster barrier then
// releases every block to read them.
//
// Replaces the replicated select of `sharded_scan_fn` (:233) and
// `sharded_segments_fn` (:279) of kubernetes_tpu/parallel/sharding.py:
// `_cycle_core`'s walk, kept-set normalizations, first-index argmax and
// round-robin tie pick over the whole node axis
// (kubernetes_tpu/ops/kernels.py:359), with the step's scalar logic around
// it (`_batch_core` :569, `_segments_core` :785).
//
// Bound on the H100: latency, a chain of reductions and scans over n_pad
// slots; the bytes (the records, ~0.75 MB a step at n_pad 16,384, read
// once from L2) and the integer work are far below it. The one-block
// select this replaces unpacked every record into global planes and ran
// `cycle_select` in ONE block of 1024 threads, 16 slots a thread at n_pad
// 16,384 (0.136 ms a step on an H100). Design:
//   - the node axis is split over the cluster's blocks as in K5: block q
//     owns [q * span, (q + 1) * span) (`select_plan` on the host: no rows,
//     the fewest slots a thread);
//   - each thread copies its slots' fields straight from the gathered
//     buffer (row j - s * rows of shard s's record) into its block's shared
//     memory: the local total, the raw planes of the families that run
//     dense, zone, tracked and the feasible bit. Past what shared memory
//     holds (`resident` 0: n_pad above 49,152 at 16 blocks) the same copy
//     goes to a global staging area of the same planes over the whole axis
//     (`recs`), which the same cycle then reads; a block reads only its own
//     slots there too. Past 180,224 slots (16 blocks) the cycle's per-slot
//     scratch moves to a global workspace as well (`cluster_cycle.cuh`,
//     GS), bound with the step's arguments once a window. Nothing stays
//     resident across launches: the locals fold the rows and rewrite the
//     records;
//   - the cycle is `cluster_cycle<true>`: the records' feasible bits and
//     local totals replace the filter and the K1 / row-local scores; 4
//     cluster rounds in axis order and with positions, 6 with perm;
//   - the step's scalar logic (K10b: the skip runs, li / lni, the fold the
//     shards owe; K11b: the segment checkpoint, the effective skip, the
//     rewind, the gang zone counts gz in every block's shared memory) runs
//     redundantly in every block. Only block 0 writes the packed block,
//     the stats, gz and the step state, and only after a cluster barrier
//     that follows every block's read of them: no block can still be
//     reading the step state while block 0 overwrites it. That barrier
//     also keeps every block's shared memory alive for its peers; the
//     setup needs none, since the cycle reads a peer's shared memory only
//     after a cluster barrier of its own.
// The occupancy query (`<name>_clusters`) sets the kernel's launch
// attributes on a device for every geometry at once; a launch only checks
// the geometry against the layout and enqueues.
#pragma once

#include "cluster_cycle.cuh"
#include "shard_scan.cuh"

// A select's shared-memory layout at geometry g, its records staged in
// shared memory (g.resident) or not, its scratch in shared memory or in the
// step's global workspace (`gscr`: g.scratch) (`cluster_smem_bytes(...,
// records=True)` in kernels.py mirrors it).
__host__ __device__ inline ClusterLayout select_layout(const ClusterGeom& g,
                                                       int z_pad, bool gscr) {
  return cluster_layout(g.npt * NTHREADS, 0, z_pad, false, g.resident != 0,
                        true, false, gscr);
}

__device__ __forceinline__ RecLayout select_rec(const ScanSelectArgs& a) {
  return RecLayout{a.v[SSI_OFF_LOCAL], a.v[SSI_OFF_NA], a.v[SSI_OFF_TT],
                   a.v[SSI_OFF_SC],    a.v[SSI_OFF_IC], a.v[SSI_OFF_ZONE],
                   a.v[SSI_OFF_FEAS],  a.v[SSI_OFF_TRACKED]};
}

// The gathered records a select reads ([D, chunk] bytes, `rows` rows a
// shard, the planes at `o`) and the global staging area for when they are
// not staged in shared memory.
struct SelectRecs {
  const unsigned char* gath;
  size_t chunk;
  int rows;
  RecLayout o;
  unsigned char* staging;
};

// Copy this thread's slots of the records `r` into its block's shared
// planes (g.resident, laid out as `L`) or into the staging area ([RP_N, n]
// int64, then zone [n] int32, tracked [n] and feasible [n] bytes): the
// local total, the raw planes of the families that run dense, zone, tracked
// and the feasible bit, read from row j - s * rows of shard s's record.
// Points `cx` at the staged planes and sets `pd` to them (the inter-pod
// switches are the caller's). No barrier.
__device__ __forceinline__ void select_stage(ClusterCtx& cx,
                                             const ClusterGeom& g,
                                             const ClusterLayout& L,
                                             unsigned char* sm, int n,
                                             i64 n_real, const SelectRecs& r,
                                             CyclePod* pd) {
  const RecLayout& o = r.o;
  const i64 offs[RP_N] = {o.local, o.na, o.tt, o.sc, o.ic};
  // the staged planes: this block's slots in shared memory, or the whole
  // axis in global memory; slot j at [j - lo]
  const bool shared = g.resident != 0;
  const size_t span = shared ? (size_t)cx.span : (size_t)n;
  const int lo = shared ? cx.lo : 0;
  unsigned char* base = shared ? sm + L.rec : r.staging;
  i64* rp = (i64*)base;  // [RP_N, span]
  int* zone = shared ? (int*)(sm + L.zone)
                     : (int*)(base + (size_t)RP_N * 8 * span);
  unsigned char* trk = shared ? base + (size_t)RP_N * 8 * span
                              : (unsigned char*)(zone + span);
  unsigned char* feas = trk + span;
  for (int j = cx.tlo; j < cx.thi; ++j) {
    const int s = j / r.rows, jj = j - s * r.rows, l = j - lo;
    const unsigned char* c = r.gath + (size_t)s * r.chunk;
#pragma unroll
    for (int q = 0; q < RP_N; ++q)
      if (offs[q] >= 0)
        rp[(size_t)q * span + l] = ((const i64*)(c + offs[q]))[jj];
    if (o.zone >= 0) zone[l] = ((const int*)(c + o.zone))[jj];
    if (o.tracked >= 0) trk[l] = c[o.tracked + jj];
    feas[l] = c[o.feas + jj];
  }
  // the staged planes, indexed by global node
  cx.rloc = rp - lo;
  cx.rfeas = feas - lo;
  cx.nd = CycleNodes{};
  cx.nd.n_pad = n;
  cx.nd.n_real = n_real;
  cx.nd.z_pad = cx.z_pad;
  cx.nd.zone_id = o.zone >= 0 ? zone - lo : nullptr;
  *pd = CyclePod{};
#define PLANE(q) (offs[q] >= 0 ? rp + (size_t)(q) * span - lo : nullptr)
  pd->na = PLANE(RP_NA);
  pd->tt = PLANE(RP_TT);
  pd->sc = PLANE(RP_SC);
  pd->ic = PLANE(RP_IC);
#undef PLANE
  pd->tracked = o.tracked >= 0 ? trk - lo : nullptr;
  pd->local_in_base = 1;
}

// This thread's view of the cluster for one select step: the block's
// tables, the step state copied into `sv`, the gang zone counts into `gz`
// (with the gang score), and, once block 0 has seen the step's stamps,
// this thread's slots of the step's half of the gathered records staged
// (`select_stage`); `pd` gets the staged planes of the families that run
// dense. GS: the scratch planes in the global workspace (SSP_WORKSPACE).
// The sharded cycle's select (K9b) has no step state: it waits for its
// cycle's stamps itself, then stages with `select_stage` directly. Ends
// with a block barrier.
template <bool GS>
__device__ __forceinline__ ClusterCtx select_setup(const ScanSelectArgs& a,
                                                   const ClusterGeom& g,
                                                   unsigned char* sm,
                                                   cg::cluster_group& cl,
                                                   CyclePod* pd) {
  const int n = (int)a.v[SSI_N_PAD], z_pad = (int)a.v[SSI_Z_PAD];
  const ClusterLayout L = select_layout(g, z_pad, GS);
  ClusterCtx cx = cluster_view<GS>(g, n, z_pad, L, sm, cl,
                                   a.p[SSP_WORKSPACE]);
  const int tid = threadIdx.x;
  const i64* st = ssp<const i64>(a, SSP_STATE);
  const i64 round = st[SS_ROUND];
  if (cx.rank == 0 && tid == 0 && a.p[SSP_STAMPS]) stamp_wait(a, round);
  cl.sync();  // every block reads the records after the stamps
  if (tid < SS_WORDS) cx.sv[tid] = st[tid];
  const i64* gz = ssp<const i64>(a, SSP_GZ);
  if (gz && a.v[SSI_GANG_SCORE])
    for (int z = tid; z < z_pad; z += NTHREADS) cx.gz[z] = gz[z];
  select_stage(cx, g, L, sm, n, a.v[SSI_N_REAL],
               SelectRecs{select_records(a, round), (size_t)a.v[SSI_CHUNK],
                          (int)a.v[SSI_ROWS], select_rec(a),
                          ssp<unsigned char>(a, SSP_RECS)},
               pd);
  pd->ipa_on = a.v[SSI_IPA_ON] != 0;
  pd->ic_inert = (int)a.v[SSI_IC_INERT];
  pd->tr_inert = (int)a.v[SSI_TR_INERT];
  __syncthreads();
  return cx;
}

// Pod-table row r's one-element inter-pod fields where their plane is
// absent (an inert field broadcasts its spec's element, [U, 1]).
__device__ __forceinline__ void select_pod_row(const ScanSelectArgs& a,
                                               int r, CyclePod* pd) {
  if (!pd->ipa_on) return;
  if (a.v[SSI_OFF_IC] < 0) pd->ic = ssp<const i64>(a, SSP_IC_B) + r;
  if (a.v[SSI_OFF_TRACKED] < 0)
    pd->tracked = ssp<const unsigned char>(a, SSP_TR_B) + r;
}

// The zone of node j, from its shard's record of round `round`.
__device__ __forceinline__ int record_zone(const ScanSelectArgs& a, i64 round,
                                           i64 j) {
  const i64 rows = a.v[SSI_ROWS], s = j / rows;
  const unsigned char* c = select_records(a, round)
                           + (size_t)s * (size_t)a.v[SSI_CHUNK];
  return ((const int*)(c + a.v[SSI_OFF_ZONE]))[j - s * rows];
}

// K10b: write step i's decision into the packed [3B] block (selected, li
// after, lni - lni0) and the stats [5, B] (selected, found, evaluated,
// max_score, lni after). One thread.
__device__ __forceinline__ void scan_write(const ScanSelectArgs& a, i64 i,
                                           const CycleResult& r, i64 lni0) {
  const i64 B = a.v[SSI_B];
  int* packed = ssp<int>(a, SSP_PACKED);
  i64* stats = ssp<i64>(a, SSP_STATS);
  packed[i] = wrap32(r.sel);
  packed[B + i] = wrap32(r.next_li);
  packed[2 * B + i] = wrap32(r.next_lni - lni0);
  stats[i] = r.sel;
  stats[B + i] = r.found;
  stats[2 * B + i] = r.evaluated;
  stats[3 * B + i] = r.max_score;
  stats[4 * B + i] = r.next_lni;
}

// K10b: the skip pods from step i on take their known result
// (`_skip_cycle`: sel -1, li reduced mod n, lni unchanged), written when
// `write`, up to the next live step, which it returns (n_steps when none
// is left). One thread.
__device__ __forceinline__ i64 scan_skip_run(const ScanSelectArgs& a, i64 i,
                                             i64* li, i64 lni, i64 lni0,
                                             bool write) {
  const i64 n_steps = a.v[SSI_N_STEPS];
  const i64 n_safe = imax64(a.v[SSI_N_REAL], 1);
  for (; i < n_steps && scan_skip(a, i); ++i) {
    *li = floormod(*li, n_safe);
    if (write)
      scan_write(a, i, CycleResult{-1, 0, 0, 0, *li, lni, false}, lni0);
  }
  return i;
}

// ---- host side --------------------------------------------------------------
// -1: the plan's shared memory is not the select's layout; -2: the plan
// does not cover the node axis or exceeds the cluster limit; -3: records
// staged in global memory without the staging area; -4: the scratch in
// global memory without its workspace, or beside staged records.
inline int select_check(const ScanSelectArgs& a, const ClusterGeom& g) {
  if ((i64)select_layout(g, (int)a.v[SSI_Z_PAD], g.scratch != 0).bytes
      != g.smem)
    return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[SSI_N_PAD])
    return -2;
  if (!g.resident && !a.p[SSP_RECS]) return -3;
  if (g.scratch && (g.resident || !a.p[SSP_WORKSPACE])) return -4;
  return 0;
}

// One select step: one cluster of g.blocks blocks, on `stream` of
// `device`, running `kernel` (its scratch in shared memory) or `kernel_gs`
// (in the workspace). Adds one to `*launched` if it launched.
template <typename Kernel>
inline int select_launch(Kernel kernel, Kernel kernel_gs, const i64* iargs,
                         void* const* ptrs, const i64* geom, int device,
                         void* stream, int* launched) {
  const ScanSelectArgs a = scan_select_args(iargs, ptrs);
  const ClusterGeom g = cluster_geom(geom);
  const int bad = select_check(a, g);
  if (bad) return bad;
  const DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const int e = cluster_launch(g.scratch ? kernel_gs : kernel, a, g,
                               (cudaStream_t)stream);
  if (e == 0) ++*launched;
  return e;
}
