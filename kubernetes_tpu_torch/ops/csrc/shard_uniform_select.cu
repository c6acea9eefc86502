// K9d shard_uniform_select: the replicated half of one sharded uniform
// pass, over the tie / stay bytes and shard maxima K9c wrote, gathered
// onto this device, on one thread-block cluster.
//
// Replaces the replicated tie-walk epilogue of `_uniform_core`
// (kubernetes_tpu/ops/kernels.py:1097-1320) inside `sharded_uniform_fn`
// (kubernetes_tpu/parallel/sharding.py:151): the global max (the largest
// shard max) and feasible count, the tie set (the tie bits of the shards
// at that max), the tie walk in each rotation order (JAX's
// `searchsorted` / `C_all[oid]`), the lane-0 STAY/ELIM probe, the K
// lanes' nodes, `first_bad`, the duplicate cut `first_dup` (a scatter-min
// on `owner` over the whole lane set, never per shard), the accept cut v,
// the emitted decisions and the pass state the shards fold from. A lane's
// fit and score after one more fold are its node's stay bit. Every
// distinct device runs it on the same bytes; a no-op once the burst is
// done.
//
// Bound on the H100: latency, as K3's pass: n_pad bytes in (plus L x
// n_pad perm entries under rotation), K int32 out. Design: K3's pass
// epilogue (`uniform_pass.cuh`, the same code) on a cluster of up to 16
// blocks x 1024 threads, planned as K3 at R = 0 (`uniform_plan`). Block q
// owns the node slice [q * span, (q + 1) * span):
//   1. every block reads the D shard headers itself (max and F), so each
//      has the global max without a barrier, then stages its slice's bits
//      straight from the gathered records into shared memory (node j is
//      row j - s * rows of shard s = j / rows; a slice may straddle a
//      shard edge): tie = (b & 1) && shard max == mx, stay = (b >> 1) & 1,
//      and lists its ties in node order; one cluster barrier publishes the
//      counts, which give each block's offset in the tie list;
//   2. rotation: each block lists every order's ties among its positions,
//      reading each named node's tie bit from its owner, behind a second
//      barrier;
//   3. block 0's K lanes read their nodes from the owners' lists and
//      their stay bits from the owners' slices (`leaves = !stay[q]`).
// A last cluster barrier keeps every block's shared memory alive for the
// lanes' reads; block 0 writes the pass state after it. Past what shared
// memory holds the lists and bits go to a global workspace (`scratch`).
#include "uniform.cuh"
#include "uniform_pass.cuh"

// scalar slots, in the order of `_SUD_INTS` (kernels.py)
enum {
  UD_N_PAD, UD_ROWS, UD_D, UD_STRIDE, UD_HOFF, UD_B, UD_K, UD_CAP, UD_L,
  UD_N_OID, UD_BAN, UD_COUNT
};
// pointer slots, in the order of `_SUD_PTRS`: the gathered records, the
// rotation, the pass state, the outputs, the scatter-min scratch and the
// workspace (NULL while the lists and bits fit in shared memory)
enum {
  DP_GATHERED, DP_PERM, DP_OID_SEQ, DP_STATE, DP_OUT, DP_LNI_OUT, DP_OWNER,
  DP_WORKSPACE, DP_COUNT
};

struct PassArgs {
  i64 v[UD_COUNT];
  void* p[DP_COUNT];
};

template <bool GS>
__global__ void __launch_bounds__(NTHREADS, 1)
    shard_uniform_select_kernel(PassArgs a, ClusterGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  i64* state = (i64*)a.p[DP_STATE];
  const i64 done = state[ST_DONE];
  // once the burst is done every block leaves here alike, before any
  // cluster barrier
  if (done >= a.v[UD_B]) return;
  cg::cluster_group cl = cg::this_cluster();
  const int n = (int)a.v[UD_N_PAD], rows = (int)a.v[UD_ROWS];
  const int D = (int)a.v[UD_D], K = (int)a.v[UD_K], L = (int)a.v[UD_L];
  const size_t stride = (size_t)a.v[UD_STRIDE];
  const i64 hoff = a.v[UD_HOFF];
  const bool ban = a.v[UD_BAN] != 0, rotate = L > 0;
  const int tid = threadIdx.x;
  const int rank = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int span = g.npt * NTHREADS;
  const int lo = min(rank * span, n), hi = min(lo + span, n);
  const int tlo = min(lo + tid * g.npt, hi), thi = min(tlo + g.npt, hi);
  const UniformLayout U = uniform_layout(span, 0, L, g.resident != 0, GS);
  const UniformPass P = uniform_pass<GS>(
      smem, U, (unsigned char*)a.p[DP_WORKSPACE], n, K, L, ban, span, C,
      rank);
  // the tie and stay bits: the first two byte planes; this block's own
  // slots indexed by global node
  unsigned char *tie_b = P.fl_b, *stay_b = P.fl_b + P.fs;
  const int shift = GS ? 0 : lo;
  unsigned char* tie = tie_b - shift;
  unsigned char* stay = stay_b - shift;
  const unsigned char* gb = (const unsigned char*)a.p[DP_GATHERED];
  auto shard_max = [&](int s) -> int {
    return ((const int*)(gb + (size_t)s * stride + hoff))[0];
  };

  // ---- 1. the global max and F, this slice's bits and ties ----------------
  int mx = INT_MIN, F = 0;
  for (int s = 0; s < D; ++s) {
    mx = max(mx, shard_max(s));
    F += ((const int*)(gb + (size_t)s * stride + hoff))[1];
  }
  int lt = 0;
  if (tlo < thi) {
    int s = tlo / rows, r = tlo - s * rows;
    bool at_max = shard_max(s) == mx;
    for (int j = tlo; j < thi; ++j, ++r) {
      if (r == rows) {
        ++s;
        r = 0;
        at_max = shard_max(s) == mx;
      }
      const unsigned char b = gb[(size_t)s * stride + r];
      const bool t = (b & 1) && at_max;
      tie[j] = t;
      stay[j] = (b >> 1) & 1;
      lt += t;
    }
  }
  int bT;
  int at = block_excl_scan(lt, P.sh32, &bT);
  if (!rotate)
    for (int j = tlo; j < thi; ++j)
      if (tie[j]) P.my_ties[at++] = j;
  if (tid == 0) {
    // every block is at the global max; F counts once, in block 0
    P.rec[0] = mx;
    P.rec[1] = rank == 0 ? F : 0;
    P.rec[2] = bT;
  }
  cl.sync();  // every block's count (and its list) is in
  pass_offsets(cl, P);

  // ---- 2. rotation: each order's ties among this block's positions --------
  if (rotate)
    pass_orders(cl, P, (const int*)a.p[DP_PERM], tlo, thi,
                [&](int q) -> bool {
                  return q >= 0 && q < n && owner_word<GS>(cl, tie_b, span, q);
                });

  // ---- 3. lanes (block 0) --------------------------------------------------
  PassLanes lanes{n, 0, false};
  const i64 lni = state[ST_LNI];
  int* out = (int*)a.p[DP_OUT];
  if (rank == 0) {
    lanes = pass_lanes<GS>(
        cl, P, (int)done, (int)a.v[UD_B], lni, (const int*)a.p[DP_OID_SEQ],
        (int)a.v[UD_N_OID], (int*)a.p[DP_OWNER], [&](int q) -> bool {
          return q >= n || !owner_word<GS>(cl, stay_b, span, q);
        });
    if (tid < K) out[done + tid] = (tid < lanes.v && F > 0) ? lanes.sel : -1;
  }
  // no block exits while a peer may still read its shared memory, and
  // every block has read the pass state
  cl.sync();
  if (rank == 0) {
    // hand the accepted lanes to the shards
    if (tid < K) state[ST_LANES + tid] = lanes.sel;
    if (tid == 0) {
      const int v = lanes.v;
      const i64 lni2 = lni + (F > 1 ? v : 0);
      state[ST_DONE] = done + v;
      state[ST_LNI] = lni2;
      state[ST_PASS] += 1;
      state[ST_VFOLD] = F > 0 ? v : 0;
      out[a.v[UD_CAP]] = (int)(lni2 - state[ST_LNI0]);
      ((i64*)a.p[DP_LNI_OUT])[0] = lni2;
    }
  }
}

// ---- host side -------------------------------------------------------------
// -1: the plan's shared memory is not K3's layout at R = 0; -2: the plan
// does not cover the node axis or exceeds the cluster limit; -3: more
// lanes than block 0 has threads; -4: the lists and bits in global memory
// without their workspace.
inline int pass_check(const PassArgs& a, const ClusterGeom& g) {
  if ((i64)uniform_layout(g.npt * NTHREADS, 0, (int)a.v[UD_L],
                          g.resident != 0, g.scratch != 0).bytes != g.smem)
    return -1;
  if (g.blocks < 1 || g.blocks > CLUSTER_MAX || g.npt < 1
      || (i64)g.blocks * g.npt * NTHREADS < a.v[UD_N_PAD])
    return -2;
  if (a.v[UD_K] < 1 || a.v[UD_K] > UK_MAX) return -3;
  if (g.scratch && !a.p[DP_WORKSPACE]) return -4;
  return 0;
}

inline void (*pass_kernel(const ClusterGeom& g))(PassArgs, ClusterGeom) {
  return g.scratch ? shard_uniform_select_kernel<true>
                   : shard_uniform_select_kernel<false>;
}

// One pass: one cluster of g.blocks blocks, on `stream` of `device`. Adds
// one to `*launched` if it launched.
extern "C" int shard_uniform_select_launch(const i64* iargs, void** ptrs,
                                           const i64* geom, int device,
                                           void* stream, int* launched) {
  PassArgs a;
  for (int i = 0; i < UD_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < DP_COUNT; ++i) a.p[i] = ptrs[i];
  const ClusterGeom g = cluster_geom(geom);
  const int bad = pass_check(a, g);
  if (bad) return bad;
  const DeviceScope on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const int e = cluster_launch(pass_kernel(g), a, g, (cudaStream_t)stream);
  if (e == 0) ++*launched;
  return e;
}

extern "C" int shard_uniform_select_clusters(const i64* geom, int* clusters) {
  const ClusterGeom g = cluster_geom(geom);
  return cluster_occupancy(pass_kernel(g), g, clusters);
}
