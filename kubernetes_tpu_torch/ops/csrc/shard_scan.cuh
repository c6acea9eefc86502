// The step of the sharded generic scan (K10) and of the sharded fused
// window (K11), as __device__ code shared by their four kernels:
//   K10a shard_scan_local, K11a shard_segments_local: the shard-local half;
//   K10b shard_scan_select, K11b shard_segments_select: the replicated half.
// The sharded pressure wave (K13a shard_pressure_local, K13b
// shard_pressure_select) takes the same argument tables (its extra slots
// NULL / 0 for K10 and K11), the grouped launch, the local helpers and
// the cluster select.
//
// Replaces `sharded_scan_fn` (:233) and `sharded_segments_fn` (:279) of
// kubernetes_tpu/parallel/sharding.py, where GSPMD runs `_batch_core`
// (kubernetes_tpu/ops/kernels.py:569) and `_segments_core` (:785) with the
// carried rows, the spread vector and the gang checkpoint pinned to the
// node sharding and the select epilogue replicated. Here one step of the
// scan is three things the host enqueues, with the same arguments every
// step (no host read between steps):
//   1. the local kernel: fold the previous step's winner into the shard's
//      rows when the shard owns it (`_fold_state`, :549, and +1 on the
//      carried spread); K11a then restores the segment checkpoint after a
//      gang failure and takes one at a segment start; then K9a's filter
//      and row-local scores of the step's pod over the shard's rows, into
//      K9a's record (K13a: the shard's candidate record too). K10a, K11a
//      and K13a run ONE launch a device over every shard it holds, each
//      shard's record written straight into row s of the device's
//      gathered buffer;
//   2. the exchange of the records. Each local writes its shard's record
//      into row s of every distinct device's buffer, its own by a plain
//      store and the other cards' through peer pointers over NVLink, then
//      publishes a stamp (below); the select waits for the D stamps of
//      its step on its own device. A host without peer access between
//      its cards copies the rows of other devices' shards in instead
//      (parallel/sharding.py `gather_in_place`), and no stamp is read;
//   3. the select on every distinct device: the walk, kept-set scores and
//      pick of the step's cycle (`cluster_cycle` across a thread-block
//      cluster, `cluster_select.cuh`), the skip pods' known result
//      (`_skip_cycle`), li / lni,
//      and for K11b the segment state (gang checkpoint, effective skip,
//      rewind, gang zone counts); it writes the decision into the packed
//      block and the step state the locals read next.
// After the last step the host launches the local kernel once more: it
// only folds the last winner (and, K11a, takes back a last rewind).
//
// The step state ([SS_WORDS] int64) lives on every distinct device and is
// written by that device's select only; the locals on that device read it.
//
// The exchange. The gathered buffer has two halves, [2, D, record bytes]:
// step i writes and reads half i & 1 (i is the step state's `SS_ROUND`, the
// steps the select has taken). So no local can overwrite a record a
// select on another card still reads: local(i + 2) on card c runs after
// select(i + 1) on c, which waited for local(i + 1) on every card c',
// which ran after select(i) on c'. After its record a shard's last row
// block publishes a stamp, stamp_base + i + 1, at [i & 1, s] of the [2, D]
// int64 stamps of every distinct device, with a system-scope release after
// every row block's records are fenced; the select's first thread spins
// on its own device's D stamps with a system-scope acquire, bounded by the
// global timer (`stamp_wait`: a lost stamp traps the launch, it never
// hangs the stream). The stamps count up over the mesh's life (each window
// reserves its values) and are never reset.
// Pod fields come from device-resident per-spec tables (row[b] picks a
// pod's spec, profile_id[b] its weight-table row): a step takes no host
// argument.
#pragma once

#include "cycle.cuh"

// step state slots (`SS_*` in kubernetes_tpu_torch/ops/kernels.py)
enum {
  SS_STEP,      // the first step whose decision is not yet written
  SS_NEXT,      // the step the next local launch computes (K10: a live
                // step, the skip pods before it already decided)
  SS_LI, SS_LNI, SS_LNI0,
  SS_FOLD_SEL,  // the node the next local launch folds (-1: none)
  SS_FOLD_ROW,  // its pod-table row
  SS_REWIND,    // K11: restore the segment checkpoint first
  SS_T,         // K11: enumerations consumed
  SS_CHK_T, SS_CHK_LI, SS_CHK_LNI, SS_FAILED,  // K11: the checkpoint
  SS_GHOST_SEL,  // K13: the node whose ghost load takes the fold (-1: none)
  SS_COUNT
};
// the exchange round after the step state proper: the steps this window's
// selects have taken on the device (written by the select only)
constexpr int SS_ROUND = SS_COUNT;
constexpr int SS_WORDS = SS_COUNT + 1;
static_assert(SS_WORDS <= 16, "a select's shared copy holds 16 words");
// the other cards a local writes its records to, at most (an 8-card host)
constexpr int MAX_PEERS = 7;

// ---- the local kernels (K10a, K11a, K13a) ---------------------------------
// scalar slots, in the order of `_SSL_INTS`
enum {
  SLI_ROWS, SLI_S, SLI_OFFSET, SLI_N_REAL, SLI_GATE, SLI_N_STEPS, SLI_P,
  SLI_CARRY_SPREAD, SLI_OFF_LOCAL, SLI_OFF_NA, SLI_OFF_TT, SLI_OFF_SC,
  SLI_OFF_IC, SLI_OFF_ZONE, SLI_OFF_FEAS, SLI_OFF_TRACKED, SLI_VIC_P,
  SLI_CAND_OFF,
  // the exchange: the shard's index, the mesh's shards, the bytes between
  // the buffer's halves, the window's first stamp, the peers written to
  SLI_INDEX, SLI_D, SLI_HALF, SLI_STAMP_BASE, SLI_N_PEERS,
  SLI_COUNT
};
// pointer slots, in the order of `_SSL_PTRS`
enum {
  SLP_VALID, SLP_ALLOC_CPU, SLP_ALLOC_MEM, SLP_ALLOC_EPH, SLP_ALLOWED,
  SLP_REQ_CPU, SLP_REQ_MEM, SLP_REQ_EPH, SLP_NZ_CPU, SLP_NZ_MEM,
  SLP_POD_COUNT, SLP_ALLOC_SCALAR, SLP_REQ_SCALAR, SLP_ZONE_ID, SLP_SPREAD,
  SLP_CHK_REQ_CPU, SLP_CHK_REQ_MEM, SLP_CHK_REQ_EPH, SLP_CHK_REQ_SCALAR,
  SLP_CHK_NZ_CPU, SLP_CHK_NZ_MEM, SLP_CHK_POD_COUNT, SLP_CHK_SPREAD,
  SLP_SCAL, SLP_REQ_SCALAR_P, SLP_UPD_SCALAR_P, SLP_SEL_OK, SLP_TAINTS_OK,
  SLP_UNSCHED_OK, SLP_PORTS_OK, SLP_HOST_OK, SLP_DISK_OK, SLP_MAXVOL_OK,
  SLP_VOLBIND_OK, SLP_VOLZONE_OK, SLP_IPA_CODE, SLP_NA, SLP_TT, SLP_SC,
  SLP_IC, SLP_IMG, SLP_PA, SLP_TRACKED, SLP_ROW, SLP_PROFILE_ID, SLP_W,
  SLP_WTAB, SLP_STATE, SLP_SEG_START, SLP_GANG, SLP_REC,
  // the exchange (NULL under the host's copies): this device's stamps,
  // the K10a / K11a launch's ticket, then row s of each peer's buffer
  // (first half) and each peer's stamps
  SLP_STAMPS, SLP_TICKET, SLP_PEER_REC0, SLP_PEER_REC1, SLP_PEER_REC2,
  SLP_PEER_REC3, SLP_PEER_REC4, SLP_PEER_REC5, SLP_PEER_REC6,
  SLP_PEER_STAMPS0, SLP_PEER_STAMPS1, SLP_PEER_STAMPS2, SLP_PEER_STAMPS3,
  SLP_PEER_STAMPS4, SLP_PEER_STAMPS5, SLP_PEER_STAMPS6,
  // the pressure wave (K13a) only; NULL for K10a and K11a
  SLP_GHOST_CPU, SLP_GHOST_MEM, SLP_GHOST_EPH, SLP_GHOST_CNT, SLP_VIC_CPU,
  SLP_VIC_MEM, SLP_VIC_EPH, SLP_VIC_PRIO, SLP_VIC_START, SLP_VIC_VALID,
  SLP_VIC_VIOLATING, SLP_PPRIO, SLP_PARTIALS,
  SLP_COUNT
};

struct ScanLocalArgs {
  i64 v[SLI_COUNT];
  void* p[SLP_COUNT];
};

template <typename T>
__device__ __forceinline__ T* slp(const ScanLocalArgs& a, int slot) {
  return (T*)a.p[slot];
}

// The shard's node rows as the cycle reads them, n_real counted from the
// shard's first row.
__device__ __forceinline__ CycleNodes local_nodes(const ScanLocalArgs& a) {
  typedef const i64* L;
  return CycleNodes{(int)a.v[SLI_ROWS], (int)a.v[SLI_S],
                    a.v[SLI_N_REAL] - a.v[SLI_OFFSET], 0,
                    (const unsigned char*)a.p[SLP_VALID],
                    (L)a.p[SLP_ALLOC_CPU], (L)a.p[SLP_ALLOC_MEM],
                    (L)a.p[SLP_ALLOC_EPH], (L)a.p[SLP_ALLOWED],
                    (L)a.p[SLP_REQ_CPU], (L)a.p[SLP_REQ_MEM],
                    (L)a.p[SLP_REQ_EPH], (L)a.p[SLP_NZ_CPU],
                    (L)a.p[SLP_NZ_MEM], (L)a.p[SLP_POD_COUNT],
                    (L)a.p[SLP_ALLOC_SCALAR], (L)a.p[SLP_REQ_SCALAR],
                    (const int*)a.p[SLP_ZONE_ID]};
}

// Row r of the shard's per-spec tables ([U, rows] when dense, NULL when
// inert in this window), as one pod's inputs.
__device__ __forceinline__ CyclePod local_pod(const ScanLocalArgs& a, int r) {
  const size_t off = (size_t)r * (size_t)a.v[SLI_ROWS];
#define ROW(T, slot) (a.p[slot] ? (const T*)a.p[slot] + off : (const T*)0)
  return CyclePod{slp<const i64>(a, SLP_SCAL) + (size_t)r * NSCAL,
                  slp<const i64>(a, SLP_REQ_SCALAR_P) + (size_t)r * a.v[SLI_S],
                  ROW(unsigned char, SLP_SEL_OK),
                  ROW(unsigned char, SLP_TAINTS_OK),
                  ROW(unsigned char, SLP_UNSCHED_OK),
                  ROW(unsigned char, SLP_PORTS_OK),
                  ROW(unsigned char, SLP_HOST_OK),
                  ROW(unsigned char, SLP_DISK_OK),
                  ROW(unsigned char, SLP_MAXVOL_OK),
                  ROW(unsigned char, SLP_VOLBIND_OK),
                  ROW(unsigned char, SLP_VOLZONE_OK),
                  ROW(signed char, SLP_IPA_CODE), ROW(i64, SLP_NA),
                  ROW(i64, SLP_TT), ROW(i64, SLP_SC), ROW(i64, SLP_IC),
                  ROW(i64, SLP_IMG), ROW(i64, SLP_PA),
                  ROW(unsigned char, SLP_TRACKED), 0, 0, 0, 0};
#undef ROW
}

// Stage the weight row of step t's pod into `ws` (its wtab row in tensor
// mode) when `run`; ends with a barrier.
__device__ __forceinline__ void local_weights(const ScanLocalArgs& a, i64 t,
                                              bool run, i64* ws) {
  if (run && threadIdx.x < W_K) {
    const i64* w = slp<const i64>(a, SLP_W);
    if (a.p[SLP_WTAB])
      w = slp<const i64>(a, SLP_WTAB)
          + clamp_index(slp<const i64>(a, SLP_PROFILE_ID)[t], a.v[SLI_P])
                * W_K;
    ws[threadIdx.x] = w[threadIdx.x];
  }
  __syncthreads();
}

// The node fields of row j that a local step reads, and the seven that the
// fold and the checkpoint change (`spread` 0 when the scan carries none).
// K10a / K11a hold them in registers: they do not depend on the step, so
// the launch loads them before the chain of dependent loads that finds the
// step's pod (step state -> pod row -> its scalars and weight row).
struct LocalRow {
  i64 req_cpu, req_mem, req_eph, nz_cpu, nz_mem, pod_count, spread;
  i64 alloc_cpu, alloc_mem, alloc_eph, allowed;
  int zone;
  bool valid;
};

__device__ __forceinline__ LocalRow local_row(const ScanLocalArgs& a, int j) {
  LocalRow v;
  v.req_cpu = slp<const i64>(a, SLP_REQ_CPU)[j];
  v.req_mem = slp<const i64>(a, SLP_REQ_MEM)[j];
  v.req_eph = slp<const i64>(a, SLP_REQ_EPH)[j];
  v.nz_cpu = slp<const i64>(a, SLP_NZ_CPU)[j];
  v.nz_mem = slp<const i64>(a, SLP_NZ_MEM)[j];
  v.pod_count = slp<const i64>(a, SLP_POD_COUNT)[j];
  v.spread = a.p[SLP_SPREAD] ? slp<const i64>(a, SLP_SPREAD)[j] : 0;
  v.alloc_cpu = slp<const i64>(a, SLP_ALLOC_CPU)[j];
  v.alloc_mem = slp<const i64>(a, SLP_ALLOC_MEM)[j];
  v.alloc_eph = slp<const i64>(a, SLP_ALLOC_EPH)[j];
  v.allowed = slp<const i64>(a, SLP_ALLOWED)[j];
  v.zone = slp<const int>(a, SLP_ZONE_ID)[j];
  v.valid = slp<const unsigned char>(a, SLP_VALID)[j] != 0;
  return v;
}

// Row j's seven live fields from `v` into the rows (`chk` false) or into
// the checkpoint (`chk` true); the spread only when the scan carries it.
__device__ __forceinline__ void local_row_put(const ScanLocalArgs& a, int j,
                                              const LocalRow& v, bool chk) {
  const i64 vals[7] = {v.req_cpu, v.req_mem,   v.req_eph, v.nz_cpu,
                       v.nz_mem,  v.pod_count, v.spread};
  const int live_slots[7] = {SLP_REQ_CPU, SLP_REQ_MEM, SLP_REQ_EPH,
                             SLP_NZ_CPU,  SLP_NZ_MEM,  SLP_POD_COUNT,
                             SLP_SPREAD};
  const int chk_slots[7] = {SLP_CHK_REQ_CPU, SLP_CHK_REQ_MEM,
                            SLP_CHK_REQ_EPH, SLP_CHK_NZ_CPU,
                            SLP_CHK_NZ_MEM,  SLP_CHK_POD_COUNT,
                            SLP_CHK_SPREAD};
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    if (!a.p[live_slots[q]]) continue;  // no carried spread
    slp<i64>(a, chk ? chk_slots[q] : live_slots[q])[j] = vals[q];
  }
}

// Row j's S scalar requests copied into the checkpoint (save) or back.
__device__ __forceinline__ void local_scalar_copy(const ScanLocalArgs& a,
                                                  int j, bool save) {
  const int S = (int)a.v[SLI_S];
  i64* live = slp<i64>(a, SLP_REQ_SCALAR) + (size_t)j * S;
  i64* chk = slp<i64>(a, SLP_CHK_REQ_SCALAR) + (size_t)j * S;
  for (int s = 0; s < S; ++s) {
    if (save) chk[s] = live[s];
    else live[s] = chk[s];
  }
}

// Pod-table row r's fold into row j (`_fold_state`), +1 on the carried
// spread: the live fields in `v`, the scalar requests in memory.
__device__ __forceinline__ void local_fold_row(const ScanLocalArgs& a, int r,
                                               int j, LocalRow& v) {
  const i64* sc = slp<const i64>(a, SLP_SCAL) + (size_t)r * NSCAL;
  const int S = (int)a.v[SLI_S];
  v.req_cpu += sc[SC_UPD_CPU];
  v.req_mem += sc[SC_UPD_MEM];
  v.req_eph += sc[SC_UPD_EPH];
  v.nz_cpu += sc[3];
  v.nz_mem += sc[4];
  v.pod_count += 1;
  if (a.v[SLI_CARRY_SPREAD]) v.spread += 1;
  const i64* upd = slp<const i64>(a, SLP_UPD_SCALAR_P) + (size_t)r * S;
  i64* req = slp<i64>(a, SLP_REQ_SCALAR) + (size_t)j * S;
  for (int s = 0; s < S; ++s) req[s] += upd[s];
}

// The same fold read from the rows and written back to them (K13a).
__device__ __forceinline__ void local_fold(const ScanLocalArgs& a, int r,
                                           int j) {
  LocalRow v = local_row(a, j);
  local_fold_row(a, r, j, v);
  local_row_put(a, j, v, false);
}

// Row j's live fields taken back from the checkpoint (a gang rewind).
__device__ __forceinline__ void local_row_restore(const ScanLocalArgs& a,
                                                  int j, LocalRow& v) {
  v.req_cpu = slp<const i64>(a, SLP_CHK_REQ_CPU)[j];
  v.req_mem = slp<const i64>(a, SLP_CHK_REQ_MEM)[j];
  v.req_eph = slp<const i64>(a, SLP_CHK_REQ_EPH)[j];
  v.nz_cpu = slp<const i64>(a, SLP_CHK_NZ_CPU)[j];
  v.nz_mem = slp<const i64>(a, SLP_CHK_NZ_MEM)[j];
  v.pod_count = slp<const i64>(a, SLP_CHK_POD_COUNT)[j];
  if (a.p[SLP_SPREAD]) v.spread = slp<const i64>(a, SLP_CHK_SPREAD)[j];
  local_scalar_copy(a, j, false);
}

// ---- the exchange -----------------------------------------------------------
__device__ __forceinline__ void st_release_sys(i64* p, i64 v) {
  asm volatile("st.release.sys.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ i64 ld_acquire_sys(const i64* p) {
  i64 v;
  asm volatile("ld.acquire.sys.global.b64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The byte offset of this step's half of the gathered buffer.
__device__ __forceinline__ size_t local_half(const ScanLocalArgs& a) {
  return (size_t)(slp<const i64>(a, SLP_STATE)[SS_ROUND] & 1)
         * (size_t)a.v[SLI_HALF];
}

// Row s of this step's half on destination k: 0 this device, then peers.
__device__ __forceinline__ unsigned char* local_dest(const ScanLocalArgs& a,
                                                     int k, size_t half) {
  return (unsigned char*)a.p[k == 0 ? SLP_REC : SLP_PEER_REC0 + k - 1]
         + half;
}

// Make this thread's record stores visible to every card before the
// stamp, when the records go to peers. On one card the select that reads
// them follows on the same stream, after this kernel: no fence is needed.
__device__ __forceinline__ void local_fence(const ScanLocalArgs& a) {
  if (a.v[SLI_N_PEERS]) __threadfence_system();
}

// Stamp value v at `slot` of this device's stamps `own` and of the
// n_peers peers' (`peer_stamps[k]`): system-scope releases, after a
// system-wide fence when records went to peers. One thread.
__device__ __forceinline__ void stamps_publish(i64* own,
                                               void* const* peer_stamps,
                                               int n_peers, size_t slot,
                                               i64 v) {
  if (n_peers) __threadfence_system();
  st_release_sys(own + slot, v);
  for (int k = 0; k < n_peers; ++k)
    st_release_sys((i64*)peer_stamps[k] + slot, v);
}

// The shard's stamp of this step, stamp_base + round + 1 at [round & 1, s]
// of this device's stamps and every peer's: a system-scope release, after
// the records it covers were fenced. One thread.
__device__ __forceinline__ void publish_stamps(const ScanLocalArgs& a) {
  const i64 round = slp<const i64>(a, SLP_STATE)[SS_ROUND];
  const size_t slot = (size_t)(round & 1) * (size_t)a.v[SLI_D]
                      + (size_t)a.v[SLI_INDEX];
  stamps_publish(slp<i64>(a, SLP_STAMPS), a.p + SLP_PEER_STAMPS0,
                 (int)a.v[SLI_N_PEERS], slot,
                 a.v[SLI_STAMP_BASE] + round + 1);
}

// K10a / K11a: every thread of a row block calls it after its record
// stores. The last of the shard's `nblk` row blocks to get here (a ticket
// counter, reset for the next step) publishes the shard's stamps. No-op
// under the host's copies (no stamps).
__device__ __forceinline__ void local_publish(const ScanLocalArgs& a,
                                              int nblk) {
  if (!a.p[SLP_STAMPS]) return;
  local_fence(a);
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* ticket = slp<unsigned long long>(a, SLP_TICKET);
  local_fence(a);
  if (atomicAdd(ticket, 1ull) != (unsigned long long)(nblk - 1)) return;
  *ticket = 0;  // for the next step's launch
  publish_stamps(a);
}

// Row j's part of K9a's record, computed once.
struct RecRow {
  i64 local, na, tt, sc, ic;
  int zone;
  unsigned char feas, tracked;
};

// Row j's part of K9a's record into the record `rec`.
__device__ __forceinline__ void record_put(const ScanLocalArgs& a,
                                           unsigned char* rec, int j,
                                           const RecRow& r) {
  const i64 o_na = a.v[SLI_OFF_NA], o_tt = a.v[SLI_OFF_TT],
            o_sc = a.v[SLI_OFF_SC], o_ic = a.v[SLI_OFF_IC],
            o_zone = a.v[SLI_OFF_ZONE], o_tr = a.v[SLI_OFF_TRACKED];
  ((i64*)(rec + a.v[SLI_OFF_LOCAL]))[j] = r.local;
  if (o_na >= 0) ((i64*)(rec + o_na))[j] = r.na;
  if (o_tt >= 0) ((i64*)(rec + o_tt))[j] = r.tt;
  if (o_sc >= 0) ((i64*)(rec + o_sc))[j] = r.sc;
  if (o_ic >= 0) ((i64*)(rec + o_ic))[j] = r.ic;
  if (o_zone >= 0) ((int*)(rec + o_zone))[j] = r.zone;
  rec[a.v[SLI_OFF_FEAS] + j] = r.feas;
  if (o_tr >= 0) rec[o_tr + j] = r.tracked;
}

// Row j's part of K9a's record: the row-local total and the raw planes
// the select normalizes (the `sc` plane is the carried spread when the
// scan carries one), and the in-range feasible bit; the node fields from
// `v`. Written into this step's half of this device's buffer and of every
// peer's.
__device__ __forceinline__ void local_record(const ScanLocalArgs& a,
                                             const CyclePod& pd,
                                             const i64* ws, int j,
                                             const LocalRow& v,
                                             bool feasible) {
  const int gate = (int)a.v[SLI_GATE];
  RecRow r;
  r.local = local_total_one(gate, ws, pd.scal[3] + v.nz_cpu,
                            pd.scal[4] + v.nz_mem, v.alloc_cpu, v.alloc_mem)
            + cycle_row_local(pd, gate, ws, j);
  r.na = a.v[SLI_OFF_NA] >= 0 ? pd.na[j] : 0;
  r.tt = a.v[SLI_OFF_TT] >= 0 ? pd.tt[j] : 0;
  r.sc = a.v[SLI_OFF_SC] < 0 ? 0 : a.v[SLI_CARRY_SPREAD] ? v.spread
                                                          : pd.sc[j];
  r.ic = a.v[SLI_OFF_IC] >= 0 ? pd.ic[j] : 0;
  r.zone = v.zone;
  r.feas = feasible && (i64)j < a.v[SLI_N_REAL] - a.v[SLI_OFFSET];
  r.tracked = a.v[SLI_OFF_TRACKED] >= 0 ? pd.tracked[j] : 0;
  const size_t half = local_half(a);
  for (int k = 0; k <= (int)a.v[SLI_N_PEERS]; ++k)
    record_put(a, local_dest(a, k, half), j, r);
}

// The local step of K10a (SEG false) and K11a (SEG true) on row j of one
// shard, one thread a row. Row j's node fields are loaded first; the fold,
// the restore and the checkpoint of row j happen in registers, in the
// thread that then filters row j, so the step needs no barrier past the
// weight row. Every thread of the block calls it (the weight row's
// barrier); a thread past the shard's rows only takes part in that.
template <bool SEG>
__device__ __forceinline__ void scan_local_row(const ScanLocalArgs& a,
                                               int j) {
  __shared__ i64 ws[W_K];
  const bool mine = j < (int)a.v[SLI_ROWS];
  LocalRow v{};
  if (mine) v = local_row(a, j);
  const i64* st = slp<const i64>(a, SLP_STATE);
  const i64 t = st[SS_NEXT];
  const i64 fold = st[SS_FOLD_SEL] - a.v[SLI_OFFSET];
  const int frow = (int)st[SS_FOLD_ROW];
  const bool live = t < a.v[SLI_N_STEPS];
  const bool rewind = SEG && st[SS_REWIND] != 0;
  const bool save = SEG && live && slp<const unsigned char>(
                                       a, SLP_SEG_START)[t] != 0;
  const int r = live ? slp<const int>(a, SLP_ROW)[t] : 0;
  bool run = live
      && slp<const i64>(a, SLP_SCAL)[(size_t)r * NSCAL + SC_SKIP] == 0;
  // a member behind its gang's failure (the failure flag resets at a
  // segment start): its record is not read
  if (SEG && run && slp<const unsigned char>(a, SLP_GANG)[t] != 0 && !save
      && st[SS_FAILED] != 0)
    run = false;
  local_weights(a, t, run, ws);
  if (!mine) return;
  bool moved = false;
  if (j == fold) {
    local_fold_row(a, frow, j, v);
    moved = true;
  }
  if (rewind) {
    local_row_restore(a, j, v);
    moved = true;
  }
  if (moved) local_row_put(a, j, v, false);
  if (save) {
    local_row_put(a, j, v, true);
    local_scalar_copy(a, j, true);
  }
  if (!run) return;
  const CycleNodes nd = local_nodes(a);
  const CyclePod pd = local_pod(a, r);
  const CycleRowRes rr{v.req_cpu,   v.req_mem,   v.req_eph,
                       v.pod_count, v.allowed,   v.alloc_cpu,
                       v.alloc_mem, v.alloc_eph, v.valid};
  i64 bits;
  int ff;
  const bool feasible = cycle_filter_res(nd, pd, false, j, rr, &bits, &ff);
  local_record(a, pd, ws, j, v, feasible);
}

// The host's argument arrays as the struct the local kernels take.
inline ScanLocalArgs scan_local_args(const i64* iargs, void* const* ptrs) {
  ScanLocalArgs a;
  for (int i = 0; i < SLI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SLP_COUNT; ++i) a.p[i] = ptrs[i];
  return a;
}

// ---- one launch a device over its shards (K10a, K11a, K13a) ---------------
// The launch takes every shard's argument struct in one kernel parameter
// (`__grid_constant__`: read in place from the parameter bank, never
// copied to local memory), so a block finds its shard's pointers with no
// load from global memory and nothing is uploaded. Four shards (2,688
// bytes) fit the classic 4 KB parameter limit; a device holding more
// shards takes one launch per four.
constexpr int LOCAL_GROUP_SHARDS = 4;
// 128-thread blocks: a card's 4 x 4,096 rows are 128 blocks on 132 SMs
constexpr int LOCAL_GROUP_THREADS = 128;
// host words of one shard's struct: its scalars, then its pointers
constexpr int SL_WORDS = SLI_COUNT + SLP_COUNT;
static_assert(sizeof(ScanLocalArgs) == 8 * SL_WORDS, "ScanLocalArgs layout");
static_assert(SLP_PEER_STAMPS0 - SLP_PEER_REC0 == MAX_PEERS
                  && SLP_GHOST_CPU - SLP_PEER_STAMPS0 == MAX_PEERS,
              "a peer slot for every peer");

struct ScanLocalGroup {
  ScanLocalArgs s[LOCAL_GROUP_SHARDS];
};

// The row blocks of shard `a`: a block of the grid past them returns at
// once.
__device__ __forceinline__ int local_blocks(const ScanLocalArgs& a) {
  return ((int)a.v[SLI_ROWS] + LOCAL_GROUP_THREADS - 1)
         / LOCAL_GROUP_THREADS;
}

// Launch `kernel` over the `n` shards whose structs lie in `words` (n x
// SL_WORDS), a grid of (row blocks, shards) a launch, on `stream` of
// `device`. Adds one to `*launched` for every launch it makes.
template <typename Kernel>
inline int scan_local_group_launch(Kernel kernel, const i64* words, int n,
                                   int device, void* stream,
                                   int* launched) {
  const DeviceScope on(device);
  cudaError_t e = on.err;
  for (int k0 = 0; e == cudaSuccess && k0 < n; k0 += LOCAL_GROUP_SHARDS) {
    ScanLocalGroup g;
    const int m = n - k0 < LOCAL_GROUP_SHARDS ? n - k0 : LOCAL_GROUP_SHARDS;
    int rows = 1;
    for (int k = 0; k < LOCAL_GROUP_SHARDS; ++k) {
      // slots past the m shards repeat the first; no block reads them
      const i64* w = words + (size_t)(k0 + (k < m ? k : 0)) * SL_WORDS;
      g.s[k] = scan_local_args(w, (void* const*)(w + SLI_COUNT));
      if (k < m && (int)g.s[k].v[SLI_ROWS] > rows)
        rows = (int)g.s[k].v[SLI_ROWS];
    }
    const dim3 grid((rows + LOCAL_GROUP_THREADS - 1) / LOCAL_GROUP_THREADS,
                    m);
    kernel<<<grid, LOCAL_GROUP_THREADS, 0, (cudaStream_t)stream>>>(g);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  return (int)e;
}

// ---- the select kernels (K10b, K11b, K13b) ---------------------------------
// Each runs as one thread-block cluster a step (`cluster_select.cuh`).
// scalar slots, in the order of `_SSS_INTS`
enum {
  SSI_N_PAD, SSI_ROWS, SSI_D, SSI_CHUNK, SSI_N_REAL, SSI_Z_PAD, SSI_B,
  SSI_N_STEPS, SSI_NUM_TO_FIND, SSI_MODE, SSI_L, SSI_N_OID, SSI_GATE, SSI_P,
  SSI_IPA_ON, SSI_IC_INERT, SSI_TR_INERT, SSI_GANG_SCORE, SSI_OFF_LOCAL,
  SSI_OFF_NA, SSI_OFF_TT, SSI_OFF_SC, SSI_OFF_IC, SSI_OFF_ZONE,
  SSI_OFF_FEAS, SSI_OFF_TRACKED, SSI_VIC_P, SSI_CAND_OFF, SSI_STAMP_BASE,
  SSI_COUNT
};
// pointer slots, in the order of `_SSS_PTRS`
enum {
  SSP_GATHERED, SSP_W, SSP_WTAB, SSP_PROFILE_ID, SSP_ROW, SSP_SCAL,
  SSP_IC_B, SSP_TR_B, SSP_PERMS, SSP_INV_PERMS, SSP_OID_SEQ, SSP_SEG_START,
  SSP_GANG, SSP_GZ, SSP_STATE, SSP_PACKED, SSP_STATS, SSP_RECS,
  SSP_WORKSPACE,
  SSP_STAMPS,  // this device's [2, D] stamps (NULL: the host copied)
  SSP_COUNT
};

struct ScanSelectArgs {
  i64 v[SSI_COUNT];
  void* p[SSP_COUNT];
};

template <typename T>
__device__ __forceinline__ T* ssp(const ScanSelectArgs& a, int slot) {
  return (T*)a.p[slot];
}

// How long a select waits for a step's stamps before it traps.
constexpr unsigned long long STAMP_WAIT_NS = 5000000000ull;

// One thread: spin until each of the D stamps at `stamps` reads `want`
// or more (system-scope acquire loads of this device's memory). A stamp
// that has not come after STAMP_WAIT_NS traps: the launch fails, the
// stream never hangs.
__device__ __forceinline__ void stamps_wait(const i64* stamps, int D,
                                            i64 want) {
  const unsigned long long t0 = global_ns();
  for (int s = 0; s < D; ++s) {
    while (ld_acquire_sys(stamps + s) < want) {
      if (global_ns() - t0 > STAMP_WAIT_NS) __trap();
      __nanosleep(64);
    }
  }
}

// One thread: wait for the D stamps of round `round`'s half.
__device__ __forceinline__ void stamp_wait(const ScanSelectArgs& a,
                                           i64 round) {
  const int D = (int)a.v[SSI_D];
  stamps_wait(ssp<const i64>(a, SSP_STAMPS) + (size_t)(round & 1) * D, D,
              a.v[SSI_STAMP_BASE] + round + 1);
}

// Round `round`'s half of the gathered records, [D, chunk].
__device__ __forceinline__ const unsigned char* select_records(
    const ScanSelectArgs& a, i64 round) {
  return ssp<const unsigned char>(a, SSP_GATHERED)
         + (size_t)(round & 1) * (size_t)a.v[SSI_D] * (size_t)a.v[SSI_CHUNK];
}

__device__ __forceinline__ bool scan_skip(const ScanSelectArgs& a, i64 i) {
  const int r = ssp<const int>(a, SSP_ROW)[i];
  return ssp<const i64>(a, SSP_SCAL)[(size_t)r * NSCAL + SC_SKIP] != 0;
}

// The walk of the cycle that consumes enumeration k: rotation order
// oid_seq[k] of the perms table (JAX's clamped gathers).
__device__ __forceinline__ CycleWalk select_walk(const ScanSelectArgs& a,
                                                 i64 li, i64 lni, i64 k) {
  CycleWalk wk;
  wk.last_index = li;
  wk.lni = lni;
  wk.num_to_find = a.v[SSI_NUM_TO_FIND];
  wk.mode = (int)a.v[SSI_MODE];
  wk.perm = wk.inv_perm = wk.pos = 0;
  if (wk.mode != 0) {
    const int* oid_seq = ssp<const int>(a, SSP_OID_SEQ);
    const i64 oid = clamp_index(oid_seq[clamp_index(k, a.v[SSI_N_OID])],
                                a.v[SSI_L]);
    const size_t off = (size_t)oid * (size_t)a.v[SSI_N_PAD];
    if (wk.mode == 2) {
      wk.pos = ssp<const int>(a, SSP_PERMS) + off;
    } else {
      wk.perm = ssp<const int>(a, SSP_PERMS) + off;
      wk.inv_perm = ssp<const int>(a, SSP_INV_PERMS) + off;
    }
  }
  return wk;
}

// Stage step i's weight row into `ws`: its wtab row in tensor mode, else
// the static weights. No barrier.
__device__ __forceinline__ void select_weights(const ScanSelectArgs& a, i64 i,
                                               i64* ws) {
  if (threadIdx.x < W_K) {
    const i64* w = ssp<const i64>(a, SSP_W);
    if (a.p[SSP_WTAB])
      w = ssp<const i64>(a, SSP_WTAB)
          + clamp_index(ssp<const i64>(a, SSP_PROFILE_ID)[i], a.v[SSI_P])
                * W_K;
    ws[threadIdx.x] = w[threadIdx.x];
  }
}

// The host's argument arrays as the struct the select kernels take.
inline ScanSelectArgs scan_select_args(const i64* iargs, void* const* ptrs) {
  ScanSelectArgs a;
  for (int i = 0; i < SSI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SSP_COUNT; ++i) a.p[i] = ptrs[i];
  return a;
}
