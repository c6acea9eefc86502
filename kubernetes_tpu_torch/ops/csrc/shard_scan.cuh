// The step of the sharded generic scan (K10) and of the sharded fused
// window (K11), as __device__ code shared by their four kernels:
//   K10a shard_scan_local, K11a shard_segments_local: the shard-local half;
//   K10b shard_scan_select, K11b shard_segments_select: the replicated half.
// The sharded pressure wave (K13a shard_pressure_local, K13b
// shard_pressure_select) takes the same argument tables (its extra slots
// NULL / 0 for K10 and K11), the local helpers and `select_cycle`.
//
// Replaces `sharded_scan_fn` (:233) and `sharded_segments_fn` (:279) of
// kubernetes_tpu/parallel/sharding.py, where GSPMD runs `_batch_core`
// (kubernetes_tpu/ops/kernels.py:569) and `_segments_core` (:785) with the
// carried rows, the spread vector and the gang checkpoint pinned to the
// node sharding and the select epilogue replicated. Here one step of the
// scan is three things the host enqueues, with the same arguments every
// step (no host read between steps):
//   1. the local kernel on every shard (its own device): fold the previous
//      step's winner into the shard's rows when the shard owns it
//      (`_fold_state`, :549, and +1 on the carried spread); K11a then
//      restores the segment checkpoint after a gang failure and takes one
//      at a segment start; then K9a's filter and row-local scores of the
//      step's pod over the shard's rows, into K9a's record;
//   2. the all-gather of the records (host side, parallel/sharding.py);
//   3. the select on every distinct device: K9b's walk, kept-set scores
//      and pick for the step (`cycle_select`), the skip pods' known result
//      (`_skip_cycle`), li / lni, and for K11b the segment state (gang
//      checkpoint, effective skip, rewind, gang zone counts); it writes
//      the decision into the packed block and the step state the locals
//      read next.
// After the last step the host launches the local kernel once more: it
// only folds the last winner (and, K11a, takes back a last rewind).
//
// The step state ([SS_COUNT] int64) lives on every distinct device and is
// written by that device's select only; the locals on that device read it.
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

// ---- the local kernels (K10a, K11a) ---------------------------------------
// scalar slots, in the order of `_SSL_INTS`
enum {
  SLI_ROWS, SLI_S, SLI_OFFSET, SLI_N_REAL, SLI_GATE, SLI_N_STEPS, SLI_P,
  SLI_CARRY_SPREAD, SLI_OFF_LOCAL, SLI_OFF_NA, SLI_OFF_TT, SLI_OFF_SC,
  SLI_OFF_IC, SLI_OFF_ZONE, SLI_OFF_FEAS, SLI_OFF_TRACKED, SLI_VIC_P,
  SLI_CAND_OFF, SLI_COUNT
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
  // the pressure wave (K13a) only; NULL for K10a and K11a
  SLP_GHOST_CPU, SLP_GHOST_MEM, SLP_GHOST_EPH, SLP_GHOST_CNT, SLP_VIC_CPU,
  SLP_VIC_MEM, SLP_VIC_EPH, SLP_VIC_PRIO, SLP_VIC_START, SLP_VIC_VALID,
  SLP_VIC_VIOLATING, SLP_PPRIO, SLP_AGG_I64, SLP_AGG_F64, SLP_AGG_U8,
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

// Row j of the shard takes pod-table row r's fold (`_fold_state`), and +1
// on the carried spread.
__device__ __forceinline__ void local_fold(const ScanLocalArgs& a, int r,
                                           int j) {
  const i64* sc = slp<const i64>(a, SLP_SCAL) + (size_t)r * NSCAL;
  const int S = (int)a.v[SLI_S];
  slp<i64>(a, SLP_REQ_CPU)[j] += sc[SC_UPD_CPU];
  slp<i64>(a, SLP_REQ_MEM)[j] += sc[SC_UPD_MEM];
  slp<i64>(a, SLP_REQ_EPH)[j] += sc[SC_UPD_EPH];
  const i64* upd = slp<const i64>(a, SLP_UPD_SCALAR_P) + (size_t)r * S;
  i64* req = slp<i64>(a, SLP_REQ_SCALAR) + (size_t)j * S;
  for (int s = 0; s < S; ++s) req[s] += upd[s];
  slp<i64>(a, SLP_NZ_CPU)[j] += sc[3];
  slp<i64>(a, SLP_NZ_MEM)[j] += sc[4];
  slp<i64>(a, SLP_POD_COUNT)[j] += 1;
  if (a.v[SLI_CARRY_SPREAD]) slp<i64>(a, SLP_SPREAD)[j] += 1;
}

// Copy row j's live fields into the checkpoint (save) or back (restore).
__device__ __forceinline__ void local_checkpoint(const ScanLocalArgs& a,
                                                 int j, bool save) {
  const int live_slots[7] = {SLP_REQ_CPU, SLP_REQ_MEM, SLP_REQ_EPH,
                             SLP_NZ_CPU,  SLP_NZ_MEM,  SLP_POD_COUNT,
                             SLP_SPREAD};
  const int chk_slots[7] = {SLP_CHK_REQ_CPU, SLP_CHK_REQ_MEM,
                            SLP_CHK_REQ_EPH, SLP_CHK_NZ_CPU,
                            SLP_CHK_NZ_MEM,  SLP_CHK_POD_COUNT,
                            SLP_CHK_SPREAD};
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    i64* live = slp<i64>(a, live_slots[q]);
    i64* chk = slp<i64>(a, chk_slots[q]);
    if (!live) continue;  // no carried spread
    if (save) chk[j] = live[j];
    else live[j] = chk[j];
  }
  const int S = (int)a.v[SLI_S];
  i64* live = slp<i64>(a, SLP_REQ_SCALAR) + (size_t)j * S;
  i64* chk = slp<i64>(a, SLP_CHK_REQ_SCALAR) + (size_t)j * S;
  for (int s = 0; s < S; ++s) {
    if (save) chk[s] = live[s];
    else live[s] = chk[s];
  }
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

// Row j's part of K9a's record: the row-local total and the raw planes
// the select normalizes (the `sc` plane is the carried spread when the
// scan carries one), and the in-range feasible bit.
__device__ __forceinline__ void local_record(const ScanLocalArgs& a,
                                             const CycleNodes& nd,
                                             const CyclePod& pd,
                                             const i64* ws, int j,
                                             bool feasible) {
  const int gate = (int)a.v[SLI_GATE];
  unsigned char* rec = slp<unsigned char>(a, SLP_REC);
  const i64* sc_plane = a.v[SLI_CARRY_SPREAD] ? slp<const i64>(a, SLP_SPREAD)
                                              : pd.sc;
  const i64 o_na = a.v[SLI_OFF_NA], o_tt = a.v[SLI_OFF_TT],
            o_sc = a.v[SLI_OFF_SC], o_ic = a.v[SLI_OFF_IC],
            o_zone = a.v[SLI_OFF_ZONE], o_tr = a.v[SLI_OFF_TRACKED];
  const i64 local = local_total_one(gate, ws, pd.scal[3] + nd.nz_cpu[j],
                                    pd.scal[4] + nd.nz_mem[j],
                                    nd.alloc_cpu[j], nd.alloc_mem[j])
                    + cycle_row_local(pd, gate, ws, j);
  ((i64*)(rec + a.v[SLI_OFF_LOCAL]))[j] = local;
  if (o_na >= 0) ((i64*)(rec + o_na))[j] = pd.na[j];
  if (o_tt >= 0) ((i64*)(rec + o_tt))[j] = pd.tt[j];
  if (o_sc >= 0) ((i64*)(rec + o_sc))[j] = sc_plane[j];
  if (o_ic >= 0) ((i64*)(rec + o_ic))[j] = pd.ic[j];
  if (o_zone >= 0) ((int*)(rec + o_zone))[j] = nd.zone_id[j];
  rec[a.v[SLI_OFF_FEAS] + j] = feasible && (i64)j < nd.n_real;
  if (o_tr >= 0) rec[o_tr + j] = pd.tracked[j];
}

// The local step. One thread per row; no row reads another, and the fold,
// the restore and the checkpoint of row j happen in the thread that then
// filters row j, so the launch needs no barrier past the weight row.
template <bool SEG>
__device__ __forceinline__ void scan_local_step(const ScanLocalArgs& a) {
  __shared__ i64 ws[W_K];
  const i64* st = slp<const i64>(a, SLP_STATE);
  const int rows = (int)a.v[SLI_ROWS];
  const i64 n_steps = a.v[SLI_N_STEPS];
  const i64 t = st[SS_NEXT];
  const i64 fold = st[SS_FOLD_SEL] - a.v[SLI_OFFSET];
  const int frow = (int)st[SS_FOLD_ROW];
  const bool live = t < n_steps;
  const bool rewind = SEG && st[SS_REWIND] != 0;
  const bool save = SEG && live && slp<const unsigned char>(
                                       a, SLP_SEG_START)[t] != 0;
  const int r = live ? slp<const int>(a, SLP_ROW)[t] : 0;
  const i64* scal = slp<const i64>(a, SLP_SCAL) + (size_t)r * NSCAL;
  bool run = live && scal[SC_SKIP] == 0;
  // a member behind its gang's failure (the failure flag resets at a
  // segment start): its record is not read
  if (SEG && run && slp<const unsigned char>(a, SLP_GANG)[t] != 0 && !save
      && st[SS_FAILED] != 0)
    run = false;
  local_weights(a, t, run, ws);
  const CycleNodes nd = local_nodes(a);
  const CyclePod pd = local_pod(a, r);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < rows;
       j += gridDim.x * blockDim.x) {
    if (j == fold) local_fold(a, frow, j);
    if (rewind) local_checkpoint(a, j, false);
    if (save) local_checkpoint(a, j, true);
    if (!run) continue;
    i64 bits;
    int ff;
    const bool feasible = cycle_filter_row(nd, pd, false, j, nullptr, &bits,
                                           &ff);
    local_record(a, nd, pd, ws, j, feasible);
  }
}

// The host's argument arrays as the struct the local kernels take, and
// their grid: 256-thread blocks over the shard's rows.
inline ScanLocalArgs scan_local_args(const i64* iargs, void* const* ptrs) {
  ScanLocalArgs a;
  for (int i = 0; i < SLI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SLP_COUNT; ++i) a.p[i] = ptrs[i];
  return a;
}

constexpr int LOCAL_THREADS = 256;

inline int scan_local_blocks(const ScanLocalArgs& a) {
  const int blocks = ((int)a.v[SLI_ROWS] + LOCAL_THREADS - 1) / LOCAL_THREADS;
  return blocks < 1 ? 1 : blocks;
}

// ---- the select kernels (K10b, K11b) ---------------------------------------
// scalar slots, in the order of `_SSS_INTS`
enum {
  SSI_N_PAD, SSI_ROWS, SSI_D, SSI_CHUNK, SSI_N_REAL, SSI_Z_PAD, SSI_B,
  SSI_N_STEPS, SSI_NUM_TO_FIND, SSI_MODE, SSI_L, SSI_N_OID, SSI_GATE, SSI_P,
  SSI_IPA_ON, SSI_IC_INERT, SSI_TR_INERT, SSI_GANG_SCORE, SSI_OFF_LOCAL,
  SSI_OFF_NA, SSI_OFF_TT, SSI_OFF_SC, SSI_OFF_IC, SSI_OFF_ZONE,
  SSI_OFF_FEAS, SSI_OFF_TRACKED, SSI_VIC_P, SSI_CAND_OFF, SSI_COUNT
};
// pointer slots, in the order of `_SSS_PTRS`
enum {
  SSP_GATHERED, SSP_W, SSP_WTAB, SSP_PROFILE_ID, SSP_ROW, SSP_SCAL,
  SSP_IC_B, SSP_TR_B, SSP_PERMS, SSP_INV_PERMS, SSP_OID_SEQ, SSP_SEG_START,
  SSP_GANG, SSP_GZ, SSP_STATE, SSP_P64, SSP_ZONE, SSP_TRACKED, SSP_TOTAL,
  SSP_KEPT, SSP_FLAGS, SSP_ZS, SSP_PACKED, SSP_STATS, SSP_COUNT
};

struct ScanSelectArgs {
  i64 v[SSI_COUNT];
  void* p[SSP_COUNT];
};

template <typename T>
__device__ __forceinline__ T* ssp(const ScanSelectArgs& a, int slot) {
  return (T*)a.p[slot];
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

__device__ __forceinline__ bool scan_skip(const ScanSelectArgs& a, i64 i) {
  const int r = ssp<const int>(a, SSP_ROW)[i];
  return ssp<const i64>(a, SSP_SCAL)[(size_t)r * NSCAL + SC_SKIP] != 0;
}

// K10b: decide the skip pods from step i on with their known result
// (`_skip_cycle`: sel -1, li reduced mod n, lni unchanged) up to the next
// live step, which it returns (n_steps when none is left). One thread.
__device__ __forceinline__ i64 scan_skip_run(const ScanSelectArgs& a, i64 i,
                                             i64* li, i64 lni, i64 lni0) {
  const i64 n_steps = a.v[SSI_N_STEPS];
  const i64 n_safe = imax64(a.v[SSI_N_REAL], 1);
  for (; i < n_steps && scan_skip(a, i); ++i) {
    *li = floormod(*li, n_safe);
    scan_write(a, i, CycleResult{-1, 0, 0, 0, *li, lni, false}, lni0);
  }
  return i;
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

// One cycle of live step i (pod-table row r, enumeration k) over the
// gathered records: stage the pod's weight row, unpack, `cycle_select`.
__device__ __forceinline__ CycleResult select_cycle(
    const ScanSelectArgs& a, i64 i, int r, i64 li, i64 lni, i64 k,
    const i64* gz, bool gmember, i64* ws, const i64* no_scal) {
  const int tid = threadIdx.x;
  const int n = (int)a.v[SSI_N_PAD];
  if (tid < W_K) {
    const i64* w = ssp<const i64>(a, SSP_W);
    if (a.p[SSP_WTAB])
      w = ssp<const i64>(a, SSP_WTAB)
          + clamp_index(ssp<const i64>(a, SSP_PROFILE_ID)[i], a.v[SSI_P])
                * W_K;
    ws[tid] = w[tid];
  }
  const RecLayout lay{a.v[SSI_OFF_LOCAL], a.v[SSI_OFF_NA], a.v[SSI_OFF_TT],
                      a.v[SSI_OFF_SC],    a.v[SSI_OFF_IC], a.v[SSI_OFF_ZONE],
                      a.v[SSI_OFF_FEAS],  a.v[SSI_OFF_TRACKED]};
  i64* p64 = ssp<i64>(a, SSP_P64);  // [5, n]: local, na, tt, sc, ic
  int* zone = ssp<int>(a, SSP_ZONE);
  unsigned char* trk = ssp<unsigned char>(a, SSP_TRACKED);
  // the barrier that ends the unpack also publishes the weight row
  unpack_records(ssp<const unsigned char>(a, SSP_GATHERED),
                 (size_t)a.v[SSI_CHUNK], n, (int)a.v[SSI_ROWS], lay, p64,
                 zone, trk, ssp<int>(a, SSP_FLAGS) + n);
  CycleNodes nd{};
  nd.n_pad = n;
  nd.n_real = a.v[SSI_N_REAL];
  nd.z_pad = (int)a.v[SSI_Z_PAD];
  nd.zone_id = lay.zone >= 0 ? zone : nullptr;
  const bool ipa_on = a.v[SSI_IPA_ON] != 0;
  CyclePod pd{};
  pd.scal = no_scal;
  pd.na = lay.na >= 0 ? p64 + (size_t)n : nullptr;
  pd.tt = lay.tt >= 0 ? p64 + 2 * (size_t)n : nullptr;
  pd.sc = lay.sc >= 0 ? p64 + 3 * (size_t)n : nullptr;
  // an inert inter-pod field broadcasts its spec's one element ([U, 1])
  pd.ic = lay.ic >= 0 ? p64 + 4 * (size_t)n
                      : (ipa_on ? ssp<const i64>(a, SSP_IC_B) + r : nullptr);
  pd.tracked = lay.tracked >= 0
                   ? trk
                   : (ipa_on ? ssp<const unsigned char>(a, SSP_TR_B) + r
                             : nullptr);
  pd.ipa_on = ipa_on;
  pd.ic_inert = (int)a.v[SSI_IC_INERT];
  pd.tr_inert = (int)a.v[SSI_TR_INERT];
  pd.local_in_base = 1;
  const CycleScratch cs{ssp<i64>(a, SSP_TOTAL), ssp<unsigned char>(a, SSP_KEPT),
                        nullptr, nullptr, nullptr, ssp<int>(a, SSP_FLAGS),
                        ssp<i64>(a, SSP_ZS)};
  const CycleResult res = cycle_select(nd, pd, false, select_walk(a, li, lni, k),
                                       (int)a.v[SSI_GATE], ws, p64, gz,
                                       gmember, cs);
  __syncthreads();  // every read of gz and of the scratch is done
  return res;
}

// K10b: one launch decides the skip pods up to the next live step, that
// step, and the skip pods after it, so the host launches one step per live
// pod and the window's padding costs no launch.
__device__ __forceinline__ void scan_select_step(const ScanSelectArgs& a) {
  __shared__ i64 ws[W_K];
  __shared__ i64 no_scal[16];  // the pod scalars the select never reads
  __shared__ i64 sv[SS_COUNT];
  const int tid = threadIdx.x;
  i64* st = ssp<i64>(a, SSP_STATE);
  if (tid < 16) no_scal[tid] = 0;
  if (tid < SS_COUNT) sv[tid] = st[tid];
  __syncthreads();
  const i64 lni0 = sv[SS_LNI0];
  if (tid == 0)
    sv[SS_STEP] = scan_skip_run(a, sv[SS_STEP], &sv[SS_LI], sv[SS_LNI], lni0);
  __syncthreads();
  i64 i = sv[SS_STEP], li = sv[SS_LI], lni = sv[SS_LNI];
  i64 fold = -1;
  int r = 0;
  if (i < a.v[SSI_N_STEPS]) {
    r = ssp<const int>(a, SSP_ROW)[i];
    const CycleResult res = select_cycle(a, i, r, li, lni, i, nullptr, false,
                                         ws, no_scal);
    fold = res.found > 0 ? res.sel : -1;
    li = res.next_li;
    lni = res.next_lni;
    if (tid == 0) {
      scan_write(a, i, res, lni0);
      i = scan_skip_run(a, i + 1, &li, lni, lni0);
    }
  }
  if (tid == 0) {
    st[SS_STEP] = i;
    st[SS_NEXT] = i;
    st[SS_LI] = li;
    st[SS_LNI] = lni;
    st[SS_FOLD_SEL] = fold;
    st[SS_FOLD_ROW] = r;
  }
}

// K11b: one step of `_segments_core` (one pod, in order): the segment
// checkpoint at a segment start (gz reset BEFORE it, so a rewind restores
// zeros), the effective skip `skip | (gang & failed)`, the cycle at
// enumeration t, the gang zone count of a placed member, and the rewind
// of li / lni / t / gz when a gang member finds no node; the packed [4B]
// block gets selected (or -1), li after, lni - lni0 and t.
__device__ __forceinline__ void segments_select_step(
    const ScanSelectArgs& a) {
  __shared__ i64 ws[W_K];
  __shared__ i64 no_scal[16];
  __shared__ i64 sv[SS_COUNT];
  const int tid = threadIdx.x;
  i64* st = ssp<i64>(a, SSP_STATE);
  if (tid < 16) no_scal[tid] = 0;
  if (tid < SS_COUNT) sv[tid] = st[tid];
  __syncthreads();
  const i64 i = sv[SS_STEP];
  if (i >= a.v[SSI_N_STEPS]) return;
  const i64 B = a.v[SSI_B];
  const int z_pad = (int)a.v[SSI_Z_PAD];
  const bool gang_score = a.v[SSI_GANG_SCORE] != 0;
  const i64 n_safe = imax64(a.v[SSI_N_REAL], 1);
  const i64 lni0 = sv[SS_LNI0];
  i64 li = sv[SS_LI], lni = sv[SS_LNI], t = sv[SS_T];
  i64 chk_li = sv[SS_CHK_LI], chk_lni = sv[SS_CHK_LNI], chk_t = sv[SS_CHK_T];
  bool failed = sv[SS_FAILED] != 0;
  i64* gz = ssp<i64>(a, SSP_GZ);
  const int r = ssp<const int>(a, SSP_ROW)[i];
  const bool sflag = ssp<const unsigned char>(a, SSP_SEG_START)[i] != 0;
  const bool gflag = ssp<const unsigned char>(a, SSP_GANG)[i] != 0;
  if (sflag) {
    if (gang_score)
      for (int z = tid; z < z_pad; z += NTHREADS) gz[z] = 0;
    chk_li = li;
    chk_lni = lni;
    chk_t = t;
    failed = false;
  }
  __syncthreads();  // the gz reset lands before the cycle reads it
  const bool eskip = scan_skip(a, i) || (gflag && failed);
  CycleResult res{-1, 0, 0, 0, floormod(li, n_safe), lni, false};
  if (!eskip)
    res = select_cycle(a, i, r, li, lni, t, gang_score ? gz : nullptr, gflag,
                       ws, no_scal);
  const bool hit = res.found > 0;
  const bool fail_now = gflag && !hit && !eskip;
  if (fail_now) {
    li = chk_li;
    lni = chk_lni;
    t = chk_t;
  } else {
    li = res.next_li;
    lni = res.next_lni;
    t += eskip ? 0 : 1;
  }
  failed = failed || fail_now;
  if (tid == 0) {
    if (gang_score && hit && gflag) {
      const int z = ssp<const int>(a, SSP_ZONE)[res.sel];
      if (z > 0 && z < z_pad) gz[z] += 1;
    }
    if (gang_score && fail_now)
      for (int z = 0; z < z_pad; ++z) gz[z] = 0;
    int* packed = ssp<int>(a, SSP_PACKED);
    packed[i] = hit ? wrap32(res.sel) : -1;
    packed[B + i] = wrap32(li);
    packed[2 * B + i] = wrap32(lni - lni0);
    packed[3 * B + i] = wrap32(t);
    st[SS_STEP] = i + 1;
    st[SS_NEXT] = i + 1;
    st[SS_LI] = li;
    st[SS_LNI] = lni;
    st[SS_FOLD_SEL] = hit ? res.sel : -1;
    st[SS_FOLD_ROW] = r;
    st[SS_REWIND] = fail_now;
    st[SS_T] = t;
    st[SS_CHK_T] = chk_t;
    st[SS_CHK_LI] = chk_li;
    st[SS_CHK_LNI] = chk_lni;
    st[SS_FAILED] = failed;
  }
}

// The host's argument arrays as the struct the select kernels take (ONE
// block of NTHREADS threads).
inline ScanSelectArgs scan_select_args(const i64* iargs, void* const* ptrs) {
  ScanSelectArgs a;
  for (int i = 0; i < SSI_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < SSP_COUNT; ++i) a.p[i] = ptrs[i];
  return a;
}
