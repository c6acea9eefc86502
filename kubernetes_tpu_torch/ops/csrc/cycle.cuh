// The per-node parts of one pod's scheduling cycle: the filter
// (`cycle_filter_row`), the row-local and kept-set scores
// (`cycle_row_local`, `cycle_score_one`), and the records and launch
// arguments the cycles share. Every cycle (K2, K5, K6, K8, and over the
// gathered shard records K9b, K10b, K11b, K13b) runs them across a
// thread-block cluster (`cluster_cycle.cuh`).
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core`
// (kubernetes_tpu/ops/kernels.py:296, :157, :359): per-node predicate bits
// and the first failing predicate; every weighted priority normalised over
// the kept set (node affinity, taint toleration, one-hot zone selector
// spread, inter-pod min-max, image locality, prefer-avoid, the K1 resource
// families and the rank-aware gang locality). A nominated-ghost load (K2's
// nominees, K8's nominations) adds to the rows the filter reads
// (`_cycle_core`'s `ghost`, kernels.py:402-413). The sharded cycle splits
// the cycle in two: K9a runs `cycle_filter_row` and `cycle_row_local` on
// each shard's rows, K9b the cluster cycle on the gathered records.
#pragma once

#include "common.cuh"

#include <climits>

struct CycleNodes {
  int n_pad, S;
  i64 n_real;
  int z_pad;
  const unsigned char* valid;
  const i64 *alloc_cpu, *alloc_mem, *alloc_eph, *allowed, *req_cpu, *req_mem,
      *req_eph, *nz_cpu, *nz_mem, *pod_count, *alloc_scalar, *req_scalar_n;
  const int* zone_id;
};

// One pod's inputs. Per-node masks and counts are NULL when inert (the
// family is skipped, as in JAX); ic/tracked may be one element.
struct CyclePod {
  const i64* scal;  // req_cpu req_mem req_eph nz_cpu nz_mem has_request
                    // check_resources unknown_scalar (skip is an argument)
  const i64* req_scalar_p;
  const unsigned char *sel_ok, *taints_ok, *unsched_ok, *ports_ok, *host_ok,
      *disk_ok, *maxvol_ok, *volbind_ok, *volzone_ok;
  const signed char* ipa_code;
  const i64 *na, *tt, *sc, *ic, *img, *pa;
  const unsigned char* tracked;
  int ipa_on, ic_inert, tr_inert;
  // 1 when the record's local total already holds the row-local families
  // (K1, image locality, prefer-avoid): the mesh selects' gathered
  // records; 0 everywhere else
  int local_in_base;
};

struct CycleWalk {
  i64 last_index, lni, num_to_find;
  int mode;  // 0 axis order, 1 perm/inv_perm, 2 positions
  const int *perm, *inv_perm, *pos;
};

// The per-node outputs of a cycle (`cluster_cycle`'s `out`): K2's five,
// or K9b's total and kept bit (the filter's three NULL).
struct CycleScratch {
  i64* total;
  unsigned char *kept, *feasible;
  signed char* fail_first;
  i64* general_bits;
};

struct CycleResult {
  i64 sel, found, evaluated, max_score, next_li, next_lni;
  // with a ghost: some in-range node's first failure is resolvable by
  // preemption (`_resolvable_candidates`, kernels.py:1675); else false
  bool any_resolvable;
};

// The nominated pods' load ([n_pad] each), added to req_* / pod_count in
// the filter only: the scores read the raw rows, as PrioritizeNodes never
// adds nominated pods.
struct CycleGhost {
  const i64 *cpu, *mem, *eph, *cnt;
};

constexpr double ZONE_WEIGHTING = 2.0 / 3.0;
constexpr double ONE_MINUS_ZW = 1.0 - ZONE_WEIGHTING;
constexpr i64 IMAGE_MIN = 23LL * 1024 * 1024;
constexpr i64 IMAGE_MAX = 1000LL * 1024 * 1024;

__device__ __forceinline__ double ratio10(i64 num, i64 den) {
  // float(MAX_PRIORITY) * (num / max(den, 1)) in float64, rounded per op
  return __dmul_rn(10.0, __ddiv_rn((double)num, (double)imax64(den, 1)));
}

// The resource fields of node j the filter compares (the ghost load
// already added): loaded by `cycle_filter_row`, or held in registers by a
// caller that loaded them earlier (K10a / K11a).
struct CycleRowRes {
  i64 req_cpu, req_mem, req_eph, pod_count, allowed, alloc_cpu, alloc_mem,
      alloc_eph;
  bool valid;
};

// The filter of node j (`_feasibility`, kernels.py:296) on its resource
// fields `rr`: its general predicate bits, its first failing predicate in
// PREDICATE_ORDERING, and whether it is feasible.
__device__ __forceinline__ bool cycle_filter_res(
    const CycleNodes& nd, const CyclePod& pd, bool skip, int j,
    const CycleRowRes& rr, i64* bits_out, int* ff_out) {
  const i64 p_req_cpu = pd.scal[0], p_req_mem = pd.scal[1],
            p_req_eph = pd.scal[2];
  const bool check_res = pd.scal[6] != 0;
  const bool has_req = pd.scal[5] != 0 && check_res;
  const bool unknown = pd.scal[7] != 0;
  i64 bits = 0;
  if (check_res && rr.pod_count + 1 > rr.allowed) bits |= 1LL << 0;
  if (has_req && rr.alloc_cpu < p_req_cpu + rr.req_cpu) bits |= 1LL << 1;
  if (has_req && rr.alloc_mem < p_req_mem + rr.req_mem) bits |= 1LL << 2;
  if (has_req && rr.alloc_eph < p_req_eph + rr.req_eph) bits |= 1LL << 3;
  i64 sbits = 0;
  for (int s = 0; s < nd.S; ++s) {
    i64 want = pd.req_scalar_p[s];
    if (has_req && want > 0
        && nd.alloc_scalar[(size_t)j * nd.S + s]
               < want + nd.req_scalar_n[(size_t)j * nd.S + s]
        && 4 + s < 64)
      sbits += 1LL << (4 + s);
  }
  bits |= sbits;
  if (check_res && unknown) bits |= 1LL << 59;
  if (pd.host_ok && !pd.host_ok[j]) bits |= 1LL << 60;
  if (pd.ports_ok && !pd.ports_ok[j]) bits |= 1LL << 61;
  if (pd.sel_ok && !pd.sel_ok[j]) bits |= 1LL << 62;
  // first failing predicate in PREDICATE_ORDERING (later overwrites win)
  int ff = 0;
  if (pd.ipa_code && pd.ipa_code[j] > 0) ff = 8;
  if (pd.volzone_ok && !pd.volzone_ok[j]) ff = 7;
  if (pd.volbind_ok && !pd.volbind_ok[j]) ff = 6;
  if (pd.maxvol_ok && !pd.maxvol_ok[j]) ff = 5;
  if (pd.taints_ok && !pd.taints_ok[j]) ff = 4;
  if (pd.disk_ok && !pd.disk_ok[j]) ff = 3;
  if (bits != 0) ff = 2;
  if (pd.unsched_ok && !pd.unsched_ok[j]) ff = 1;
  *bits_out = bits;
  *ff_out = ff;
  return rr.valid && ff == 0 && !skip;
}

// The filter of node j read from the rows `nd`; `ghost` (NULL = off)
// adds K8's carried nominated load to the rows the filter reads.
__device__ __forceinline__ bool cycle_filter_row(
    const CycleNodes& nd, const CyclePod& pd, bool skip, int j,
    const CycleGhost* ghost, i64* bits_out, int* ff_out) {
  CycleRowRes rr{nd.req_cpu[j],   nd.req_mem[j],   nd.req_eph[j],
                 nd.pod_count[j], nd.allowed[j],   nd.alloc_cpu[j],
                 nd.alloc_mem[j], nd.alloc_eph[j], nd.valid[j] != 0};
  if (ghost) {
    rr.req_cpu += ghost->cpu[j];
    rr.req_mem += ghost->mem[j];
    rr.req_eph += ghost->eph[j];
    rr.pod_count += ghost->cnt[j];
  }
  return cycle_filter_res(nd, pd, skip, j, rr, bits_out, ff_out);
}

// The static masks a preemption winner must pass, for node j (K8, K13a):
// in range, valid, and every non-resource mask of the pod
__device__ __forceinline__ bool pressure_static(const CycleNodes& nd,
                                                const CyclePod& pd, int j) {
  bool fs = (i64)j < nd.n_real && nd.valid[j];
  if (pd.sel_ok) fs = fs && pd.sel_ok[j];
  if (pd.taints_ok) fs = fs && pd.taints_ok[j];
  if (pd.unsched_ok) fs = fs && pd.unsched_ok[j];
  if (pd.host_ok) fs = fs && pd.host_ok[j];
  if (pd.ports_ok) fs = fs && pd.ports_ok[j];
  if (pd.disk_ok) fs = fs && pd.disk_ok[j];
  if (pd.maxvol_ok) fs = fs && pd.maxvol_ok[j];
  if (pd.volbind_ok) fs = fs && pd.volbind_ok[j];
  if (pd.volzone_ok) fs = fs && pd.volzone_ok[j];
  if (pd.ipa_code) fs = fs && pd.ipa_code[j] == 0;
  return fs;
}

// Whether node j's first failure is one preemption cannot resolve
// (`_resolvable_candidates`, kubernetes_tpu/ops/kernels.py:1675):
// unschedulable, taints, volume zone, volume binding, and GENERAL with the
// host-name or selector bit.
__device__ __forceinline__ bool cycle_unresolvable(int ff, i64 bits) {
  return ff == 1 || ff == 4 || ff == 7 || ff == 6
         || (ff == 2 && (((bits >> 60) & 1) || ((bits >> 62) & 1)));
}

// The priorities of node j that read no other node besides K1's: image
// locality and prefer-avoid (its constant when the field is inert).
__device__ __forceinline__ i64 cycle_row_local(const CyclePod& pd, int gate,
                                               const i64* w, int j) {
  i64 t = 0;
  if (ON(gate, W_IMAGE) && pd.img) {
    i64 s = imin64(imax64(pd.img[j], IMAGE_MIN), IMAGE_MAX);
    t += w[W_IMAGE] * floordiv(MAX_PRIORITY * (s - IMAGE_MIN),
                               IMAGE_MAX - IMAGE_MIN);
  }
  if (ON(gate, W_AVOID)) t += w[W_AVOID] * (pd.pa ? pd.pa[j] : MAX_PRIORITY);
  return t;
}

// The kept-set normalizers of one cycle's scores (`_fit_scores`,
// kubernetes_tpu/ops/kernels.py:157): which families run, their maxima
// over the kept set, the largest zone count and the constant families.
struct CycleNorm {
  bool do_na, do_tt, do_sc, do_ic, do_gang, have_zones;
  i64 na_max, tt_max, mbn, ic_max, ic_min, mbz, cst;
};

// The families one pod's scores run (`gz` NULL = no gang score) and the
// constant of the inert taint and spread families; the maxima are the
// caller's.
__device__ __forceinline__ CycleNorm cycle_norm_families(const CyclePod& pd,
                                                         int gate,
                                                         const i64* w,
                                                         const i64* gz,
                                                         bool gmember) {
  CycleNorm nm;
  nm.do_na = ON(gate, W_NODEAFF) && pd.na;
  nm.do_tt = ON(gate, W_TAINT) && pd.tt;
  nm.do_sc = ON(gate, W_SPREAD) && pd.sc;
  nm.do_ic = ON(gate, W_INTERPOD) && pd.ipa_on;
  nm.do_gang = ON(gate, W_GANG) && gz && gmember;
  nm.cst = 0;
  if (ON(gate, W_TAINT) && !pd.tt) nm.cst += w[W_TAINT] * MAX_PRIORITY;
  if (ON(gate, W_SPREAD) && !pd.sc) nm.cst += w[W_SPREAD] * MAX_PRIORITY;
  nm.na_max = nm.tt_max = nm.mbn = nm.ic_max = nm.ic_min = nm.mbz = 0;
  nm.have_zones = false;
  return nm;
}

// The largest count among the zones present in the table `zs` ([2, z_pad]:
// spread counts, present flags).
__device__ __forceinline__ i64 cycle_zone_max(const i64* zs, int z_pad) {
  i64 mbz = 0;
  for (int z = 0; z < z_pad; ++z) mbz = imax64(mbz, zs[z_pad + z] ? zs[z] : 0);
  return mbz;
}

// The score of node j, the body of `_fit_scores`' weighted sum: `t` holds
// its K1 totals (or, with pd.local_in_base, its whole row-local part),
// `sc_j` its spread count, `z` its zone id (read by the caller only when
// the gang or spread family runs), `zs` the kept set's zone table and `gz`
// the current gang's per-zone member count.
__device__ __forceinline__ i64 cycle_score_one(const CyclePod& pd, int gate,
                                               const i64* w,
                                               const CycleNorm& nm, int j,
                                               i64 t, i64 sc_j, int z,
                                               int z_pad, const i64* zs,
                                               const i64* gz) {
  if (nm.do_gang && z > 0)
    // min(members of this gang already in the node's zone, 10) x weight
    t += w[W_GANG] * imin64(z < z_pad ? gz[z] : 0, MAX_PRIORITY);
  if (nm.do_na)
    t += w[W_NODEAFF] * (nm.na_max == 0 ? pd.na[j]
                         : floordiv(MAX_PRIORITY * pd.na[j],
                                    imax64(nm.na_max, 1)));
  if (nm.do_tt)
    t += w[W_TAINT] * (nm.tt_max == 0 ? MAX_PRIORITY
                       : MAX_PRIORITY - floordiv(MAX_PRIORITY * pd.tt[j],
                                                 imax64(nm.tt_max, 1)));
  if (nm.do_sc) {
    double f = nm.mbn > 0 ? ratio10(nm.mbn - sc_j, nm.mbn) : 10.0;
    i64 zc = (z >= 0 && z < z_pad) ? zs[z] : 0;
    double zsc = nm.mbz > 0 ? ratio10(nm.mbz - zc, nm.mbz) : 10.0;
    if (nm.have_zones && z > 0)
      f = __dadd_rn(__dmul_rn(f, ONE_MINUS_ZW),
                    __dmul_rn(ZONE_WEIGHTING, zsc));
    t += w[W_SPREAD] * (i64)f;
  }
  if (nm.do_ic) {
    bool tr = pd.tracked[pd.tr_inert ? 0 : j];
    i64 icv = pd.ic[pd.ic_inert ? 0 : j];
    i64 diff = nm.ic_max - nm.ic_min;
    t += w[W_INTERPOD] * ((diff > 0 && tr)
                          ? (i64)ratio10(icv - nm.ic_min, diff) : 0);
  }
  if (!pd.local_in_base) t += cycle_row_local(pd, gate, w, j);
  return t + nm.cst;
}

// ---- the gathered records of the sharded cycle (K9b, K10b, K11b, K13b) -----
// Byte offsets of the planes in one shard's record (-1 = absent), in the
// order of `_REC_PLANES` (kubernetes_tpu_torch/ops/kernels.py).
struct RecLayout {
  i64 local, na, tt, sc, ic, zone, feas, tracked;
};

// ---- the scan kernels' (K5, K6, K8) launch arguments -----------------------
// Scalars and pointers in the order of `_SCAN_INTS` / `_SCAN_PTRS`
// (kubernetes_tpu_torch/ops/kernels.py). Pod fields are per-spec tables:
// row r of a [U, n_pad] field is pod spec r; NULL = inert in this window.
enum {
  I_N_PAD, I_S, I_N_REAL, I_Z_PAD, I_B, I_NTF, I_LAST_INDEX, I_LNI0, I_MODE,
  I_L, I_N_OID, I_CARRY_SPREAD, I_GATE, I_P, I_IPA_ON, I_IC_INERT,
  I_TR_INERT, I_N_PODS, I_GANG_SCORE, I_U, I_VIC_P, I_COUNT
};
enum {
  P_VALID, P_ALLOC_CPU, P_ALLOC_MEM, P_ALLOC_EPH, P_ALLOWED, P_ALLOC_SCALAR,
  P_ZONE_ID, P_REQ_CPU, P_REQ_MEM, P_REQ_EPH, P_REQ_SCALAR, P_NZ_CPU,
  P_NZ_MEM, P_POD_COUNT, P_SCAL, P_REQ_SCALAR_P, P_UPD_SCALAR_P, P_SEL_OK,
  P_TAINTS_OK, P_UNSCHED_OK, P_PORTS_OK, P_HOST_OK, P_DISK_OK, P_MAXVOL_OK,
  P_VOLBIND_OK, P_VOLZONE_OK, P_IPA_CODE, P_NA, P_TT, P_SC, P_IC, P_IMG,
  P_PA, P_TRACKED, P_ROW, P_PROFILE_ID, P_W, P_WTAB, P_PERMS, P_INV_PERMS,
  P_OID_SEQ, P_SPREAD, P_STATS, P_PACKED,
  P_CARRY_OUT, P_SEG_START, P_GANG, P_GZ, P_LOG_NODE, P_LOG_ROW,
  // the pressure scan (K8) only; NULL for K5 and K6
  P_GHOST_CPU, P_GHOST_MEM, P_GHOST_EPH, P_GHOST_CNT, P_VIC_CPU, P_VIC_MEM,
  P_VIC_EPH, P_VIC_PRIO, P_VIC_START, P_VIC_VALID, P_VIC_VIOL, P_PPRIO,
  P_CARRY_IN, P_AGG_I64, P_AGG_F64, P_AGG_U8,
  // the cluster's per-slot scratch in global memory (`ClusterGeom::scratch`);
  // NULL while it fits in shared memory
  P_WORKSPACE,
  P_COUNT
};
// slots of a pod-spec row of the [U, NSCAL] scalar table
enum { SC_SKIP = 8, SC_UPD_CPU = 10, SC_UPD_MEM = 11, SC_UPD_EPH = 12,
       NSCAL = 13 };

struct ScanArgs {
  i64 v[I_COUNT];
  void* p[P_COUNT];
};

template <typename T>
__device__ __forceinline__ const T* cptr(const ScanArgs& a, int slot) {
  return (const T*)a.p[slot];
}

template <typename T>
__device__ __forceinline__ T* mptr(const ScanArgs& a, int slot) {
  return (T*)a.p[slot];
}

__device__ __forceinline__ CycleNodes scan_nodes(const ScanArgs& a) {
  CycleNodes nd;
  nd.n_pad = (int)a.v[I_N_PAD];
  nd.S = (int)a.v[I_S];
  nd.n_real = a.v[I_N_REAL];
  nd.z_pad = (int)a.v[I_Z_PAD];
  nd.valid = cptr<unsigned char>(a, P_VALID);
  nd.alloc_cpu = cptr<i64>(a, P_ALLOC_CPU);
  nd.alloc_mem = cptr<i64>(a, P_ALLOC_MEM);
  nd.alloc_eph = cptr<i64>(a, P_ALLOC_EPH);
  nd.allowed = cptr<i64>(a, P_ALLOWED);
  nd.req_cpu = cptr<i64>(a, P_REQ_CPU);
  nd.req_mem = cptr<i64>(a, P_REQ_MEM);
  nd.req_eph = cptr<i64>(a, P_REQ_EPH);
  nd.nz_cpu = cptr<i64>(a, P_NZ_CPU);
  nd.nz_mem = cptr<i64>(a, P_NZ_MEM);
  nd.pod_count = cptr<i64>(a, P_POD_COUNT);
  nd.alloc_scalar = cptr<i64>(a, P_ALLOC_SCALAR);
  nd.req_scalar_n = cptr<i64>(a, P_REQ_SCALAR);
  nd.zone_id = cptr<int>(a, P_ZONE_ID);
  return nd;
}

// row `r` of the per-spec tables, as one pod's inputs
__device__ __forceinline__ CyclePod scan_pod(const ScanArgs& a, int r) {
  const size_t n = (size_t)a.v[I_N_PAD], S = (size_t)a.v[I_S];
  CyclePod pd;
#define ROW(T, slot, width) \
  (a.p[slot] ? cptr<T>(a, slot) + (size_t)r * (width) : (const T*)0)
  pd.scal = cptr<i64>(a, P_SCAL) + (size_t)r * NSCAL;
  pd.req_scalar_p = cptr<i64>(a, P_REQ_SCALAR_P) + (size_t)r * S;
  pd.sel_ok = ROW(unsigned char, P_SEL_OK, n);
  pd.taints_ok = ROW(unsigned char, P_TAINTS_OK, n);
  pd.unsched_ok = ROW(unsigned char, P_UNSCHED_OK, n);
  pd.ports_ok = ROW(unsigned char, P_PORTS_OK, n);
  pd.host_ok = ROW(unsigned char, P_HOST_OK, n);
  pd.disk_ok = ROW(unsigned char, P_DISK_OK, n);
  pd.maxvol_ok = ROW(unsigned char, P_MAXVOL_OK, n);
  pd.volbind_ok = ROW(unsigned char, P_VOLBIND_OK, n);
  pd.volzone_ok = ROW(unsigned char, P_VOLZONE_OK, n);
  pd.ipa_code = ROW(signed char, P_IPA_CODE, n);
  pd.na = ROW(i64, P_NA, n);
  pd.tt = ROW(i64, P_TT, n);
  // the carried spread vector replaces the field when the scan carries it
  pd.sc = a.v[I_CARRY_SPREAD] ? cptr<i64>(a, P_SPREAD) : ROW(i64, P_SC, n);
  pd.img = ROW(i64, P_IMG, n);
  pd.pa = ROW(i64, P_PA, n);
  pd.ipa_on = (int)a.v[I_IPA_ON];
  pd.ic_inert = (int)a.v[I_IC_INERT];
  pd.tr_inert = (int)a.v[I_TR_INERT];
  pd.ic = ROW(i64, P_IC, pd.ic_inert ? 1 : n);
  pd.tracked = ROW(unsigned char, P_TRACKED, pd.tr_inert ? 1 : n);
  pd.local_in_base = 0;
#undef ROW
  return pd;
}

// JAX's dynamic-index rules: a negative index wraps once, then clamps
__device__ __forceinline__ i64 clamp_index(i64 i, i64 len) {
  if (i < 0) i += len;
  return imin64(imax64(i, 0), len - 1);
}

// the walk of the cycle that consumes enumeration `k` (rotation order
// oid_seq[k] of the perms table)
__device__ __forceinline__ CycleWalk scan_walk(const ScanArgs& a, i64 li,
                                               i64 lni, i64 k) {
  CycleWalk wk;
  wk.last_index = li;
  wk.lni = lni;
  wk.num_to_find = a.v[I_NTF];
  wk.mode = (int)a.v[I_MODE];
  wk.perm = wk.inv_perm = wk.pos = 0;
  if (wk.mode != 0) {
    const int* oid_seq = cptr<int>(a, P_OID_SEQ);
    i64 oid = clamp_index(oid_seq[clamp_index(k, a.v[I_N_OID])], a.v[I_L]);
    size_t off = (size_t)oid * (size_t)a.v[I_N_PAD];
    if (wk.mode == 2) {
      wk.pos = cptr<int>(a, P_PERMS) + off;
    } else {
      wk.perm = cptr<int>(a, P_PERMS) + off;
      wk.inv_perm = cptr<int>(a, P_INV_PERMS) + off;
    }
  }
  return wk;
}

// Stage pod b's weight row into `ws` (shared): its wtab row in tensor
// mode, else the static weights. Ends with a barrier.
__device__ __forceinline__ void scan_weights(const ScanArgs& a, int b,
                                             i64* ws) {
  if (threadIdx.x < W_K) {
    const i64* w = cptr<i64>(a, P_W);
    if (a.p[P_WTAB]) {
      i64 pid = cptr<i64>(a, P_PROFILE_ID)[b];
      w = cptr<i64>(a, P_WTAB) + clamp_index(pid, a.v[I_P]) * W_K;
    }
    ws[threadIdx.x] = w[threadIdx.x];
  }
  __syncthreads();
}

// Add (sign +1) or take back (sign -1) the fold of pod spec `r` on node
// `sel` (`_fold_state`, kubernetes_tpu/ops/kernels.py:549); one thread.
__device__ __forceinline__ void scan_fold(const ScanArgs& a, int r, i64 sel,
                                          i64 sign) {
  const i64* sc = cptr<i64>(a, P_SCAL) + (size_t)r * NSCAL;
  const int S = (int)a.v[I_S];
  mptr<i64>(a, P_REQ_CPU)[sel] += sign * sc[SC_UPD_CPU];
  mptr<i64>(a, P_REQ_MEM)[sel] += sign * sc[SC_UPD_MEM];
  mptr<i64>(a, P_REQ_EPH)[sel] += sign * sc[SC_UPD_EPH];
  const i64* upd_s = cptr<i64>(a, P_UPD_SCALAR_P) + (size_t)r * S;
  i64* req_s = mptr<i64>(a, P_REQ_SCALAR) + (size_t)sel * S;
  for (int s = 0; s < S; ++s) req_s[s] += sign * upd_s[s];
  mptr<i64>(a, P_NZ_CPU)[sel] += sign * sc[3];
  mptr<i64>(a, P_NZ_MEM)[sel] += sign * sc[4];
  mptr<i64>(a, P_POD_COUNT)[sel] += sign;
  if (a.v[I_CARRY_SPREAD]) mptr<i64>(a, P_SPREAD)[sel] += sign;
}

// Copy the host's argument arrays into the struct the kernel takes.
inline ScanArgs scan_args(const i64* iargs, void* const* ptrs) {
  ScanArgs a;
  for (int i = 0; i < I_COUNT; ++i) a.v[i] = iargs[i];
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = ptrs[i];
  return a;
}
