// The scheduling cycle of one pod over every node, as a __device__
// function of one block: K2 runs it once, K5 and K6 once per pod.
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core`
// (kubernetes_tpu/ops/kernels.py:296, :157, :359): per-node predicate bits
// and the first failing predicate; the rotation walk from last_index as a
// cumsum with the num_to_find cutoff (identity, `perm` and gather-free
// `pos` modes); every weighted priority normalised over the kept set (node
// affinity, taint toleration, one-hot zone selector spread, inter-pod
// min-max, image locality, prefer-avoid, the K1 resource families and the
// rank-aware gang locality); and the round-robin k-th tie select. The
// pressure scan (K8) adds its carried nominated-ghost load to the rows the
// filter reads (`_cycle_core`'s `ghost`, kernels.py:402-413) and asks
// whether any in-range node is a preemption candidate. The sharded cycle
// splits it in two: K9a runs `cycle_filter_row` and `cycle_row_local` on
// each shard's rows, K9b `cycle_select` on the gathered records.
//
// Layout: ONE block of NTHREADS threads, each owning a contiguous slice of
// the node axis, so a reduction or scan is a block barrier; scratch and the
// zone tables live in global memory (L2). Every thread returns the same
// CycleResult (each field comes out of a block-wide reduction).
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
  // 1 when `base` already holds the row-local families (K1, image
  // locality, prefer-avoid): K9b's gathered records; 0 everywhere else
  int local_in_base;
};

struct CycleWalk {
  i64 last_index, lni, num_to_find;
  int mode;  // 0 axis order, 1 perm/inv_perm, 2 positions
  const int *perm, *inv_perm, *pos;
};

// Per-node outputs and scratch; feasible/fail_first/general_bits may be
// NULL (the scans read only the decision).
struct CycleScratch {
  i64* total;
  unsigned char *kept, *feasible;
  signed char* fail_first;
  i64* general_bits;
  int* scratch;  // [2, n_pad]: prefix sums / tie-rank marks, node flags
  i64* zs;       // [2, z_pad]: zone counts, zone present
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

enum { FL_FEAS = 1, FL_KEPTP = 2, FL_TIE = 4 };

constexpr double ZONE_WEIGHTING = 2.0 / 3.0;
constexpr double ONE_MINUS_ZW = 1.0 - ZONE_WEIGHTING;
constexpr i64 IMAGE_MIN = 23LL * 1024 * 1024;
constexpr i64 IMAGE_MAX = 1000LL * 1024 * 1024;

__device__ __forceinline__ double ratio10(i64 num, i64 den) {
  // float(MAX_PRIORITY) * (num / max(den, 1)) in float64, rounded per op
  return __dmul_rn(10.0, __ddiv_rn((double)num, (double)imax64(den, 1)));
}

// The filter of node j (`_feasibility`, kernels.py:296): its general
// predicate bits, its first failing predicate in PREDICATE_ORDERING, and
// whether it is feasible. `ghost` (NULL = off) adds K8's carried
// nominated load to the rows the filter reads.
__device__ __forceinline__ bool cycle_filter_row(
    const CycleNodes& nd, const CyclePod& pd, bool skip, int j,
    const CycleGhost* ghost, i64* bits_out, int* ff_out) {
  const i64 p_req_cpu = pd.scal[0], p_req_mem = pd.scal[1],
            p_req_eph = pd.scal[2];
  const bool check_res = pd.scal[6] != 0;
  const bool has_req = pd.scal[5] != 0 && check_res;
  const bool unknown = pd.scal[7] != 0;
  i64 bits = 0;
  i64 rcpu = nd.req_cpu[j], rmem = nd.req_mem[j], reph = nd.req_eph[j];
  i64 pcnt = nd.pod_count[j];
  if (ghost) {
    rcpu += ghost->cpu[j];
    rmem += ghost->mem[j];
    reph += ghost->eph[j];
    pcnt += ghost->cnt[j];
  }
  if (check_res && pcnt + 1 > nd.allowed[j]) bits |= 1LL << 0;
  if (has_req && nd.alloc_cpu[j] < p_req_cpu + rcpu) bits |= 1LL << 1;
  if (has_req && nd.alloc_mem[j] < p_req_mem + rmem) bits |= 1LL << 2;
  if (has_req && nd.alloc_eph[j] < p_req_eph + reph) bits |= 1LL << 3;
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
  return nd.valid[j] && ff == 0 && !skip;
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

// The walk, the scores and the select of one cycle over nodes whose
// in-range feasible bit (FL_FEAS) is already in FL = cs.scratch + n_pad,
// behind a barrier. `w` is the pod's weight row (static weights or its
// wtab row), `gate` the families the static weights turn on. `base` holds
// the K1 totals when the caller computed them (K2), or the whole row-local
// part when `pd.local_in_base` (K9b); NULL computes K1 inline (K5/K6, where
// the rows change between pods). `gz` (NULL = off) is the current gang's
// per-zone member count and `gmember` whether this pod is a member.
__device__ __forceinline__ CycleResult cycle_select(
    const CycleNodes& nd, const CyclePod& pd, bool skip, const CycleWalk& wk,
    int gate, const i64* w, const i64* base, const i64* gz, bool gmember,
    const CycleScratch& cs) {
  __shared__ i64 sh64[NWARPS];
  __shared__ int sh32[NWARPS];
  const int n = nd.n_pad, tid = threadIdx.x;
  int lo, hi;
  my_range(n, &lo, &hi);
  int* A = cs.scratch;
  int* FL = cs.scratch + n;
  const i64 nr = nd.n_real;
  const i64 n_safe = imax64(nr, 1);
  const i64 li = floormod(wk.last_index, n_safe);
  const i64 ntf = wk.num_to_find;
  const i64 p_nz_cpu = pd.scal[3], p_nz_mem = pd.scal[4];
  // ---- rotation walk -----------------------------------------------------
  i64 found, evaluated;
  if (wk.mode == 2) {
    int lF = 0;
    for (int j = lo; j < hi; ++j) lF += FL[j] & FL_FEAS;
    i64 F = block_sum64(lF, sh64);
    for (int j = lo; j < hi; ++j) cs.kept[j] = (FL[j] & FL_FEAS) != 0;
    found = imin64(F, ntf);
    evaluated = skip ? 0 : nr;
  } else {
    // position space: feas_p[p] = feas[perm[p]] (identity when mode 0)
    int lF = 0;
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      lF += (FL[q] & FL_FEAS) != 0;
    }
    int Fi;
    int run = block_excl_scan(lF, sh32, &Fi);
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      run += (FL[q] & FL_FEAS) != 0;
      A[p] = run;  // inclusive cumsum S
    }
    __syncthreads();
    const i64 F = Fi;
    const i64 pre = li > 0 ? A[li - 1] : 0;
    i64 lstar = n;  // first p with kept_p & rank == ntf
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      bool fp = (FL[q] & FL_FEAS) != 0;
      i64 rank = p >= li ? A[p] - pre : F - pre + A[p];
      bool kp = fp && rank <= ntf;
      if (kp) FL[p] |= FL_KEPTP;
      if (kp && rank == ntf && p < lstar) lstar = p;
    }
    i64 pstar = block_min64(lstar, sh64);
    if (pstar == n) pstar = 0;  // argmax of an all-false mask
    found = imin64(F, ntf);
    bool reached = F >= ntf;
    i64 stop_pos = pstar >= li ? pstar - li : nr - li + pstar;
    evaluated = skip ? 0 : (reached ? stop_pos + 1 : nr);
    for (int j = lo; j < hi; ++j) {
      int p = wk.mode == 1 ? min(max(wk.inv_perm[j], 0), n - 1) : j;
      cs.kept[j] = (FL[p] & FL_KEPTP) != 0;
    }
    __syncthreads();
  }

  // ---- scores: reductions over the kept set ------------------------------
  const bool do_na = ON(gate, W_NODEAFF) && pd.na;
  const bool do_tt = ON(gate, W_TAINT) && pd.tt;
  const bool do_sc = ON(gate, W_SPREAD) && pd.sc;
  const bool do_ic = ON(gate, W_INTERPOD) && pd.ipa_on;
  const bool do_gang = ON(gate, W_GANG) && gz && gmember;
  for (int z = tid; z < 2 * nd.z_pad; z += NTHREADS) cs.zs[z] = 0;
  __syncthreads();
  i64 l_na = LLONG_MIN, l_tt = LLONG_MIN, l_sc = LLONG_MIN;
  i64 l_icmax = LLONG_MIN, l_icmin = LLONG_MAX;
  int l_zone = 0;
  for (int j = lo; j < hi; ++j) {
    bool k = cs.kept[j];
    if (do_na) l_na = imax64(l_na, k ? pd.na[j] : 0);
    if (do_tt) l_tt = imax64(l_tt, k ? pd.tt[j] : 0);
    if (do_sc) {
      l_sc = imax64(l_sc, k ? pd.sc[j] : 0);
      int z = nd.zone_id[j];
      if (k && z > 0) {
        l_zone = 1;
        if (z < nd.z_pad) {
          atomicAdd((unsigned long long*)&cs.zs[z],
                    (unsigned long long)pd.sc[j]);
          cs.zs[nd.z_pad + z] = 1;
        }
      }
    }
    if (do_ic) {
      bool tr = pd.tracked[pd.tr_inert ? 0 : j];
      i64 icv = pd.ic[pd.ic_inert ? 0 : j];
      if (k && tr) {
        l_icmax = imax64(l_icmax, icv);
        l_icmin = imin64(l_icmin, icv);
      }
    }
  }
  const i64 na_max = block_max64(l_na, sh64);
  const i64 tt_max = block_max64(l_tt, sh64);
  const i64 mbn = block_max64(l_sc, sh64);
  const i64 ic_max = imax64(block_max64(l_icmax, sh64), 0);
  const i64 ic_min = imin64(block_min64(l_icmin, sh64), 0);
  const bool have_zones = block_sum64(l_zone, sh64) > 0;
  i64 mbz = 0;
  for (int z = 0; z < nd.z_pad; ++z)
    mbz = imax64(mbz, cs.zs[nd.z_pad + z] ? cs.zs[z] : 0);
  i64 cst = 0;
  if (ON(gate, W_TAINT) && !pd.tt) cst += w[W_TAINT] * MAX_PRIORITY;
  if (ON(gate, W_SPREAD) && !pd.sc) cst += w[W_SPREAD] * MAX_PRIORITY;

  i64 l_max = LLONG_MIN;
  for (int j = lo; j < hi; ++j) {
    i64 t = base ? base[j]
                 : local_total_one(gate, w, p_nz_cpu + nd.nz_cpu[j],
                                   p_nz_mem + nd.nz_mem[j], nd.alloc_cpu[j],
                                   nd.alloc_mem[j]);
    if (do_gang) {
      // min(members of this gang already in the node's zone, 10) x weight
      int z = nd.zone_id[j];
      if (z > 0)
        t += w[W_GANG] * imin64(z < nd.z_pad ? gz[z] : 0, MAX_PRIORITY);
    }
    if (do_na)
      t += w[W_NODEAFF] * (na_max == 0 ? pd.na[j]
                           : floordiv(MAX_PRIORITY * pd.na[j],
                                      imax64(na_max, 1)));
    if (do_tt)
      t += w[W_TAINT] * (tt_max == 0 ? MAX_PRIORITY
                         : MAX_PRIORITY - floordiv(MAX_PRIORITY * pd.tt[j],
                                                   imax64(tt_max, 1)));
    if (do_sc) {
      double f = mbn > 0 ? ratio10(mbn - pd.sc[j], mbn) : 10.0;
      int z = nd.zone_id[j];
      i64 zc = (z >= 0 && z < nd.z_pad) ? cs.zs[z] : 0;
      double zsc = mbz > 0 ? ratio10(mbz - zc, mbz) : 10.0;
      if (have_zones && z > 0)
        f = __dadd_rn(__dmul_rn(f, ONE_MINUS_ZW),
                      __dmul_rn(ZONE_WEIGHTING, zsc));
      t += w[W_SPREAD] * (i64)f;
    }
    if (do_ic) {
      bool tr = pd.tracked[pd.tr_inert ? 0 : j];
      i64 icv = pd.ic[pd.ic_inert ? 0 : j];
      i64 diff = ic_max - ic_min;
      t += w[W_INTERPOD] * ((diff > 0 && tr)
                            ? (i64)ratio10(icv - ic_min, diff) : 0);
    }
    if (!pd.local_in_base) t += cycle_row_local(pd, gate, w, j);
    t += cst;
    cs.total[j] = t;
    if (cs.kept[j]) l_max = imax64(l_max, t);
  }

  // ---- select: round-robin k-th tie in rotation order --------------------
  const i64 max_score = block_max64(l_max, sh64);
  int l_ties = 0;
  for (int j = lo; j < hi; ++j) {
    bool tie = cs.kept[j] && cs.total[j] == max_score;
    if (tie) {
      FL[j] |= FL_TIE;
      ++l_ties;
    }
  }
  const i64 num_ties = imax64(block_sum64(l_ties, sh64), 1);
  const i64 k = floormod(wk.lni, num_ties);
  i64 l_sel = n;
  if (wk.mode == 2) {
    // k-th smallest walk-relative position among the ties: count ties per
    // relative position, prefix-sum, find where the count passes k
    for (int j = lo; j < hi; ++j) A[j] = 0;
    __syncthreads();
    for (int j = lo; j < hi; ++j) {
      if (!(FL[j] & FL_TIE)) continue;
      i64 pj = wk.pos[j];
      i64 rel = pj >= li ? pj - li : nr - li + pj;
      if (rel >= 0 && rel < n) atomicAdd(&A[rel], 1);
    }
    __syncthreads();
    int lc = 0;
    for (int r = lo; r < hi; ++r) lc += A[r];
    int tot;
    int run = block_excl_scan(lc, sh32, &tot);
    i64 l_kth = LLONG_MAX;
    for (int r = lo; r < hi; ++r) {
      if (run <= k && k < run + A[r] && r < l_kth) l_kth = r;
      run += A[r];
    }
    const i64 kth = block_min64(l_kth, sh64);
    for (int j = lo; j < hi; ++j) {
      if (!(FL[j] & FL_TIE)) continue;
      i64 pj = wk.pos[j];
      i64 rel = pj >= li ? pj - li : nr - li + pj;
      if (rel == kth && j < l_sel) l_sel = j;
    }
  } else {
    int lt = 0;
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      lt += (FL[q] & FL_TIE) != 0;
    }
    int Ttot;
    int run = block_excl_scan(lt, sh32, &Ttot);
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      run += (FL[q] & FL_TIE) != 0;
      A[p] = run;
    }
    __syncthreads();
    const i64 preT = li > 0 ? A[li - 1] : 0;
    for (int p = lo; p < hi; ++p) {
      int q = wk.mode == 1 ? min(max(wk.perm[p], 0), n - 1) : p;
      if (!(FL[q] & FL_TIE)) continue;
      i64 trank = p >= li ? A[p] - preT : Ttot - preT + A[p];
      if (trank == k + 1 && p < l_sel) l_sel = p;
    }
  }
  i64 sel = block_min64(l_sel, sh64);
  if (sel == n) sel = 0;  // argmax of an all-false mask
  if (wk.mode == 1) sel = wk.perm[sel];
  CycleResult r;
  r.sel = found > 0 ? sel : -1;
  r.found = found;
  r.evaluated = evaluated;
  r.max_score = found > 0 ? max_score : 0;
  r.next_li = floormod(wk.last_index + evaluated, n_safe);
  r.next_lni = wk.lni + (found > 1 ? 1 : 0);
  r.any_resolvable = false;
  return r;
}

// One whole cycle: the filter of every node, then `cycle_select`. `ghost`
// (NULL = off: K2, K5, K6) is K8's carried nominated load; with it the
// result also says whether some in-range node is a preemption candidate.
__device__ __forceinline__ CycleResult cycle_run(
    const CycleNodes& nd, const CyclePod& pd, bool skip, const CycleWalk& wk,
    int gate, const i64* w, const i64* base, const i64* gz, bool gmember,
    const CycleScratch& cs, const CycleGhost* ghost = nullptr) {
  __shared__ i64 sh64[NWARPS];
  const int n = nd.n_pad;
  int lo, hi;
  my_range(n, &lo, &hi);
  int* FL = cs.scratch + n;
  const i64 nr = nd.n_real;
  int l_res = 0;
  for (int j = lo; j < hi; ++j) {
    i64 bits;
    int ff;
    const bool feasible = cycle_filter_row(nd, pd, skip, j, ghost, &bits,
                                           &ff);
    if (ghost && (i64)j < nr && !cycle_unresolvable(ff, bits)) l_res = 1;
    if (cs.general_bits) cs.general_bits[j] = bits;
    if (cs.fail_first) cs.fail_first[j] = (signed char)ff;
    if (cs.feasible) cs.feasible[j] = feasible;
    FL[j] = (feasible && (i64)j < nr) ? FL_FEAS : 0;
  }
  const bool any_res = ghost ? block_sum64(l_res, sh64) > 0 : false;
  __syncthreads();
  CycleResult r = cycle_select(nd, pd, skip, wk, gate, w, base, gz, gmember,
                               cs);
  r.any_resolvable = any_res;
  return r;
}

// ---- the gathered records of the sharded cycle (K9b, K10b, K11b) ----------
// Byte offsets of the planes in one shard's record (-1 = absent), in the
// order of `_REC_PLANES` (kubernetes_tpu_torch/ops/kernels.py).
struct RecLayout {
  i64 local, na, tt, sc, ic, zone, feas, tracked;
};

// Unpack the D shard records of `g` ([D, chunk] bytes, `rows` rows each)
// into flat [n] planes: p64 [5, n] (local, na, tt, sc, ic), zone, the
// tracked bytes, and the in-range feasible bit into FL = flags + n. Ends
// with a barrier.
__device__ __forceinline__ void unpack_records(const unsigned char* g,
                                               size_t chunk, int n, int rows,
                                               const RecLayout& o, i64* p64,
                                               int* zone, unsigned char* trk,
                                               int* FL) {
  const i64 offs[5] = {o.local, o.na, o.tt, o.sc, o.ic};
  // row j of the mesh is row j - s * rows of shard s's record
  for (int j = threadIdx.x; j < n; j += NTHREADS) {
    const int s = j / rows, jj = j - s * rows;
    const unsigned char* c = g + (size_t)s * chunk;
    for (int q = 0; q < 5; ++q)
      if (offs[q] >= 0)
        p64[(size_t)q * n + j] = ((const i64*)(c + offs[q]))[jj];
    if (o.zone >= 0) zone[j] = ((const int*)(c + o.zone))[jj];
    if (o.tracked >= 0) trk[j] = c[o.tracked + jj];
    FL[j] = c[o.feas + jj] ? FL_FEAS : 0;
  }
  __syncthreads();
}

// ---- the scan kernels' (K5, K6) launch arguments ---------------------------
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
  P_OID_SEQ, P_SPREAD, P_TOTAL, P_KEPT, P_FLAGS, P_ZS, P_STATS, P_PACKED,
  P_CARRY_OUT, P_SEG_START, P_GANG, P_GZ, P_LOG_NODE, P_LOG_ROW,
  // the pressure scan (K8) only; NULL for K5 and K6
  P_GHOST_CPU, P_GHOST_MEM, P_GHOST_EPH, P_GHOST_CNT, P_VIC_CPU, P_VIC_MEM,
  P_VIC_EPH, P_VIC_PRIO, P_VIC_START, P_VIC_VALID, P_VIC_VIOL, P_PPRIO,
  P_CARRY_IN, P_AGG_I64, P_AGG_F64, P_AGG_U8,
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

__device__ __forceinline__ CycleScratch scan_scratch(const ScanArgs& a) {
  CycleScratch cs;
  cs.total = mptr<i64>(a, P_TOTAL);
  cs.kept = mptr<unsigned char>(a, P_KEPT);
  cs.feasible = 0;
  cs.fail_first = 0;
  cs.general_bits = 0;
  cs.scratch = mptr<int>(a, P_FLAGS);
  cs.zs = mptr<i64>(a, P_ZS);
  return cs;
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
