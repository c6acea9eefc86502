// K2 schedule_cycle: one scheduling cycle of one pod over every node.
//
// Replaces `_feasibility` + `_fit_scores` + `_cycle_core` ->
// `schedule_cycle` (kubernetes_tpu/ops/kernels.py:296, :157, :359, :509):
// per-node predicate bits and the first failing predicate; the rotation
// walk from last_index as a cumsum with the num_to_find cutoff (identity,
// `perm` and gather-free `pos` modes); every weighted priority normalised
// over the kept set (node affinity, taint toleration, one-hot zone selector
// spread, inter-pod min-max, image locality, prefer-avoid, plus the K1
// resource families, which K1 computes into `base` just before); and the
// round-robin k-th tie select.
//
// Bound on the H100: latency. The bytes are ~150 B per node (14 node
// fields in, five per-node outputs), ~2.5 MB at n_pad 16,384, under 1 us
// at 3.35 TB/s; the work is a chain of whole-axis reductions and scans,
// each of which needs every node before the next can start. Design: ONE
// block of 1024 threads, each owning a contiguous slice of the axis, so a
// reduction or scan is a block barrier, not a launch; scratch and the zone
// tables live in global memory (L2).
#include "common.cuh"

#include <climits>

struct CArgs {
  int n_pad, S;
  i64 n_real;
  int z_pad;
  i64 last_index, lni, num_to_find;
  int mode, ipa_on, ic_inert, tr_inert;
  const unsigned char* valid;
  const i64 *alloc_cpu, *alloc_mem, *alloc_eph, *allowed, *req_cpu, *req_mem,
      *req_eph, *nz_cpu, *nz_mem, *pod_count, *alloc_scalar, *req_scalar_n;
  const int* zone_id;
  // per-node pod masks, NULL = inert (the family is skipped, as in JAX)
  const unsigned char *sel_ok, *taints_ok, *unsched_ok, *ports_ok, *host_ok,
      *disk_ok, *maxvol_ok, *volbind_ok, *volzone_ok;
  const signed char* ipa_code;
  // per-node score inputs, NULL = inert; ic/tracked may be one element
  const i64 *na, *tt, *sc, *ic, *img, *pa;
  const unsigned char* tracked;
  const i64* scal;  // req_cpu req_mem req_eph nz_cpu nz_mem has_request
                    // check_resources unknown_scalar skip profile_id
  const i64* req_scalar_p;
  int gate;
  const i64* w;
  const i64* base;
  const int *perm, *inv_perm, *pos;
  i64* total;
  unsigned char *kept, *feasible;
  signed char* fail_first;
  i64* general_bits;
  int* scratch;  // [2, n_pad]: prefix sums / tie-rank marks, node flags
  i64* zs;       // [2, z_pad]: zone counts, zone present
  i64* out;      // selected found evaluated max_score next_li next_lni
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

__global__ void __launch_bounds__(NTHREADS) schedule_cycle_kernel(CArgs a) {
  __shared__ i64 sh64[NWARPS];
  __shared__ int sh32[NWARPS];
  const int n = a.n_pad, tid = threadIdx.x;
  int lo, hi;
  my_range(n, &lo, &hi);
  int* A = a.scratch;
  int* FL = a.scratch + n;
  const i64 nr = a.n_real;
  const i64 n_safe = imax64(nr, 1);
  const i64 li = floormod(a.last_index, n_safe);
  const i64 ntf = a.num_to_find;
  const i64 p_req_cpu = a.scal[0], p_req_mem = a.scal[1],
            p_req_eph = a.scal[2];
  const bool check_res = a.scal[6] != 0;
  const bool has_req = a.scal[5] != 0 && check_res;
  const bool unknown = a.scal[7] != 0;
  const bool skip = a.scal[8] != 0;

  // ---- feasibility -------------------------------------------------------
  for (int j = lo; j < hi; ++j) {
    i64 bits = 0;
    if (check_res && a.pod_count[j] + 1 > a.allowed[j]) bits |= 1LL << 0;
    if (has_req && a.alloc_cpu[j] < p_req_cpu + a.req_cpu[j]) bits |= 1LL << 1;
    if (has_req && a.alloc_mem[j] < p_req_mem + a.req_mem[j]) bits |= 1LL << 2;
    if (has_req && a.alloc_eph[j] < p_req_eph + a.req_eph[j]) bits |= 1LL << 3;
    i64 sbits = 0;
    for (int s = 0; s < a.S; ++s) {
      i64 want = a.req_scalar_p[s];
      if (has_req && want > 0
          && a.alloc_scalar[(size_t)j * a.S + s]
                 < want + a.req_scalar_n[(size_t)j * a.S + s]
          && 4 + s < 64)
        sbits += 1LL << (4 + s);
    }
    bits |= sbits;
    if (check_res && unknown) bits |= 1LL << 59;
    if (a.host_ok && !a.host_ok[j]) bits |= 1LL << 60;
    if (a.ports_ok && !a.ports_ok[j]) bits |= 1LL << 61;
    if (a.sel_ok && !a.sel_ok[j]) bits |= 1LL << 62;
    // first failing predicate in PREDICATE_ORDERING (later overwrites win)
    int ff = 0;
    if (a.ipa_code && a.ipa_code[j] > 0) ff = 8;
    if (a.volzone_ok && !a.volzone_ok[j]) ff = 7;
    if (a.volbind_ok && !a.volbind_ok[j]) ff = 6;
    if (a.maxvol_ok && !a.maxvol_ok[j]) ff = 5;
    if (a.taints_ok && !a.taints_ok[j]) ff = 4;
    if (a.disk_ok && !a.disk_ok[j]) ff = 3;
    if (bits != 0) ff = 2;
    if (a.unsched_ok && !a.unsched_ok[j]) ff = 1;
    bool feasible = a.valid[j] && ff == 0 && !skip;
    a.general_bits[j] = bits;
    a.fail_first[j] = (signed char)ff;
    a.feasible[j] = feasible;
    FL[j] = (feasible && (i64)j < nr) ? FL_FEAS : 0;
  }
  __syncthreads();

  // ---- rotation walk -----------------------------------------------------
  i64 found, evaluated;
  if (a.mode == 2) {
    int lF = 0;
    for (int j = lo; j < hi; ++j) lF += FL[j] & FL_FEAS;
    i64 F = block_sum64(lF, sh64);
    for (int j = lo; j < hi; ++j) a.kept[j] = (FL[j] & FL_FEAS) != 0;
    found = imin64(F, ntf);
    evaluated = skip ? 0 : nr;
  } else {
    // position space: feas_p[p] = feas[perm[p]] (identity when mode 0)
    int lF = 0;
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
      lF += (FL[q] & FL_FEAS) != 0;
    }
    int Fi;
    int run = block_excl_scan(lF, sh32, &Fi);
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
      run += (FL[q] & FL_FEAS) != 0;
      A[p] = run;  // inclusive cumsum S
    }
    __syncthreads();
    const i64 F = Fi;
    const i64 pre = li > 0 ? A[li - 1] : 0;
    i64 lstar = n;  // first p with kept_p & rank == ntf
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
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
      int p = a.mode == 1 ? min(max(a.inv_perm[j], 0), n - 1) : j;
      a.kept[j] = (FL[p] & FL_KEPTP) != 0;
    }
    __syncthreads();
  }

  // ---- scores: reductions over the kept set ------------------------------
  const bool do_na = ON(a.gate, W_NODEAFF) && a.na;
  const bool do_tt = ON(a.gate, W_TAINT) && a.tt;
  const bool do_sc = ON(a.gate, W_SPREAD) && a.sc;
  const bool do_ic = ON(a.gate, W_INTERPOD) && a.ipa_on;
  for (int z = tid; z < 2 * a.z_pad; z += NTHREADS) a.zs[z] = 0;
  __syncthreads();
  i64 l_na = LLONG_MIN, l_tt = LLONG_MIN, l_sc = LLONG_MIN;
  i64 l_icmax = LLONG_MIN, l_icmin = LLONG_MAX;
  int l_zone = 0;
  for (int j = lo; j < hi; ++j) {
    bool k = a.kept[j];
    if (do_na) l_na = imax64(l_na, k ? a.na[j] : 0);
    if (do_tt) l_tt = imax64(l_tt, k ? a.tt[j] : 0);
    if (do_sc) {
      l_sc = imax64(l_sc, k ? a.sc[j] : 0);
      int z = a.zone_id[j];
      if (k && z > 0) {
        l_zone = 1;
        if (z < a.z_pad) {
          atomicAdd((unsigned long long*)&a.zs[z], (unsigned long long)a.sc[j]);
          a.zs[a.z_pad + z] = 1;
        }
      }
    }
    if (do_ic) {
      bool tr = a.tracked[a.tr_inert ? 0 : j];
      i64 icv = a.ic[a.ic_inert ? 0 : j];
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
  for (int z = 0; z < a.z_pad; ++z)
    mbz = imax64(mbz, a.zs[a.z_pad + z] ? a.zs[z] : 0);
  const i64* w = a.w;
  i64 cst = 0;
  if (ON(a.gate, W_TAINT) && !a.tt) cst += w[W_TAINT] * MAX_PRIORITY;
  if (ON(a.gate, W_SPREAD) && !a.sc) cst += w[W_SPREAD] * MAX_PRIORITY;
  if (ON(a.gate, W_AVOID) && !a.pa) cst += w[W_AVOID] * MAX_PRIORITY;

  i64 l_max = LLONG_MIN;
  for (int j = lo; j < hi; ++j) {
    i64 t = a.base[j];
    if (do_na)
      t += w[W_NODEAFF] * (na_max == 0 ? a.na[j]
                           : floordiv(MAX_PRIORITY * a.na[j],
                                      imax64(na_max, 1)));
    if (do_tt)
      t += w[W_TAINT] * (tt_max == 0 ? MAX_PRIORITY
                         : MAX_PRIORITY - floordiv(MAX_PRIORITY * a.tt[j],
                                                   imax64(tt_max, 1)));
    if (do_sc) {
      double f = mbn > 0 ? ratio10(mbn - a.sc[j], mbn) : 10.0;
      int z = a.zone_id[j];
      i64 zc = (z >= 0 && z < a.z_pad) ? a.zs[z] : 0;
      double zsc = mbz > 0 ? ratio10(mbz - zc, mbz) : 10.0;
      if (have_zones && z > 0)
        f = __dadd_rn(__dmul_rn(f, ONE_MINUS_ZW),
                      __dmul_rn(ZONE_WEIGHTING, zsc));
      t += w[W_SPREAD] * (i64)f;
    }
    if (do_ic) {
      bool tr = a.tracked[a.tr_inert ? 0 : j];
      i64 icv = a.ic[a.ic_inert ? 0 : j];
      i64 diff = ic_max - ic_min;
      t += w[W_INTERPOD] * ((diff > 0 && tr)
                            ? (i64)ratio10(icv - ic_min, diff) : 0);
    }
    if (ON(a.gate, W_IMAGE) && a.img) {
      i64 s = imin64(imax64(a.img[j], IMAGE_MIN), IMAGE_MAX);
      t += w[W_IMAGE] * floordiv(MAX_PRIORITY * (s - IMAGE_MIN),
                                 IMAGE_MAX - IMAGE_MIN);
    }
    if (ON(a.gate, W_AVOID) && a.pa) t += w[W_AVOID] * a.pa[j];
    t += cst;
    a.total[j] = t;
    if (a.kept[j]) l_max = imax64(l_max, t);
  }

  // ---- select: round-robin k-th tie in rotation order --------------------
  const i64 max_score = block_max64(l_max, sh64);
  int l_ties = 0;
  for (int j = lo; j < hi; ++j) {
    bool tie = a.kept[j] && a.total[j] == max_score;
    if (tie) {
      FL[j] |= FL_TIE;
      ++l_ties;
    }
  }
  const i64 num_ties = imax64(block_sum64(l_ties, sh64), 1);
  const i64 k = floormod(a.lni, num_ties);
  i64 l_sel = n;
  if (a.mode == 2) {
    // k-th smallest walk-relative position among the ties: count ties per
    // relative position, prefix-sum, find where the count passes k
    for (int j = lo; j < hi; ++j) A[j] = 0;
    __syncthreads();
    for (int j = lo; j < hi; ++j) {
      if (!(FL[j] & FL_TIE)) continue;
      i64 pj = a.pos[j];
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
      i64 pj = a.pos[j];
      i64 rel = pj >= li ? pj - li : nr - li + pj;
      if (rel == kth && j < l_sel) l_sel = j;
    }
  } else {
    int lt = 0;
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
      lt += (FL[q] & FL_TIE) != 0;
    }
    int Ttot;
    int run = block_excl_scan(lt, sh32, &Ttot);
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
      run += (FL[q] & FL_TIE) != 0;
      A[p] = run;
    }
    __syncthreads();
    const i64 preT = li > 0 ? A[li - 1] : 0;
    for (int p = lo; p < hi; ++p) {
      int q = a.mode == 1 ? min(max(a.perm[p], 0), n - 1) : p;
      if (!(FL[q] & FL_TIE)) continue;
      i64 trank = p >= li ? A[p] - preT : Ttot - preT + A[p];
      if (trank == k + 1 && p < l_sel) l_sel = p;
    }
  }
  i64 sel = block_min64(l_sel, sh64);
  if (sel == n) sel = 0;  // argmax of an all-false mask
  if (a.mode == 1) sel = a.perm[sel];
  if (tid == 0) {
    a.out[0] = found > 0 ? sel : -1;
    a.out[1] = found;
    a.out[2] = evaluated;
    a.out[3] = found > 0 ? max_score : 0;
    a.out[4] = floormod(a.last_index + evaluated, n_safe);
    a.out[5] = a.lni + (found > 1 ? 1 : 0);
  }
}

extern "C" int schedule_cycle_launch(
    int n_pad, int S, i64 n_real, int z_pad, i64 last_index, i64 lni,
    i64 num_to_find, int mode, int ipa_on, int ic_inert, int tr_inert,
    void** p, const void* scal, const void* req_scalar_p, int gate,
    const void* w, const void* base, const void* perm, const void* inv_perm,
    const void* pos, void* total, void* kept, void* feasible,
    void* fail_first, void* general_bits, void* scratch, void* zs, void* out,
    void* stream) {
  typedef const unsigned char* B;
  typedef const i64* L;
  CArgs a{n_pad, S, n_real, z_pad, last_index, lni, num_to_find, mode,
          ipa_on, ic_inert, tr_inert,
          (B)p[0], (L)p[1], (L)p[2], (L)p[3], (L)p[4], (L)p[5], (L)p[6],
          (L)p[7], (L)p[8], (L)p[9], (L)p[10], (L)p[11], (L)p[12],
          (const int*)p[13],
          (B)p[14], (B)p[15], (B)p[16], (B)p[17], (B)p[18], (B)p[19],
          (B)p[20], (B)p[21], (B)p[22], (const signed char*)p[23],
          (L)p[24], (L)p[25], (L)p[26], (L)p[27], (L)p[28], (L)p[29],
          (B)p[30],
          (L)scal, (L)req_scalar_p, gate, (L)w, (L)base, (const int*)perm,
          (const int*)inv_perm, (const int*)pos, (i64*)total,
          (unsigned char*)kept, (unsigned char*)feasible,
          (signed char*)fail_first, (i64*)general_bits, (int*)scratch,
          (i64*)zs, (i64*)out};
  schedule_cycle_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
