// Victim selection of one node and the five-criteria node pick, shared by
// K7 (preempt_scan.cu, through preempt_grid.cuh), K8 (pressure_batch.cu)
// and the mesh kernels K13a/b and K14a/b (shard_pressure_*.cu,
// shard_preempt_*.cu).
//
// Replaces `_victim_select` and `_pick_one_node`
// (kubernetes_tpu/ops/kernels.py:1494, :1570), the vmapped mirror of
// selectVictimsOnNode / pickOneNodeForPreemption (generic_scheduler.go
// :1054, :837):
//   - `victim_node`: ONE thread walks one node's P slots, which the host
//     sorted into the reprieve order (PDB-violating first, then priority
//     descending, start ascending). Pass 1 removes every slot of priority
//     below the preemptor's and checks the fit; pass 2 re-adds the slots
//     in order and keeps each one that still fits, carrying the freed
//     (cpu, mem, eph, pods) in registers. The slot mask keeps the host's
//     order because the sort key is monotone in priority, so the kernel
//     never sorts. It returns the node's aggregates and, on request, its
//     per-slot victim flags.
//   - the pick: the zero-victim instant win, else the staged minimum of
//     PDB violations, first victim's priority, sum of (priority + 2^31),
//     victim count and -(earliest start of the highest-priority victims),
//     each compared in float64 exactly as JAX converts and compares them (a
//     sum of 128 priorities + 2^31 would pass 2^53 only with priorities
//     above 2^45; comparing the converted values keeps the pick equal
//     regardless), then the lowest rank among what is left. Three forms:
//   - the candidate record (`CR_*`) and `pick_records` (K13a / K13b,
//     K14a / K14b): a shard's pick as a record, then the pick over the D
//     records (`pick_records_warp`: K14b's, by one warp);
//   - `VicBest` (K8, K13a): the pick by axis order as one reduction whose
//     partial results combine in any order, carried by warp shuffles and
//     cluster rounds;
//   - `PickRec` (K7, K14a): the same reduction keyed by (order_rank, row),
//     over the warps and blocks of one grid-wide launch
//     (preempt_grid.cuh).
//
// Numeric contract: int64 sums as JAX (wrapping), first-index argmax for
// the first victim (slot 0 when the node has none: its priority is read
// whatever the slot holds), +inf start padding and +inf for "no victim".
#pragma once

#include "common.cuh"

#include <climits>

__device__ __forceinline__ double dinf() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// the [n_pad, P] slot planes of the persistent victim table
struct VictimPlanes {
  int P;
  const i64 *cpu, *mem, *eph, *prio;
  const double* start;
  const unsigned char *valid, *viol;
};

// the node rows a victim scan reads (K8: the rows before this pod's
// fold) and the optional nominated-ghost load (NULL = none)
struct VictimRows {
  const i64 *alloc_cpu, *alloc_mem, *alloc_eph, *allowed;
  const i64 *req_cpu, *req_mem, *req_eph, *pod_count;
  const i64 *g_cpu, *g_mem, *g_eph, *g_cnt;
};

struct VictimPod {
  i64 req_cpu, req_mem, req_eph, max_prio;
  bool cr, hr;  // check_resources; has_request && check_resources
};

struct VictimAgg {
  bool feas0;
  i64 nv, viol_ct, first_prio, sum_prio;
  double earliest_high;
};

__device__ __forceinline__ bool victim_fits(const VictimRows& r, int j,
                                            const VictimPod& p, i64 rc,
                                            i64 rm, i64 re, i64 pc) {
  bool f = true;
  if (p.cr) f = f && pc + 1 <= r.allowed[j];
  if (p.hr)
    f = f && r.alloc_cpu[j] >= p.req_cpu + rc
        && r.alloc_mem[j] >= p.req_mem + rm
        && r.alloc_eph[j] >= p.req_eph + re;
  return f;
}

// selectVictimsOnNode for node j. `flags` (NULL or [P]) gets the victim
// bit of every slot.
__device__ __forceinline__ VictimAgg victim_node(int j, const VictimRows& r,
                                                 const VictimPlanes& v,
                                                 const VictimPod& p,
                                                 bool feas_static,
                                                 int* flags) {
  const size_t o = (size_t)j * v.P;
  i64 scpu = 0, smem = 0, seph = 0, nvic = 0;
  for (int s = 0; s < v.P; ++s) {
    if (v.valid[o + s] && v.prio[o + s] < p.max_prio) {
      scpu += v.cpu[o + s];
      smem += v.mem[o + s];
      seph += v.eph[o + s];
      ++nvic;
    }
  }
  i64 rc = r.req_cpu[j] - scpu, rm = r.req_mem[j] - smem,
      re = r.req_eph[j] - seph, pc = r.pod_count[j] - nvic;
  if (r.g_cpu) {
    rc += r.g_cpu[j];
    rm += r.g_mem[j];
    re += r.g_eph[j];
    pc += r.g_cnt[j];
  }
  VictimAgg a;
  a.feas0 = feas_static && victim_fits(r, j, p, rc, rm, re, pc);
  a.nv = a.viol_ct = a.sum_prio = 0;
  a.earliest_high = dinf();
  i64 high = LLONG_MIN;
  int first = -1;
  for (int s = 0; s < v.P; ++s) {
    const bool vval = v.valid[o + s] && v.prio[o + s] < p.max_prio;
    const i64 nrc = rc + v.cpu[o + s], nrm = rm + v.mem[o + s],
              nre = re + v.eph[o + s], npc = pc + (vval ? 1 : 0);
    const bool keep =
        vval && a.feas0 && victim_fits(r, j, p, nrc, nrm, nre, npc);
    if (keep) {
      rc = nrc;
      rm = nrm;
      re = nre;
      pc = npc;
    }
    const bool victim = vval && !keep && a.feas0;
    if (flags) flags[s] = victim ? 1 : 0;
    if (victim) {
      const i64 pr = v.prio[o + s];
      const double st = v.start[o + s];
      ++a.nv;
      a.viol_ct += v.viol[o + s] ? 1 : 0;
      if (first < 0) first = s;
      a.sum_prio += pr + (1LL << 31);
      // min start over the victims of the highest priority, kept online
      if (pr > high) {
        high = pr;
        a.earliest_high = st;
      } else if (pr == high && st < a.earliest_high) {
        a.earliest_high = st;
      }
    }
  }
  a.first_prio = v.prio[o + (first < 0 ? 0 : first)];
  return a;
}

__device__ __forceinline__ i64 warp_sum64(i64 x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// selectVictimsOnNode for node j by the 32 lanes of a warp, each calling it
// with the same j and returning the same aggregates: lane l holds slots l,
// l + 32, ..., so each plane's row is read once and coalesced where one
// thread would wait on every slot in turn. Pass 1 is a warp sum; pass 2's
// keep chain runs in every lane over the slots broadcast in order; the
// aggregates are warp reductions (the victims' priorities and starts
// combine chunk by chunk as the online loop of `victim_node` keeps them).
// `flags` (NULL or [P]) gets each slot's victim bit from the lane that
// holds it. Equal to `victim_node`.
__device__ __forceinline__ VictimAgg victim_node_warp(int j,
                                                      const VictimRows& r,
                                                      const VictimPlanes& v,
                                                      const VictimPod& p,
                                                      bool feas_static,
                                                      int* flags) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t o = (size_t)j * v.P;
  i64 scpu = 0, smem = 0, seph = 0, nvic = 0;
  for (int s = lane; s < v.P; s += 32) {
    if (v.valid[o + s] && v.prio[o + s] < p.max_prio) {
      scpu += v.cpu[o + s];
      smem += v.mem[o + s];
      seph += v.eph[o + s];
      ++nvic;
    }
  }
  i64 rc = r.req_cpu[j] - warp_sum64(scpu),
      rm = r.req_mem[j] - warp_sum64(smem),
      re = r.req_eph[j] - warp_sum64(seph),
      pc = r.pod_count[j] - warp_sum64(nvic);
  if (r.g_cpu) {
    rc += r.g_cpu[j];
    rm += r.g_mem[j];
    re += r.g_eph[j];
    pc += r.g_cnt[j];
  }
  VictimAgg a;
  a.feas0 = feas_static && victim_fits(r, j, p, rc, rm, re, pc);
  a.nv = a.viol_ct = a.sum_prio = 0;
  a.earliest_high = dinf();
  i64 high = LLONG_MIN;
  int first = -1;
  for (int s0 = 0; s0 < v.P; s0 += 32) {
    const int s = s0 + lane, n = v.P - s0 < 32 ? v.P - s0 : 32;
    const bool in = lane < n;
    const bool vval = in && v.valid[o + s] && v.prio[o + s] < p.max_prio;
    const i64 c = in ? v.cpu[o + s] : 0, m = in ? v.mem[o + s] : 0,
              e = in ? v.eph[o + s] : 0;
    bool kept = false;
    for (int k = 0; k < n; ++k) {
      const bool vk = __shfl_sync(full, vval, k);
      const i64 nrc = rc + __shfl_sync(full, c, k),
                nrm = rm + __shfl_sync(full, m, k),
                nre = re + __shfl_sync(full, e, k), npc = pc + (vk ? 1 : 0);
      const bool keep =
          vk && a.feas0 && victim_fits(r, j, p, nrc, nrm, nre, npc);
      if (keep) {
        rc = nrc;
        rm = nrm;
        re = nre;
        pc = npc;
      }
      if (lane == k) kept = keep;
    }
    const bool victim = vval && !kept && a.feas0;
    if (flags && in) flags[s] = victim ? 1 : 0;
    const unsigned vb = __ballot_sync(full, victim);
    a.nv += __popc(vb);
    a.viol_ct += __popc(__ballot_sync(full, victim && v.viol[o + s]));
    if (first < 0 && vb) first = s0 + __ffs(vb) - 1;
    const i64 pr = in ? v.prio[o + s] : 0;
    a.sum_prio += warp_sum64(victim ? pr + (1LL << 31) : 0);
    i64 hk = victim ? pr : LLONG_MIN;
    for (int q = 16; q > 0; q >>= 1)
      hk = imax64(hk, __shfl_xor_sync(full, hk, q));
    double ek = victim && pr == hk ? v.start[o + s] : dinf();
    for (int q = 16; q > 0; q >>= 1) {
      const double u = __shfl_xor_sync(full, ek, q);
      ek = u < ek ? u : ek;
    }
    // the chunk's highest victim priority and its earliest start, merged
    // as the online loop merges a victim
    if (hk > high) {
      high = hk;
      a.earliest_high = ek;
    } else if (hk == high && ek < a.earliest_high) {
      a.earliest_high = ek;
    }
  }
  a.first_prio = v.prio[o + (first < 0 ? 0 : first)];
  return a;
}

// aggregate planes of a scan: i64 [4, n] (nv, viol_ct, first_prio,
// sum_prio), f64 [n] earliest_high, u8 [2, n] (feas0, pick mask)
struct VictimAggPlanes {
  i64* i;
  double* f;
  unsigned char* u;
};

__device__ __forceinline__ void store_agg(const VictimAggPlanes& g, int n,
                                          int j, const VictimAgg& a) {
  g.i[j] = a.nv;
  g.i[n + j] = a.viol_ct;
  g.i[2 * n + j] = a.first_prio;
  g.i[3 * n + j] = a.sum_prio;
  g.f[j] = a.earliest_high;
  g.u[j] = a.feas0;
}

__device__ __forceinline__ VictimAgg load_agg(const VictimAggPlanes& g,
                                              int n, int j) {
  VictimAgg a;
  a.nv = g.i[j];
  a.viol_ct = g.i[n + j];
  a.first_prio = g.i[2 * n + j];
  a.sum_prio = g.i[3 * n + j];
  a.earliest_high = g.f[j];
  a.feas0 = g.u[j] != 0;
  return a;
}

// ---- the sharded pick (K13a/K14a reduce, K13b/K14b select) ---------------
// A shard's candidate record: the i64 slots below, the five criteria of
// its best row as float64, then that row's P slot flags as int32. Every
// slot is written on every reduction. The best row is the one of lowest
// (key, row) among the rows at the lexicographic minimum of the five
// criteria; a lexicographic minimum decomposes over shards, so the D
// records decide the pick of `_pick_one_node` exactly, provided every
// candidate's key is below 2^60.
enum {
  CR_ANY_FEAS,  // some row of the shard is a candidate (feas0)
  CR_ANY_ZERO,  // some candidate row has no victim
  CR_ZKEY,      // the lowest key among zero-victim rows (I64 max: none)
  CR_ZIDX,      // its global row, the lowest on a key tie (-1: none)
  CR_BKEY,      // the lowest key among the rows tied at the shard's
  CR_BIDX,      // lexicographic minimum of the five criteria, and its row
  CR_NV,        // that row's victim count
  CR_VIOL,      // and PDB-violation count
  CR_ANY_RES,   // K13: some in-range row's first failure is resolvable
  CR_I64
};
constexpr int CR_CRIT_BYTES = CR_I64 * 8;         // 5 x f64 from here
constexpr int CR_FLAG_BYTES = CR_CRIT_BYTES + 40;  // P x i32 from here
// A record is CR_FLAG_BYTES + 4 P bytes (`cand_record_bytes`,
// kubernetes_tpu_torch/ops/kernels.py); P is even, so every shard's
// record in a gathered buffer starts 8-byte aligned.

// The candidate record at byte `off` of shard s's gathered record
__device__ __forceinline__ const unsigned char* cand_at(
    const unsigned char* gathered, size_t chunk, size_t off, int s) {
  return gathered + (size_t)s * chunk + off;
}

// whether candidate record a's five criteria are lexicographically below
// (-1), equal to (0) or above (1) b's, with IEEE `<` and `==`
__device__ __forceinline__ int crit_order(const unsigned char* a,
                                          const unsigned char* b) {
  const double* x = (const double*)(a + CR_CRIT_BYTES);
  const double* y = (const double*)(b + CR_CRIT_BYTES);
  for (int q = 0; q < 5; ++q) {
    if (x[q] < y[q]) return -1;
    if (!(x[q] == y[q])) return 1;
  }
  return 0;
}

struct CandPick {
  i64 winner;  // global row, -1 when no node is a candidate
  int src;     // the shard whose record holds the winner's flags (-1:
               // a zero-victim winner or none: every flag 0)
  i64 nv, viol;
  bool any_res;  // the OR of the shards' CR_ANY_RES
};

// pickOneNodeForPreemption over the D shards' candidate records: no
// candidate anywhere -> -1; a zero-victim row anywhere -> the lowest
// (key, row) of them; else the shards at the lexicographic minimum of the
// five criteria, and among them the lowest (key, row). One thread.
__device__ __forceinline__ CandPick pick_records(const unsigned char* g,
                                                size_t chunk, size_t off,
                                                int D) {
  CandPick p{-1, -1, 0, 0, false};
  bool any = false, any_zero = false;
  for (int s = 0; s < D; ++s) {
    const i64* h = (const i64*)cand_at(g, chunk, off, s);
    any |= h[CR_ANY_FEAS] != 0;
    any_zero |= h[CR_ANY_ZERO] != 0;
    p.any_res |= h[CR_ANY_RES] != 0;
  }
  if (!any) return p;
  int best = -1;
  for (int s = 0; s < D; ++s) {
    const unsigned char* r = cand_at(g, chunk, off, s);
    const i64* h = (const i64*)r;
    if (any_zero) {
      if (!h[CR_ANY_ZERO]) continue;
      const i64* b = best < 0 ? 0 : (const i64*)cand_at(g, chunk, off, best);
      if (!b || h[CR_ZKEY] < b[CR_ZKEY]
          || (h[CR_ZKEY] == b[CR_ZKEY] && h[CR_ZIDX] < b[CR_ZIDX]))
        best = s;
      continue;
    }
    if (!h[CR_ANY_FEAS]) continue;
    if (best < 0) {
      best = s;
      continue;
    }
    const unsigned char* br = cand_at(g, chunk, off, best);
    const i64* b = (const i64*)br;
    const int o = crit_order(r, br);
    if (o < 0 || (o == 0 && (h[CR_BKEY] < b[CR_BKEY]
                             || (h[CR_BKEY] == b[CR_BKEY]
                                 && h[CR_BIDX] < b[CR_BIDX]))))
      best = s;
  }
  const i64* h = (const i64*)cand_at(g, chunk, off, best);
  if (any_zero) {
    p.winner = h[CR_ZIDX];
  } else {
    p.winner = h[CR_BIDX];
    p.src = best;
    p.nv = h[CR_NV];
    p.viol = h[CR_VIOL];
  }
  return p;
}

// the P slot flags of a pick: the winning shard's flags, or zeros
__device__ __forceinline__ void pick_flags(const unsigned char* g,
                                           size_t chunk, size_t off,
                                           const CandPick& p, int P,
                                           int* out) {
  const int* f = p.src < 0 ? 0
      : (const int*)(cand_at(g, chunk, off, p.src) + CR_FLAG_BYTES);
  for (int s = threadIdx.x; s < P; s += blockDim.x) out[s] = f ? f[s] : 0;
}

// ---- the pick as one lexicographic reduction (K8, K13a) -------------------
// pickOneNodeForPreemption by axis order as a reduction whose partial
// results combine in any order over any split of the rows: the lowest key
// among the zero-victim candidates, and the candidate at the lexicographic
// minimum of (the five criteria, key). `_pick_one_node`'s staged filter
// keeps exactly the rows at the lexicographic minimum of the five
// criteria (IEEE `<` and `==`; no criterion is NaN: counts, sums and
// starts are finite or +inf), and among them the lowest key wins, so the
// two agree. Some row is a candidate exactly when a best one exists.
// The key is the row's global index.
struct VicBest {
  i64 zkey;     // the lowest key among zero-victim candidates (I64 max: none)
  i64 bkey;     // the best candidate's key (I64 max: no candidate)
  double c[5];  // its five criteria, as JAX converts them
};
constexpr int VB_WORDS = 7;  // int64 words of a VicBest

__device__ __forceinline__ VicBest vic_none() {
  VicBest v;
  v.zkey = v.bkey = LLONG_MAX;
  for (int q = 0; q < 5; ++q) v.c[q] = 0.0;
  return v;
}

// whether a's best candidate comes before b's
__device__ __forceinline__ bool vic_before(const VicBest& a,
                                           const VicBest& b) {
  if (a.bkey == LLONG_MAX) return false;
  if (b.bkey == LLONG_MAX) return true;
  for (int q = 0; q < 5; ++q) {
    if (a.c[q] < b.c[q]) return true;
    if (!(a.c[q] == b.c[q])) return false;
  }
  return a.bkey < b.bkey;
}

__device__ __forceinline__ VicBest vic_comb(const VicBest& a,
                                            const VicBest& b) {
  VicBest r = vic_before(b, a) ? b : a;
  r.zkey = imin64(a.zkey, b.zkey);
  return r;
}

// row `key`, whose victim scan gave `a`, added to v
__device__ __forceinline__ void vic_add(VicBest& v, const VictimAgg& a,
                                        i64 key) {
  if (!a.feas0) return;
  if (a.nv == 0) v.zkey = imin64(v.zkey, key);
  VicBest c;
  c.zkey = LLONG_MAX;
  c.bkey = key;
  c.c[0] = (double)a.viol_ct;
  c.c[1] = (double)a.first_prio;
  c.c[2] = (double)a.sum_prio;
  c.c[3] = (double)a.nv;
  c.c[4] = -a.earliest_high;
  if (vic_before(c, v)) {
    v.bkey = key;
    for (int q = 0; q < 5; ++q) v.c[q] = c.c[q];
  }
}

// the pick: -1 when no row is a candidate, else the zero-victim key, else
// the best candidate's
__device__ __forceinline__ i64 vic_winner(const VicBest& v) {
  return v.bkey == LLONG_MAX ? -1 : v.zkey != LLONG_MAX ? v.zkey : v.bkey;
}

// the lanes' candidates combined, in every lane (`vic_comb` is
// commutative: no two candidates share a key)
__device__ __forceinline__ VicBest warp_vic(VicBest v) {
  for (int o = 16; o > 0; o >>= 1) {
    VicBest u;
    u.zkey = __shfl_xor_sync(0xffffffffu, v.zkey, o);
    u.bkey = __shfl_xor_sync(0xffffffffu, v.bkey, o);
    for (int q = 0; q < 5; ++q)
      u.c[q] = __shfl_xor_sync(0xffffffffu, v.c[q], o);
    v = vic_comb(v, u);
  }
  return v;
}

// A K8 pod's victim scan as its cycle's select round reads it: the
// aggregates of every node, indexed by global node (`store_agg` planes of
// stride n), and the cluster's pick, which the round writes into `best`.
struct PickScan {
  VictimAggPlanes g;
  int n;
  VicBest best;
};

// a VicBest as VB_WORDS int64 words `stride` apart, and back
__device__ __forceinline__ void vic_store(i64* w, const VicBest& v,
                                          int stride) {
  w[0] = v.zkey;
  w[stride] = v.bkey;
  for (int q = 0; q < 5; ++q)
    w[(2 + q) * stride] = __double_as_longlong(v.c[q]);
}

__device__ __forceinline__ VicBest vic_load(const i64* w, int stride) {
  VicBest v;
  v.zkey = w[0];
  v.bkey = w[stride];
  for (int q = 0; q < 5; ++q)
    v.c[q] = __longlong_as_double(w[(2 + q) * stride]);
  return v;
}

// ---- the pick as one reduction keyed by (rank, row) (K7) ------------------
// pickOneNodeForPreemption as `VicBest`'s reduction, with the key the
// caller's `order_rank`, which any int64 may be: ties of the key go to the
// lower row, as JAX's argmin takes the first index, so a record carries
// (key, row) and never packs them into one word. The lowest (key, row)
// among the zero-victim candidates, and the candidate at the lexicographic
// minimum of (the five criteria, key, row); a row of -1 marks none.
// Equals `_pick_one_node` provided every candidate's key is below 2^60
// (its mask fill). Held as PK_WORDS int64 words (the criteria by their
// bits), so that a shuffle or a record moves it word by word.
enum { PK_ZKEY, PK_ZROW, PK_BKEY, PK_BROW, PK_CRIT, PK_WORDS = PK_CRIT + 5 };

struct PickRec {
  i64 w[PK_WORDS];
  __device__ double crit(int q) const {
    return __longlong_as_double(w[PK_CRIT + q]);
  }
};

__device__ __forceinline__ PickRec pick_none() {
  PickRec v;
  v.w[PK_ZKEY] = v.w[PK_BKEY] = LLONG_MAX;
  v.w[PK_ZROW] = v.w[PK_BROW] = -1;
#pragma unroll
  for (int q = 0; q < 5; ++q) v.w[PK_CRIT + q] = 0;
  return v;
}

// whether a's best candidate comes before b's
__device__ __forceinline__ bool pick_before(const PickRec& a,
                                            const PickRec& b) {
  if (a.w[PK_BROW] < 0) return false;
  if (b.w[PK_BROW] < 0) return true;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (a.crit(q) < b.crit(q)) return true;
    if (!(a.crit(q) == b.crit(q))) return false;
  }
  return a.w[PK_BKEY] < b.w[PK_BKEY]
         || (a.w[PK_BKEY] == b.w[PK_BKEY] && a.w[PK_BROW] < b.w[PK_BROW]);
}

__device__ __forceinline__ PickRec pick_comb(const PickRec& a,
                                             const PickRec& b) {
  PickRec r = pick_before(b, a) ? b : a;
  const bool bz = b.w[PK_ZROW] >= 0
      && (a.w[PK_ZROW] < 0 || b.w[PK_ZKEY] < a.w[PK_ZKEY]
          || (b.w[PK_ZKEY] == a.w[PK_ZKEY] && b.w[PK_ZROW] < a.w[PK_ZROW]));
  r.w[PK_ZKEY] = bz ? b.w[PK_ZKEY] : a.w[PK_ZKEY];
  r.w[PK_ZROW] = bz ? b.w[PK_ZROW] : a.w[PK_ZROW];
  return r;
}

// row `row` of key `key`, whose victim scan gave `a`, added to v;
// whether the row is now v's best candidate
__device__ __forceinline__ bool pick_add(PickRec& v, const VictimAgg& a,
                                         i64 key, i64 row) {
  if (!a.feas0) return false;
  PickRec c = pick_none();
  if (a.nv == 0) {
    c.w[PK_ZKEY] = key;
    c.w[PK_ZROW] = row;
  }
  c.w[PK_BKEY] = key;
  c.w[PK_BROW] = row;
  c.w[PK_CRIT] = __double_as_longlong((double)a.viol_ct);
  c.w[PK_CRIT + 1] = __double_as_longlong((double)a.first_prio);
  c.w[PK_CRIT + 2] = __double_as_longlong((double)a.sum_prio);
  c.w[PK_CRIT + 3] = __double_as_longlong((double)a.nv);
  c.w[PK_CRIT + 4] = __double_as_longlong(-a.earliest_high);
  const bool best = pick_before(c, v);
  v = pick_comb(v, c);
  return best;
}

// the pick: -1 when no row is a candidate, else the zero-victim row, else
// the best candidate's
__device__ __forceinline__ i64 pick_winner(const PickRec& v) {
  return v.w[PK_BROW] < 0 ? -1
         : v.w[PK_ZROW] >= 0 ? v.w[PK_ZROW] : v.w[PK_BROW];
}

// the lanes' records combined, in every lane (`pick_comb` is commutative:
// no two candidates share a row)
__device__ __forceinline__ PickRec warp_pick(PickRec v) {
  for (int o = 16; o > 0; o >>= 1) {
    PickRec u;
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w)
      u.w[w] = __shfl_xor_sync(0xffffffffu, v.w[w], o);
    v = pick_comb(v, u);
  }
  return v;
}

// `pick_records` by the 32 lanes of one warp, every lane returning the
// same pick: lane l takes the records l, l + 32, ... as `PickRec`s (a
// record's zero-victim key and row, its best's key, row and criteria, each
// read past L1), and the lanes combine them by shuffles. `PickRec`'s
// order is `pick_records`'s: a zero-victim row anywhere wins at the lowest
// (key, row), else the lowest (criteria, key, row); the winner's record
// is the one whose best row it is (rows are global: no two shards share
// one).
__device__ __forceinline__ CandPick pick_records_warp(
    const unsigned char* g, size_t chunk, size_t off, int D) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  PickRec r = pick_none();
  int mine = -1;  // the record of this lane's best candidate
  bool any_res = false;
  for (int s = lane; s < D; s += 32) {
    const unsigned char* rec = cand_at(g, chunk, off, s);
    const i64* h = (const i64*)rec;
    const i64* c = (const i64*)(rec + CR_CRIT_BYTES);
    PickRec u = pick_none();
    if (__ldcg(h + CR_ANY_ZERO)) {
      u.w[PK_ZKEY] = __ldcg(h + CR_ZKEY);
      u.w[PK_ZROW] = __ldcg(h + CR_ZIDX);
    }
    if (__ldcg(h + CR_ANY_FEAS)) {
      u.w[PK_BKEY] = __ldcg(h + CR_BKEY);
      u.w[PK_BROW] = __ldcg(h + CR_BIDX);
#pragma unroll
      for (int q = 0; q < 5; ++q) u.w[PK_CRIT + q] = __ldcg(c + q);
    }
    any_res |= __ldcg(h + CR_ANY_RES) != 0;
    if (pick_before(u, r)) mine = s;
    r = pick_comb(r, u);
  }
  const i64 brow = r.w[PK_BROW];
  r = warp_pick(r);
  const unsigned who = __ballot_sync(full, r.w[PK_BROW] >= 0
                                                && brow == r.w[PK_BROW]);
  const int best = __shfl_sync(full, mine, who ? __ffs(who) - 1 : 0);
  CandPick p{pick_winner(r), -1, 0, 0, __any_sync(full, any_res) != 0};
  if (p.winner >= 0 && r.w[PK_ZROW] < 0) {
    // the best candidate wins: its record's counts and flags
    const i64* h = (const i64*)cand_at(g, chunk, off, best);
    p.src = best;
    p.nv = __ldcg(h + CR_NV);
    p.viol = __ldcg(h + CR_VIOL);
  }
  return p;
}
