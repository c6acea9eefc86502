// Victim selection of one node and the five-criteria node pick, shared by
// K7 (preempt_scan.cu) and K8 (pressure_batch.cu).
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
//   - `pick_block`: one block reduces the aggregates of every node: the
//     zero-victim instant win, else the staged minimum of PDB violations,
//     first victim's priority, sum of (priority + 2^31), victim count and
//     -(earliest start of the highest-priority victims), each compared in
//     float64 exactly as JAX converts and compares them (a sum of 128
//     priorities + 2^31 would pass 2^53 only with priorities above 2^45;
//     comparing the converted values keeps the pick equal regardless),
//     then the lowest rank among what is left.
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

__device__ __forceinline__ double block_min_f64(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    double u = __shfl_down_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = sh[0];
  for (int i = 1; i < NWARPS; ++i) r = sh[i] < r ? sh[i] : r;
  return r;
}

// criterion c of node j, as JAX converts it to float64
__device__ __forceinline__ double pick_crit(const VictimAggPlanes& g, int n,
                                            int c, int j) {
  if (c == 0) return (double)g.i[n + j];       // PDB violations
  if (c == 1) return (double)g.i[2 * n + j];   // first victim's priority
  if (c == 2) return (double)g.i[3 * n + j];   // sum of priority + 2^31
  if (c == 3) return (double)g.i[j];           // victim count
  return -g.f[j];                              // latest earliest start
}

// The staged five-criteria filter (`_pick_one_node`'s loop): narrow the
// mask m[lo, hi) of this thread, criterion by criterion, to the rows tied
// at the block-wide minimum. Equals the lexicographic minimum of the five
// criteria over the rows m started with (IEEE `<` and `==`).
__device__ __forceinline__ void staged_filter(const VictimAggPlanes& g,
                                              int n, unsigned char* m,
                                              int lo, int hi, double* shd) {
  for (int c = 0; c < 5; ++c) {
    double lmin = dinf();
    for (int j = lo; j < hi; ++j) {
      if (!m[j]) continue;
      const double x = pick_crit(g, n, c, j);
      lmin = x < lmin ? x : lmin;
    }
    const double best = block_min_f64(lmin, shd);
    for (int j = lo; j < hi; ++j)
      if (m[j] && !(pick_crit(g, n, c, j) == best)) m[j] = 0;
  }
}

// pickOneNodeForPreemption over the n nodes whose aggregates `g` holds,
// by the whole block (blockDim.x == NTHREADS, every thread gets the
// result). `rank` (NULL = the axis index) breaks the last tie. Returns
// -1 when no node is a candidate.
__device__ __forceinline__ int pick_block(const VictimAggPlanes& g, int n,
                                          const i64* rank) {
  __shared__ i64 sh64[NWARPS];
  __shared__ double shd[NWARPS];
  const i64 BIGR = 1LL << 60;
  int lo, hi;
  my_range(n, &lo, &hi);
  unsigned char* m = g.u + n;
  int l_any = 0, l_zero = 0;
  for (int j = lo; j < hi; ++j) {
    const bool f = g.u[j] != 0;
    l_any |= f;
    l_zero |= f && g.i[j] == 0;
    m[j] = f;
  }
  const bool any_cand = block_sum64(l_any, sh64) > 0;
  const bool any_zero = block_sum64(l_zero, sh64) > 0;
  if (any_zero) {
    for (int j = lo; j < hi; ++j) m[j] = g.u[j] && g.i[j] == 0;
  } else {
    staged_filter(g, n, m, lo, hi, shd);
  }
  // argmin of where(mask, rank, 2^60), first index on ties
  i64 lk = LLONG_MAX;
  for (int j = lo; j < hi; ++j) {
    const i64 key = m[j] ? (rank ? rank[j] : (i64)j) : BIGR;
    lk = imin64(lk, key);
  }
  const i64 kmin = block_min64(lk, sh64);
  i64 li = LLONG_MAX;
  for (int j = lo; j < hi; ++j) {
    const i64 key = m[j] ? (rank ? rank[j] : (i64)j) : BIGR;
    if (key == kmin && j < li) li = j;
  }
  const i64 w = block_min64(li, sh64);
  return any_cand ? (int)w : -1;
}

// ---- the sharded pick (K13a/K14a reduce, K13b/K14b select) ---------------
// A shard's candidate record: the i64 slots below, the five criteria of
// its best row as float64, then that row's P slot flags as int32. Every
// slot is written on every reduction.
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

// Reduce the aggregates `g` of one shard's `rows` rows into the head of
// its candidate record `rec` (slots CR_ANY_FEAS..CR_VIOL and the five
// criteria; the caller writes CR_ANY_RES and the flags). A row's key is
// rank[j], or its global row offset + j when `rank` is NULL (the pressure
// wave's axis order). A lexicographic minimum decomposes over shards, so
// the D records decide the pick of `_pick_one_node` exactly, provided
// every candidate's key is below 2^60. By the whole block; returns (to
// every thread) the local row of the best candidate, -1 when none.
__device__ __forceinline__ int shard_candidate(const VictimAggPlanes& g,
                                               int rows, const i64* rank,
                                               i64 offset,
                                               unsigned char* rec) {
  __shared__ i64 sh64[NWARPS];
  __shared__ double shd[NWARPS];
  int lo, hi;
  my_range(rows, &lo, &hi);
  unsigned char* m = g.u + rows;
  int l_any = 0, l_zero = 0;
  i64 lz = LLONG_MAX;
  for (int j = lo; j < hi; ++j) {
    const bool f = g.u[j] != 0;
    const bool z = f && g.i[j] == 0;
    l_any |= f;
    l_zero |= z;
    m[j] = f;
    if (z) lz = imin64(lz, rank ? rank[j] : offset + j);
  }
  const bool any = block_sum64(l_any, sh64) > 0;
  const bool any_zero = block_sum64(l_zero, sh64) > 0;
  const i64 zkey = block_min64(lz, sh64);
  i64 lzi = LLONG_MAX;
  for (int j = lo; j < hi; ++j)
    if (g.u[j] && g.i[j] == 0 && (rank ? rank[j] : offset + j) == zkey)
      lzi = imin64(lzi, j);
  const i64 zj = block_min64(lzi, sh64);
  staged_filter(g, rows, m, lo, hi, shd);
  i64 lb = LLONG_MAX;
  for (int j = lo; j < hi; ++j)
    if (m[j]) lb = imin64(lb, rank ? rank[j] : offset + j);
  const i64 bkey = block_min64(lb, sh64);
  i64 lbi = LLONG_MAX;
  for (int j = lo; j < hi; ++j)
    if (m[j] && (rank ? rank[j] : offset + j) == bkey) lbi = imin64(lbi, j);
  const i64 bj = block_min64(lbi, sh64);
  const int best = (any && bj < rows) ? (int)bj : -1;
  if (threadIdx.x == 0) {
    i64* h = (i64*)rec;
    double* c = (double*)(rec + CR_CRIT_BYTES);
    h[CR_ANY_FEAS] = any;
    h[CR_ANY_ZERO] = any_zero;
    h[CR_ZKEY] = any_zero ? zkey : LLONG_MAX;
    h[CR_ZIDX] = any_zero ? offset + zj : -1;
    h[CR_BKEY] = best >= 0 ? bkey : LLONG_MAX;
    h[CR_BIDX] = best >= 0 ? offset + best : -1;
    h[CR_NV] = best >= 0 ? g.i[best] : 0;
    h[CR_VIOL] = best >= 0 ? g.i[rows + best] : 0;
    for (int q = 0; q < 5; ++q)
      c[q] = best >= 0 ? pick_crit(g, rows, q, best) : 0.0;
  }
  return best;
}

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
