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
