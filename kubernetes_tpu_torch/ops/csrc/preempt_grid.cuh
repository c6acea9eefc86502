// The grid-wide victim scan and pick of one preemptor, as device code
// shared by K7 (preempt_scan.cu: one launch over the whole node axis) and
// K14a (shard_preempt_local.cu: one launch over every shard a card holds).
//
// A thread takes a node and a warp 32 consecutive nodes, which it walks
// together:
//   - `k7_stage` copies the warp's rows of the five wide victim planes into
//     shared memory, K7_CS slots at a time, by asynchronous copies
//     (cp.async) that the lanes issue on consecutive elements (coalesced)
//     to slot-major places, all in flight at once; meanwhile each lane
//     loads its own row's valid and violating bytes (16 at a time);
//   - `k7_node` walks one node's slots (`victim_node`'s arithmetic,
//     victim.cuh) from shared memory without a bank conflict, and keeps
//     its victim flags in registers (P <= K7_PMAX bits);
//   - the pick is `PickRec`'s lexicographic minimum (victim.cuh): each
//     lane folds its nodes and keeps its best node's flags, the warp
//     combines its lanes by shuffles, the block its warps, and writes one
//     record with the best's flags (`k7_scan_block`);
//   - each block then fences and draws a ticket; the block that draws the
//     last one reads every record past L1 and combines them
//     (`k7_last_pick`). No aggregate plane goes to global memory and no
//     row is walked twice.
#pragma once

#include "victim.cuh"

#include <cuda_pipeline.h>

// warps of a block, threads of a block (`PREEMPT_THREADS` in kernels.py),
// slots of a staged chunk, the words of a staged slot (32 nodes and one
// more, so that the staging copies meet no bank twice), the victim slots
// a record's flags hold, and the int64 words of a block's record (the
// pick, then its best node's flags; `PREEMPT_RECORD_WORDS` in kernels.py)
constexpr int K7_WARPS = 2;
constexpr int K7_THREADS = 32 * K7_WARPS;
constexpr int K7_CS = 16;
constexpr int K7_LD = 33;
constexpr int K7_PMAX = 128;
constexpr int K7_FLAG_WORDS = K7_PMAX / 64;
constexpr int K7_WORDS = PK_WORDS + K7_FLAG_WORDS;

// a warp's 32 nodes x K7_CS slots of the five wide victim planes,
// slot-major: a lane reads its node's slot s from a row of its own bank
struct K7Tile {
  i64 cpu[K7_CS][K7_LD], mem[K7_CS][K7_LD], eph[K7_CS][K7_LD],
      prio[K7_CS][K7_LD];
  double start[K7_CS][K7_LD];
};

// a node's victim flags, one bit a slot (two words, held in registers)
struct K7Flags {
  unsigned long long w[K7_FLAG_WORDS];
};
static_assert(K7_FLAG_WORDS == 2, "a node's flags are two words");

// a block's shared memory: its warps' tiles, their picks and their best
// nodes' flags, whether it drew the last ticket, and (the last block)
// the warp whose flags are the pick's best node's
struct K7Shared {
  K7Tile tile[K7_WARPS];
  PickRec wrec[K7_WARPS];
  K7Flags wflags[K7_WARPS];
  int last, src;
};

// Slots [c0, c0 + cs) of the warp's nodes [j0, j0 + 32) into its tile:
// the lanes copy consecutive elements of each plane (asynchronously, to
// their slot-major places). Every lane of the warp calls it; `k7_wait`
// ends the copies. FULL: every chunk holds K7_CS slots (P a multiple of
// it), known to the compiler.
template <bool FULL>
__device__ __forceinline__ void k7_stage(K7Tile& t, const VictimPlanes& v,
                                         int n, int j0, int c0, int cs,
                                         int lane) {
  if (FULL) cs = K7_CS;
  __syncwarp();  // every lane is done with the previous chunk
#pragma unroll 4
  for (int e = lane; e < 32 * cs; e += 32) {
    const int row = e / cs, s = e - row * cs;
    if (j0 + row >= n) continue;
    const size_t g = (size_t)(j0 + row) * v.P + c0 + s;
    __pipeline_memcpy_async(&t.cpu[s][row], v.cpu + g, 8);
    __pipeline_memcpy_async(&t.mem[s][row], v.mem + g, 8);
    __pipeline_memcpy_async(&t.eph[s][row], v.eph + g, 8);
    __pipeline_memcpy_async(&t.prio[s][row], v.prio + g, 8);
    __pipeline_memcpy_async(&t.start[s][row], v.start + g, 8);
  }
  __pipeline_commit();
}

__device__ __forceinline__ void k7_wait() {
  __pipeline_wait_prior(0);
  __syncwarp();  // every lane's copies have landed
}

// one bit a nonzero byte of the 16 bytes in x
__device__ __forceinline__ unsigned k7_byte_bits(uint4 x) {
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
  unsigned b = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    b |= ((w[k >> 2] >> (8 * (k & 3))) & 0xffu ? 1u : 0u) << k;
  return b;
}

// the bits of slots [c0, c0 + cs) of byte plane `p`'s row j: one 16-byte
// load where aligned, else a byte at a time
__device__ __forceinline__ unsigned k7_bits(const unsigned char* p, int P,
                                            int j, int c0, int cs) {
  const unsigned char* q = p + (size_t)j * P + c0;
  if (cs == 16 && ((size_t)q & 15) == 0)
    return k7_byte_bits(*(const uint4*)q);
  unsigned b = 0;
  for (int s = 0; s < cs; ++s) b |= (q[s] ? 1u : 0u) << s;
  return b;
}

// selectVictimsOnNode for node j0 + lane (`victim_node`, victim.cuh, on
// the slots the warp stages; no nominated ghost), and its victim flags.
// Every lane of the warp calls it; a lane past the node axis returns no
// candidate. FULL as `k7_stage`: the slot loops unroll.
template <bool FULL>
__device__ __forceinline__ VictimAgg k7_node(K7Tile& t, const VictimRows& r,
                                             const VictimPlanes& v,
                                             const VictimPod& p,
                                             bool feas_static, int n,
                                             int j0, int lane,
                                             K7Flags* flags) {
  const int j = j0 + lane, P = v.P;
  const bool live = j < n, one = P <= K7_CS;
  // the node's rows, loaded while the first chunk's copies fly
  i64 rc = 0, rm = 0, re = 0, pc = 0, acpu = 0, amem = 0, aeph = 0,
      allowed = 0;
  if (live) {
    rc = r.req_cpu[j];
    rm = r.req_mem[j];
    re = r.req_eph[j];
    pc = r.pod_count[j];
    acpu = r.alloc_cpu[j];
    amem = r.alloc_mem[j];
    aeph = r.alloc_eph[j];
    allowed = r.allowed[j];
  }
  unsigned vb = 0, xb = 0;  // this chunk's valid and violating bits
  // pass 1: every potential victim removed
  i64 scpu = 0, smem = 0, seph = 0, nvic = 0, prio0 = 0;
  for (int c0 = 0; c0 < P; c0 += K7_CS) {
    const int cs = FULL ? K7_CS : min(K7_CS, P - c0);
    if (!one || c0 == 0) {
      k7_stage<FULL>(t, v, n, j0, c0, cs, lane);
      if (live) {
        vb = k7_bits(v.valid, P, j, c0, cs);
        xb = k7_bits(v.viol, P, j, c0, cs);
      }
      k7_wait();
    }
    if (c0 == 0) prio0 = t.prio[0][lane];
#pragma unroll
    for (int s = 0; s < cs; ++s)
      if (((vb >> s) & 1) && t.prio[s][lane] < p.max_prio) {
        scpu += t.cpu[s][lane];
        smem += t.mem[s][lane];
        seph += t.eph[s][lane];
        ++nvic;
      }
  }
  // the fit's running totals: the pod's request plus the node's load
  // (req + (rc + c) == (req + rc) + c in wrapping int64, so the request is
  // added once), the pod count plus one
  i64 tc = p.req_cpu + (rc - scpu), tm = p.req_mem + (rm - smem),
      te = p.req_eph + (re - seph), tk = pc - nvic + 1;
  auto fits = [&](i64 c, i64 m, i64 e, i64 k) -> bool {
    bool f = true;
    if (p.cr) f = f && k <= allowed;
    if (p.hr) f = f && acpu >= c && amem >= m && aeph >= e;
    return f;
  };
  VictimAgg a;
  a.feas0 = live && feas_static && fits(tc, tm, te, tk);
  a.nv = a.viol_ct = a.sum_prio = 0;
  a.earliest_high = dinf();
  a.first_prio = prio0;
  unsigned long long f0 = 0, f1 = 0;  // the victim flags, slots 0-63, 64-127
  i64 high = LLONG_MIN;
  bool found = false;
  // pass 2: the reprieve walk in the host's order
  for (int c0 = 0; c0 < P; c0 += K7_CS) {
    const int cs = FULL ? K7_CS : min(K7_CS, P - c0);
    if (!one) {
      k7_stage<FULL>(t, v, n, j0, c0, cs, lane);
      if (live) {
        vb = k7_bits(v.valid, P, j, c0, cs);
        xb = k7_bits(v.viol, P, j, c0, cs);
      }
      k7_wait();
    }
#pragma unroll
    for (int s = 0; s < cs; ++s) {
      const i64 pr = t.prio[s][lane];
      const bool vval = ((vb >> s) & 1) && pr < p.max_prio;
      const i64 nc = tc + t.cpu[s][lane],
                nm = tm + t.mem[s][lane],
                ne = te + t.eph[s][lane], nk = tk + (vval ? 1 : 0);
      const bool keep = vval && a.feas0 && fits(nc, nm, ne, nk);
      if (keep) {
        tc = nc;
        tm = nm;
        te = ne;
        tk = nk;
      }
      if (vval && !keep && a.feas0) {
        const double st = t.start[s][lane];
        const int slot = c0 + s;
        if (slot < 64)
          f0 |= 1ull << slot;
        else
          f1 |= 1ull << (slot - 64);
        ++a.nv;
        a.viol_ct += (xb >> s) & 1;
        if (!found) a.first_prio = pr;
        found = true;
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
  }
  flags->w[0] = f0;
  flags->w[1] = f1;
  return a;
}

// The warps' picks and their best nodes' flags (in `wrec`, `wflags`)
// combined by one thread: the pick, and in `*src` the warp whose flags
// are its best's (-1: no candidate)
__device__ __forceinline__ PickRec block_pick(const PickRec* wrec,
                                              int* src) {
  PickRec r = wrec[0];
  *src = 0;
  for (int k = 1; k < K7_WARPS; ++k) {
    if (pick_before(wrec[k], r)) *src = k;
    r = pick_comb(r, wrec[k]);
  }
  if (r.w[PK_BROW] < 0) *src = -1;
  return r;
}

// A warp's pick of its lanes' (`r`, each lane's best node's flags
// `best`) into wrec[wid] and wflags[wid]
__device__ __forceinline__ void warp_record(PickRec r, const K7Flags& best,
                                            PickRec* wrec, K7Flags* wflags,
                                            int lane, int wid) {
  const i64 mine = r.w[PK_BROW];
  r = warp_pick(r);
  if (lane == 0) wrec[wid] = r;
  if (r.w[PK_BROW] >= 0 && r.w[PK_BROW] == mine) wflags[wid] = best;
}

// One block's part of a grid-wide scan of a node axis [0, n) (K7: the
// whole axis; K14a: one shard's rows): its warps take the 32-node groups
// blk * K7_WARPS + wid, then every G * K7_WARPS groups on. Node j is a
// candidate of the scan when feas[j] and j < live; its key is rank[j], its
// row in the pick row0 + j. The block's record (its pick, then its best
// node's flags) goes to column blk of `records` ([K7_WORDS][G]); then
// thread 0 fences and draws a ticket. Returns, to every thread, whether
// this block drew the last of the G tickets.
template <bool FULL>
__device__ __forceinline__ bool k7_scan_block(
    K7Shared& sh, const VictimRows& rows, const VictimPlanes& planes,
    const VictimPod& pod, const unsigned char* feas, const i64* rank, int n,
    i64 live, i64 row0, int blk, int G, i64* records,
    unsigned int* ticket) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  PickRec r = pick_none();
  K7Flags best{};  // the flags of this lane's best candidate
  for (int g = blk * K7_WARPS + wid; g * 32 < n; g += G * K7_WARPS) {
    const int j = g * 32 + lane;
    K7Flags f;
    const VictimAgg v = k7_node<FULL>(sh.tile[wid], rows, planes, pod,
                                      j < n && feas[j] && (i64)j < live, n,
                                      g * 32, lane, &f);
    if (j < n && pick_add(r, v, rank[j], row0 + j)) best = f;
  }
  warp_record(r, best, sh.wrec, sh.wflags, lane, wid);
  __syncthreads();
  if (threadIdx.x == 0) {
    int src;
    r = block_pick(sh.wrec, &src);
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w) records[(size_t)w * G + blk] = r.w[w];
#pragma unroll
    for (int w = 0; w < K7_FLAG_WORDS; ++w)
      records[(size_t)(PK_WORDS + w) * G + blk] =
          src >= 0 ? (i64)sh.wflags[src].w[w] : 0;
    // the record is visible to every block before the ticket is drawn
    __threadfence();
    sh.last = atomicAdd(ticket, 1u) == (unsigned)G - 1;
  }
  __syncthreads();
  return sh.last;
}

// The block that drew the last ticket: the G block records of `records`
// (read past L1) combined as one block combines its lanes. Thread 0 gets
// the pick and sets sh.src to the warp whose flags (sh.wflags) are its
// best node's (-1: no candidate); the caller's barrier publishes it.
// Every thread of the block calls it.
__device__ __forceinline__ PickRec k7_last_pick(K7Shared& sh,
                                                const i64* records, int G) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __threadfence();
  PickRec r = pick_none();
  K7Flags best{};
  for (int b = threadIdx.x; b < G; b += K7_THREADS) {
    PickRec u;
    K7Flags f;
#pragma unroll
    for (int w = 0; w < PK_WORDS; ++w)
      u.w[w] = __ldcg(records + (size_t)w * G + b);
#pragma unroll
    for (int w = 0; w < K7_FLAG_WORDS; ++w)
      f.w[w] = (unsigned long long)__ldcg(records
                                          + (size_t)(PK_WORDS + w) * G + b);
    if (pick_before(u, r)) best = f;
    r = pick_comb(r, u);
  }
  warp_record(r, best, sh.wrec, sh.wflags, lane, wid);
  __syncthreads();
  if (threadIdx.x == 0) r = block_pick(sh.wrec, &sh.src);
  return r;
}

// flag q of the best node of the last block's pick (0 when none)
__device__ __forceinline__ int k7_flag(const K7Shared& sh, int q) {
  return sh.src >= 0 ? (int)((sh.wflags[sh.src].w[q >> 6] >> (q & 63)) & 1)
                     : 0;
}
