// The uniform burst's per-node fit and score (`_uniform_core`'s
// `resource_fit` / `lane_fit`, kubernetes_tpu/ops/kernels.py:1097): K3
// runs them over each cluster block's slice of the node axis and on its
// lanes' nodes, K9c over one shard's rows.
#pragma once

#include "common.cuh"

// what the per-node fit and score read, held by value (a reference to the
// kernel's parameter struct would force a local-memory copy of it)
struct Ctx {
  int n, R, check_res, has_req, gate;
  const unsigned char* ok;
  const i64 *st, *allowed, *alloc_cpu, *alloc_mem, *xalloc, *ws;
  i64 req_cpu, req_mem, nz_cpu, nz_mem;
  const i64 *delta, *xreq;
  // elements between two carried rows of `st` (n for rows over the whole
  // axis; K3: a block's span for its rows in shared memory, 1 for the
  // rows of one node a lane holds in registers)
  int sn;

  __device__ i64 row(int r, int j) const { return st[(size_t)r * sn + j]; }
  // PodFitsResources of the incoming pod on node j (plus=1: after one
  // more fold of the class delta), including the static mask
  __device__ bool fit(int j, int plus) const {
    if (!ok[j]) return false;
    if (check_res) {
      if (!(row(4, j) + plus * delta[4] + 1 <= allowed[j])) return false;
      if (has_req) {
        if (!(alloc_cpu[j] >= req_cpu + (row(0, j) + plus * delta[0])))
          return false;
        if (!(alloc_mem[j] >= req_mem + (row(1, j) + plus * delta[1])))
          return false;
        for (int r = 5; r < R; ++r)
          if (!(xalloc[(size_t)(r - 5) * n + j]
                >= xreq[r - 5] + (row(r, j) + plus * delta[r])))
            return false;
      }
    }
    return true;
  }
  __device__ int score(int j, int plus) const {
    return (int)local_total_one(gate, ws,
                                nz_cpu + (row(2, j) + plus * delta[2]),
                                nz_mem + (row(3, j) + plus * delta[3]),
                                alloc_cpu[j], alloc_mem[j]);
  }
};

// Slots of a sharded uniform burst's pass state, one int64 vector per
// device (`ST_*`, kubernetes_tpu_torch/ops/kernels.py): K9d writes it, the
// K9c of every shard on that device reads it.
enum { ST_DONE, ST_LNI, ST_PASS, ST_VFOLD, ST_LNI0, ST_LANES };
