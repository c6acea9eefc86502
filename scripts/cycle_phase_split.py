"""Per-pod phase split of K5 (`schedule_batch`) or of K8 (`pressure_batch`)
on the card, and the cost of one cluster round.

    python3 scripts/cycle_phase_split.py [--fine] [--threads N]
    python3 scripts/cycle_phase_split.py --k8 [--tree DIR]

With `--k8` it splits K8 instead (K8 below); else:

1. Builds an instrumented copy of K5 from the port's CUDA sources into
   build/phase_split/new/: clock64() probes in thread 0 of block 0 add up
   the cycles of each phase of a pod's cycle (filter, rotation walk,
   scores, select) and of the whole pod loop. The probes go in at the
   cycle's phase markers (`// ---- rotation walk`, `// ---- scores`,
   `// ---- select`, and the `CycleResult r;` that closes the cycle) of
   `cluster_cycle.cuh`. `--fine` splits the cluster cycle further, at
   each of its rounds and per-node loops (FINE). `--threads N` also builds
   the cluster K5 with N threads a block (NTHREADS; the planner's
   CLUSTER_THREADS follows it for that run), more node slots a thread.
2. Drives scan-default's window (15,000 nodes, 10,000 pods at the default
   50 %, as chip_smoke.py does), captures its K5 call and cuts it to the
   first 1,024 pods (chip_smoke.PREFIX); runs each instrumented copy on it
   once to warm up and once measured (CUDA events around the launch),
   checks its decisions against the production kernel's, and prints each
   phase in microseconds a pod: its share of the pod loop's cycles times
   the launch's event time over 1,024.
3. Times one cluster round alone: kernels of 16 x 1024 threads (the
   resident geometry) that run 20,000 `cluster_round`s of 8 values and of
   1 value, 20,000 bare cluster barriers, and one block's 20,000
   `__syncthreads`; prints microseconds a round.
4. Times the host's side of one launch (host clock around 20,000
   enqueues of an empty kernel that takes a mesh select's arguments, the
   stream drained every 256 launches outside the clock): a plain
   <<<1, 1024>>> block (the one-block select's launch), one block through
   `cudaLaunchKernelEx`, and one cluster of 16 x 1024 threads at the
   select's shared memory at n_pad 16,384 (K10b's / K11b's launch);
   prints microseconds a launch.

K8 (`--k8`): with the `kubernetes_tpu_torch` package and `chip_smoke.py`
of DIR (default: this checkout; an older checkout unpacked with `git
archive` gives the before side of a comparison), drives preempt-wave
(15,000 nodes, 149,700 victims, 1,024 preemptors, as chip_smoke.py does),
captures its first 128-pod chunk's K8 call, times DIR's production K8 on
that chunk (`[k8]`: CUDA events around 3 wrapper calls after a warm-up,
and the kernel's device time over the same calls from torch.profiler, by
this checkout's `chip_smoke.device_time`), builds DIR's K8 with the same
probes into build/phase_split/k8/ and runs it on that chunk once to warm
up and once measured, checks the chunk's outputs against DIR's production
kernel, and prints each phase of a pod in microseconds (its share of the
pod loop's cycles in thread 0 of block 0, times the launch's event time
over 128). A pod's phases, in the order thread 0 of block 0 meets them:
in a cluster K8 (this PR's) the victim scan of its own nodes, the cycle
up to its select round, the select round that carries the pick, and the
winner's flags and the folds; in the cooperative K8 before it the cycle
(block 0 alone), the victim scan between the two grid barriers, the pick
(`pick_block`, block 0 alone), and the flags and folds. A probe line that
is not found in DIR's sources stops the script.

Needs a card and nvcc, as chip_smoke.py does; writes nothing outside
build/. The probes cost a few cycles each; the numbers are a split, not a
timing of the production kernel (chip_smoke.py times that).
"""
import argparse
import contextlib
import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "phase_split"
PHASES = ("filter", "walk", "scores", "select")
#: K8's probes: (phases, the file, [(pattern, probe, after)]) for the
#: cluster K8 and for the cooperative K8 it replaced
K8_CLUSTER = (
    ("victim scan", "cycle", "pick (the select round)", "flags and fold"),
    [("pressure_batch.cu", r"^    CycleResult res\{-1, 0, 0, 0, "
      r"floormod\(li, n_safe\), lni, false\};", "PHASE_MARK(0);", False),
     ("cluster_cycle.cuh", r"^    if \(pick\)$", "PHASE_MARK(1);", False),
     ("pressure_batch.cu",
      r"^    const i64 winner_raw = vic_winner\(ps.best\);", "PHASE_MARK(2);",
      True),
     ("pressure_batch.cu", r"^    changed = hit \? res.sel", "PHASE_MARK(3);",
      False),
     ("pressure_batch.cu", r"^  cluster_store<RES>\(cx, a\);", "PHASE_END;",
      False)])
K8_GRID = (
    ("cycle", "victim scan", "pick", "flags and fold"),
    [("pressure_batch.cu",
      r"^    // the previous pod's folds are visible to every block",
      "PHASE_MARK(0);", False),
     ("pressure_batch.cu",
      r"^    // every node's aggregates are visible to block 0",
      "PHASE_MARK(1);", False),
     ("pressure_batch.cu",
      r"^    const int winner_raw = pick_block\(g, n, 0\);",
      "PHASE_MARK(2);", True),
     ("pressure_batch.cu", r"^    li = res.next_li;$", "PHASE_MARK(3);",
      False),
     ("pressure_batch.cu", r"^  if \(lead && threadIdx.x == 0\) \{",
      "PHASE_END;", False)])
#: the finer split of the cluster cycle: (name, the line of
#: cluster_cycle.cuh that closes the part, the probe going in before it)
FINE = (
    ("filter", r"^  // ---- rotation walk"),
    ("walk: feasible bits and block scan",
     r"^    // the block totals, and the prefix before li where it lives"),
    ("walk: scan round", r"^    const i64 off = cx.boff\[cx.rank\];"),
    ("walk: cutoff and kept set",
     r"^  // ---- scores: reductions over the kept set"),
    ("scores: kept-set maxima",
     r"^    // the maxima of the families that run, and the walk's cutoff"),
    ("scores: maxima round", r"^  nm.na_max = v\[PR_NA\];"),
    ("scores: zone table", r"^  i64 l_max = LLONG_MIN;"),
    ("scores: per-node score",
     r"^  // ---- select: round-robin k-th tie in rotation order"),
    ("select: block maximum and tie scan",
     r"^  const bool tie_blocks = mode != 1;"),
    ("select: max and ties round",
     r"^  const bool any_kept = max_score != LLONG_MIN;"),
    ("select: the k-th tie", r"^    i64 s\[1\] = \{l_sel\};"),
    ("select: select round", r"^  i64 sel = l_sel == n \? 0 : l_sel;"),
    ("result", r"^  CycleResult r;$"),
)
NSLOT = 32          # probe table: parts, then begin stamp, loop, cycles run

PRELUDE = r"""
// ---- phase probes (scripts/cycle_phase_split.py) ----
__device__ unsigned long long phase_acc[32];
__device__ unsigned long long phase_t;
#define PHASE_LEAD (threadIdx.x == 0 && blockIdx.x == 0)
#define PHASE_MARK(k) do { if (PHASE_LEAD) { \
    unsigned long long _n = clock64(); \
    if ((k) >= 0) phase_acc[(k)] += _n - phase_t; \
    else phase_acc[31] += 1; \
    phase_t = _n; } } while (0)
#define PHASE_BEGIN do { if (PHASE_LEAD) phase_acc[29] = clock64(); } \
    while (0)
#define PHASE_END do { if (PHASE_LEAD) \
    phase_acc[30] = clock64() - phase_acc[29]; } while (0)
"""

READER = r"""
extern "C" int phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_acc, sizeof(phase_acc));
}
extern "C" int phase_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(phase_acc, z, sizeof(z));
}
"""

ROUNDS = r"""
#include <chrono>

#include "cluster_select.cuh"

template <int NV>
__global__ void __launch_bounds__(NTHREADS, 1)
    rounds_kernel(int R, long long* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cl = cg::this_cluster();
  const ClusterLayout L = cluster_layout(NTHREADS, 0, 4, false, false);
  ClusterCtx cx;
  cx.rank = (int)cl.block_rank();
  cx.C = (int)cl.num_blocks();
  cx.z_pad = 4;
  cx.round = 0;
  cx.warp = (i64*)(sm + L.warp);
  cx.slots = (i64*)(sm + L.slot);
  cx.res = (i64*)(sm + L.res);
  cl.sync();
  int ops[NV];
  for (int k = 0; k < NV; ++k) ops[k] = k & 1 ? OP_SUM : OP_MAX;
  i64 acc = 0;
  for (int i = 0; i < R; ++i) {
    i64 v[NV];
    for (int k = 0; k < NV; ++k) v[k] = threadIdx.x + i + k;
    cluster_round(cx, cl, v, ops);
    acc += v[NV - 1];
  }
  if (threadIdx.x == 0 && cx.rank == 0) out[0] = acc;
  cl.sync();
}

__global__ void __launch_bounds__(NTHREADS, 1)
    barrier_kernel(int R, long long* out) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < R; ++i) cl.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = R;
}

__global__ void __launch_bounds__(NTHREADS, 1)
    block_kernel(int R, long long* out) {
  __shared__ int x;
  for (int i = 0; i < R; ++i) {
    if (threadIdx.x == (i & 1023)) x = i;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = x;
}

// which: 0 rounds of 8 values, 1 rounds of 1 value, 2 bare cluster
// barriers (all on `blocks` blocks), 3 one block's __syncthreads
extern "C" int rounds_launch(int which, int blocks, int R, long long* out,
                             void* stream) {
  const ClusterLayout L = cluster_layout(NTHREADS, 0, 4, false, false);
  ClusterGeom g{blocks, 1, 0, (i64)L.bytes};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (which == 3) {
    block_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(R, out);
    return (int)cudaGetLastError();
  }
  cluster_config(g, (cudaStream_t)stream, &cfg, &attr);
  if (which == 0) {
    e = cluster_attrs(rounds_kernel<8>);
    if (!e) e = cudaLaunchKernelEx(&cfg, rounds_kernel<8>, R, out);
  } else if (which == 1) {
    e = cluster_attrs(rounds_kernel<1>);
    if (!e) e = cudaLaunchKernelEx(&cfg, rounds_kernel<1>, R, out);
  } else {
    e = cluster_attrs(barrier_kernel);
    if (!e) e = cudaLaunchKernelEx(&cfg, barrier_kernel, R, out);
  }
  return e ? (int)e : (int)cudaGetLastError();
}

__global__ void __launch_bounds__(NTHREADS, 1)
    empty_kernel(ScanSelectArgs a, ClusterGeom g) {}

// Host microseconds a launch of `empty_kernel` over n enqueues: which 0 a
// <<<1, NTHREADS>>> block, 1 one block through cudaLaunchKernelEx, 2 one
// cluster of `blocks` blocks at `smem` bytes a block. The stream is
// drained every 256 launches, outside the clock.
extern "C" int launch_cost(int which, int blocks, long long smem, int n,
                           double* us, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const ScanSelectArgs a{};
  const ClusterGeom one{1, 1, 1, 0}, g{blocks, 1, 1, smem};
  cudaError_t e = cluster_attrs(empty_kernel);
  cudaLaunchConfig_t cfg1 = {}, cfg;
  cudaLaunchAttribute attr;
  cfg1.gridDim = dim3(1, 1, 1);
  cfg1.blockDim = dim3(NTHREADS, 1, 1);
  cfg1.stream = s;
  cluster_config(g, s, &cfg, &attr);
  double total = 0;
  for (int done = 0; done < n && !e;) {
    const int k = n - done < 256 ? n - done : 256;
    const auto t0 = std::chrono::steady_clock::now();
    for (int i = 0; i < k && !e; ++i) {
      if (which == 0)
        empty_kernel<<<1, NTHREADS, 0, s>>>(a, one);
      else
        e = cudaLaunchKernelEx(which == 1 ? &cfg1 : &cfg, empty_kernel, a,
                               which == 1 ? one : g);
    }
    total += std::chrono::duration<double, std::micro>(
                 std::chrono::steady_clock::now() - t0).count();
    if (!e) e = cudaStreamSynchronize(s);
    done += k;
  }
  *us = total / n;
  return e ? (int)e : (int)cudaGetLastError();
}
"""


def _insert(text: str, pattern: str, probe: str, after: bool) -> str:
    """`probe` on a line of its own before (or after) every line that
    matches `pattern`."""
    out = []
    for line in text.splitlines(keepends=True):
        hit = re.search(pattern, line) is not None
        if hit and not after:
            out.append(probe + "\n")
        out.append(line)
        if hit and after:
            out.append(probe + "\n")
    return "".join(out)


def instrument_k8(csrc: Path, dest: Path):
    """An instrumented copy of `csrc` in `dest` with K8's probes (the
    cluster K8's when its sources hold `pick_round`, else the cooperative
    K8's); returns (its K8 library, the phases, whether the launch takes a
    geometry)."""
    from kubernetes_tpu_torch.ops import _build
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(csrc, dest)
    cluster = "pick_round" in (dest / "cluster_cycle.cuh").read_text()
    phases, probes = K8_CLUSTER if cluster else K8_GRID
    common = dest / "common.cuh"
    common.write_text(common.read_text() + PRELUDE)
    k8 = dest / "pressure_batch.cu"
    loop = r"^  for \(int b = 0; b < B; \+\+b\) \{"
    k8.write_text(_insert(_insert(k8.read_text(), loop, "PHASE_BEGIN;",
                                  False), loop, "PHASE_MARK(-1);", True))
    for name, pattern, probe, after in probes:
        p = dest / name
        t = p.read_text()
        before = len(t)
        t = _insert(t, pattern, probe, after)
        if len(t) == before:
            raise SystemExit(f"{p}: no line matches {pattern!r}")
        p.write_text(t)
    t = k8.read_text()
    if t.count("PHASE_BEGIN") != 1 or t.count("PHASE_END") != 1:
        raise SystemExit(f"{k8}: the pod loop's probe points were not found")
    k8.write_text(t + READER)
    lib = dest / "pressure_batch.so"
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(k8)], check=True)
    return lib, phases, cluster


def run_k8(sync) -> None:
    """The K8 split of preempt-wave's first chunk (the package imported
    is DIR's: main puts it first on the path)."""
    import chip_smoke as C
    import torch
    from kubernetes_tpu_torch.ops import _build, kernels as K
    device = torch.device("cuda")
    infos, tree, pdbs = C.preempt_world(C.N_NODES)
    with C.capture("pressure_batch") as cap:
        C.run_wave(infos, tree, pdbs, C.wave_pods(), device, sync)
    del infos, tree, pdbs
    nodes, args, kw = cap.call
    kw = {k: v for k, v in kw.items() if k != "out"}
    ref = K.pressure_batch(nodes, *args, **kw)
    n = len(args[2])
    here = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(here)
    here.loader.exec_module(mod)

    def chunk():
        K.pressure_batch(nodes, *args, **kw)
    ms = C.cuda_time(chunk, sync, 3)
    dev_ms, seen = mod.device_time(chunk, sync, 3, "pressure_batch")
    print(f"[k8] production K8 on the chunk: {ms:.4f} ms a chunk, "
          f"{ms / n * 1e3:.2f} us/pod (wrapper, CUDA events); device_ms "
          + ("not measured" if dev_ms is None else
             f"{dev_ms:.4f} over {seen} launches, {dev_ms / n * 1e3:.2f} "
             f"us/pod"), flush=True)
    lib_path, phases, cluster = instrument_k8(_build.CSRC, OUT / "k8")
    lib = ctypes.CDLL(str(lib_path))
    L, P = ctypes.c_longlong, ctypes.c_void_p
    fn = lib.pressure_batch_launch
    fn.argtypes = [ctypes.POINTER(L), ctypes.POINTER(P)] + (
        [ctypes.POINTER(L)] if cluster else []) + [P]
    fn.restype = ctypes.c_int
    lib.phase_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    if cluster:
        lib.pressure_batch_clusters.argtypes = [ctypes.POINTER(L),
                                                ctypes.POINTER(ctypes.c_int)]
        lib.pressure_batch_clusters.restype = ctypes.c_int

    def launch(name, iargs, parr, *extra):
        if cluster:
            # the copy's kernel takes its launch attributes from its own
            # occupancy query, as the production kernel does from its own
            fit = ctypes.c_int(0)
            K._check(lib.pressure_batch_clusters(extra[0],
                                                 ctypes.byref(fit)),
                     "pressure_batch (instrumented) occupancy query")
        K._check(fn(iargs, parr, *extra, K._stream()),
                 "pressure_batch (instrumented)")
    saved = K._launch
    K._launch = launch
    try:
        K.pressure_batch(nodes, *args, **kw)        # warm-up
        sync()
        K._check(lib.phase_reset(), "phase_reset")
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        got = K.pressure_batch(nodes, *args, **kw)
        end.record()
        sync()
    finally:
        K._launch = saved
    if C.max_abs_err(got, ref) != 0:
        raise SystemExit(f"the instrumented K8 disagrees with the production "
                         f"kernel ({C.first_diff(got, ref)})")
    acc = (ctypes.c_ulonglong * NSLOT)()
    K._check(lib.phase_read(acc), "phase_read")
    ms = start.elapsed_time(end)
    loop = acc[30]
    us = [acc[k] / loop * ms * 1e3 / n for k in range(len(phases))]
    rest = (loop - sum(acc[:len(phases)])) / loop * ms * 1e3 / n
    split = ", ".join(f"{p} {u:.2f} us ({100 * acc[k] / loop:.1f} %)"
                      for k, (p, u) in enumerate(zip(phases, us)))
    kind = "cooperative K8"
    if cluster:
        plan = K.last_geometry["pressure_batch"][0]
        kind = (f"cluster K8 ({plan.blocks} x {K.CLUSTER_THREADS} threads, "
                f"rows {'resident' if plan.resident else 'in global memory'})")
    print(f"[phase] {kind}: {ms / n * 1e3:.2f} us/pod over the {n} pods of "
          f"preempt-wave's first chunk ({acc[31]} pods run; "
          f"{loop / (ms * 1e3):.0f} SM cycles/us): {split}, the rest "
          f"{rest:.2f} us")


def instrument(csrc: Path, dest: Path, fine: bool = False,
               threads: int = 0) -> Path:
    """An instrumented copy of `csrc` in `dest`; returns its K5 library.
    With `fine` the cluster cycle gets FINE's probes instead of the four
    phases'; `threads` > 0 sets the copy's block size."""
    from kubernetes_tpu_torch.ops import _build
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(csrc, dest)
    common = dest / "common.cuh"
    t = common.read_text()
    if threads:
        if "#define NTHREADS 1024\n" not in t:
            raise SystemExit(f"{common}: no NTHREADS to set")
        t = t.replace("#define NTHREADS 1024\n", f"#define NTHREADS {threads}\n")
    common.write_text(t + PRELUDE)
    p = dest / "cluster_cycle.cuh"
    t = p.read_text()
    # the filter starts where the cycle does
    t = _insert(t, r"^  // ---- filter", "PHASE_MARK(-1);", True)
    if fine:
        for k, (_part, pattern) in enumerate(FINE):
            before = len(t)
            t = _insert(t, pattern, f"PHASE_MARK({k});", False)
            if len(t) == before:
                raise SystemExit(f"{p}: no line matches {pattern!r}")
    else:
        t = _insert(t, r"^  // ---- rotation walk", "PHASE_MARK(0);", False)
        t = _insert(t, r"^  // ---- scores", "PHASE_MARK(1);", False)
        t = _insert(t, r"^  // ---- select", "PHASE_MARK(2);", False)
        t = t.replace("  CycleResult r;\n  r.sel = found > 0",
                      "PHASE_MARK(3);\n  CycleResult r;\n"
                      "  r.sel = found > 0")
    p.write_text(t)
    k5 = dest / "schedule_batch.cu"
    t = k5.read_text()
    t = _insert(t, r"^  for \(int b = 0; b < B; \+\+b\) \{", "PHASE_BEGIN;",
                False)
    t = t.replace("  cluster_store<RES>(cx, a);",
                  "PHASE_END;\n  cluster_store<RES>(cx, a);")
    if t.count("PHASE_BEGIN") != 1 or t.count("PHASE_END") != 1:
        raise SystemExit(f"{k5}: the pod loop's probe points were not found")
    k5.write_text(t + READER)
    lib = dest / "schedule_batch.so"
    cmd = [_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(k5)]
    subprocess.run(cmd, check=True)
    return lib


def scan_default_prefix(device, sync):
    """scan-default's K5 call, cut to its first PREFIX pods."""
    import chip_smoke as C
    cfg, n_nodes, window_fn = C.scan_cells()[0]
    with C.capture("schedule_batch") as cap:
        C.run_scan(cfg, n_nodes, window_fn(C.N_PODS), 0, device, sync)
    return C.prefix_call(cap.call, C.PREFIX)


@contextlib.contextmanager
def block_size(threads):
    """The planner's block size set to `threads` (0: as it is), so K5's
    wrapper plans the instrumented copy's geometry."""
    from kubernetes_tpu_torch.ops import kernels as K
    saved = (K.CLUSTER_THREADS, K._NWARPS)
    if threads:
        K.CLUSTER_THREADS, K._NWARPS = threads, threads // 32
    try:
        yield
    finally:
        K.CLUSTER_THREADS, K._NWARPS = saved


def run_split(label, lib_path, call, ref, sync, parts=PHASES, threads=0):
    import chip_smoke as C
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.schedule_batch_launch
    P, L = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [ctypes.POINTER(L), ctypes.POINTER(P), ctypes.POINTER(L), P]
    fn.restype = ctypes.c_int
    lib.phase_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    # the copy's kernel takes its launch attributes from its own occupancy
    # query, as the production kernel does from its own
    lib.schedule_batch_clusters.argtypes = [ctypes.POINTER(L),
                                            ctypes.POINTER(ctypes.c_int)]
    lib.schedule_batch_clusters.restype = ctypes.c_int

    def launch(name, iargs, parr, *extra):
        fit = ctypes.c_int(0)
        K._check(lib.schedule_batch_clusters(extra[0], ctypes.byref(fit)),
                 f"{name} ({label}, instrumented) occupancy query")
        K._check(fn(iargs, parr, *extra, K._stream()),
                 f"{name} ({label}, instrumented)")
    saved = K._launch
    K._launch = launch
    try:
        with block_size(threads):
            nodes, args, kw = call
            K.schedule_batch(nodes, *args, **kw)       # warm-up
            sync()
            K._check(lib.phase_reset(), "phase_reset")
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            got = K.schedule_batch(nodes, *args, **kw)
            end.record()
            sync()
            plan = K.last_geometry["schedule_batch"][0]
    finally:
        K._launch = saved
    if C.max_abs_err(got, ref) != 0:
        raise SystemExit(f"{label}: the instrumented K5 disagrees with the "
                         f"production kernel ({C.first_diff(got, ref)})")
    acc = (ctypes.c_ulonglong * NSLOT)()
    K._check(lib.phase_read(acc), "phase_read")
    ms = start.elapsed_time(end)
    n = C.PREFIX
    loop = acc[30]
    m = len(parts)
    us = [acc[k] / loop * ms * 1e3 / n for k in range(m)]
    rest = (loop - sum(acc[:m])) / loop * ms * 1e3 / n
    split = ", ".join(f"{p} {u:.2f} us ({100 * acc[k] / loop:.1f} %)"
                      for k, (p, u) in enumerate(zip(parts, us)))
    label += (f" ({plan.blocks} x {threads or K.CLUSTER_THREADS} "
              f"threads, {plan.nodes_per_thread} slot(s) a thread)")
    print(f"[phase] {label}: {ms / n * 1e3:.2f} us/pod over {n} pods "
          f"({acc[31]} cycles run; {loop / (ms * 1e3):.0f} SM cycles/us): "
          f"{split}, fold and bookkeeping {rest:.2f} us")


def run_rounds(sync):
    import torch
    from kubernetes_tpu_torch.ops import _build, kernels as K
    src = OUT / "rounds"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(_build.CSRC, src)
    (src / "rounds.cu").write_text(ROUNDS)
    lib_path = src / "rounds.so"
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(src / "rounds.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.rounds_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.rounds_launch.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    R = 20000
    names = ("cluster round of 8 values", "cluster round of 1 value",
             "bare cluster barrier", "__syncthreads of one block")
    for which, name in enumerate(names):
        blocks = 1 if which == 3 else K.CLUSTER_BLOCKS

        def go():
            K._check(lib.rounds_launch(which, blocks, R, out.data_ptr(),
                                       K._stream()), name)
        go()
        sync()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        go()
        end.record()
        sync()
        print(f"[round] {name} ({blocks} x 1024 threads): "
              f"{start.elapsed_time(end) / R * 1e3:.3f} us")
    lib.launch_cost.argtypes = [ctypes.c_int, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_void_p]
    lib.launch_cost.restype = ctypes.c_int
    smem = K.select_plan(16384, 8).smem_bytes
    names = ("<<<1, 1024>>> block", "one block, cudaLaunchKernelEx",
             f"cluster of {K.CLUSTER_BLOCKS} x 1024, {smem} B a block")
    us = ctypes.c_double(0)
    for rep in range(2):
        for which, name in enumerate(names):
            K._check(lib.launch_cost(which, K.CLUSTER_BLOCKS, smem, 20000,
                                     ctypes.byref(us), K._stream()), name)
            print(f"[launch] host cost of one launch, {name} (pass "
                  f"{rep + 1}): {us.value:.3f} us")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fine", action="store_true",
                    help="also split the cluster cycle at each round")
    ap.add_argument("--threads", type=int, default=0,
                    help="also time the cluster K5 at this block size")
    ap.add_argument("--k8", action="store_true",
                    help="split K8 on preempt-wave's first chunk instead")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="with --k8: the checkout whose K8 to split")
    opts = ap.parse_args()
    if opts.k8:
        # DIR's package and chip_smoke.py before this checkout's
        sys.path.insert(0, str(opts.tree.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("cycle_phase_split: no CUDA device", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import _build, kernels as K
    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip())
    if opts.k8:
        if not K.__file__.startswith(str(opts.tree.resolve())):
            raise SystemExit(f"imported {K.__file__}, not the package of "
                             f"{opts.tree}")
        _build.build_all()
        run_k8(sync)
        print(f"[time] cycle_phase_split.py --k8 "
              f"{time.perf_counter() - t0:.1f} s")
        return 0
    _build.build_all(("schedule_batch",))
    libs = [("cluster K5", instrument(_build.CSRC, OUT / "new"), PHASES, 0)]
    if opts.fine:
        libs.append(("cluster K5, fine", instrument(
            _build.CSRC, OUT / "fine", fine=True),
            tuple(p for p, _ in FINE), 0))
    if opts.threads:
        libs.append(("cluster K5", instrument(
            _build.CSRC, OUT / f"t{opts.threads}", threads=opts.threads),
            PHASES, opts.threads))
    device = torch.device("cuda")
    call = scan_default_prefix(device, sync)
    nodes, args, kw = call
    ref = K.schedule_batch(nodes, *args, **kw)
    print(f"[phase] the production K5: "
          f"{K.last_geometry['schedule_batch']}")
    for label, lib, parts, threads in libs:
        run_split(label, lib, call, ref, sync, parts, threads)
    run_rounds(sync)
    print(f"[time] cycle_phase_split.py {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
