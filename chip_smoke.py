"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (one nvcc per source, all at once).
2. Holds each kernel (K1 local_total, K2 schedule_cycle, K3 uniform_burst,
   K4 scatter_rows, K5 schedule_batch, K6 schedule_segments, K7
   preempt_scan, K8 pressure_batch) equal to its plain PyTorch version on
   the card, at the main paths' shapes (n_pad 16,384; K5 and K6 on whole
   10,000-pod windows, K8 on a 128-pod chunk of preempt-wave, K7 on a
   preempt-single round), times both, and holds every kernel mode against
   the plain version on random inputs (K7/K8 at P 16 and 128, K4 on the
   victim planes).
3. Drives the paths through TorchScheduler, each on 15,000 or 15,001 nodes
   (bench.py's node shape: 4 CPU, 32 Gi, 110 pods, zone i % 3):
   - the uniform burst (K3): 10,000 identical pods (100m / 500 Mi), the
     assume loop, then serial cycles; on 15,000 and 15,001 nodes;
   - scan-default (K5): the same pods at the default
     percentageOfNodesToScore (50: 7,500 nodes to find), identity and
     perm walks, then four serial cycles at the carried last_index;
   - scan-mixed (K5): four Deployment shapes interleaved, two profiles,
     full scan on 15,001 nodes (the gather-free position walk);
   - scan-spread (K5): identical pods one Service selects (the carried
     selector-spread vector);
   - fused-gang (K6): one drain window of 100 gangs of 64 and singleton
     runs, under a rank-aware profile, with one gang that cannot all fit
     and rewinds mid-window;
   - preempt-wave (K8): 10 victims of 400m on each of 15,000 nodes (9 on
     every 50th), a PDB over a quarter of them, and 1,024 preemptors
     (512 at priority 100, 384 at 50, 128 at 1) in 8 chunks and one
     fetch: bound, nominated and failed outcomes;
   - preempt-baseline (K8): BASELINE.json configs[3], 1,000 nodes x
     10,000 victims and 128 preemptors, after prewarm_preempt;
   - preempt-single (K7, with K2 and K4): 32 rounds of schedule ->
     FitError -> preempt on the preempt-wave world, the shell's evictions
     in between; rounds 2-32 scatter the victim planes' dirty rows.
   Launch counts are zeroed just before each path and read just after;
   each path's kernels must have run and no window may be refused.
   Decisions, walk counters and folded rows must equal the plain path on
   the card (whole window for the uniform burst, the first >= 1,024 pods
   of the scan and fused windows, whole waves with their ghost load for
   the pressure paths, every K7 block of preempt-single).
4. Checks the burst against the serial cycle on a small world: a burst
   must decide exactly what one schedule() per pod decides.

Any mismatch or exception exits non-zero. Without a CUDA device it exits
non-zero before printing any result. The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

N_NODES, N_PODS, N_SERIAL = 15000, 10000, 4
PREFIX = 1024                   # pods of a window held against the plain path
UNIFORM_KERNELS = ("local_total", "schedule_cycle", "uniform_burst",
                   "scatter_rows")
# the fused window: gangs of GANG_SIZE interleaved with singleton runs of
# RUN_SIZE, plus one gang on the RACK_NODES nodes labelled rack=r0
N_GANGS, GANG_SIZE, RUN_SIZE, RACK_NODES = 100, 64, 36, 40
GI, MI = 1024 ** 3, 1024 ** 2
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# non-tensor-core peak (fp32, H100 SXM data sheet); integer ops run no
# faster, so it bounds the scans' per-node integer work from below
H100_OPS_PER_S = 67e12
# integer operations per node of one cycle at the default families, a
# floor: feasibility 8, walk 5, LeastRequested 12, BalancedAllocation 7
OPS_PER_NODE_CYCLE = 32

SOURCES = {
    "local_total": ("kubernetes_tpu_torch/ops/csrc/local_total.cu",
                    "kubernetes_tpu/ops/kernels.py:110"),
    "schedule_cycle": ("kubernetes_tpu_torch/ops/csrc/schedule_cycle.cu",
                       "kubernetes_tpu/ops/kernels.py:359"),
    "uniform_burst": ("kubernetes_tpu_torch/ops/csrc/uniform_burst.cu",
                      "kubernetes_tpu/ops/kernels.py:1097"),
    "scatter_rows": ("kubernetes_tpu_torch/ops/csrc/scatter_rows.cu",
                     "kubernetes_tpu/core/tpu_scheduler.py:158"),
    "schedule_batch": ("kubernetes_tpu_torch/ops/csrc/schedule_batch.cu",
                       "kubernetes_tpu/ops/kernels.py:569"),
    "schedule_segments": (
        "kubernetes_tpu_torch/ops/csrc/schedule_segments.cu",
        "kubernetes_tpu/ops/kernels.py:785"),
    "preempt_scan": ("kubernetes_tpu_torch/ops/csrc/preempt_scan.cu",
                     "kubernetes_tpu/ops/kernels.py:1598"),
    "pressure_batch": ("kubernetes_tpu_torch/ops/csrc/pressure_batch.cu",
                       "kubernetes_tpu/ops/kernels.py:1690"),
}


def cluster(n_nodes, labels=None):
    """bench.py's cluster (build_cluster) as the port's objects; `labels(i)`
    adds labels to node i."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    from kubernetes_tpu_torch.cache.node_tree import NodeTree
    nodes = [Node(name=f"node-{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"zone-{i % 3}",
        "failure-domain.beta.kubernetes.io/region": "r1",
        "kubernetes.io/hostname": f"node-{i}",
        **(labels(i) if labels else {})},
        allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(n_nodes)]
    infos = {n.name: NodeInfo(n) for n in nodes}
    tree = NodeTree()
    for n in nodes:
        tree.add_node(n)
    return infos, tree


def pods(n_pods, prefix="pod", cpu=100, mem=500 * MI, app="density",
         **kw):
    """bench.py's density pods (make_pods); other shapes by keyword."""
    from kubernetes_tpu_torch.api.types import Pod, Container
    return [Pod(name=f"{prefix}-{j}", labels={"app": app},
                containers=(Container.make(
                    name="c", requests={"cpu": cpu, "memory": mem}),), **kw)
            for j in range(n_pods)]


def assume(infos, pod, host):
    placed = dataclasses.replace(pod, node_name=host)
    infos[host].add_pod(placed)
    return infos[host].generation


@contextlib.contextmanager
def plain_versions():
    """Route the port's kernel entry points to their plain versions (the
    reference run of the same path on the card)."""
    from kubernetes_tpu_torch.ops import kernels as K
    saved = {k: getattr(K, k) for k in (
        "local_total", "schedule_cycle", "schedule_batch_uniform",
        "scatter_rows", "schedule_batch", "schedule_batch_segments",
        "preemption_scan", "pressure_batch")}
    K.local_total = K.local_total_plain
    K.schedule_cycle = K.schedule_cycle_plain
    K.schedule_batch_uniform = K.schedule_batch_uniform_plain
    K.scatter_rows = K.scatter_rows_plain
    K.schedule_batch = K.schedule_batch_plain
    K.schedule_batch_segments = K.schedule_batch_segments_plain
    K.preemption_scan = K.preemption_scan_plain
    K.pressure_batch = K.pressure_batch_plain
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(K, k, v)


def run_path(n_nodes, n_pods, n_serial, device, sync):
    """The main path once: burst, assume loop, serial cycles. Returns the
    decisions, the scheduler, and host seconds by phase."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    infos, tree = cluster(n_nodes)
    burst = pods(n_pods)
    sched = TorchScheduler(percentage_of_nodes_to_score=100,
                           node_tree=tree, device=device)
    t0 = time.perf_counter()
    names = tree.list_names()
    hosts = sched.schedule_burst(burst, infos, names)
    sync()
    t_burst = time.perf_counter() - t0
    if hosts is None:
        raise SystemExit("main path: the burst was refused")
    kf = hosts.index(None) if None in hosts else len(hosts)
    t1 = time.perf_counter()
    gens = [assume(infos, p, h) for p, h in zip(burst[:kf], hosts[:kf])]
    sched.note_burst_assumed_many(burst[:kf], hosts[:kf], gens)
    if kf:
        tree.advance_enumerations(kf - 1)
    t_assume = time.perf_counter() - t1
    serial = []
    t2 = time.perf_counter()
    for p in pods(n_serial, prefix="serial"):
        r = sched.schedule(p, infos, tree.list_names())
        serial.append((r.suggested_host, r.evaluated_nodes,
                       r.feasible_nodes, tuple(r.host_priority)))
        assume(infos, p, r.suggested_host)
    sync()
    t_serial = time.perf_counter() - t2
    return {"hosts": hosts, "serial": serial, "sched": sched,
            "t_burst": t_burst, "t_assume": t_assume, "t_serial": t_serial,
            "phases": dict(sched.last_burst_phases or {})}


def cuda_time(fn, sync, reps):
    """Mean ms of `fn` over `reps` runs, by CUDA events after a warm-up."""
    import torch
    fn()
    sync()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    """Max |a - b| over two (nested dicts of) tensors; exact equality
    means 0. Bool and int tensors compare as int64."""
    import torch
    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def first_diff(a, b, path=""):
    """Where two (nested) results first differ: (path, index, a, b)."""
    import torch
    if isinstance(a, dict):
        for k in a:
            d = first_diff(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    a, b = torch.as_tensor(a).reshape(-1), torch.as_tensor(b).reshape(-1)
    bad = (a.to(torch.int64) != b.to(torch.int64)).nonzero()
    if len(bad) == 0:
        return None
    i = int(bad[0])
    return path, i, int(a[i]), int(b[i]), len(bad)


def kernel_checks(device, sync):
    """Each kernel against its plain version on the card at the main
    path's shapes; returns the per-kernel report entries."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.ops import kernels as K
    infos, tree = cluster(N_NODES)
    sched = TorchScheduler(percentage_of_nodes_to_score=100, node_tree=tree,
                           device=device)
    names = tree.list_names()
    # a partly filled cluster (3 pods on every 7th node), so scores and
    # ties are not all equal
    probe = pods(1, prefix="fill")[0]
    for i in range(0, len(names), 7):
        for _ in range(3):
            assume(infos, probe, names[i])
    b = sched.encoder.encode(infos, names)
    nodes = sched._node_arrays(b)
    n_pad = b.n_pad
    w = dict(K.DEFAULT_WEIGHTS)
    out = {}

    def entry(name, got, want, fn, plain, reps, plain_reps, nbytes,
              library_ms=None, label=None):
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"(path, index, kernel, plain, count): "
                             f"{first_diff(got, want)})")
        ms = cuda_time(fn, sync, reps)
        plain_ms = cuda_time(plain, sync, plain_reps)
        if label is not None:
            print(f"[kernel] {name} ({label}): equal to plain "
                  f"(max_abs_err 0), kernel_ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f}")
            return
        out[name] = {"name": name, "route": "cuda",
                     "source": SOURCES[name][0],
                     "replaces": SOURCES[name][1], "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": library_ms}
        print(f"[kernel] {name}: equal to plain (max_abs_err 0), "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {out[name]['bound_ms']:.6f}"
              + ("" if library_ms is None
                 else f" library_ms {library_ms:.4f}"))

    # K1 local_total over [n_pad]
    args = (w, nodes["nz_cpu"] + 100, nodes["nz_mem"] + 500 * MI,
            nodes["alloc_cpu"], nodes["alloc_mem"])
    entry("local_total", K.local_total(*args), K.local_total_plain(*args),
          lambda: K.local_total(*args), lambda: K.local_total_plain(*args),
          200, 20, n_pad * (4 * 8 + 8))

    # K2 schedule_cycle: one density pod against the filled cluster
    from kubernetes_tpu_torch.ops.node_state import PodEncoder
    feats = PodEncoder(infos, b, state_encoder=sched.encoder).encode(probe)
    pod_in = sched._pod_arrays(feats)
    cargs = (nodes, pod_in, 123, 45, b.n_real, b.n_real, 4)
    keys = ("selected", "found", "evaluated", "max_score", "total", "kept",
            "feasible", "fail_first", "general_bits", "next_last_index",
            "next_last_node_index")

    def pick(o):
        return {k: o[k] for k in keys}
    node_bytes = sum(v.numel() * v.element_size() for v in nodes.values())
    entry("schedule_cycle", pick(K.schedule_cycle(*cargs)),
          pick(K.schedule_cycle_plain(*cargs)),
          lambda: K.schedule_cycle(*cargs),
          lambda: K.schedule_cycle_plain(*cargs), 50, 5,
          node_bytes + n_pad * (8 + 1 + 1 + 1 + 8))

    # K3 uniform_burst: the headline burst's one launch, on the main
    # path's own input (the empty cluster, lastNodeIndex 0) ...
    cap = 16384
    state_bytes = n_pad * (1 + 3 * 8 + 8 + 5 * 8 * 2)   # valid, alloc x3,
    #   K1 scores, five carried rows read and written
    e_infos, e_tree = cluster(N_NODES)
    e_sched = TorchScheduler(percentage_of_nodes_to_score=100,
                             node_tree=e_tree, device=device)
    e_names = e_tree.list_names()
    eb = e_sched.encoder.encode(e_infos, e_names)
    e_nodes = e_sched._node_arrays(eb)
    f0 = PodEncoder(e_infos, eb, state_encoder=e_sched.encoder).encode(probe)
    cls, extra_ok, ban = e_sched._uniform_class(probe, f0, eb, e_infos)
    ukw = dict(extra_ok=extra_ok, ban=ban, cap=cap)
    uargs = (e_nodes, cls, N_PODS, 0, eb.n_real, True)
    entry("uniform_burst", K.schedule_batch_uniform(*uargs, **ukw),
          K.schedule_batch_uniform_plain(*uargs, **ukw),
          lambda: K.schedule_batch_uniform(*uargs, **ukw),
          lambda: K.schedule_batch_uniform_plain(*uargs, **ukw), 20, 2,
          state_bytes + (cap + 1) * 4)
    # ... and on the filled cluster, where every 7th node leaves the tie
    # set after one more pod: STAY batches cut every ~7 pods
    sargs = (nodes, cls, N_PODS, 7, b.n_real, True)
    entry("uniform_burst", K.schedule_batch_uniform(*sargs, **ukw),
          K.schedule_batch_uniform_plain(*sargs, **ukw),
          lambda: K.schedule_batch_uniform(*sargs, **ukw),
          lambda: K.schedule_batch_uniform_plain(*sargs, **ukw), 5, 1,
          state_bytes + (cap + 1) * 4,
          label="filled cluster: 3 pods on every 7th node, lni 7")

    # K4 scatter_rows: 16 dirty rows (the serial path's bucket) of every field
    rows = np.arange(0, 16 * 97, 97, dtype=np.int32)
    upd = {k: np.asarray(getattr(b, k))[rows] for k in nodes}
    dev_a = {k: v.clone() for k, v in nodes.items()}
    dev_b = {k: v.clone() for k, v in nodes.items()}
    for k in upd:
        if upd[k].dtype == np.int64:
            upd[k] = upd[k] + 1
    # updates already on the card for all three timings, so each times
    # the scatter itself and not the uploads
    rows_t = torch.as_tensor(rows).to(device)
    rows_l = rows_t.long()
    upd_t = {k: torch.as_tensor(v).to(device) for k, v in upd.items()}
    K.scatter_rows(dev_a, rows_t, upd_t)
    K.scatter_rows_plain(dev_b, rows_t, upd_t)

    def library():
        for k, v in upd_t.items():
            dev_b[k].index_copy_(0, rows_l, v)
    library_ms = cuda_time(library, sync, 200)
    row_bytes = sum(v.element_size() * (v.numel() // v.shape[0])
                    for v in nodes.values())
    entry("scatter_rows", dev_a, dev_b,
          lambda: K.scatter_rows(dev_a, rows_t, upd_t),
          lambda: K.scatter_rows_plain(dev_b, rows_t, upd_t), 200, 50,
          len(rows) * (2 * row_bytes + 4), library_ms=library_ms)
    return out


def _rand_nodes(rng, n_pad, n_real, s_count, zones, device):
    """A random node matrix: mixed capacities, some rows over capacity."""
    import numpy as np
    import torch
    i64 = np.int64
    alloc_cpu = rng.choice([0, 2000, 4000, 8000], n_pad).astype(i64)
    alloc_mem = rng.choice([0, 8, 16, 32], n_pad).astype(i64) * GI
    host = {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": alloc_cpu, "alloc_mem": alloc_mem,
        "alloc_eph": rng.choice([0, 10, 50], n_pad).astype(i64) * GI,
        "allowed_pods": rng.choice([4, 8, 110], n_pad).astype(i64),
        "req_cpu": (alloc_cpu * rng.random(n_pad) * 1.1).astype(i64),
        "req_mem": (alloc_mem * rng.random(n_pad) * 1.1).astype(i64),
        "req_eph": rng.integers(0, 20, n_pad).astype(i64) * GI,
        "nz_cpu": rng.integers(0, 4000, n_pad).astype(i64),
        "nz_mem": rng.integers(0, 16, n_pad).astype(i64) * GI,
        "pod_count": rng.integers(0, 9, n_pad).astype(i64),
        "alloc_scalar": rng.integers(0, 8, (n_pad, s_count)).astype(i64),
        "req_scalar": rng.integers(0, 6, (n_pad, s_count)).astype(i64),
        "zone_id": rng.integers(0, zones, n_pad).astype(np.int32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def _rand_pod(rng, n_pad, s_count, dense):
    """A random pod input of K2: each per-node family dense or inert."""
    import numpy as np
    pod = {"req_cpu": np.int64(500), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI),
           "req_scalar": rng.integers(0, 2, s_count).astype(np.int64),
           "has_request": np.bool_(True), "unknown_scalar": np.bool_(False),
           "skip": np.bool_(False), "check_resources": np.bool_(True),
           "nz_cpu": np.int64(500), "nz_mem": np.int64(GI)}
    for k in ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
              "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok"):
        pod[k] = (rng.random(n_pad) < 0.9) if dense else np.ones(1, bool)
    pod["interpod_code"] = rng.choice([0, 0, 0, 1, 2, 3], n_pad).astype(
        np.int8) if dense else np.zeros(1, np.int8)
    for k, hi in (("node_aff_counts", 200), ("taint_counts", 5),
                  ("spread_counts", 7), ("interpod_counts", 9)):
        pod[k] = rng.integers(0, hi, n_pad).astype(np.int64) if dense \
            else np.zeros(1, np.int64)
    if dense:
        pod["interpod_counts"] -= 4
    pod["interpod_tracked"] = (rng.random(n_pad) < 0.7) if dense \
        else np.zeros(1, bool)
    pod["image_sums"] = rng.integers(0, 1200, n_pad).astype(np.int64) * MI \
        if dense else np.zeros(1, np.int64)
    pod["prefer_avoid"] = np.where(rng.random(n_pad) < 0.2, 0, 10).astype(
        np.int64) if dense else np.full(1, 10, np.int64)
    return pod


def variant_checks(device, sync):
    """Every mode and score family of the kernels against the plain
    versions on random inputs (the main path exercises only the plain
    density burst): K1 per weight family and weight row, K2 with every
    per-node family dense or inert in the identity, perm and pos walks
    and with a weight table, K3 with rotation, ban + extra_ok, carried
    ephemeral/scalar rows, a weight table and a saturated tail, K4 with
    duplicate and out-of-range rows."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261017)
    n_pad, n_real, s_count, zones = 4096, 4000, 2, 6
    axis = K.PRIORITY_AXIS
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    weight_cases = [
        dict(K.DEFAULT_WEIGHTS),
        {**K.DEFAULT_WEIGHTS, "least_requested": 0, "most_requested": 2},
        {**K.DEFAULT_WEIGHTS, "least_requested": 0, "rtcr": 3},
        {**K.DEFAULT_WEIGHTS, "balanced": 5, "least_requested": 2},
    ]
    nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(axis)))).to(device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(axis)}
    # K1
    for w in weight_cases:
        args = (w, nodes["req_cpu"], nodes["req_mem"], nodes["alloc_cpu"],
                nodes["alloc_mem"])
        same("local_total", K.local_total(*args), K.local_total_plain(*args))
        same("local_total/wrow", K.local_total(*args, wrow=wtab[1]),
             K.local_total_plain(*args, wrow=wtab[1]))
    # K2
    perm = np.concatenate([rng.permutation(n_real),
                           np.arange(n_real, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    perm_t = torch.as_tensor(perm).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    keys = ("selected", "found", "evaluated", "max_score", "total", "kept",
            "feasible", "fail_first", "general_bits", "next_last_index",
            "next_last_node_index")
    for dense in (False, True):
        pod = _rand_pod(rng, n_pad, s_count, dense)
        for w in weight_cases:
            for li, lni, ntf in ((0, 0, n_real), (37, 11, 900),
                                 (3999, 2 ** 33 + 7, 50)):
                for mode in ("identity", "perm", "pos"):
                    kw = {}
                    if mode == "perm":
                        kw = dict(perm=perm_t, inv_perm=inv_t)
                    elif mode == "pos":
                        kw = dict(pos=inv_t)
                        ntf = n_real
                    args = (nodes, pod, li, lni, ntf, n_real, 8)
                    got = K.schedule_cycle(*args, weights=w, **kw)
                    want = K.schedule_cycle_plain(*args, weights=w, **kw)
                    same(f"schedule_cycle/{mode}",
                         {k: got[k] for k in keys},
                         {k: want[k] for k in keys})
        for pid in (0, 2, 7):
            p = dict(pod, profile_id=np.int64(pid))
            args = (nodes, p, 5, 3, n_real, n_real, 8)
            got = K.schedule_cycle(*args, weights=union, wtab=wtab)
            want = K.schedule_cycle_plain(*args, weights=union, wtab=wtab)
            same("schedule_cycle/wtab", {k: got[k] for k in keys},
                 {k: want[k] for k in keys})
    # K3: a fresh, roomy cluster and a class with every carried row kind
    fresh = {k: v.clone() for k, v in nodes.items()}
    for k in ("req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem",
              "pod_count", "req_scalar"):
        fresh[k].zero_()
    fresh["alloc_cpu"].fill_(4000)
    fresh["alloc_mem"].fill_(32 * GI)
    fresh["allowed_pods"].fill_(110)
    fresh["alloc_scalar"].fill_(40)
    base = {"req_cpu": 100, "req_mem": 500 * MI, "req_eph": 0,
            "req_scalar": np.zeros(s_count, np.int64), "nz_cpu": 100,
            "nz_mem": 500 * MI, "upd_cpu": 100, "upd_mem": 500 * MI,
            "upd_eph": 0, "upd_scalar": np.zeros(s_count, np.int64),
            "has_request": True}
    carried = dict(base, req_eph=GI, upd_eph=GI,
                   req_scalar=np.array([1, 2], np.int64),
                   upd_scalar=np.array([1, 0], np.int64))
    rows = [np.concatenate([np.arange(n_real), np.full(n_pad + 1 - n_real,
                                                       n_pad)])]
    for _ in range(3):
        rows.append(np.concatenate([rng.permutation(n_real),
                                    np.full(n_pad + 1 - n_real, n_pad)]))
    perms = torch.as_tensor(np.stack(rows).astype(np.int32)).to(device)
    cap = 4096
    seq = np.zeros(cap + K.K_BATCH, np.int32)
    seq[1:700] = 2
    seq[700:] = rng.integers(0, 4, len(seq) - 700)
    seq_t = torch.as_tensor(seq).to(device)
    extra = torch.as_tensor(rng.random(n_pad) < 0.8).to(device)
    cases = [
        ("plain", base, 3000, 0, {}),
        ("lni", base, 3000, 2 ** 31 - 9, {}),
        ("rotate", base, 3000, 5, dict(rotation=(perms, seq_t))),
        ("ban+extra_ok", base, 3000, 1, dict(ban=True, extra_ok=extra)),
        ("carried rows", carried, 3000, 3, {}),
        ("weight table", base, 3000, 2, dict(weights=union, wtab=wtab,
                                             pid=1)),
        ("saturated", dict(base, req_cpu=3000, upd_cpu=3000, nz_cpu=3000),
         4096, 4, {}),
    ]
    for name, cls, n_pods, lni, kw in cases:
        args = (fresh, cls, n_pods, lni, n_real, True)
        got = K.schedule_batch_uniform(*args, cap=cap, **kw)
        want = K.schedule_batch_uniform_plain(*args, cap=cap, **kw)
        same(f"uniform_burst/{name}", got, want)
    # K4: duplicates repeat row 0's values; out-of-range rows are dropped
    rws = np.concatenate([rng.choice(n_pad - 8, 20, replace=False),
                          [n_pad + 5, -3]]).astype(np.int32)
    rws = np.concatenate([rws, np.full(10, rws[0], np.int32)])
    upd = {k: v.cpu().numpy()[np.clip(rws, 0, n_pad - 1)].copy()
           for k, v in nodes.items()}
    for k, v in upd.items():
        if v.dtype == np.int64:
            v += rng.integers(0, 100, v.shape)
        v[22:] = v[0]
    dev_a = {k: v.clone() for k, v in nodes.items()}
    dev_b = {k: v.clone() for k, v in nodes.items()}
    same("scatter_rows", K.scatter_rows(dev_a, rws, upd),
         K.scatter_rows_plain(dev_b, rws, upd))
    sync()
    print(f"[variants] {checked} kernel calls equal to their plain "
          f"versions (every K2 family dense and inert; identity, perm and "
          f"pos walks; K3 rotate, ban + extra_ok, carried rows, weight "
          f"table, saturated tail; K4 duplicate and out-of-range rows)")


def small_world_check(device, sync):
    """A burst decides exactly what one serial cycle per pod decides."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    for n_nodes in (60, 61):
        decided = []
        for mode in ("burst", "serial"):
            infos, tree = cluster(n_nodes)
            sched = TorchScheduler(percentage_of_nodes_to_score=100,
                                   node_tree=tree, device=device)
            batch = pods(400)
            if mode == "burst":
                hosts = sched.schedule_burst(batch, infos, tree.list_names())
            else:
                hosts = []
                for p in batch:
                    h = sched.schedule(p, infos,
                                       tree.list_names()).suggested_host
                    assume(infos, p, h)
                    hosts.append(h)
            decided.append(hosts)
        if decided[0] != decided[1]:
            raise SystemExit(f"burst != serial cycles on {n_nodes} nodes")
    print("[check] burst == serial cycles on 60 and 61 nodes (400 pods)")


def _spec(req_cpu, dense, rng, n_pad, s_count):
    """A random pod-spec row of the scan kernels: `_rand_pod` plus the
    fold deltas."""
    import numpy as np
    d = _rand_pod(rng, n_pad, s_count, dense)
    d.update(req_cpu=np.int64(req_cpu), nz_cpu=np.int64(req_cpu),
             upd_cpu=np.int64(req_cpu), upd_mem=np.int64(GI),
             upd_eph=np.int64(0),
             upd_scalar=rng.integers(0, 2, s_count).astype(np.int64))
    return d


def scan_variant_checks(device, sync):
    """K5 and K6 against their plain versions on random inputs, in every
    mode: identity, perm and pos walks, the carried spread vector, a
    weight table with per-pod profile ids, dense and inert fields mixed in
    one window, skip padding, carry_in chaining; for K6 also gang rewinds,
    a singleton failure, the rank-aware gang score and n_pods < B."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261018)
    n_pad, n_real, s_count, zones, B = 4096, 4000, 2, 6, 256
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
    for k in ("req_cpu", "req_mem", "pod_count"):
        nodes[k] = nodes[k] // 3        # room for the window's pods
    perms = np.stack([np.arange(n_pad)] + [
        np.concatenate([rng.permutation(n_real), np.arange(n_real, n_pad)])
        for _ in range(3)]).astype(np.int32)
    inv = np.empty_like(perms)
    for i in range(len(perms)):
        inv[i, perms[i]] = np.arange(n_pad, dtype=np.int32)
    perms_t = torch.as_tensor(perms).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    oid = rng.integers(0, 4, B).astype(np.int32)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                           ).to(device)
    wtab[:, K.PRIORITY_AXIS.index("gang_locality")] = torch.tensor(
        [0, 3, 5], device=device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(K.PRIORITY_AXIS)}
    specs = [_spec(500, False, rng, n_pad, s_count),
             _spec(1000, True, rng, n_pad, s_count),
             _spec(2000, False, rng, n_pad, s_count),
             _spec(7000, False, rng, n_pad, s_count)]
    n_pods = 200
    rows = np.concatenate([rng.integers(0, 3, n_pods),
                           np.full(B - n_pods, 4)])
    pad = dict(specs[0], skip=np.bool_(True))
    prof = rng.integers(-1, 4, B)

    def stack(spread=False, with_prof=False, rows=rows):
        sp = [dict(d) for d in specs] + [dict(pad)]
        if spread:
            for d in sp:
                d["spread_counts"] = np.zeros(1, np.int64)
        return K.PodStack.from_specs(sp, rows, prof if with_prof else None,
                                     device)
    spread0 = torch.as_tensor(rng.integers(0, 5, n_pad)).to(device)
    cases = [
        ("identity", {}, 900),
        ("perm", dict(rotation=(perms_t, inv_t, oid)), 700),
        ("pos", dict(rotation_pos=(inv_t, oid)), n_real),
        ("spread", dict(spread0=spread0), 900),
        ("weight table", dict(weights=union, wtab=wtab), n_real),
    ]
    for name, kw, ntf in cases:
        st = stack(spread=name == "spread", with_prof=name == "weight table")
        args = (nodes, st, 37, 11, ntf, n_real, 8)
        got = K.schedule_batch(*args, **kw)
        want = K.schedule_batch_plain(*args, **kw)
        same(f"schedule_batch/{name}", got, want)
        if name == "spread":
            # chain a second window on the first one's device carry
            args2 = (nodes, st, got[1], got[2], ntf, n_real, 8)
            same("schedule_batch/carry_in",
                 K.schedule_batch(*args2, carry_in=(got[0], got[3])),
                 K.schedule_batch_plain(*args2,
                                        carry_in=(want[0], want[3])))
    # K6: singleton runs, gangs (spec 3 asks 7 CPU: its 60-member gang
    # cannot all fit and rewinds), a failing 9-CPU singleton, padding
    big = dict(specs[0], req_cpu=np.int64(9000), nz_cpu=np.int64(9000),
               upd_cpu=np.int64(9000))
    sp = [dict(d) for d in specs] + [dict(pad), big]
    layout = [(0, 20, False), (1, 30, True), (3, 60, True), (2, 15, False),
              (1, 40, True), (5, 1, False), (0, 10, False)]
    seg = np.zeros(B, bool)
    gang = np.zeros(B, bool)
    rws = np.full(B, 4)
    i = 0
    for spec, length, g in layout:
        seg[i] = True
        gang[i: i + length] = g
        rws[i: i + length] = spec
        i += length
    seg[i] = True
    n_pods = i
    seg_t = torch.as_tensor(seg).to(device)
    gang_t = torch.as_tensor(gang).to(device)
    for name, kw, ntf, np_ in [
            ("axis", {}, 900, n_pods),
            ("perm", dict(rotation=(perms_t, inv_t, oid)), 700, n_pods),
            ("pos", dict(rotation_pos=(inv_t, oid)), n_real, n_pods),
            ("gang score + weight table",
             dict(weights=union, wtab=wtab, gang_score=True), n_real,
             n_pods),
            ("spread carry", dict(spread0=spread0), 900, n_pods),
            ("n_pods < B, stops mid-gang", {}, 900, 100)]:
        st = K.PodStack.from_specs(sp, rws, prof if "wtab" in kw else None,
                                   device)
        args = (nodes, st, seg_t, gang_t, np_, 5, 9, ntf, n_real, 8)
        got = K.schedule_batch_segments(*args, **kw)
        want = K.schedule_batch_segments_plain(*args, **kw)
        same(f"schedule_segments/{name}", got, want)
        sel = want[4][:B].cpu().numpy()
        if name == "axis":
            g = sel[50:110]
            if not ((g >= 0).any() and (g < 0).any()):
                raise SystemExit("variant schedule_segments: the 7-CPU "
                                 "gang did not rewind part way")
    sync()
    print(f"[variants] {checked} scan kernel calls equal to their plain "
          f"versions (K5 identity, perm, pos, spread carry + carry_in, "
          f"weight table; K6 axis, perm, pos, gang score + weight table, "
          f"spread carry, n_pods < B; dense/inert mixes, skip padding, gang "
          f"rewinds, a "
          f"singleton failure)")


MIXED_PROFILES = [
    {"schedulerName": "default-scheduler"},
    # MostRequested in place of LeastRequested (the ClusterAutoscaler
    # provider's vector)
    {"schedulerName": "packer", "priorities": {
        "SelectorSpreadPriority": 1, "InterPodAffinityPriority": 1,
        "MostRequestedPriority": 1, "BalancedResourceAllocation": 1,
        "NodePreferAvoidPodsPriority": 10000, "NodeAffinityPriority": 1,
        "TaintTolerationPriority": 1, "ImageLocalityPriority": 1}},
]
FUSED_PROFILES = [{"schedulerName": "default-scheduler",
                   "rankAwareGang": True, "gangWeight": 2}]


def mixed_labels(i):
    out = {}
    if i % 3 == 0:
        out["disktype"] = "ssd"
    if i % 5 == 0:
        out["tier"] = "gold"
    return out


def mixed_window(n_pods):
    """Four Deployment shapes, interleaved: (100m, 500 Mi); (250m, 1 Gi);
    (500m, 2 Gi) on disktype=ssd; (1 CPU, 4 Gi) preferring tier=gold
    (weight 50). The last two use the `packer` profile."""
    from kubernetes_tpu_torch.api import types as T
    gold = T.Affinity(node_affinity=T.NodeAffinity(preferred=(
        T.PreferredSchedulingTerm(weight=50, preference=T.NodeSelectorTerm(
            match_expressions=(T.Requirement(key="tier", op=T.IN,
                                             values=("gold",)),))),)))
    shapes = [
        pods(n_pods, prefix="web", cpu=100, mem=500 * MI, app="web"),
        pods(n_pods, prefix="api", cpu=250, mem=GI, app="api"),
        pods(n_pods, prefix="db", cpu=500, mem=2 * GI, app="db",
             node_selector={"disktype": "ssd"},
             scheduler_name="packer"),
        pods(n_pods, prefix="batch", cpu=1000, mem=4 * GI, app="batch",
             affinity=gold, scheduler_name="packer"),
    ]
    return [shapes[j % 4][j] for j in range(n_pods)]


def spread_window(n_pods):
    return pods(n_pods, prefix="spread", app="spread")


def spread_services():
    from kubernetes_tpu_torch.api.types import Service
    return [Service(name="spread", selector={"app": "spread"})]


def rack_labels(i):
    # every 375th node of 15,000: 40 nodes
    return {"rack": "r0"} if i % (N_NODES // RACK_NODES) == 0 else {}


def fused_window(with_rack=True):
    """One drain window: 100 gangs of 64 (500m / 1 Gi) interleaved with
    singleton runs of 36 (100m / 500 Mi), and after the fifth gang one gang
    of 64 x 3 CPU on rack=r0, which 40 nodes carry: 40 members place, the
    41st fails, and the gang rewinds."""
    segs = []
    for g in range(N_GANGS):
        segs.append((pods(RUN_SIZE, prefix=f"run{g}"), False))
        segs.append((pods(GANG_SIZE, prefix=f"gang{g}", cpu=500, mem=GI,
                          app=f"gang{g}"), True))
        if g == 4 and with_rack:
            segs.append((pods(GANG_SIZE, prefix="rack", cpu=3000, mem=GI,
                              app="rack", node_selector={"rack": "r0"}),
                         True))
    return segs


def prefix_segments(segs, n):
    """The leading segments holding at least `n` pods."""
    out, k = [], 0
    for seg in segs:
        if k >= n:
            break
        out.append(seg)
        k += len(seg[0])
    return out


def make_sched(tree, device, pct, services=(), profiles=None):
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.profiles import ProfileSet
    sched = TorchScheduler(percentage_of_nodes_to_score=pct, node_tree=tree,
                           device=device,
                           services_fn=lambda: list(services))
    if profiles is not None:
        sched.set_profiles(ProfileSet.from_dict({"profiles": profiles}))
    return sched


def mutable_rows(sched):
    from kubernetes_tpu_torch.ops.kernels import _MUTABLE
    if sched._dev_nodes is None:
        return None
    return {k: sched._dev_nodes[k].cpu() for k in _MUTABLE}


def run_scan(cfg, n_nodes, window, n_serial, device, sync):
    """One scan path: the window through schedule_burst, the assume loop,
    then `n_serial` serial cycles."""
    infos, tree = cluster(n_nodes, cfg.get("labels"))
    sched = make_sched(tree, device, cfg["pct"], cfg.get("services", ()),
                       cfg.get("profiles"))
    t0 = time.perf_counter()
    hosts = sched.schedule_burst(window, infos, tree.list_names())
    sync()
    t_burst = time.perf_counter() - t0
    if hosts is None:
        raise SystemExit(f"{cfg['name']}: the window was refused")
    rows = mutable_rows(sched)
    counters = (sched.last_index, sched.last_node_index)
    kf = hosts.index(None) if None in hosts else len(hosts)
    t1 = time.perf_counter()
    gens = [assume(infos, p, h) for p, h in zip(window[:kf], hosts[:kf])]
    sched.note_burst_assumed_many(window[:kf], hosts[:kf], gens)
    if kf:
        tree.advance_enumerations(kf - 1)
    t_assume = time.perf_counter() - t1
    serial = []
    t2 = time.perf_counter()
    for p in pods(n_serial, prefix="serial"):
        r = sched.schedule(p, infos, tree.list_names())
        serial.append((r.suggested_host, r.evaluated_nodes,
                       r.feasible_nodes, tuple(r.host_priority)))
        assume(infos, p, r.suggested_host)
    sync()
    return {"hosts": hosts, "serial": serial, "sched": sched, "rows": rows,
            "counters": counters, "t_burst": t_burst, "t_assume": t_assume,
            "t_serial": time.perf_counter() - t2,
            "phases": dict(sched.last_burst_phases or {})}


def run_fused(cfg, n_nodes, segments, device, sync):
    """One fused drain window, committed as the shell commits it."""
    infos, tree = cluster(n_nodes, cfg.get("labels"))
    sched = make_sched(tree, device, cfg["pct"], (), cfg.get("profiles"))
    t0 = time.perf_counter()
    res = sched.schedule_burst_fused(segments, infos, tree.list_names())
    sync()
    t_burst = time.perf_counter() - t0
    if res is None:
        raise SystemExit(f"{cfg['name']}: the window was refused")
    placed, hosts = [], []
    for (seg, _g), rec in zip(segments, res["segments"]):
        if rec["status"] in ("decided", "failed"):
            placed += seg[:len(rec["hosts"])]
            hosts += rec["hosts"]
    gens = [assume(infos, p, h) for p, h in zip(placed, hosts)]
    sched.note_burst_assumed_many(placed, hosts, gens)
    if res["consumed"] > 0:
        tree.advance_enumerations(res["consumed"] - 1)
    return {"res": res, "sched": sched, "rows": mutable_rows(sched),
            "counters": (sched.last_index, sched.last_node_index),
            "t_burst": t_burst, "phases": dict(sched.last_burst_phases)}


def _records(res):
    """A fused result without its numpy counter sequences."""
    return [{k: (list(map(int, v)) if k.endswith("_seq") else v)
             for k, v in r.items()} for r in res["segments"]]


def same_rows(name, a, b):
    if (a is None) != (b is None):
        raise SystemExit(f"{name}: folded rows kept on one side only")
    if a is not None and max_abs_err(a, b) != 0:
        raise SystemExit(f"{name}: folded rows differ "
                         f"({first_diff(a, b)})")


class capture:
    """Record the inputs of the first call of a kernel entry point (node
    tensors cloned), so the kernel check runs on the main path's own
    inputs, and the result of its last call."""

    def __init__(self, fn_name):
        self.fn_name = fn_name
        self.call = self.last = None

    def __enter__(self):
        from kubernetes_tpu_torch.ops import kernels as K
        real = self.real = getattr(K, self.fn_name)

        def rec(nodes, *args, **kw):
            if self.call is None:
                self.call = ({k: v.clone() for k, v in nodes.items()},
                             args, dict(kw))
            self.last = real(nodes, *args, **kw)
            return self.last
        setattr(K, self.fn_name, rec)
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.ops import kernels as K
        setattr(K, self.fn_name, self.real)


def scan_bound(nodes, stack, n_cycles, n_real, out_bytes):
    """(bound_ms, bound_by) of one scan window: its bytes (node fields and
    pod tables read once, mutable rows written once, the decision block)
    over the memory rate, against its integer work (OPS_PER_NODE_CYCLE per
    node per cycle run) over the non-tensor peak."""
    nbytes = sum(v.numel() * v.element_size() for v in nodes.values())
    nbytes += sum(v.numel() * v.element_size()
                  for v in stack.table.values())
    nbytes += 8 * 7 * nodes["valid"].shape[0] + out_bytes + 12 * len(stack)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = n_cycles * n_real * OPS_PER_NODE_CYCLE / H100_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def call_entry(report, name, fn, plain, call, bound, sync, reps, label):
    """Hold a kernel against its plain version on one captured call of its
    main path, time both (the plain version once), file its report entry;
    returns the kernel's ms."""
    import torch
    nodes, args, kw = call
    got = fn(nodes, *args, **kw)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    want = plain(nodes, *args, **kw)
    end.record()
    sync()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with plain (max_abs_err "
                         f"{err}; first difference {first_diff(got, want)})")
    ms = cuda_time(lambda: fn(nodes, *args, **kw), sync, reps)
    report[name] = {"name": name, "route": "cuda",
                    "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": None}
    print(f"[kernel] {name}: equal to plain on {label} (max_abs_err 0), "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound[0]:.6f} ({bound[1]})")
    return ms


def scan_kernel_entry(report, name, fn, plain, call, n_cycles, n_pods,
                      out_bytes, sync):
    """call_entry for a scan kernel on one whole window of its path."""
    nodes, args, _kw = call
    bound = scan_bound(nodes, args[0], n_cycles, int(nodes["valid"].sum()),
                       out_bytes)
    ms = call_entry(report, name, fn, plain, call, bound, sync, 3,
                    f"the whole {n_pods}-pod window")
    print(f"[kernel] {name}: {ms / n_pods * 1e3:.2f} us/pod")


def path_report(name, n_nodes, n_pods, run, counts, extra=""):
    ph = run["phases"]
    t = run["t_burst"]
    print(f"[path] {name}: {n_nodes} nodes, {n_pods} pods, "
          f"{n_pods / t:.1f} pods/s ({t * 1e3:.2f} ms: encode "
          f"{ph['encode'] * 1e3:.2f} (node mirror {ph['mirror'] * 1e3:.2f}) "
          f"dispatch {ph['dispatch'] * 1e3:.2f} fetch "
          f"{ph['fetch'] * 1e3:.2f}); launches {counts}{extra}")


def scan_path(cfg, n_nodes, window_fn, device, sync, report, check):
    """A scan path: the whole window on the kernels (launches counted),
    then the first PREFIX pods on the kernels and on the plain versions,
    which must agree in decisions, walk counters, folded rows and serial
    cycles, and must be the whole run's first decisions."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    name = cfg["name"]
    window = window_fn(N_PODS)
    obs.reset()
    with capture("schedule_batch") as cap:
        run = run_scan(cfg, n_nodes, window, cfg["serial"], device, sync)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    for k in cfg["kernels"]:
        if counts[k] == 0:
            raise SystemExit(f"{name}: {k} was not launched on the path")
    placed = sum(h is not None for h in run["hosts"])
    if placed != N_PODS:
        raise SystemExit(f"{name}: placed {placed} of {N_PODS}")
    short = window_fn(PREFIX)
    kern = run_scan(cfg, n_nodes, short, cfg["serial"], device, sync)
    with plain_versions():
        ref = run_scan(cfg, n_nodes, short, cfg["serial"], device, sync)
    if kern["hosts"] != ref["hosts"] or kern["serial"] != ref["serial"] \
            or kern["counters"] != ref["counters"]:
        raise SystemExit(f"{name}: the first {PREFIX} pods differ from "
                         f"the plain path")
    same_rows(name, kern["rows"], ref["rows"])
    if run["hosts"][:PREFIX] != kern["hosts"]:
        raise SystemExit(f"{name}: the window's first {PREFIX} decisions "
                         f"differ from the {PREFIX}-pod window's")
    if check is not None:
        check(cap.call, run)
    add_launches(report, counts)
    rot = run["sched"]._tree_rotates()
    path_report(name, n_nodes, N_PODS, run, counts,
                f"; rotating walk {rot}; assume loop "
                f"{run['t_assume'] * 1e3:.1f} ms; {cfg['serial']} serial "
                f"cycles {run['t_serial'] * 1e3:.1f} ms; first {PREFIX} "
                f"pods, counters, rows and serial cycles equal to the plain "
                f"path")


def fused_path(cfg, device, sync, report, check):
    """The fused-gang path: the whole window on K6 (launches counted); the
    rack gang is rejected after placing 40 members, and the window without
    it ends in the same rows, counters and consumed enumerations; its
    first >= PREFIX pods agree with the plain path."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    name = cfg["name"]
    segs = fused_window()
    n_pods = sum(len(s) for s, _g in segs)
    obs.reset()
    with capture("schedule_batch_segments") as cap:
        run = run_fused(cfg, N_NODES, segs, device, sync)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    if counts["schedule_segments"] == 0:
        raise SystemExit(f"{name}: schedule_segments was not launched")
    recs = run["res"]["segments"]
    rack = next(i for i, (s, _g) in enumerate(segs)
                if s[0].name.startswith("rack"))
    if recs[rack]["status"] != "rejected" \
            or recs[rack]["placed"] != RACK_NODES:
        raise SystemExit(f"{name}: the rack gang was {recs[rack]}")
    others = [r for i, r in enumerate(recs) if i != rack]
    if any(r["status"] != "decided" for r in others):
        raise SystemExit(f"{name}: not every other segment was decided")
    bare = run_fused(cfg, N_NODES, fused_window(with_rack=False), device,
                     sync)
    if _records({"segments": others}) != _records(bare["res"]) \
            or run["counters"] != bare["counters"] \
            or run["res"]["consumed"] != bare["res"]["consumed"]:
        raise SystemExit(f"{name}: the window differs from one without "
                         f"the rejected gang")
    same_rows(name + " (without the rejected gang)", run["rows"],
              bare["rows"])
    short = prefix_segments(segs, PREFIX)
    kern = run_fused(cfg, N_NODES, short, device, sync)
    with plain_versions():
        ref = run_fused(cfg, N_NODES, short, device, sync)
    if _records(kern["res"]) != _records(ref["res"]) \
            or kern["counters"] != ref["counters"] \
            or kern["res"]["consumed"] != ref["res"]["consumed"]:
        raise SystemExit(f"{name}: the first segments differ from the "
                         f"plain path")
    same_rows(name, kern["rows"], ref["rows"])
    if _records(kern["res"]) != _records(run["res"])[:len(short)]:
        raise SystemExit(f"{name}: the window's first segments differ "
                         f"from the short window's")
    if check is not None:
        check(cap.call, run, n_pods)
    add_launches(report, counts)
    n_short = sum(len(s) for s, _g in short)
    path_report(name, N_NODES, n_pods, run, counts,
                f"; {len(segs)} segments, rack gang rejected after "
                f"{RACK_NODES} members, window without it equal (rows, "
                f"counters, "
                f"{run['res']['consumed']} enumerations); first "
                f"{len(short)} segments ({n_short} pods) equal to the "
                f"plain path")


def add_launches(report, counts):
    """Add a path's launch counts to the kernels' report entries."""
    for k, v in counts.items():
        if v:
            report[k]["launches"] += v


def scan_paths(device, sync, report):
    """The K5 and K6 paths, each kernel held against its plain version on
    its main path's whole window first."""
    from kubernetes_tpu_torch.ops import kernels as K

    def k5_check(call, run):
        n_cycles = N_PODS
        scan_kernel_entry(report, "schedule_batch", K.schedule_batch,
                          K.schedule_batch_plain, call, n_cycles, N_PODS,
                          len(call[1][0]) * (3 * 4 + 5 * 8), sync)

    def k6_check(call, run, n_pods):
        rec = run["res"]["segments"]
        # every placed pod, plus the rack gang's placed members and the
        # member that failed
        n_cycles = sum(len(r.get("hosts", ())) for r in rec) + RACK_NODES + 1
        scan_kernel_entry(report, "schedule_segments",
                          K.schedule_batch_segments,
                          K.schedule_batch_segments_plain, call, n_cycles,
                          n_pods, len(call[1][0]) * 4 * 4, sync)

    default = {"name": "scan-default", "pct": 50, "serial": N_SERIAL,
               "kernels": ("schedule_batch", "local_total",
                           "schedule_cycle", "scatter_rows")}
    scan_path(default, N_NODES, pods, device, sync, report, k5_check)
    scan_path(dict(default, name="scan-default (uneven zones, perm walk)"),
              N_NODES + 1, pods, device, sync, report, None)
    scan_path({"name": "scan-mixed", "pct": 100, "serial": 0,
               "labels": mixed_labels, "profiles": MIXED_PROFILES,
               "kernels": ("schedule_batch",)},
              N_NODES + 1, mixed_window, device, sync, report, None)
    scan_path({"name": "scan-spread", "pct": 100, "serial": 0,
               "services": spread_services(),
               "kernels": ("schedule_batch",)},
              N_NODES, spread_window, device, sync, report, None)
    fused_path({"name": "fused-gang", "pct": 50, "labels": rack_labels,
                "profiles": FUSED_PROFILES}, device, sync, report, k6_check)


def main_path(name, n_nodes, device, sync, report):
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    obs.reset()
    run = run_path(n_nodes, N_PODS, N_SERIAL, device, sync)
    rotates = run["sched"]._tree_rotates()
    counts = K.launches()
    refusals = obs.family("refusal")
    fetches = obs.family("fetch")
    with plain_versions():
        ref = run_path(n_nodes, N_PODS, N_SERIAL, device, sync)
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    missing = [k for k in UNIFORM_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    if run["hosts"] != ref["hosts"] or run["serial"] != ref["serial"]:
        raise SystemExit(f"{name}: decisions differ from the plain path")
    placed = sum(h is not None for h in run["hosts"])
    if placed != N_PODS:
        raise SystemExit(f"{name}: placed {placed} of {N_PODS}")
    sched = run["sched"]
    if sched.last_node_index != ref["sched"].last_node_index:
        raise SystemExit(f"{name}: lastNodeIndex differs")
    ph = run["phases"]
    print(f"[path] {name}: {n_nodes} nodes (rotating walk: {rotates}), "
          f"{N_PODS} pods placed, "
          f"{N_PODS / run['t_burst']:.1f} pods/s burst "
          f"({run['t_burst'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"(node mirror {ph['mirror'] * 1e3:.2f}) "
          f"dispatch {ph['dispatch'] * 1e3:.2f} fetch "
          f"{ph['fetch'] * 1e3:.2f}); "
          f"assume loop {run['t_assume'] * 1e3:.1f} ms; {N_SERIAL} serial "
          f"cycles {run['t_serial'] * 1e3:.1f} ms; launches {counts}; "
          f"fetches {fetches}; plain path burst "
          f"{ref['t_burst'] * 1e3:.1f} ms; decisions equal")
    add_launches(report, counts)


# ---------------------------------------------------------------------------
# Device preemption: K7 preempt_scan, K8 pressure_batch
# ---------------------------------------------------------------------------
# integer operations per slot step of the victim scan, a floor: pass 1
# (mask compare, three adds, count) 5; pass 2 (three adds, count, the fit's
# four compares and three adds, keep, three selects, the aggregates) 15
OPS_PER_SLOT = 20
# the preempt worlds: 10 victims of 400m per node (9 on every 50th node),
# priorities 1-5 by slot and node, a quarter of them PDB-guarded
VICTIMS_PER_NODE, VICTIM_CPU = 10, 400
N_SINGLE = 32                    # preempt-single rounds


def preempt_world(n_nodes):
    """bench.py's cluster with VICTIMS_PER_NODE lower-priority pods on every
    node (one fewer on every 50th node: 400m free there), priorities 1-5
    cycling by slot and node, distinct start times, a PDB with no
    disruptions left over `app=guarded` (every fourth victim), and the
    label pool=preempt on zones 0 and 1."""
    from kubernetes_tpu_torch.api.types import (
        Pod, Container, LabelSelector, PodDisruptionBudget)
    infos, tree = cluster(n_nodes, lambda i: {"pool": "preempt"}
                          if i % 3 != 2 else {})
    uid = 0
    for i in range(n_nodes):
        name = f"node-{i}"
        k = VICTIMS_PER_NODE - (1 if i % 50 == 0 else 0)
        for s in range(k):
            uid += 1
            infos[name].add_pod(Pod(
                name=f"victim-{uid}", node_name=name,
                priority=1 + (s + i) % 5, start_time=float(uid),
                labels={"app": "guarded" if uid % 4 == 0 else "batch"},
                containers=(Container.make(
                    name="c", requests={"cpu": VICTIM_CPU}),)))
    pdbs = [PodDisruptionBudget(
        name="guard", disruptions_allowed=0,
        selector=LabelSelector(match_labels=(("app", "guarded"),)))]
    return infos, tree, pdbs


def wave_pods():
    """The preempt-wave queue, priorities non-increasing: 512 pods at 100
    (400m), 384 at 50 (800m), 128 at 1 (400m)."""
    return (pods(512, prefix="urgent", cpu=400, priority=100)
            + pods(384, prefix="mid", cpu=800, priority=50)
            + pods(128, prefix="low", cpu=400, priority=1))


def outcome_names(out):
    return [(o[0], o[1], [v.name for v in o[2]]) if o[0] == "nominated"
            else o for o in out]


def victim_bound(nodes, vic, n_real, extra_bytes, extra_ops):
    """(bound_ms, bound_by) of a victim scan: node rows and the seven
    victim planes read once plus `extra_bytes`, against OPS_PER_SLOT per
    slot step of every real node plus `extra_ops`."""
    P = int(vic["prio"].shape[1])
    nbytes = sum(v.numel() * v.element_size() for v in vic.values())
    nbytes += 8 * 8 * nodes["valid"].shape[0] + extra_bytes
    ops = n_real * P * OPS_PER_SLOT + extra_ops
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _rand_victims(rng, n_pad, P, device, fill=0.6):
    """Random victim planes in the host table's slot order per node
    (PDB-violating first, then priority descending, start ascending; empty
    slots last), some starts +inf."""
    import numpy as np
    import torch
    valid = rng.random((n_pad, P)) < fill
    prio = np.where(valid, rng.integers(0, 8, (n_pad, P)), 0)
    start = np.where(valid & (rng.random((n_pad, P)) < 0.8),
                     rng.integers(1, 500, (n_pad, P)).astype(float), np.inf)
    viol = valid & (rng.random((n_pad, P)) < 0.25)
    cpu = np.where(valid, rng.choice([100, 200, 400, 800], (n_pad, P)), 0)
    mem = np.where(valid, rng.integers(0, 4, (n_pad, P)) * GI // 4, 0)
    eph = np.where(valid, rng.integers(0, 2, (n_pad, P)) * GI, 0)
    order = np.lexsort((start, -prio, ~viol, ~valid), axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)
    host = {"cpu": take(cpu).astype(np.int64),
            "mem": take(mem).astype(np.int64),
            "eph": take(eph).astype(np.int64),
            "prio": take(prio).astype(np.int64), "start": take(start),
            "valid": take(valid), "violating": take(viol)}
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def _victim_nodes(rng, vic, n_pad, n_real, device):
    """Node rows around the victim planes: the victims' load plus some,
    so that nodes fit 0 to several more pods after evictions."""
    import numpy as np
    import torch
    h = {k: v.cpu().numpy() for k, v in vic.items()}
    alloc_cpu = rng.choice([2000, 4000, 8000], n_pad).astype(np.int64)
    used = (h["cpu"] * h["valid"]).sum(1)
    host = {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": np.maximum(alloc_cpu, used),
        "alloc_mem": np.full(n_pad, 32 * GI, np.int64),
        "alloc_eph": np.full(n_pad, 50 * GI, np.int64),
        "allowed_pods": rng.choice([8, 110, 128], n_pad).astype(np.int64),
        "req_cpu": used + rng.integers(0, 800, n_pad),
        "req_mem": (h["mem"] * h["valid"]).sum(1) + rng.integers(
            0, 8, n_pad) * GI,
        "req_eph": (h["eph"] * h["valid"]).sum(1),
        "nz_cpu": used, "nz_mem": rng.integers(0, 8, n_pad) * GI,
        "pod_count": h["valid"].sum(1).astype(np.int64),
        "alloc_scalar": np.zeros((n_pad, 1), np.int64),
        "req_scalar": np.zeros((n_pad, 1), np.int64),
        "zone_id": rng.integers(0, 4, n_pad).astype(np.int32)}
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def preempt_variant_checks(device, sync, n_pad=16384, n_real=16000):
    """K7 and K8 against their plain versions on random inputs at n_pad
    16,384 with P 16 and 128: ghosts on and off, check_resources /
    has_request false, no candidate, a zero-victim win, ties down to
    order_rank, +inf starts, PDB-violating slots, skip padding and an
    init-container request (the filter's request above the fold's); K4
    on the seven victim planes; K2/K5/K6 ran above with no ghost."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261019)
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    for P in (16, 128):
        vic = _rand_victims(rng, n_pad, P, device)
        nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
        feas = torch.as_tensor(rng.random(n_pad) < 0.9).to(device)
        rank = torch.as_tensor(rng.permutation(n_pad)).to(device)
        pod = {"req_cpu": np.int64(1500), "req_mem": np.int64(2 * GI),
               "req_eph": np.int64(GI)}
        args = (nodes, vic, pod, feas, rank, n_real, True, True, 6)
        want = K.preemption_scan_plain(*args)
        same(f"preempt_scan/P{P}/default", K.preemption_scan(*args), want)
        # every node a copy of the default winner's row and slots: the
        # pick ties through all five criteria and falls to order_rank
        w = max(int(want[0]), 0)
        tie_vic = {k: v[w:w + 1].expand_as(v).contiguous()
                   for k, v in vic.items()}
        tie_nodes = {k: (v[w:w + 1].expand_as(v).contiguous()
                         if k != "valid" else v) for k, v in nodes.items()}
        roomy = {**nodes, "req_cpu": nodes["req_cpu"] // 4}
        cases = [
            ("check_resources false", nodes, vic, pod, feas, False, False,
             6),
            ("has_request false", nodes, vic, pod, feas, True, False, 6),
            ("no candidate", nodes, vic, pod,
             torch.zeros_like(feas), True, True, 6),
            ("zero-victim win", roomy, vic, pod, feas, True, True, 6),
            ("ties to order_rank", tie_nodes, tie_vic, pod, feas, True,
             True, 6),
            ("no lower priority", nodes, vic, pod, feas, True, True, 0),
        ]
        for name, nd, vc, pd, fs, cr, hr, mp in cases:
            args = (nd, vc, pd, fs, rank, n_real, cr, hr, mp)
            same(f"preempt_scan/P{P}/{name}", K.preemption_scan(*args),
                 K.preemption_scan_plain(*args))
        # K8: a chunk of 32 pods over the same planes, on a cluster with
        # room on six nodes only: pods bind, then preempt, then fail
        room = torch.zeros(n_pad, dtype=torch.bool)
        room[rng.choice(n_real, 6, replace=False)] = True
        full = {**nodes, "req_cpu": torch.where(
            room.to(device), nodes["req_cpu"], nodes["alloc_cpu"])}
        specs = []
        for j, (cpu, upd, prio) in enumerate(
                [(400, 400, 9), (1200, 800, 7), (2000, 2000, 5),
                 (9000, 9000, 3)]):
            d = _spec(cpu, j == 1, rng, n_pad, 1)
            d.update(req_mem=np.int64(GI), req_eph=np.int64(0),
                     upd_cpu=np.int64(upd), upd_mem=np.int64(GI),
                     upd_scalar=np.zeros(1, np.int64),
                     req_scalar=np.zeros(1, np.int64),
                     check_resources=np.bool_(j != 2),
                     has_request=np.bool_(True),
                     pprio=np.int64(prio))
            specs.append(d)
        specs.append(dict(specs[3], skip=np.bool_(True)))
        row = np.concatenate([np.repeat([0, 1, 2, 3], 7), [4] * 4])
        stack = K.PodStack.from_specs(specs, row, None, device)
        mut0 = {k: full[k] for k in K._MUTABLE}
        zero = {k: torch.zeros(n_pad, dtype=torch.int64, device=device)
                for k in K.GHOST_FIELDS}
        busy = {k: torch.as_tensor(rng.integers(0, hi, n_pad)).to(device)
                for k, hi in (("cpu", 600), ("mem", GI), ("eph", 2),
                              ("cnt", 3))}
        for gname, g0 in (("ghost off", zero), ("ghost on", busy)):
            args = (full, mut0, g0, stack, vic, 37, 5, 9000, n_real, 4)
            got = K.pressure_batch(*args)
            want = K.pressure_batch_plain(*args)
            same(f"pressure_batch/P{P}/{gname}", got, want)
            kinds = set(want[4]["winner"].cpu().tolist())
            if P == 16 and gname == "ghost off" and not (
                    {-2, -1} <= kinds and max(kinds) >= 0):
                raise SystemExit(f"variant pressure_batch/P{P}: the chunk "
                                 f"lacks bound, failed or nominated pods "
                                 f"({sorted(kinds)})")
        # K4 on the seven victim planes: duplicates and an out-of-range row
        rws = np.concatenate([rng.choice(n_pad - 8, 24, replace=False),
                              [n_pad + 3]]).astype(np.int32)
        rws = np.concatenate([rws, np.full(7, rws[0], np.int32)])
        fresh = _rand_victims(rng, n_pad, P, device)
        upd = {k: v.cpu().numpy()[np.clip(rws, 0, n_pad - 1)]
               for k, v in fresh.items()}
        for v in upd.values():
            v[25:] = v[0]
        dev_a = {k: v.clone() for k, v in vic.items()}
        dev_b = {k: v.clone() for k, v in vic.items()}
        same(f"scatter_rows/victim planes P{P}",
             K.scatter_rows(dev_a, rws, upd),
             K.scatter_rows_plain(dev_b, rws, upd))
    sync()
    print(f"[variants] {checked} preemption kernel calls equal to their "
          f"plain versions (K7 at P 16 and 128: default, check_resources "
          f"and has_request false, no candidate, zero-victim win, ties to "
          f"order_rank, no lower priority; K8 32-pod chunks with ghosts "
          f"off and on, skip padding, an init-container request; K4 on "
          f"the seven victim planes)")


def run_wave(infos, tree, pdbs, wave, device, sync, pct=None):
    """prewarm_preempt, then one pressure wave; returns its outcomes,
    scheduler, prewarm and wave seconds."""
    sched = make_sched(tree, device, 50 if pct is None else pct) \
        if tree is not None else None
    if sched is None:
        from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
        sched = TorchScheduler(percentage_of_nodes_to_score=pct,
                               device=device)
        names = sorted(infos, key=lambda s: int(s.split("-")[1]))
    else:
        names = tree.list_names()
    t0 = time.perf_counter()
    sched.prewarm_preempt(infos, names, pdbs)
    sync()
    t1 = time.perf_counter()
    out = sched.preempt_pressure_burst(wave, infos, names, pdbs)
    sync()
    return {"out": out, "sched": sched, "t_prewarm": t1 - t0,
            "t_wave": time.perf_counter() - t1,
            "rows": mutable_rows(sched),
            "counters": (sched.last_index, sched.last_node_index),
            "phases": dict(sched.last_preempt_phases or {})}


def wave_path(name, infos, tree, pdbs, wave, device, sync, report,
              pct=None, check=True):
    """One pressure-wave path: launches counted on the kernel run, then
    the same wave on the plain versions; outcomes, counters, the last
    chunk's ghost vector and the folded rows must agree."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    obs.reset()
    with capture("pressure_batch") as rec:
        run = run_wave(infos, tree, pdbs, wave, device, sync, pct)
    counts = K.launches()
    refusals = obs.family("refusal")
    fetches = obs.get("fetch.pressure_batch")
    if refusals or run["out"] is None:
        raise SystemExit(f"{name}: refused ({refusals})")
    n_chunks = -(-len(wave) // 128)
    if counts["pressure_batch"] != n_chunks or fetches != 1:
        raise SystemExit(f"{name}: {counts['pressure_batch']} K8 launches "
                         f"and {fetches} fetches for {n_chunks} chunks")
    with plain_versions(), capture("pressure_batch") as rec_p:
        ref = run_wave(infos, tree, pdbs, wave, device, sync, pct)
    if outcome_names(run["out"]) != outcome_names(ref["out"]) \
            or run["counters"] != ref["counters"]:
        raise SystemExit(f"{name}: outcomes or counters differ from the "
                         f"plain path")
    same_rows(name, run["rows"], ref["rows"])
    if max_abs_err(rec.last[1], rec_p.last[1]) != 0:
        raise SystemExit(f"{name}: ghost vectors differ from the plain "
                         f"path ({first_diff(rec.last[1], rec_p.last[1])})")
    kinds = {}
    for o in run["out"]:
        key = o[0] if o[0] != "failed" else f"failed(any_cand={o[1]})"
        kinds[key] = kinds.get(key, 0) + 1
    if check:
        b = run["sched"].encoder._batch
        nodes, args, kw = rec.call
        # the check writes its own block, not the wave's fetch buffer
        call = (nodes, args, {k: v for k, v in kw.items() if k != "out"})
        n_pods = len(args[2])
        width = len(K.PRESSURE_HEAD) + int(args[3]["prio"].shape[1])
        bound = victim_bound(
            nodes, args[3], b.n_real,
            sum(v.numel() * v.element_size()
                for v in args[2].table.values()) + n_pods * 4 * width,
            n_pods * b.n_real * OPS_PER_NODE_CYCLE
            + (n_pods - 1) * b.n_real * int(args[3]["prio"].shape[1])
            * OPS_PER_SLOT)
        ms = call_entry(report, "pressure_batch", K.pressure_batch,
                        K.pressure_batch_plain, call, bound, sync, 3,
                        f"the first {n_pods}-pod chunk of {name}")
        print(f"[kernel] pressure_batch: {ms / n_pods * 1e3:.2f} us/pod")
    add_launches(report, counts)
    ph = run["phases"]
    print(f"[path] {name}: {len(infos)} nodes, "
          f"{sum(len(ni.pods) for ni in infos.values())} pods on them, "
          f"{len(wave)} preemptors in {n_chunks} chunks and 1 fetch, "
          f"{len(wave) / run['t_wave']:.1f} preemptors/s "
          f"({run['t_wave'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"scan {ph['scan'] * 1e3:.2f} of which fetch "
          f"{ph['fetch'] * 1e3:.2f}); prewarm "
          f"{run['t_prewarm'] * 1e3:.1f} ms; outcomes {kinds}; launches "
          f"{counts}; plain path wave {ref['t_wave'] * 1e3:.1f} ms; "
          f"outcomes, counters, ghost and rows equal to the plain path")
    return run, kinds


def baseline_world():
    """BASELINE.json configs[3] as perf/harness.py:203-245 builds it: 1,000
    nodes (4 CPU, 32 Gi, 110 pods, no labels), 10 victims of 400m at
    priority 1 on each, 128 preemptors of 400m at priority 10."""
    from kubernetes_tpu_torch.api.types import Node, Pod, Container
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    infos = {}
    uid = 0
    for i in range(1000):
        node = Node(name=f"node-{i}", allocatable={
            "cpu": 4000, "memory": 32 * GI, "pods": 110})
        ni = NodeInfo(node)
        for _ in range(10):
            uid += 1
            ni.add_pod(Pod(name=f"victim-{uid}", priority=1,
                           node_name=node.name, containers=(Container.make(
                               name="c", requests={"cpu": 400}),)))
        infos[node.name] = ni
    wave = [Pod(name=f"hi-{k}", priority=10, containers=(Container.make(
        name="c", requests={"cpu": 400}),)) for k in range(128)]
    return infos, wave


def single_path(infos, tree, pdbs, device, sync, report):
    """preempt-single: N_SINGLE rounds of schedule (K2 raises FitError),
    preempt (K7), then the shell's work: the victims leave their
    NodeInfos, the pod joins the chosen node. Every K7 block is held
    against preemption_scan_plain; rounds 2.. must scatter the victim
    planes' dirty rows (K4), not upload them whole."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Pod, Container
    from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
    from kubernetes_tpu_torch.ops import kernels as K
    sched = make_sched(tree, device, 50)
    real = K.preemption_scan
    held = []

    def checked(nodes, *args):
        out = real(nodes, *args)
        want = K.preemption_scan_plain(nodes, *args)
        if max_abs_err(out, want) != 0:
            raise SystemExit(f"preempt-single: K7 block differs from plain "
                             f"({first_diff(out, want)})")
        if not held:
            # the resident planes change in place later: keep copies
            held.append(({k: v.clone() for k, v in nodes.items()},
                         ({k: v.clone() for k, v in args[0].items()},)
                         + args[1:], {}))
        return out
    names = tree.list_names()
    sched.prewarm_preempt(infos, names, pdbs)
    sync()
    obs.reset()
    uploads = []
    evicted = 0
    t_sched = t_pre = 0.0
    phases = {"encode": 0.0, "scan": 0.0, "fetch": 0.0}
    K.preemption_scan = checked
    try:
        for r in range(N_SINGLE):
            pod = Pod(name=f"single-{r}", priority=100,
                      node_selector={"pool": "preempt"},
                      containers=(Container.make(
                          name="c", requests={"cpu": 1000}),))
            t0 = time.perf_counter()
            try:
                sched.schedule(pod, infos, tree.list_names())
                raise SystemExit("preempt-single: the pod was scheduled")
            except FitError as e:
                err = e
            t1 = time.perf_counter()
            res = sched.preempt(pod, infos, names, err, pdbs)
            sync()
            t_pre += time.perf_counter() - t1
            t_sched += t1 - t0
            if res is None or res.node is None or not res.victims:
                raise SystemExit(f"preempt-single round {r}: {res}")
            for k in phases:
                phases[k] += sched.last_preempt_phases[k]
            uploads.append((obs.get("dispatch.vic_upload"),
                            obs.get("dispatch.vic_scatter")))
            for v in res.victims:
                infos[v.node_name].remove_pod(v)
            evicted += len(res.victims)
            assume(infos, pod, res.node.name)
    finally:
        K.preemption_scan = real
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"preempt-single: refusals {refusals}")
    if counts["preempt_scan"] != N_SINGLE:
        raise SystemExit(f"preempt-single: {counts['preempt_scan']} K7 "
                         f"launches for {N_SINGLE} rounds")
    if any(u != (0, r) for r, u in enumerate(uploads)):
        raise SystemExit(f"preempt-single: victim planes (uploads, "
                         f"scatters) per round {uploads}")
    b = sched.encoder._batch
    nodes, args, _kw = held[0]
    bound = victim_bound(nodes, args[0], b.n_real, b.n_pad * 9 + 4 * 19, 0)
    call_entry(report, "preempt_scan", K.preemption_scan,
               K.preemption_scan_plain, held[0], bound, sync, 20,
               "the first preempt-single round")
    add_launches(report, counts)
    print(f"[path] preempt-single: {len(infos)} nodes, {N_SINGLE} rounds "
          f"of schedule (FitError) + preempt, {N_SINGLE / t_pre:.1f} "
          f"preemptions/s (preempt {t_pre * 1e3:.1f} ms in all: encode "
          f"{phases['encode'] * 1e3:.2f} scan {phases['scan'] * 1e3:.2f} "
          f"of which fetch {phases['fetch'] * 1e3:.2f}; schedule "
          f"{t_sched * 1e3:.1f} ms in all); {evicted} victims evicted; "
          f"victim planes uploaded once (prewarm), scattered in rounds "
          f"2-{N_SINGLE}; launches {counts}; every K7 block equal to "
          f"preemption_scan_plain")


def preempt_paths(device, sync, report):
    """The three preemption paths: preempt-wave (15,000 nodes, 150,000
    victims, 1,024 preemptors), preempt-baseline (BASELINE configs[3]),
    preempt-single (32 serial preemptions on the preempt-wave world)."""
    t = time.perf_counter()
    infos, tree, pdbs = preempt_world(N_NODES)
    print(f"[world] preempt: {N_NODES} nodes, "
          f"{sum(len(ni.pods) for ni in infos.values())} victims built in "
          f"{time.perf_counter() - t:.1f} s")
    _run, kinds = wave_path("preempt-wave", infos, tree, pdbs, wave_pods(),
                            device, sync, report)
    for want in ("bound", "nominated", "failed(any_cand=True)"):
        if not kinds.get(want):
            raise SystemExit(f"preempt-wave: no {want} outcome ({kinds})")
    b_infos, b_wave = baseline_world()
    wave_path("preempt-baseline", b_infos, None, [], b_wave, device, sync,
              report, pct=100, check=False)
    single_path(infos, tree, pdbs, device, sync, report)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import kernels as K
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    print("kernels: K1 local_total, K2 schedule_cycle, K3 uniform_burst, "
          "K4 scatter_rows, K5 schedule_batch, K6 schedule_segments, "
          "K7 preempt_scan, K8 pressure_batch (CUDA C++, sm_90a)")
    t = time.perf_counter()
    built = _build.build_all(verbose=True)
    print(f"[build] {sorted(built)} in {time.perf_counter() - t:.1f} s")
    report = kernel_checks(device, sync)
    variant_checks(device, sync)
    scan_variant_checks(device, sync)
    preempt_variant_checks(device, sync)
    small_world_check(device, sync)
    main_path("even zones", N_NODES, device, sync, report)
    main_path("uneven zones (rotate)", N_NODES + 1, device, sync, report)
    scan_paths(device, sync, report)
    preempt_paths(device, sync, report)
    print(json.dumps({"kernels": [report[k] for k in K.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
