"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (one nvcc per source, all at once).
2. Holds each kernel (K1 local_total, K2 schedule_cycle, K3 uniform_burst,
   K4 scatter_rows) equal to its plain PyTorch version on the card, at the
   main path's shapes (n_pad 16,384), and times both.
3. Drives the main path through TorchScheduler: bench.py's headline burst,
   10,000 identical pods (100m / 500 Mi) on 15,000 nodes (4 CPU, 32 Gi,
   110 pods, zone i % 3), the assume loop, then serial cycles; again on
   15,001 nodes (uneven zones, the rotated walk). Launch counts are zeroed
   just before each run and read just after; every kernel must have run,
   and no burst may be refused. Decisions must equal the same path run
   with the plain versions on the card.
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
GI, MI = 1024 ** 3, 1024 ** 2
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet

SOURCES = {
    "local_total": ("kubernetes_tpu_torch/ops/csrc/local_total.cu",
                    "kubernetes_tpu/ops/kernels.py:110"),
    "schedule_cycle": ("kubernetes_tpu_torch/ops/csrc/schedule_cycle.cu",
                       "kubernetes_tpu/ops/kernels.py:359"),
    "uniform_burst": ("kubernetes_tpu_torch/ops/csrc/uniform_burst.cu",
                      "kubernetes_tpu/ops/kernels.py:1097"),
    "scatter_rows": ("kubernetes_tpu_torch/ops/csrc/scatter_rows.cu",
                     "kubernetes_tpu/core/tpu_scheduler.py:158"),
}


def cluster(n_nodes):
    """bench.py's cluster (build_cluster) as the port's objects."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    from kubernetes_tpu_torch.cache.node_tree import NodeTree
    nodes = [Node(name=f"node-{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"zone-{i % 3}",
        "failure-domain.beta.kubernetes.io/region": "r1",
        "kubernetes.io/hostname": f"node-{i}"},
        allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(n_nodes)]
    infos = {n.name: NodeInfo(n) for n in nodes}
    tree = NodeTree()
    for n in nodes:
        tree.add_node(n)
    return infos, tree


def pods(n_pods, prefix="pod"):
    """bench.py's density pods (make_pods)."""
    from kubernetes_tpu_torch.api.types import Pod, Container
    return [Pod(name=f"{prefix}-{j}", labels={"app": "density"},
                containers=(Container.make(
                    name="c", requests={"cpu": 100, "memory": 500 * MI}),))
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
        "scatter_rows")}
    K.local_total = K.local_total_plain
    K.schedule_cycle = K.schedule_cycle_plain
    K.schedule_batch_uniform = K.schedule_batch_uniform_plain
    K.scatter_rows = K.scatter_rows_plain
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
    missing = [k for k, v in counts.items() if v == 0]
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
    for k, v in counts.items():
        report[k]["launches"] += v


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
          "K4 scatter_rows (CUDA C++, sm_90a)")
    t = time.perf_counter()
    built = _build.build_all(verbose=True)
    print(f"[build] {sorted(built)} in {time.perf_counter() - t:.1f} s")
    report = kernel_checks(device, sync)
    variant_checks(device, sync)
    small_world_check(device, sync)
    main_path("even zones", N_NODES, device, sync, report)
    main_path("uneven zones (rotate)", N_NODES + 1, device, sync, report)
    print(json.dumps({"kernels": [report[k] for k in K.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
