"""The port's plain kernel versions against the JAX programs they replace.

K1 local_total vs `K._local_total`, K2 schedule_cycle vs `K.schedule_cycle`
and `K._cycle_core` (perm and pos modes), K3 schedule_batch_uniform vs
`K.schedule_batch_uniform`, K4 scatter_rows vs `tpu_scheduler._scatter_rows`.
The same numpy inputs, made from a seed, go to both; tolerance is exact
equality (every output is an integer or a bool, and the float64 scores
truncate identically). The CUDA kernels are held against these same plain
versions by `chip_smoke.py` on the card.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.core.tpu_scheduler import (
    TPUScheduler, _scatter_rows as j_scatter_rows)
from tests.test_tpu_parity import make_pod
from tests.test_torch_encoders import make_world, to_port, uniform_pods

from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from tests.torch_threads import one_torch_thread  # noqa: F401


NODE_FIELDS = TorchScheduler._NODE_FIELDS

WEIGHT_CASES = {
    "default": dict(JK.DEFAULT_WEIGHTS),
    "least": {**JK.DEFAULT_WEIGHTS, "balanced": 0, "least_requested": 3},
    "most": {**JK.DEFAULT_WEIGHTS, "least_requested": 0,
             "most_requested": 2},
    "rtcr": {**JK.DEFAULT_WEIGHTS, "least_requested": 0, "rtcr": 5},
    "balanced": {**JK.DEFAULT_WEIGHTS, "least_requested": 0,
                 "balanced": 7},
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def node_dicts(batch):
    host = {k: np.asarray(getattr(batch, k)) for k in NODE_FIELDS}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v.copy()) for k, v in host.items()})


# ---------------------------------------------------------------------------
# K1 local_total
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wname", sorted(WEIGHT_CASES))
def test_local_total_matches(wname):
    rng = np.random.default_rng(11)
    n = 257
    alloc_cpu = rng.choice([0, 1000, 2000, 4000, 4001], n).astype(np.int64)
    alloc_mem = rng.choice([0, 8, 16, 32], n).astype(np.int64) * 1024 ** 3
    req_cpu = rng.integers(0, 5000, n).astype(np.int64)
    req_mem = rng.integers(0, 40 * 1024 ** 3, n).astype(np.int64)
    w = WEIGHT_CASES[wname]
    got = PK.local_total_plain(w, *map(torch.as_tensor, (
        req_cpu, req_mem, alloc_cpu, alloc_mem)))
    want = JK._local_total(w, *map(jnp.asarray, (
        req_cpu, req_mem, alloc_cpu, alloc_mem)))
    assert_same(got, want, wname)
    # weight-row mode: the static dict gates, the row scales
    wrow = rng.integers(0, 9, len(JK.PRIORITY_AXIS)).astype(np.int64)
    got = PK.local_total_plain(w, *map(torch.as_tensor, (
        req_cpu, req_mem, alloc_cpu, alloc_mem)), wrow=torch.as_tensor(wrow))
    want = JK._local_total(w, *map(jnp.asarray, (
        req_cpu, req_mem, alloc_cpu, alloc_mem)), wrow=jnp.asarray(wrow))
    assert_same(got, want, wname + "/wrow")
    # the wrapper takes the plain version for CPU tensors
    got = PK.local_total(w, *map(torch.as_tensor, (
        req_cpu, req_mem, alloc_cpu, alloc_mem)))
    assert_same(got, JK._local_total(w, *map(jnp.asarray, (
        req_cpu, req_mem, alloc_cpu, alloc_mem))), wname + "/wrapper")


# ---------------------------------------------------------------------------
# K2 schedule_cycle
# ---------------------------------------------------------------------------
CYCLE_OUT = ("selected", "found", "evaluated", "max_score", "total", "kept",
             "feasible", "fail_first", "general_bits", "next_last_index",
             "next_last_node_index")

POD_KINDS = [
    dict(),
    dict(selectors=True, tolerations=True, node_affinity=True),
    dict(pod_affinity=True, ports=True, images=True),
]


def _cycle_inputs(seed, kind, n=37, zones=3):
    """A world with some bound pods, one pod to place, both encodings."""
    rng = random.Random(seed)
    w = make_world(seed, n, zones=zones, taint_frac=0.3, labeled_frac=0.5,
                   images=True)
    names = w.names()
    for j in range(n // 2):
        w.assume(make_pod(rng, 100 + j, **POD_KINDS[kind]),
                 names[rng.randrange(n)])
    jsched, psched = TPUScheduler(), TorchScheduler(device="cpu")
    jb = jsched.encoder.encode(w.j_infos, names)
    pb = psched.encoder.encode(w.p_infos, names)
    pod = make_pod(rng, 0, **POD_KINDS[kind])
    from kubernetes_tpu.ops.node_state import PodEncoder as JPE
    from kubernetes_tpu_torch.ops.node_state import PodEncoder as PPE
    from kubernetes_tpu.api.types import Service
    svc = [Service(name="s", namespace="default", selector={"app": "web"})]
    jf = JPE(w.j_infos, jb, svc, []).encode(pod)
    pf = PPE(w.p_infos, pb, [to_port(s) for s in svc], []).encode(
        to_port(pod))
    jpod = jsched._pod_arrays(jf, jb.n_pad)
    ppod = psched._pod_arrays(pf)
    jn, pn = node_dicts(jb)
    z_pad = 4
    while z_pad < len(jb.zone_names):
        z_pad *= 2
    return jn, pn, jpod, ppod, jb.n_real, jb.n_pad, z_pad


def _check_cycle(got, want):
    for k in CYCLE_OUT:
        assert_same(got[k], want[k], k)


@pytest.mark.parametrize("kind", range(len(POD_KINDS)))
@pytest.mark.parametrize("wname", ["default", "most", "rtcr"])
def test_schedule_cycle_matches(kind, wname):
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(5 + kind, kind)
    w = WEIGHT_CASES[wname]
    for li, lni, ntf in [(0, 0, n), (5, 3, n), (11, 7, 9), (n - 1, 12, 4),
                         (3 * n + 2, 2 ** 33 + 5, 1)]:
        want = JK.schedule_cycle(jn, jpod, li, lni, ntf, n, z_pad, weights=w)
        got = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad, weights=w)
        _check_cycle(got, want)


def test_schedule_cycle_spread_scores_match():
    """Selector spread with zones and inter-pod preferred terms: the
    float64 families, normalised over a partial kept set."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(3, 2, n=45, zones=4)
    rng = np.random.default_rng(3)
    for k, dt in (("spread_counts", np.int64), ("interpod_counts", np.int64),
                  ("node_aff_counts", np.int64), ("taint_counts", np.int64),
                  ("image_sums", np.int64)):
        v = rng.integers(0, 9, n_pad).astype(dt)
        if k == "image_sums":
            v = v * 150 * 1024 ** 2
        if k == "interpod_counts":
            v = v - 4
        jpod[k] = v
        ppod[k] = v.copy()
    tracked = rng.random(n_pad) < 0.7
    jpod["interpod_tracked"], ppod["interpod_tracked"] = tracked, tracked.copy()
    pa = np.where(rng.random(n_pad) < 0.2, 0, 10).astype(np.int64)
    jpod["prefer_avoid"], ppod["prefer_avoid"] = pa, pa.copy()
    for li, lni, ntf in [(0, 0, n), (7, 5, 13), (20, 1, 30)]:
        want = JK.schedule_cycle(jn, jpod, li, lni, ntf, n, z_pad)
        got = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad)
        _check_cycle(got, want)


def test_schedule_cycle_wtab_matches():
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(9, 1)
    rng = np.random.default_rng(9)
    wtab = rng.integers(0, 4, (3, len(JK.PRIORITY_AXIS))).astype(np.int64)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(JK.PRIORITY_AXIS)}
    for pid in (0, 1, 2, 5, -1):
        jpod["profile_id"] = ppod["profile_id"] = np.int64(pid)
        want = JK.schedule_cycle(jn, jpod, 4, 9, n, n, z_pad, weights=union,
                                 wtab=jnp.asarray(wtab))
        got = PK.schedule_cycle(pn, ppod, 4, 9, n, n, z_pad, weights=union,
                                wtab=torch.as_tensor(wtab))
        _check_cycle(got, want)


@pytest.mark.parametrize("mode", ["perm", "pos"])
def test_schedule_cycle_rotation_modes_match(mode):
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(21, 1, n=29)
    rng = np.random.default_rng(21)
    perm = np.concatenate([rng.permutation(n),
                           np.arange(n, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    w = dict(JK.DEFAULT_WEIGHTS)
    cases = [(0, 0, n), (6, 4, n), (13, 11, n)] if mode == "pos" \
        else [(0, 0, n), (6, 4, 10), (13, 11, 3), (28, 2, n)]
    jpod_j = {k: jnp.asarray(v) for k, v in jpod.items()}
    for li, lni, ntf in cases:
        if mode == "pos":
            want = JK._cycle_core(jn, jpod_j, li, lni, ntf, n, w, z_pad,
                                  pos=jnp.asarray(inv))
            got = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad,
                                    pos=torch.as_tensor(inv))
        else:
            want = JK._cycle_core(jn, jpod_j, li, lni, ntf, n, w, z_pad,
                                  perm=jnp.asarray(perm),
                                  inv_perm=jnp.asarray(inv))
            got = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad,
                                    perm=torch.as_tensor(perm),
                                    inv_perm=torch.as_tensor(inv))
        _check_cycle(got, want)


# ---------------------------------------------------------------------------
# K3 schedule_batch_uniform
# ---------------------------------------------------------------------------
def _uniform_inputs(n, zones, cpu=4000, pods_cap=110, seed=0):
    from kubernetes_tpu.api.types import Node, LABEL_HOSTNAME
    from tests.test_torch_encoders import World
    nodes = [Node(name=f"n{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"z{i % zones}",
        LABEL_HOSTNAME: f"n{i}"},
        allocatable={"cpu": cpu, "memory": 32 * 1024 ** 3,
                     "pods": pods_cap})
        for i in range(n)]
    w = World(nodes)
    names = w.names()
    jsched = TPUScheduler()
    jb = jsched.encoder.encode(w.j_infos, names)
    from kubernetes_tpu.ops.node_state import PodEncoder as JPE
    pod = uniform_pods(1)[0]
    f0 = JPE(w.j_infos, jb, [], []).encode(pod)
    cls, extra, ban = jsched._uniform_class(pod, f0, jb, w.j_infos)
    jn, pn = node_dicts(jb)
    return jn, pn, cls, jb.n_real, jb.n_pad


def _run_uniform(jn, pn, cls, n_pods, lni, n, **kw):
    jkw = {k: (tuple(map(np.asarray, v)) if k == "rotation" and v is not None
               else v) for k, v in kw.items()}
    jrows, jpacked, jlni = JK.schedule_batch_uniform(
        jn, dict(cls), n_pods, lni, n, True, **jkw)
    pkw = dict(kw)
    if kw.get("rotation") is not None:
        pkw["rotation"] = tuple(torch.as_tensor(np.asarray(v))
                                for v in kw["rotation"])
    if kw.get("extra_ok") is not None:
        pkw["extra_ok"] = torch.as_tensor(kw["extra_ok"])
    prows, ppacked, plni = PK.schedule_batch_uniform(
        pn, dict(cls), n_pods, lni, n, True, **pkw)
    assert_same(ppacked, jpacked, "packed")
    assert int(plni) == int(jlni)
    assert set(prows) == set(jrows)
    for k in jrows:
        assert_same(prows[k], jrows[k], k)
    return np.asarray(jpacked)


@pytest.mark.parametrize("wname", sorted(WEIGHT_CASES))
def test_uniform_matches_weights(wname):
    jn, pn, cls, n, n_pad = _uniform_inputs(50, 3)
    packed = _run_uniform(jn, pn, cls, 300, 0, n, cap=512,
                          weights=WEIGHT_CASES[wname])
    assert (packed[:300] >= 0).all()


def test_uniform_saturation_tail():
    """More pods than the cluster holds: the tail is F == 0 (the clamp
    hazard of the lane-0 probe) and stays -1."""
    jn, pn, cls, n, n_pad = _uniform_inputs(6, 3, cpu=1000, pods_cap=8)
    packed = _run_uniform(jn, pn, cls, 70, 3, n, cap=128)
    assert (packed[:60] >= 0).sum() == 6 * 8 and (packed[48:70] == -1).all()


@pytest.mark.parametrize("lni", [0, 7, 1000003, 2 ** 31 - 5])
def test_uniform_lni_wraparound(lni):
    jn, pn, cls, n, n_pad = _uniform_inputs(23, 3)
    _run_uniform(jn, pn, cls, 200, lni, n, cap=256)


def test_uniform_rotate():
    jn, pn, cls, n, n_pad = _uniform_inputs(41, 3)
    rng = np.random.default_rng(4)
    rows = [np.concatenate([np.arange(n), np.full(n_pad + 1 - n, n_pad)])]
    for _ in range(3):
        rows.append(np.concatenate([rng.permutation(n),
                                    np.full(n_pad + 1 - n, n_pad)]))
    perm = np.stack(rows).astype(np.int32)
    n_pods, cap = 200, 256
    seq = np.zeros(cap + JK.K_BATCH, np.int32)
    seq[1:60] = 2                  # a constant-order run (full ELIM batches)
    seq[60:] = rng.integers(0, 4, len(seq) - 60)
    _run_uniform(jn, pn, cls, n_pods, 5, n, cap=cap, rotation=(perm, seq))


def test_uniform_ban_and_extra_ok():
    jn, pn, cls, n, n_pad = _uniform_inputs(40, 3)
    rng = np.random.default_rng(8)
    extra = rng.random(n_pad) < 0.8
    packed = _run_uniform(jn, pn, cls, 60, 2, n, cap=64, extra_ok=extra,
                          ban=True)
    placed = packed[:60][packed[:60] >= 0]
    assert len(set(placed.tolist())) == len(placed)    # one pod per node


def test_uniform_wtab_and_carried_rows():
    """A weight-table row, and a class that carries ephemeral storage and
    a scalar resource (rows beyond the five fixed ones)."""
    jn, pn, cls, n, n_pad = _uniform_inputs(30, 3)
    eph = np.full(n_pad, 10 * 1024 ** 3, np.int64)
    jn["alloc_eph"], pn["alloc_eph"] = jnp.asarray(eph), torch.as_tensor(eph)
    cls = dict(cls, req_eph=1024 ** 3, upd_eph=1024 ** 3)
    rng = np.random.default_rng(2)
    wtab = rng.integers(0, 5, (2, len(JK.PRIORITY_AXIS))).astype(np.int64)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(JK.PRIORITY_AXIS)}
    _run_uniform(jn, pn, cls, 250, 1, n, cap=256, weights=union, wtab=wtab,
                 pid=1)


# ---------------------------------------------------------------------------
# K4 scatter_rows
# ---------------------------------------------------------------------------
def test_scatter_rows_matches():
    rng = np.random.default_rng(5)
    w = make_world(5, 40, zones=3)
    jb = TPUScheduler().encoder.encode(w.j_infos, w.names())
    jn, pn = node_dicts(jb)
    rows = np.asarray(sorted(rng.choice(jb.n_real, 11, replace=False)),
                      np.int32)
    # one negative row (JAX wraps it once) and one past the end (dropped)
    rows = np.concatenate([rows, [-3, jb.n_pad + 4],
                           np.full(5, rows[0], np.int32)]).astype(np.int32)
    upd = {}
    for k in NODE_FIELDS:
        v = np.asarray(getattr(jb, k))[np.clip(rows, 0, jb.n_pad - 1)].copy()
        if v.dtype == np.int64:
            v = v + rng.integers(0, 1000, v.shape)
        elif v.dtype == np.int32:
            v = v + 1
        else:
            v = ~v
        v[len(rows) - 5:] = v[0]        # padding repeats row 0's values
        upd[k] = v
    want = j_scatter_rows(jn, jnp.asarray(rows),
                          {k: jnp.asarray(v) for k, v in upd.items()})
    got = PK.scatter_rows(pn, rows, upd)
    for k in NODE_FIELDS:
        assert_same(got[k], want[k], k)


# ---------------------------------------------------------------------------
# K5 schedule_batch / K6 schedule_batch_segments
# ---------------------------------------------------------------------------
SCAN_B = 32          # one JAX compile per mode: every case stacks 32 pods


def _scan_inputs(seed, n=37, zones=3, kinds=(0, 1, 2), n_pods=24,
                 spread=False):
    """A partly filled world and a window of `n_pods` pods of mixed kinds
    (dense and inert per-node fields side by side), padded to SCAN_B with
    skip pods, in the JAX [B, ...] layout."""
    from kubernetes_tpu.ops.node_state import PodEncoder as JPE
    from kubernetes_tpu.api.types import Service
    rng = random.Random(seed)
    w = make_world(seed, n, zones=zones, taint_frac=0.3, labeled_frac=0.5,
                   images=True)
    names = w.names()
    for j in range(n // 3):
        w.assume(make_pod(rng, 100 + j), names[rng.randrange(n)])
    for j in range(4):
        w.assume(uniform_pods(1, prefix=f"old{j}")[0], names[3 * j])
    jsched = TPUScheduler()
    jb = jsched.encoder.encode(w.j_infos, names)
    svc = [Service(name="s", namespace="default", selector={"app": "web"}),
           Service(name="b", namespace="default", selector={"app": "burst"})]
    enc = JPE(w.j_infos, jb, svc, [])
    if spread:
        pods = uniform_pods(n_pods, cpu=300)
    else:
        pods = [make_pod(rng, j, **POD_KINDS[kinds[j % len(kinds)]])
                for j in range(n_pods)]
    per_pod = [jsched._pod_arrays(enc.encode(p), jb.n_pad, upd_fields=True,
                                  pod=p) for p in pods]
    spread0 = None
    if spread:
        spread0 = np.asarray(enc.encode(pods[0]).spread_counts)
        for pp in per_pod:
            pp["spread_counts"] = np.zeros(1, np.int64)
    pad = dict(per_pod[-1], skip=np.bool_(True))
    per_pod += [pad] * (SCAN_B - n_pods)
    stacked = {k: np.ascontiguousarray(v)
               for k, v in TPUScheduler._stack_pods(per_pod).items()}
    jn, pn = node_dicts(jb)
    z_pad = 4
    while z_pad < len(jb.zone_names):
        z_pad *= 2
    return jn, pn, stacked, spread0, jb.n_real, jb.n_pad, z_pad


def _rotation_tables(rng, n, n_pad, orders=3):
    perms = [np.arange(n_pad)]
    for _ in range(orders):
        perms.append(np.concatenate([rng.permutation(n),
                                     np.arange(n, n_pad)]))
    perms = np.stack(perms).astype(np.int32)
    inv = np.empty_like(perms)
    for l in range(len(perms)):
        inv[l, perms[l]] = np.arange(n_pad, dtype=np.int32)
    return perms, inv


def _tensors(kw):
    """The port's form of a JAX call's keyword arguments."""
    out = {}
    for k, v in kw.items():
        if v is None or isinstance(v, (dict, bool, int)):
            out[k] = v
        elif isinstance(v, tuple):
            out[k] = tuple(torch.as_tensor(np.asarray(x)) for x in v)
        else:
            out[k] = torch.as_tensor(np.asarray(v))
    return out


def _check_scan(got, want, packed_only=False):
    (ps, pli, plni, psp, pouts), (js, jli, jlni, jsp, jouts) = got, want
    for k in js:
        assert_same(ps[k], js[k], k)
    assert int(pli) == int(jli) and int(plni) == int(jlni)
    assert_same(psp, jsp, "spread")
    for k in jouts:
        assert_same(pouts[k], jouts[k], k)


SCAN_CASES = ["identity", "partial", "perm", "pos", "spread", "wtab"]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_schedule_batch_matches(case):
    jn, pn, stacked, spread0, n, n_pad, z_pad = _scan_inputs(
        40 + SCAN_CASES.index(case), spread=case == "spread")
    rng = np.random.default_rng(7)
    ntf = n if case in ("identity", "pos", "wtab", "spread") else 11
    kw = {}
    if case == "perm":
        perms, inv = _rotation_tables(rng, n, n_pad)
        kw["rotation"] = (perms, inv,
                          rng.integers(0, 4, SCAN_B).astype(np.int32))
    if case == "pos":
        perms, inv = _rotation_tables(rng, n, n_pad)
        kw["rotation_pos"] = (inv, rng.integers(0, 4, SCAN_B).astype(
            np.int32))
    if case == "spread":
        kw["spread0"] = spread0
    if case == "wtab":
        wtab = rng.integers(0, 4, (3, len(JK.PRIORITY_AXIS))).astype(np.int64)
        kw["wtab"] = wtab
        kw["weights"] = {k: int(wtab[:, i].max())
                         for i, k in enumerate(JK.PRIORITY_AXIS)}
        stacked = dict(stacked, profile_id=rng.integers(
            -1, 4, SCAN_B).astype(np.int64))
    li, lni = (5, 2 ** 31 + 3) if case != "identity" else (0, 0)
    want = JK.schedule_batch(jn, {k: jnp.asarray(v) for k, v in
                                  stacked.items()},
                             li, lni, ntf, n, z_pad, **kw)
    got = PK.schedule_batch(pn, stacked, li, lni, ntf, n, z_pad,
                            **_tensors(kw))
    _check_scan(got, want)
    packed = np.asarray(want[4]["packed"])
    assert (packed[:24] >= 0).any()


def test_schedule_batch_carry_in_chains():
    """Two windows chained on the device carry equal the JAX chain."""
    jn, pn, stacked, spread0, n, n_pad, z_pad = _scan_inputs(
        61, spread=True)
    j1 = JK.schedule_batch(jn, {k: jnp.asarray(v) for k, v in
                                stacked.items()}, 0, 3, n, n, z_pad,
                           spread0=spread0)
    p1 = PK.schedule_batch(pn, stacked, 0, 3, n, n, z_pad,
                           spread0=torch.as_tensor(spread0))
    _check_scan(p1, j1)
    j2 = JK.schedule_batch(jn, {k: jnp.asarray(v) for k, v in
                                stacked.items()}, j1[1], j1[2], n, n, z_pad,
                           carry_in=(j1[0], j1[3]))
    p2 = PK.schedule_batch(pn, stacked, p1[1], p1[2], n, n, z_pad,
                           carry_in=(p1[0], p1[3]))
    _check_scan(p2, j2)


def _segments(B, layout):
    """seg_start / gang flags for [(length, is_gang), ...]."""
    seg = np.zeros(B, bool)
    gang = np.zeros(B, bool)
    i = 0
    for length, g in layout:
        seg[i] = True
        gang[i: i + length] = g
        i += length
    if i < B:
        seg[i] = True
    return seg, gang, i


SEG_CASES = ["axis", "perm", "pos", "gang_score", "spread", "short"]


@pytest.mark.parametrize("case", SEG_CASES)
def test_schedule_batch_segments_matches(case):
    """Singleton runs and gangs; the 14-member gang cannot all fit (its
    pods ask for 3 CPU of 13 nodes' 4) so it rewinds mid-window; a singleton failure
    follows; n_pods < B leaves -1 filler."""
    from kubernetes_tpu.api.types import Node, LABEL_HOSTNAME
    from kubernetes_tpu.ops.node_state import PodEncoder as JPE
    from tests.test_torch_encoders import World
    n = 13
    nodes = [Node(name=f"n{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"z{i % 4}",
        LABEL_HOSTNAME: f"n{i}"},
        allocatable={"cpu": 4000, "memory": 32 * 1024 ** 3, "pods": 110})
        for i in range(n)]
    w = World(nodes)
    names = w.names()
    jsched = TPUScheduler()
    jb = jsched.encoder.encode(w.j_infos, names)
    enc = JPE(w.j_infos, jb, [], [])
    small = uniform_pods(6, cpu=500, prefix="s")
    wide = uniform_pods(14, cpu=3000, prefix="g")
    mid = uniform_pods(5, cpu=700, prefix="m")
    huge = uniform_pods(2, cpu=9000, prefix="h")
    layout = [(small[:3], False), (mid, True), (wide, True),
              (small[3:], False), (huge, False), (small[:2], False)]
    if case == "short":
        layout = layout[:3]
    flat = [p for seg, _g in layout for p in seg]
    per_pod = [jsched._pod_arrays(enc.encode(p), jb.n_pad, upd_fields=True,
                                  pod=p) for p in flat]
    seg, gang, n_pods = _segments(SCAN_B, [(len(s), g) for s, g in layout])
    pad = dict(per_pod[-1], skip=np.bool_(True))
    per_pod += [pad] * (SCAN_B - n_pods)
    stacked = {k: np.ascontiguousarray(v)
               for k, v in TPUScheduler._stack_pods(per_pod).items()}
    rng = np.random.default_rng(3)
    jn, pn = node_dicts(jb)
    z_pad = 8
    kw = {}
    ntf = n if case != "perm" else 6
    if case in ("perm", "pos"):
        perms, inv = _rotation_tables(rng, n, jb.n_pad)
        oid = rng.integers(0, 4, SCAN_B).astype(np.int32)
        kw["rotation" if case == "perm" else "rotation_pos"] = \
            (perms, inv, oid) if case == "perm" else (inv, oid)
    if case == "gang_score":
        wtab = np.array([[1, 1, 1, 0, 0, 1, 10000, 1, 1, 1, 0],
                         [1, 1, 0, 2, 0, 1, 10000, 1, 1, 1, 7]], np.int64)
        kw.update(wtab=wtab, gang_score=True, weights={
            k: int(wtab[:, i].max()) for i, k in enumerate(JK.PRIORITY_AXIS)})
        stacked = dict(stacked, profile_id=(np.arange(SCAN_B) % 2).astype(
            np.int64))
    if case == "spread":
        # a carried spread vector rewinds with the gang
        kw["spread0"] = rng.integers(0, 5, jb.n_pad).astype(np.int64)
    if case == "short":
        n_pods = 10
    want = JK.schedule_batch_segments(
        jn, {k: jnp.asarray(v) for k, v in stacked.items()}, seg, gang,
        n_pods, 3, 5, ntf, n, z_pad, **kw)
    got = PK.schedule_batch_segments(pn, stacked, seg, gang, n_pods, 3, 5,
                                     ntf, n, z_pad, **_tensors(kw))
    (js, jli, jlni, jsp, jpk), (ps, pli, plni, psp, ppk) = want, got
    for k in js:
        assert_same(ps[k], js[k], k)
    assert int(pli) == int(jli) and int(plni) == int(jlni)
    assert_same(psp, jsp, "spread")
    assert_same(ppk, jpk, "packed")
    packed = np.asarray(jpk)
    sel = packed[:SCAN_B]
    assert (sel[n_pods:] == -1).all()
    if case != "short":
        # the wide gang placed some members, then rewound: its selections
        # stay in the block and the carry after it equals the one before
        g0 = 3 + 5
        assert (sel[g0: g0 + 14] >= 0).any() \
            and (sel[g0: g0 + 14] < 0).any()
        t_after = packed[3 * SCAN_B: 4 * SCAN_B]
        assert t_after[g0 + 13] == t_after[g0 - 1]
