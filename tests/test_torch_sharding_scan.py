"""The sharded generic scan (K10) and the sharded fused window (K11) of the
port against the JAX package's sharded programs, on the CPU.

The same numpy inputs go through `JK.schedule_batch(mesh=make_mesh(D))` /
`JK.schedule_batch_segments(mesh=...)` / `JS.sharded_batch_fn` on
conftest's virtual 8-device CPU mesh, through the port's sharded programs
on `["cpu"] * D` (the plain versions of K10a/K10b and K11a/K11b with an
all-gather between them, one step per pod) and through the port's
single-device plain K5/K6. A mesh TorchScheduler runs scan and fused
windows beside `TPUScheduler(mesh=make_mesh(4))` and the serial oracle.
Every comparison is exact. The JAX package caches its sharded jits by
(mesh, statics), so cases of one shape share a compile.
"""
import dataclasses
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import LABEL_HOSTNAME, Node, Service
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.ops.node_state import PodEncoder as JPE
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_encoders import World, to_port, uniform_pods
from tests.test_torch_kernels import (
    SCAN_B, _rotation_tables, _scan_inputs, _segments, _tensors,
    assert_same, node_dicts)
from tests.test_torch_scheduler import (
    PROFILES, Trio, _burst_vs_oracle, _gang, _kinds_pods, burst_nodes)
from tests.test_torch_sharding import MeshTrio, _cat
from tests.test_tpu_parity import make_cluster

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.carry import state_from_jax
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from kubernetes_tpu_torch.profiles import ProfileSet as PProfileSet
from tests.torch_threads import one_torch_thread  # noqa: F401


def _jnodes(jmesh, jn):
    return JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                        for k, v in jn.items()})


def _jpods(stacked):
    return {k: jnp.asarray(v) for k, v in stacked.items()}


def _whole(rows):
    """Per-shard rows (or spread slices) as whole vectors."""
    if isinstance(rows, list) and isinstance(rows[0], dict):
        return _cat(rows)
    if isinstance(rows, list):
        return torch.cat(rows)
    return rows


def _check_window(got, want, single):
    """(state, li, lni, spread, outs-or-packed) of the port's sharded
    program against JAX's and the port's single-device plain version."""
    for other in (want, single):
        rows = _whole(got[0])
        for k in PK._MUTABLE:
            assert_same(rows[k], other[0][k], k)
        assert int(got[1]) == int(other[1]) and int(got[2]) == int(other[2])
        assert_same(_whole(got[3]), other[3], "spread")
        if isinstance(other[4], dict):
            for k in other[4]:
                assert_same(got[4][k], other[4][k], k)
        else:
            assert_same(got[4], other[4], "packed")


# ---------------------------------------------------------------------------
# sharded_scan: K10a + all-gather + K10b per live pod
# ---------------------------------------------------------------------------
SCAN_MESH_CASES = [(1, "identity"), (2, "identity"), (4, "identity"),
                   (4, "partial"), (2, "perm"), (4, "perm"), (4, "pos"),
                   (2, "spread"), (4, "wtab"), (4, "skips")]


def _scan_case(case):
    """One window of `_scan_inputs` (37 nodes, n_pad 64: n_real a multiple
    of no D) and the JAX keyword arguments of `case`."""
    jn, pn, stacked, spread0, n, n_pad, z_pad = _scan_inputs(
        70 + [c for _d, c in SCAN_MESH_CASES].index(case),
        spread=case == "spread")
    rng = np.random.default_rng(11)
    ntf = 11 if case in ("partial", "perm") else n
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
    if case == "skips":
        # skip pods mid-window, between live ones: the select decides
        # them around a live step without a launch of their own
        skip = stacked["skip"].copy()
        skip[[0, 3, 4, 9, 23]] = True
        stacked = dict(stacked, skip=skip)
    li, lni = (0, 0) if case == "identity" else (5, 2 ** 31 + 3)
    return jn, pn, stacked, n, z_pad, ntf, li, lni, kw


@pytest.mark.parametrize("d,case", SCAN_MESH_CASES)
def test_sharded_scan_matches_jax(d, case):
    """Identity, partial (num_to_find 11 of 37), perm and pos walks, the
    carried spread vector, a weight table with per-pod profile ids
    (negative ones wrap), skip pods mid-window; lni starts past 2**31."""
    jn, pn, stacked, n, z_pad, ntf, li, lni, kw = _scan_case(case)
    jmesh, mesh = JS.make_mesh(d), PS.Mesh(["cpu"] * d)
    want = JK.schedule_batch(_jnodes(jmesh, jn), _jpods(stacked), li, lni,
                             ntf, n, z_pad, mesh=jmesh, **kw)
    steps = obs.get("steps.burst_scan")
    got = PK.schedule_batch(PS.shard_node_arrays(mesh, pn), stacked, li,
                            lni, ntf, n, z_pad, mesh=mesh, **_tensors(kw))
    single = PK.schedule_batch_plain(pn, stacked, li, lni, ntf, n, z_pad,
                                     **_tensors(kw))
    _check_window(got, want, single)
    assert len(got[0]) == d
    live = int((~np.asarray(stacked["skip"])).sum())
    assert obs.get("steps.burst_scan") - steps == live
    assert (np.asarray(want[4]["selected"])[:24] >= 0).any()


def test_sharded_scan_carry_in_chains():
    """Two windows chained on the per-shard carry (rows and spread
    slices) equal the JAX chain on its sharded carry."""
    jn, pn, stacked, spread0, n, n_pad, z_pad = _scan_inputs(
        61, spread=True)
    jmesh, mesh = JS.make_mesh(2), PS.Mesh(["cpu"] * 2)
    jnodes, shards = _jnodes(jmesh, jn), PS.shard_node_arrays(mesh, pn)
    j1 = JK.schedule_batch(jnodes, _jpods(stacked), 0, 3, n, n, z_pad,
                           spread0=spread0, mesh=jmesh)
    p1 = PK.schedule_batch(shards, stacked, 0, 3, n, n, z_pad,
                           spread0=torch.as_tensor(spread0), mesh=mesh)
    s1 = PK.schedule_batch_plain(pn, stacked, 0, 3, n, n, z_pad,
                                 spread0=torch.as_tensor(spread0))
    _check_window(p1, j1, s1)
    j2 = JK.schedule_batch(jnodes, _jpods(stacked), j1[1], j1[2], n, n,
                           z_pad, carry_in=(j1[0], j1[3]), mesh=jmesh)
    p2 = PK.schedule_batch(shards, stacked, p1[1], p1[2], n, n, z_pad,
                           carry_in=(p1[0], p1[3]), mesh=mesh)
    s2 = PK.schedule_batch_plain(pn, stacked, s1[1], s1[2], n, n, z_pad,
                                 carry_in=(s1[0], s1[3]))
    _check_window(p2, j2, s2)


def test_sharded_batch_matches_jax():
    """`sharded_batch` (a wrapper over `sharded_scan`, no rotation, no
    spread) against `JS.sharded_batch_fn`."""
    jn, pn, stacked, _s0, n, n_pad, z_pad = _scan_inputs(66)
    jmesh, mesh = JS.make_mesh(4), PS.Mesh(["cpu"] * 4)
    fn = JS.sharded_batch_fn(jmesh, z_pad=z_pad)
    zero = jnp.asarray(0, jnp.int64)
    js, jli, jlni, jouts = fn(
        _jnodes(jmesh, jn), JS.shard_pod_batch(jmesh, _jpods(stacked)),
        zero, zero, jnp.asarray(n, jnp.int64), jnp.asarray(n, jnp.int64))
    ps, pli, plni, pouts = PS.sharded_batch(
        mesh, PS.shard_node_arrays(mesh, pn), stacked, 0, 0, n, n, z_pad)
    whole = _cat(ps)
    for k in JK._MUTABLE:
        assert_same(whole[k], js[k], k)
    assert int(pli) == int(jli) and int(plni) == int(jlni)
    for k in jouts:
        assert_same(pouts[k], jouts[k], k)


# ---------------------------------------------------------------------------
# sharded_segments: K11a + all-gather + K11b per pod
# ---------------------------------------------------------------------------
SEG_MESH_CASES = [(4, "axis"), (2, "perm"), (4, "pos"), (2, "gang_score"),
                  (4, "gang_score"), (4, "spread"), (2, "short")]
GANG0, WIDE = 3 + 5, 14       # the wide gang: its first pod, its size


def _segments_case(case):
    """13 nodes (n_pad 16), four zones; singleton runs and gangs: the
    14-member gang of 3 CPU cannot all fit on 13 nodes of 4 CPU and
    rewinds mid-window, a 9-CPU singleton fails, n_pods < B."""
    n = 13
    nodes = [Node(name=f"n{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"z{i % 4}",
        LABEL_HOSTNAME: f"n{i}"},
        allocatable={"cpu": 4000, "memory": 32 * 1024 ** 3, "pods": 110})
        for i in range(n)]
    w = World(nodes)
    jsched = TPUScheduler()
    jb = jsched.encoder.encode(w.j_infos, w.names())
    enc = JPE(w.j_infos, jb, [], [])
    small = uniform_pods(6, cpu=500, prefix="s")
    layout = [(small[:3], False), (uniform_pods(5, cpu=700, prefix="m"), True),
              (uniform_pods(WIDE, cpu=3000, prefix="g"), True),
              (small[3:], False), (uniform_pods(2, cpu=9000, prefix="h"),
                                   False), (small[:2], False)]
    if case == "short":
        layout = layout[:3]
    flat = [p for seg, _g in layout for p in seg]
    per_pod = [jsched._pod_arrays(enc.encode(p), jb.n_pad, upd_fields=True,
                                  pod=p) for p in flat]
    seg, gang, n_pods = _segments(SCAN_B, [(len(s), g) for s, g in layout])
    per_pod += [dict(per_pod[-1], skip=np.bool_(True))] * (SCAN_B - n_pods)
    stacked = {k: np.ascontiguousarray(v)
               for k, v in TPUScheduler._stack_pods(per_pod).items()}
    rng = np.random.default_rng(5)
    jn, pn = node_dicts(jb)
    kw = {}
    ntf = 6 if case == "perm" else n
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
        kw["spread0"] = rng.integers(0, 5, jb.n_pad).astype(np.int64)
    if case == "short":
        n_pods = 10
    return jn, pn, stacked, seg, gang, n_pods, n, jb.n_pad, ntf, kw


@pytest.mark.parametrize("d,case", SEG_MESH_CASES)
def test_sharded_segments_matches_jax(d, case):
    """The fused window over the mesh: the wide gang's placed members lie
    on several shards when a later member finds no node, and every shard
    rewinds its rows (and spread slice) to the segment checkpoint on the
    same step; gang_score carries the zone counts; `short` stops inside
    the second gang (n_pods < B)."""
    jn, pn, stacked, seg, gang, n_pods, n, n_pad, ntf, kw = \
        _segments_case(case)
    jmesh, mesh = JS.make_mesh(d), PS.Mesh(["cpu"] * d)
    z_pad = 8
    args = (seg, gang, n_pods, 3, 5, ntf, n, z_pad)
    want = JK.schedule_batch_segments(_jnodes(jmesh, jn), _jpods(stacked),
                                      *args, mesh=jmesh, **kw)
    steps = obs.get("steps.burst_segments")
    got = PK.schedule_batch_segments(PS.shard_node_arrays(mesh, pn),
                                     stacked, *args, mesh=mesh,
                                     **_tensors(kw))
    single = PK.schedule_batch_segments_plain(pn, stacked, *args,
                                              **_tensors(kw))
    _check_window(got, want, single)
    assert obs.get("steps.burst_segments") - steps == n_pods
    sel = np.asarray(want[4])[:SCAN_B]
    assert (sel[n_pods:] == -1).all()
    if case != "short":
        wide = sel[GANG0: GANG0 + WIDE]
        assert (wide < 0).any()
        placed = wide[wide >= 0]
        assert len({int(s) // (n_pad // d) for s in placed}) == min(d, 4)


# ---------------------------------------------------------------------------
# TorchScheduler(mesh=...) scan and fused windows against
# TPUScheduler(mesh=...) and the oracle
# ---------------------------------------------------------------------------
class ScanMeshTrio(MeshTrio):
    """A MeshTrio with the Trio's percentage, services and profiles."""

    def __init__(self, nodes, d, pct=None, services=(), profiles=None):
        Trio.__init__(self, nodes, pct=pct, services=services,
                      profiles=profiles)
        kw = {} if pct is None else {"percentage_of_nodes_to_score": pct}
        self.jax = TPUScheduler(node_tree=self.w.j_tree,
                                mesh=JS.make_mesh(d),
                                services_fn=lambda: self.services, **kw)
        self.port = TorchScheduler(
            node_tree=self.w.p_tree, device="cpu",
            mesh=PS.Mesh(["cpu"] * d),
            services_fn=lambda: [to_port(x) for x in self.services], **kw)
        if profiles is not None:
            self.jax.set_profiles(self.profiles)
            self.port.set_profiles(PProfileSet.from_dict(
                {"profiles": profiles}))


@pytest.mark.parametrize("case", ["mixed-50", "mixed-profile", "spread"])
def test_mesh_scan_window_matches_jax_and_oracle(case):
    """Generic scan windows in mesh mode: mixed specs at the default
    percentageOfNodesToScore on 151 nodes (a partial, rotated walk), two
    profiles in one window (per-pod weight rows, the position walk), the
    carried spread vector; each with one fetch, the decided prefix the
    oracle's, serial cycles after, and a second window."""
    rng = random.Random(zlib.crc32(case.encode()) % 1000)
    svc, profiles = (), None
    if case == "mixed-50":
        nodes = make_cluster(rng, 151, zones=3, taint_frac=0.3,
                             labeled_frac=0.5, images=True)
        pods = _kinds_pods(rng, 48)
    elif case == "mixed-profile":
        nodes, profiles = burst_nodes(31), PROFILES
        pods = [dataclasses.replace(p, scheduler_name="packer" if j % 3 == 0
                                    else "default-scheduler")
                for j, p in enumerate(uniform_pods(30) + uniform_pods(
                    30, cpu=300, prefix="b"))]
        rng.shuffle(pods)
    else:
        nodes = burst_nodes(30)
        svc = [Service(name="s", namespace="default",
                       selector={"app": "burst"})]
        pods = uniform_pods(50)
    t = ScanMeshTrio(nodes, 4, pct=100 if case == "spread" else None,
                     services=svc, profiles=profiles)
    refusals = obs.family("refusal")
    fetches = obs.get("fetch.burst_scan")
    _burst_vs_oracle(t, pods)
    assert obs.get("fetch.burst_scan") == fetches + 1
    phases = t.port.last_burst_phases
    assert phases["gather_bytes"] > 0 and phases["steps"] >= 1
    if case == "mixed-50":
        assert t.port.last_index != 0       # a partial walk moved it
    for j in range(2):
        pod = uniform_pods(1, cpu=200 + 100 * j, prefix=f"x{j}")[0]
        assert t.serial(pod) == t.oracle_one(pod)
    more = _kinds_pods(rng, 16, prefix="q") if case == "mixed-50" \
        else uniform_pods(16, prefix="q")
    _burst_vs_oracle(t, more)
    assert obs.family("refusal") == refusals


@pytest.mark.parametrize("case", ["rank-aware", "default-50"])
def test_mesh_fused_window_matches_jax_and_oracle(case):
    """A fused drain window in mesh mode: a gang that cannot all fit
    rewinds mid-window on every shard, the rest matches the serial gang
    trials, and a serial cycle continues from the window's counters."""
    n = 31 if case != "default-50" else 151
    nodes = burst_nodes(n, labels=lambda i: {"rack": "r0"}
                        if i % 6 == 1 and i < 30 else {})
    profiles = None
    if case == "rank-aware":
        profiles = [{"schedulerName": "default-scheduler",
                     "rankAwareGang": True, "gangWeight": 3}]
    t = ScanMeshTrio(nodes, 4, profiles=profiles)
    segments = [
        (_gang(4, 500, "a"), True),
        (uniform_pods(5, prefix="s"), False),
        (_gang(6, 3000, "r", node_selector={"rack": "r0"}), True),
        (_gang(6, 700, "b"), True),
        (uniform_pods(3, cpu=300, prefix="u"), False),
    ]
    res = t.fused(segments)
    assert res is not None
    assert res["segments"][2]["status"] == "rejected"
    assert res["segments"][2]["placed"] > 0
    phases = t.port.last_burst_phases
    assert phases["steps"] == sum(len(s) for s, _g in segments)
    assert phases["gather_bytes"] > 0
    for (seg, is_gang), rec in zip(segments, res["segments"]):
        if rec["status"] == "rejected":
            assert t.oracle_gang(seg) is None
        else:
            assert rec["status"] == "decided"
            exp = t.oracle_gang(seg) if is_gang \
                else [t.oracle_one(p) for p in seg]
            assert rec["hosts"] == exp
    pod = uniform_pods(1, prefix="after")[0]
    assert t.serial(pod) == t.oracle_one(pod)


@pytest.mark.parametrize("window", ["scan", "fused"])
def test_mesh_carry_after_window(window):
    """A scan or fused window run on a JAX mesh scheduler alone, its
    folded matrix and walk counters carried into a mesh port scheduler:
    the port's per-shard rows equal JAX's, and the next window of the
    same kind runs on both meshes with equal decisions, counters and
    rows."""
    rng = random.Random(41)
    t = ScanMeshTrio(make_cluster(rng, 31, zones=3, taint_frac=0.3,
                                  labeled_frac=0.5, images=True), 4)
    names = t.w.names()
    if window == "scan":
        pods = _kinds_pods(rng, 40)
        first, second = pods[:20], pods[20:]
        hosts = t.jax.schedule_burst(first, t.w.j_infos, names)
        placed, consumed = first, len(first)
    else:
        first = [(_gang(4, 500, "a"), True), (uniform_pods(5, prefix="s"),
                                               False)]
        second = [(_gang(6, 700, "b"), True),
                  (uniform_pods(3, cpu=300, prefix="u"), False)]
        res = t.jax.schedule_burst_fused(first, t.w.j_infos, names)
        assert all(r["status"] == "decided" for r in res["segments"])
        placed = [p for seg, _g in first for p in seg]
        hosts = [h for r in res["segments"] for h in r["hosts"]]
        consumed = res["consumed"]
    assert None not in hosts
    gens = [t.w.assume(p, h)[0] for p, h in zip(placed, hosts)]
    t.jax.note_burst_assumed_many(placed, hosts, gens)
    t.w.advance(consumed - 1)
    state = state_from_jax({k: np.asarray(v)
                            for k, v in t.jax._dev_nodes.items()},
                           t.jax.last_index, t.jax.last_node_index,
                           device="cpu")
    t.port.load_state(state, t.w.p_infos, names)
    assert isinstance(t.port._dev_nodes, list)
    t.check_state()
    if window == "scan":
        assert t.burst(second) is not None
    else:
        assert t.fused(second) is not None
