"""Device preemption in the port (K7 preempt_scan, K8 pressure_batch and the
host paths around them) against the JAX package and the oracle.

Kernel level: the same numpy inputs, made from a seed, go to the JAX
programs (`preemption_scan`, `pressure_batch`, `_victim_select`,
`_cycle_core` with a ghost, `_resolvable_candidates`) and to the port's
plain versions. Scheduler level: TorchScheduler(device="cpu").preempt and
.preempt_pressure_burst against TPUScheduler and the oracle (Preemptor, and
the serial schedule-else-preempt loop) on the worlds of
tests/test_preemption.py, mirrored here. Tolerance: exact equality
everywhere (every output is an integer, a bool, or a float64 start time
copied through).
"""
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import (
    Affinity, Container, LabelSelector, Node, PodAffinityTerm,
    PodAntiAffinity, PodDisruptionBudget, LABEL_HOSTNAME)
from kubernetes_tpu.cache.node_tree import NodeTree as JNodeTree
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.ops.node_state import NodeStateEncoder as JEncoder
from kubernetes_tpu.oracle import predicates as jpreds
from kubernetes_tpu.oracle.generic_scheduler import (
    FitError as JFitError, GenericScheduler)
from kubernetes_tpu.oracle.preemption import Preemptor
from tests.test_preemption import mknode, mkpod, snapshot
from tests.test_torch_encoders import to_port

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.cache.node_info import NodeInfo as PNodeInfo
from kubernetes_tpu_torch.cache.node_tree import NodeTree as PNodeTree
from kubernetes_tpu_torch.carry import state_from_jax
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.ops.node_state import NodeStateEncoder as PEncoder
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    FitError as PFitError)
from tests.torch_threads import one_torch_thread  # noqa: F401


GI = 1024 ** 3
NODE_FIELDS = TorchScheduler._NODE_FIELDS


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---------------------------------------------------------------------------
# random kernel inputs (numpy; both packages take the same arrays)
# ---------------------------------------------------------------------------
def rand_victims(rng, n_pad, P, fill=0.6, starts_inf=False):
    """Victim planes in the host table's slot order per node: valid slots
    first, PDB-violating first among them, then priority descending,
    start ascending."""
    valid = rng.random((n_pad, P)) < fill
    prio = np.where(valid, rng.integers(0, 8, (n_pad, P)), 0)
    start = np.where(valid & (rng.random((n_pad, P)) < 0.7),
                     rng.integers(1, 60, (n_pad, P)).astype(float), np.inf)
    if starts_inf:
        start = np.full((n_pad, P), np.inf)
    viol = valid & (rng.random((n_pad, P)) < 0.3)
    cpu = np.where(valid, rng.choice([100, 200, 500, 1000], (n_pad, P)), 0)
    mem = np.where(valid, rng.integers(0, 4, (n_pad, P)) * GI // 4, 0)
    eph = np.where(valid, rng.integers(0, 2, (n_pad, P)) * GI, 0)
    order = np.lexsort((start, -prio, ~viol, ~valid), axis=1)

    def take(a):
        return np.ascontiguousarray(np.take_along_axis(a, order, axis=1))
    return {"cpu": take(cpu).astype(np.int64),
            "mem": take(mem).astype(np.int64),
            "eph": take(eph).astype(np.int64),
            "prio": take(prio).astype(np.int64), "start": take(start),
            "valid": take(valid), "violating": take(viol)}


def victim_nodes(rng, vic, n_pad, n_real, room=None):
    """The 14 node fields around the victim planes: the victims' load plus
    some; with `room` (row indices) those rows get 2 CPU of headroom and
    every other row is full on cpu."""
    used = (vic["cpu"] * vic["valid"]).sum(1)
    alloc_cpu = np.maximum(rng.choice([1000, 2000, 4000], n_pad), used)
    req_cpu = used + rng.integers(0, 600, n_pad)
    if room is not None:
        req_cpu = np.maximum(alloc_cpu, req_cpu)
        alloc_cpu[room] = used[room] + 2000
        req_cpu[room] = used[room]
    return {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": alloc_cpu.astype(np.int64),
        "alloc_mem": np.full(n_pad, 16 * GI, np.int64),
        "alloc_eph": np.full(n_pad, 20 * GI, np.int64),
        "allowed_pods": rng.choice([4, 8, 110], n_pad).astype(np.int64),
        "req_cpu": req_cpu.astype(np.int64),
        "req_mem": ((vic["mem"] * vic["valid"]).sum(1)
                    + rng.integers(0, 8, n_pad) * GI).astype(np.int64),
        "req_eph": (vic["eph"] * vic["valid"]).sum(1).astype(np.int64),
        "nz_cpu": used.astype(np.int64),
        "nz_mem": (rng.integers(0, 8, n_pad) * GI).astype(np.int64),
        "pod_count": vic["valid"].sum(1).astype(np.int64),
        "alloc_scalar": np.zeros((n_pad, 1), np.int64),
        "req_scalar": np.zeros((n_pad, 1), np.int64),
        "zone_id": rng.integers(0, 4, n_pad).astype(np.int32)}


def both(d):
    """The same arrays for JAX and for the port."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in d.items()})


# ---------------------------------------------------------------------------
# K7: preemption_scan and its parts
# ---------------------------------------------------------------------------
PREEMPT_CASES = ["default", "check_resources false", "has_request false",
                 "no candidate", "zero-victim win", "ties to order_rank",
                 "all starts inf", "no lower priority", "P16"]


def _preempt_inputs(case):
    seed = 300 + PREEMPT_CASES.index(case)
    rng = np.random.default_rng(seed)
    n_pad, n_real, P = 64, 60, (16 if case == "P16" else 8)
    vic = rand_victims(rng, n_pad, P, starts_inf=case == "all starts inf")
    nodes = victim_nodes(rng, vic, n_pad, n_real)
    feas = rng.random(n_pad) < 0.85
    rank = np.full(n_pad, 1 << 30, np.int64)
    cand = rng.permutation(n_pad)[:50]
    rank[cand] = np.arange(50)
    pod = {"req_cpu": np.int64(900), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI)}
    cr = hr = True
    max_prio = 6
    if case == "check_resources false":
        cr = hr = False
    if case == "has_request false":
        hr = False
    if case == "no candidate":
        feas[:] = False
    if case == "zero-victim win":
        nodes["req_cpu"] = nodes["req_cpu"] // 4
    if case == "no lower priority":
        max_prio = 0
    if case == "ties to order_rank":
        # every node a copy of row 3: the pick ties through all five
        # criteria and falls to the lowest candidate rank
        for k in vic:
            vic[k] = np.ascontiguousarray(np.repeat(vic[k][3:4], n_pad, 0))
        for k in nodes:
            if k != "valid":
                nodes[k] = np.ascontiguousarray(
                    np.repeat(nodes[k][3:4], n_pad, 0))
        nodes["req_cpu"][:] = nodes["alloc_cpu"][0]
    return nodes, vic, pod, feas, rank, n_real, cr, hr, max_prio


@pytest.mark.parametrize("case", PREEMPT_CASES)
def test_preemption_scan_matches_jax(case):
    nodes, vic, pod, feas, rank, n_real, cr, hr, max_prio = \
        _preempt_inputs(case)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    want = np.asarray(JK.preemption_scan(
        jn, jv, pod, jnp.asarray(feas), jnp.asarray(rank), n_real, cr, hr,
        max_prio))
    got = PK.preemption_scan(pn, vic, pod, feas, rank, n_real, cr, hr,
                             max_prio)
    assert got.dtype == torch.int32
    assert_same(got, want, case)
    if case == "no candidate":
        assert want[0] == -1 and not want[3:].any()
    if case == "ties to order_rank":
        assert want[0] == int(np.argmin(np.where(feas, rank, 1 << 60)))
    if case in ("zero-victim win", "no lower priority"):
        assert want[0] >= 0 and want[1] == 0


@pytest.mark.parametrize("ghost", [False, True])
def test_victim_select_aggregates_match_jax(ghost):
    rng = np.random.default_rng(41 + ghost)
    n_pad, P = 64, 8
    vic = rand_victims(rng, n_pad, P)
    nodes = victim_nodes(rng, vic, n_pad, 60)
    g = None
    if ghost:
        g = {"cpu": rng.integers(0, 800, n_pad), "mem": rng.integers(
            0, 2, n_pad) * GI, "eph": np.zeros(n_pad, np.int64),
            "cnt": rng.integers(0, 3, n_pad)}
        g = {k: v.astype(np.int64) for k, v in g.items()}
    valid_v = vic["valid"] & (vic["prio"] < 5)
    feas = rng.random(n_pad) < 0.9
    jn, pn = both(nodes)
    jv, pv = both(vic)
    jg, pg = both(g) if g else (None, None)
    want = JK._victim_select(jn, jv, jnp.asarray(valid_v), 700, GI, 0, jg,
                             jnp.asarray(feas), True, True)
    got = PK._victim_select_plain(pn, pv, torch.as_tensor(valid_v), 700, GI,
                                  0, pg, torch.as_tensor(feas), True, True)
    assert_same(got[0], want[0], "feas0")
    assert_same(got[1], want[1], "victims")
    for k in want[2]:
        assert_same(got[2][k], want[2][k], k)
    assert bool(np.asarray(want[1]).any())


def test_cycle_core_with_ghost_matches_jax():
    """`_cycle_core(ghost=...)`: the ghost enters the filter only."""
    rng = np.random.default_rng(5)
    n_pad, n_real = 64, 60
    vic = rand_victims(rng, n_pad, 8)
    nodes = victim_nodes(rng, vic, n_pad, n_real,
                         room=np.arange(0, n_pad, 2))
    pod = _pod_spec(rng, n_pad, True, 300, 300, 9)
    ghost = {"cpu": rng.integers(0, 3000, n_pad), "mem": rng.integers(
        0, 3, n_pad) * GI, "eph": rng.integers(0, 2, n_pad) * GI,
        "cnt": rng.integers(0, 4, n_pad)}
    ghost = {k: v.astype(np.int64) for k, v in ghost.items()}
    jn, pn = both(nodes)
    jp, pp = both(pod)
    jg, pg = both(ghost)
    for li, lni, ntf in ((0, 0, n_real), (17, 5, 9)):
        want = JK._cycle_core(jn, jp, li, lni, ntf, n_real,
                              dict(JK.DEFAULT_WEIGHTS), 4, ghost=jg)
        got = PK._cycle_core_plain(pn, pp, li, lni, ntf, n_real,
                                   dict(JK.DEFAULT_WEIGHTS), 4, ghost=pg)
        for k in ("selected", "found", "evaluated", "max_score", "total",
                  "kept", "feasible", "fail_first", "general_bits",
                  "next_last_index", "next_last_node_index"):
            assert_same(got[k], want[k], k)
        plain = JK._cycle_core(jn, jp, li, lni, ntf, n_real,
                               dict(JK.DEFAULT_WEIGHTS), 4)
        # the ghost load takes nodes out of the filter
        assert np.asarray(plain["feasible"]).sum() > np.asarray(
            want["feasible"]).sum()


def test_resolvable_candidates_match_jax():
    rng = np.random.default_rng(9)
    ff = rng.integers(0, 9, 200).astype(np.int8)
    gb = np.zeros(200, np.int64)
    for bit in (0, 1, JK.BIT_HOST, JK.BIT_PORTS, JK.BIT_SELECTOR):
        gb |= np.where(rng.random(200) < 0.3, np.int64(1) << bit, 0)
    want = JK._resolvable_candidates(jnp.asarray(ff), jnp.asarray(gb))
    got = PK._resolvable_candidates_plain(torch.as_tensor(ff),
                                          torch.as_tensor(gb))
    assert_same(got, want)


# ---------------------------------------------------------------------------
# K8: pressure_batch
# ---------------------------------------------------------------------------
MASKS = ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
         "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok")


def _pod_spec(rng, n_pad, dense, req_cpu, upd_cpu, prio, check_res=True):
    """One pod's inputs in the `_pod_arrays` layout plus the fold deltas
    and `pprio`; `dense` draws every per-node family, else they stay [1]."""
    d = {"req_cpu": np.int64(req_cpu), "req_mem": np.int64(GI),
         "req_eph": np.int64(0), "req_scalar": np.zeros(1, np.int64),
         "has_request": np.bool_(True), "unknown_scalar": np.bool_(False),
         "skip": np.bool_(False), "check_resources": np.bool_(check_res),
         "nz_cpu": np.int64(req_cpu), "nz_mem": np.int64(GI),
         "upd_cpu": np.int64(upd_cpu), "upd_mem": np.int64(GI),
         "upd_eph": np.int64(0), "upd_scalar": np.zeros(1, np.int64),
         "pprio": np.int64(prio)}
    for k in MASKS:
        d[k] = (rng.random(n_pad) < 0.9) if dense else np.ones(1, bool)
    d["interpod_code"] = (rng.choice([0, 0, 0, 0, 1, 3], n_pad).astype(
        np.int8) if dense else np.zeros(1, np.int8))
    for k, hi in (("node_aff_counts", 50), ("taint_counts", 4),
                  ("spread_counts", 5), ("interpod_counts", 6)):
        d[k] = (rng.integers(0, hi, n_pad).astype(np.int64) if dense
                else np.zeros(1, np.int64))
    d["interpod_tracked"] = (rng.random(n_pad) < 0.6) if dense \
        else np.zeros(1, bool)
    d["image_sums"] = (rng.integers(0, 900, n_pad).astype(np.int64)
                       * 1024 ** 2) if dense else np.zeros(1, np.int64)
    d["prefer_avoid"] = (np.where(rng.random(n_pad) < 0.2, 0, 10).astype(
        np.int64) if dense else np.full(1, 10, np.int64))
    return d


def _stack(per_pod):
    return {k: np.ascontiguousarray(v)
            for k, v in TPUScheduler._stack_pods(per_pod).items()}


PRESSURE_B = 16
PRESSURE_CASES = ["plain", "dense masks", "ghost carried in",
                  "check_resources false", "skip padding", "P16"]


def _pressure_inputs(case):
    seed = 500 + PRESSURE_CASES.index(case)
    rng = np.random.default_rng(seed)
    n_pad, n_real, P = 64, 60, (16 if case == "P16" else 8)
    vic = rand_victims(rng, n_pad, P)
    nodes = victim_nodes(rng, vic, n_pad, n_real,
                         room=rng.choice(n_real, 3, replace=False))
    dense = case == "dense masks"
    # queue order, priorities non-increasing; the 700m pods ask 900m of
    # the filter (an init container) and fold 700m
    kinds = [(400, 400, 9), (900, 700, 7), (300, 300, 5), (5000, 5000, 3)]
    per_pod = []
    for j in range(PRESSURE_B):
        req, upd, prio = kinds[min(j * len(kinds) // PRESSURE_B, 3)]
        per_pod.append(_pod_spec(rng, n_pad, dense and j % 2 == 0, req, upd,
                                 prio, check_res=not (
                                     case == "check_resources false"
                                     and j == 5)))
    if dense:
        # dense and inert fields side by side: broadcast like _stack_pods
        for pp in per_pod[1::2]:
            for k in MASKS:
                pp[k] = np.ones(n_pad, bool)
    if case == "skip padding":
        for j in range(11, PRESSURE_B):
            per_pod[j] = dict(per_pod[10], skip=np.bool_(True))
    ghost = {k: np.zeros(n_pad, np.int64) for k in PK.GHOST_FIELDS}
    if case == "ghost carried in":
        ghost = {"cpu": rng.integers(0, 500, n_pad),
                 "mem": rng.integers(0, 2, n_pad) * GI,
                 "eph": np.zeros(n_pad, np.int64),
                 "cnt": rng.integers(0, 2, n_pad)}
        ghost = {k: v.astype(np.int64) for k, v in ghost.items()}
    return nodes, vic, _stack(per_pod), ghost, n_real


def _run_pressure(nodes, vic, stacked, ghost, n_real, li, lni, ntf,
                  jcarry=None, pcarry=None):
    jn, pn = both(nodes)
    jv, pv = both(vic)
    jg, pg = both(ghost)
    jmut = jcarry or {k: jn[k] for k in PK._MUTABLE}
    pmut = pcarry or {k: pn[k] for k in PK._MUTABLE}
    want = JK.pressure_batch(jn, jmut, jg, {k: jnp.asarray(v) for k, v in
                                            stacked.items()}, jv, li, lni,
                             ntf, n_real, 4)
    got = PK.pressure_batch(pn, pmut, pg, {k: torch.as_tensor(v) for k, v in
                                           stacked.items()}, vic, li, lni,
                            ntf, n_real, 4)
    return got, want


def _check_pressure(got, want):
    (pm, pg, pli, plni, po), (jm, jg, jli, jlni, jo) = got, want
    for k in jm:
        assert_same(pm[k], jm[k], k)
    for k in jg:
        assert_same(pg[k], jg[k], "ghost " + k)
    assert int(pli) == int(jli) and int(plni) == int(jlni)
    for k in ("selected", "winner", "any_cand", "victims"):
        assert_same(po[k], jo[k], k)
    # the packed block carries the same per pod
    packed = po["packed"].numpy()
    assert_same(packed[:, 0], np.asarray(jo["selected"]), "packed selected")
    assert_same(packed[:, 1], np.asarray(jo["winner"]), "packed winner")
    assert_same(packed[:, 5:], np.asarray(jo["victims"]), "packed victims")


@pytest.mark.parametrize("case", PRESSURE_CASES)
def test_pressure_batch_matches_jax(case):
    nodes, vic, stacked, ghost, n_real = _pressure_inputs(case)
    ntf = n_real if case != "plain" else 11
    got, want = _run_pressure(nodes, vic, stacked, ghost, n_real, 7, 3, ntf)
    _check_pressure(got, want)
    win = np.asarray(want[4]["winner"])
    if case == "plain":
        # every outcome: bound (-2), nominated (>= 0), failed (-1) with a
        # candidate flag
        assert (win == -2).any() and (win >= 0).any() and (win == -1).any()
        assert np.asarray(want[4]["any_cand"]).any()
    if case == "skip padding":
        assert (win[11:] == -1).all()
        assert not np.asarray(want[4]["any_cand"])[11:].any()


def test_pressure_batch_chunks_chain_like_jax():
    """Two chunks chained on the carries (rows, ghost, li, lni) equal the
    JAX chain: the second chunk sees the first one's nominations."""
    nodes, vic, stacked, ghost, n_real = _pressure_inputs("plain")
    got1, want1 = _run_pressure(nodes, vic, stacked, ghost, n_real, 0, 0,
                                n_real)
    _check_pressure(got1, want1)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    want2 = JK.pressure_batch(jn, want1[0], want1[1],
                              {k: jnp.asarray(v) for k, v in
                               stacked.items()}, jv, want1[2], want1[3],
                              n_real, n_real, 4)
    got2 = PK.pressure_batch(pn, got1[0], got1[1],
                             {k: torch.as_tensor(v) for k, v in
                              stacked.items()}, vic, got1[2], got1[3],
                             n_real, n_real, 4)
    _check_pressure(got2, want2)
    assert int(np.asarray(want2[1]["cnt"]).sum()) > int(
        np.asarray(want1[1]["cnt"]).sum())


# ---------------------------------------------------------------------------
# the host paths: preempt and preempt_pressure_burst
# ---------------------------------------------------------------------------
def port_infos(infos):
    """The port's NodeInfos of a JAX snapshot, pods in the same order."""
    out = {}
    for name, ni in infos.items():
        p = PNodeInfo(to_port(ni.node))
        for pod in ni.pods:
            p.add_pod(to_port(pod))
        out[name] = p
    return out


def _names(victims):
    return sorted(v.name for v in victims)


def compare_preempt(infos, names, incoming, pdbs, msg=""):
    """TorchScheduler.preempt vs TPUScheduler.preempt vs the oracle."""
    err = JFitError(incoming, len(names), {
        n: ["InsufficientResource:cpu"] for n in names})
    oracle = Preemptor(pdbs_fn=lambda: pdbs).preempt(incoming, infos,
                                                     names, err)
    jax_res = TPUScheduler(percentage_of_nodes_to_score=100).preempt(
        incoming, infos, names, err, pdbs)
    obs.reset()
    port = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu")
    perr = PFitError(to_port(incoming), len(names), {
        n: ["InsufficientResource:cpu"] for n in names})
    got = port.preempt(to_port(incoming), port_infos(infos), names, perr,
                       to_port(pdbs))
    assert got is not None and jax_res is not None, msg
    for res in (jax_res, oracle):
        assert (got.node.name if got.node else None) == \
            (res.node.name if res.node else None), msg
        assert _names(got.victims) == _names(res.victims), msg
    assert [p.name for p in got.nominated_to_clear] == \
        [p.name for p in oracle.nominated_to_clear], msg
    if got.node is not None:
        assert obs.get("launch.preempt_scan") == 0   # plain on the CPU
    return got


def _anti(key, value, topology=LABEL_HOSTNAME):
    return Affinity(pod_anti_affinity=PodAntiAffinity(required=(
        PodAffinityTerm(label_selector=LabelSelector(
            match_labels=((key, value),)), topology_key=topology),)))


def _world_basic():
    nodes = [mknode("n0", cpu=2000), mknode("n1", cpu=2000),
             mknode("n2", cpu=2000)]
    infos = snapshot(nodes, {
        "n0": [mkpod("a0", cpu=1000, priority=5),
               mkpod("a1", cpu=1000, priority=1)],
        "n1": [mkpod("b0", cpu=2000, priority=3)],
        "n2": [mkpod("c0", cpu=1000, priority=2),
               mkpod("c1", cpu=1000, priority=2)]})
    return infos, ["n0", "n1", "n2"], mkpod("hi", cpu=1500, priority=10), []


def _world_pdb():
    sel = LabelSelector(match_labels=(("app", "db"),))
    pdbs = [PodDisruptionBudget(name="b", selector=sel,
                                disruptions_allowed=0)]
    infos = snapshot([mknode("n0", cpu=1000), mknode("n1", cpu=1000)], {
        "n0": [mkpod("v0", cpu=1000, priority=1, labels={"app": "db"})],
        "n1": [mkpod("v1", cpu=1000, priority=2)]})
    return infos, ["n0", "n1"], mkpod("hi", cpu=1000, priority=10), pdbs


def _world_bystander(labels_incoming):
    nodes = [mknode("n0", cpu=2000), mknode("n1", cpu=2000)]
    for n in nodes:
        n.labels = {LABEL_HOSTNAME: n.name}
    guard = mkpod("guard", cpu=500, priority=50, labels={"app": "guard"})
    guard.affinity = _anti("app", "web")
    infos = snapshot(nodes, {
        "n0": [guard, mkpod("v0", cpu=1500, priority=1)],
        "n1": [mkpod("v1", cpu=2000, priority=2)]})
    return infos, ["n0", "n1"], mkpod("hi", cpu=1500, priority=10,
                                      labels=labels_incoming), []


def _world_init_container():
    """The incoming pod's init container asks more than its containers:
    the fit uses the larger request."""
    infos = snapshot([mknode("n0", cpu=2000), mknode("n1", cpu=2000)], {
        "n0": [mkpod("a", cpu=600, priority=1), mkpod("b", cpu=600,
                                                      priority=2),
               mkpod("c", cpu=800, priority=3)],
        "n1": [mkpod("d", cpu=1000, priority=1), mkpod("e", cpu=1000,
                                                       priority=4)]})
    inc = mkpod("hi", cpu=500, priority=10)
    inc.init_containers = (Container.make(name="init",
                                          requests={"cpu": 1400}),)
    return infos, ["n0", "n1"], inc, []


PREEMPT_WORLDS = {
    "basic": _world_basic,
    "pdb steering": _world_pdb,
    "affinity bystander": lambda: _world_bystander({}),
    "bystander anti-affinity excludes node":
        lambda: _world_bystander({"app": "web"}),
    "init container": _world_init_container,
}


@pytest.mark.parametrize("world", sorted(PREEMPT_WORLDS))
def test_preempt_matches_jax_and_oracle(world):
    infos, names, inc, pdbs = PREEMPT_WORLDS[world]()
    got = compare_preempt(infos, names, inc, pdbs, world)
    if world == "pdb steering":
        assert got.node.name == "n1"
    if world == "bystander anti-affinity excludes node":
        assert got.node.name == "n1"


@pytest.mark.parametrize("bystanders", [False, True])
def test_preempt_randomized_parity(bystanders):
    rng = random.Random(20260731 if bystanders else 20260730)
    for trial in range(8):
        n_nodes = rng.randint(2, 7)
        nodes = [mknode(f"n{i}", cpu=rng.choice([1000, 2000, 4000]))
                 for i in range(n_nodes)]
        for n in nodes:
            n.labels = {LABEL_HOSTNAME: n.name}
        by_node, uid = {}, 0
        for n in nodes:
            pods = []
            if bystanders and rng.random() < 0.5:
                uid += 1
                g = mkpod(f"g{uid}", cpu=500, priority=50,
                          labels={"app": "guard"})
                g.affinity = _anti("app", rng.choice(["web", "db"]))
                pods.append(g)
            for _ in range(rng.randint(0, 5)):
                uid += 1
                pods.append(mkpod(
                    f"p{uid}", cpu=rng.choice([200, 500, 1000]),
                    priority=rng.randint(0, 6),
                    labels={"app": rng.choice(["db", "web", "etc"])},
                    start=rng.choice([None, float(rng.randint(1, 100))])))
            by_node[n.name] = pods
        infos = snapshot(nodes, by_node)
        pdbs = [PodDisruptionBudget(
            name="b", selector=LabelSelector(match_labels=(("app", "db"),)),
            disruptions_allowed=rng.randint(0, 2))]
        inc = mkpod("hi", cpu=rng.choice([1000, 1500, 2000]), priority=7,
                    labels={"app": rng.choice(["web", "db", "etc"])})
        compare_preempt(infos, [n.name for n in nodes], inc, pdbs,
                        f"trial={trial}")


def oracle_serial(pods, node_infos, names, pdbs):
    """The serial referee: schedule (with nominated ghosts) else preempt
    and nominate, per pod; successes folded into cloned NodeInfos."""
    nominated: dict = {}

    def nom_fn(name):
        return list(nominated.get(name, []))

    g = GenericScheduler(percentage_of_nodes_to_score=100,
                         nominated_pods_fn=nom_fn)
    infos = dict(node_infos)
    out = []
    for pod in pods:
        funcs = jpreds.default_predicate_set(infos)
        try:
            r = g.schedule(pod, infos, names, predicate_funcs=funcs)
        except JFitError as err:
            res = Preemptor(pdbs_fn=lambda: pdbs).preempt(
                pod, infos, names, err, nominated_pods_fn=nom_fn)
            if res.node is not None:
                ghost = pod.clone()
                ghost.node_name = res.node.name
                nominated.setdefault(res.node.name, []).append(ghost)
                out.append(("nominated", res.node.name,
                            [v.name for v in res.victims]))
            else:
                out.append(("failed", not res.nominated_to_clear))
            continue
        assumed = pod.clone()
        assumed.node_name = r.suggested_host
        ni = infos[r.suggested_host].clone()
        ni.add_pod(assumed)
        infos = {**infos, r.suggested_host: ni}
        out.append(("bound", r.suggested_host))
    return out


def _norm(out):
    return [(o[0], o[1], [v.name for v in o[2]]) if o[0] == "nominated"
            else o for o in out]


def compare_pressure(pods, infos, names, pdbs, msg="", b_cap=None):
    """preempt_pressure_burst: the port vs TPUScheduler vs the serial
    oracle, outcomes and walk counters."""
    jax_s = TPUScheduler(percentage_of_nodes_to_score=100)
    port = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu")
    if b_cap is not None:
        jax_s.PRESSURE_B_CAP = port.PRESSURE_B_CAP = b_cap
    want = jax_s.preempt_pressure_burst(pods, infos, names, pdbs)
    obs.reset()
    got = port.preempt_pressure_burst([to_port(p) for p in pods],
                                      port_infos(infos), names,
                                      to_port(pdbs))
    assert got is not None and want is not None, msg
    assert _norm(got) == _norm(want), msg
    assert _norm(got) == oracle_serial(pods, infos, names, pdbs), msg
    assert (port.last_index, port.last_node_index) == \
        (jax_s.last_index, jax_s.last_node_index), msg
    assert obs.get("fetch.pressure_batch") == 1
    assert obs.family("refusal") == {}
    for k in PK._MUTABLE:
        assert_same(port._dev_nodes[k], np.asarray(jax_s._dev_nodes[k]), k)
    return _norm(got)


def _pressure_world(name):
    if name == "identical preemptors spread nominations":
        nodes = [mknode(f"n{i}", cpu=1000) for i in range(4)]
        infos = snapshot(nodes, {
            f"n{i}": [mkpod(f"v{i}a", cpu=400, priority=0),
                      mkpod(f"v{i}b", cpu=400, priority=0)]
            for i in range(4)})
        pods = [mkpod(f"hi{k}", cpu=400, priority=9) for k in range(6)]
        return pods, infos, [n.name for n in nodes], []
    if name == "mixed bind and preempt":
        infos = snapshot([mknode("n0", cpu=1000), mknode("n1", cpu=1000)], {
            "n0": [mkpod("v0", cpu=900, priority=0)],
            "n1": [mkpod("v1", cpu=600, priority=0)]})
        pods = [mkpod("big", cpu=900, priority=5),
                mkpod("small", cpu=100, priority=5),
                mkpod("big2", cpu=900, priority=5)]
        return pods, infos, ["n0", "n1"], []
    if name == "no candidates":
        infos = snapshot([mknode("n0", cpu=1000)],
                         {"n0": [mkpod("v", cpu=1000, priority=0)]})
        p = mkpod("pre", cpu=100, priority=9)
        p.node_selector = {"disk": "ssd"}
        return [p], infos, ["n0"], []
    if name == "pdb steering":
        infos, names, inc, pdbs = _world_pdb()
        return [mkpod("hi", cpu=1000, priority=9)], infos, names, pdbs
    if name == "init container":
        infos = snapshot([mknode(f"n{i}", cpu=2000) for i in range(3)], {
            f"n{i}": [mkpod(f"v{i}", cpu=1200, priority=1),
                      mkpod(f"w{i}", cpu=500, priority=2)]
            for i in range(3)})
        pods = []
        for k in range(5):
            p = mkpod(f"hi{k}", cpu=300, priority=8)
            p.init_containers = (Container.make(
                name="init", requests={"cpu": 700}),)
            pods.append(p)
        return pods, infos, ["n0", "n1", "n2"], []
    raise KeyError(name)


PRESSURE_WORLDS = ["identical preemptors spread nominations",
                   "mixed bind and preempt", "no candidates",
                   "pdb steering", "init container"]


@pytest.mark.parametrize("world", PRESSURE_WORLDS)
def test_pressure_burst_matches_jax_and_oracle(world):
    pods, infos, names, pdbs = _pressure_world(world)
    out = compare_pressure(pods, infos, names, pdbs, world)
    kinds = [o[0] for o in out]
    if world == "identical preemptors spread nominations":
        assert kinds == ["nominated"] * 6
        assert len({o[1] for o in out[:4]}) == 4
    if world == "mixed bind and preempt":
        assert "bound" in kinds and "nominated" in kinds
    if world == "no candidates":
        assert out == [("failed", False)]
    if world == "pdb steering":
        assert out[0][1] == "n1"


def _random_pressure_world(rng):
    n_nodes = rng.randint(2, 6)
    cap = rng.choice([1000, 2000])
    nodes = [mknode(f"n{i}", cpu=cap) for i in range(n_nodes)]
    by_node, uid = {}, 0
    for n in nodes:
        pods = []
        for _ in range(rng.randint(1, 4)):
            uid += 1
            pods.append(mkpod(
                f"p{uid}", cpu=rng.choice([200, 500, 800]),
                priority=rng.randint(0, 5),
                labels={"app": rng.choice(["db", "web"])},
                start=rng.choice([None, float(rng.randint(1, 90))])))
        by_node[n.name] = pods
    infos = snapshot(nodes, by_node)
    pdbs = [PodDisruptionBudget(
        name="b", selector=LabelSelector(match_labels=(("app", "db"),)),
        disruptions_allowed=rng.randint(0, 1))]
    return infos, [n.name for n in nodes], pdbs


def test_pressure_burst_randomized_parity():
    rng = random.Random(20260801)
    for trial in range(8):
        infos, names, pdbs = _random_pressure_world(rng)
        pres = [mkpod(f"hi{j}", cpu=rng.choice([300, 600, 900]),
                      priority=rng.choice([6, 7, 8, 9]))
                for j in range(rng.randint(2, 8))]
        pres.sort(key=lambda p: -p.priority)
        compare_pressure(pres, infos, names, pdbs, f"trial={trial}")


def test_pressure_burst_chunks_and_padding():
    """A wave of 21 pods in chunks of 8 (the last padded with skip pods):
    the carries chain across chunks, one fetch for the wave."""
    rng = random.Random(7)
    infos, names, pdbs = _random_pressure_world(rng)
    pres = [mkpod(f"hi{j}", cpu=rng.choice([100, 300, 600]),
                  priority=9 - j // 6) for j in range(21)]
    out = compare_pressure(pres, infos, names, pdbs, b_cap=8)
    assert len(out) == 21


# ---------------------------------------------------------------------------
# refusals: JAX and the port both return None; the port counts the reason
# ---------------------------------------------------------------------------
class _Nominated:
    def has_any(self):
        return True


def _preempt_refusal(reason):
    """(infos, names, incoming, pdbs, scheduler kwargs) for a preempt()
    refusal."""
    nodes = [mknode("n0", cpu=1000, pods=200)]
    victim = mkpod("v", cpu=1000, priority=1, labels={"app": "web"})
    inc = mkpod("hi", cpu=1000, priority=10)
    kw = {}
    if reason == "preempt-nominated-ghosts":
        kw["nominated"] = _Nominated()
    if reason == "preempt-pod-volumes":
        from kubernetes_tpu.api.types import VolumeSource
        inc.volumes = (VolumeSource(name="v", pvc="c"),)
    if reason == "preempt-scalar-request":
        inc.containers = (Container.make(name="c", requests={
            "cpu": 1000, "example.com/gpu": 1}),)
    if reason == "preempt-victims-affinity-terms":
        victim.affinity = _anti("a", "b")
    if reason == "preempt-victims-term-match":
        inc.affinity = _anti("app", "web")
    if reason == "preempt-victims-ports":
        from kubernetes_tpu.api.types import ContainerPort
        port = (ContainerPort(host_port=80, container_port=80),)
        victim.containers = (Container.make(
            name="c", requests={"cpu": 1000}, ports=port),)
        inc.containers = (Container.make(
            name="c", requests={"cpu": 1000}, ports=port),)
    if reason == "preempt-victims-scalar":
        victim.containers = (Container.make(name="c", requests={
            "cpu": 1000, "example.com/gpu": 1}),)
    pods = [victim]
    if reason == "preempt-victims-overflow":
        pods = [mkpod(f"v{j}", cpu=1, priority=1) for j in range(129)]
    return snapshot(nodes, {"n0": pods}), ["n0"], inc, [], kw


PREEMPT_REFUSALS = ["preempt-nominated-ghosts", "preempt-pod-volumes",
                    "preempt-scalar-request", "preempt-victims-overflow",
                    "preempt-victims-affinity-terms",
                    "preempt-victims-ports", "preempt-victims-scalar",
                    "preempt-victims-term-match"]


@pytest.mark.parametrize("reason", PREEMPT_REFUSALS)
def test_preempt_refusal_is_counted(reason):
    infos, names, inc, pdbs, kw = _preempt_refusal(reason)
    err = JFitError(inc, 1, {"n0": ["InsufficientResource:cpu"]})
    assert TPUScheduler(percentage_of_nodes_to_score=100, **kw).preempt(
        inc, infos, names, err, pdbs) is None
    obs.reset()
    port = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu",
                          **kw)
    perr = PFitError(to_port(inc), 1, {"n0": ["InsufficientResource:cpu"]})
    assert port.preempt(to_port(inc), port_infos(infos), names, perr,
                        to_port(pdbs)) is None
    assert obs.family("refusal") == {reason: 1}


def _pressure_refusal(reason):
    nodes = [mknode("n0", cpu=1000, pods=200)]
    victims = [mkpod("v", cpu=800, priority=0)]
    pods = [mkpod("hi", cpu=400, priority=9)]
    kw = {}
    jtree = ptree = None
    if reason == "nominated-ghosts":
        kw["nominated"] = _Nominated()
    if reason == "priority-order":
        pods = [mkpod("lo", cpu=400, priority=1)] + pods
    if reason == "pod-features":
        pods[0].nominated_node_name = "n0"
    if reason == "spread-selectors":
        pods[0].labels = {"app": "web"}
    if reason == "pressure-victims-overflow":
        victims = [mkpod(f"v{j}", cpu=1, priority=0) for j in range(129)]
    if reason == "pressure-victims-affinity-terms":
        victims[0].affinity = _anti("a", "b")
    if reason == "pressure-victims-scalar":
        victims[0].containers = (Container.make(name="c", requests={
            "cpu": 800, "example.com/gpu": 1}),)
    if reason == "tree-rotation":
        # three zones of uneven sizes: the enumeration rotates
        nodes = [mknode(f"n{i}", cpu=1000) for i in range(5)]
        for i, n in enumerate(nodes):
            n.labels = {"failure-domain.beta.kubernetes.io/zone":
                        f"z{min(i, 2)}"}
        jtree, ptree = JNodeTree(), PNodeTree()
        for n in nodes:
            jtree.add_node(n)
            ptree.add_node(to_port(n))
    infos = snapshot(nodes, {"n0": victims})
    return infos, [n.name for n in nodes], pods, kw, jtree, ptree


PRESSURE_REFUSALS = ["nominated-ghosts", "tree-rotation", "priority-order",
                     "pod-features", "spread-selectors", "profile-mixed",
                     "pressure-victims-overflow",
                     "pressure-victims-affinity-terms",
                     "pressure-victims-scalar"]


@pytest.mark.parametrize("reason", PRESSURE_REFUSALS)
def test_pressure_refusal_is_counted(reason):
    from kubernetes_tpu.api.types import Service
    from kubernetes_tpu.profiles import ProfileSet as JProfileSet
    from kubernetes_tpu_torch.profiles import ProfileSet as PProfileSet
    infos, names, pods, kw, jtree, ptree = _pressure_refusal(reason)
    svc = [Service(name="s", selector={"app": "web"})]
    jax_s = TPUScheduler(percentage_of_nodes_to_score=100, node_tree=jtree,
                         services_fn=lambda: svc, **kw)
    port = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu",
                          node_tree=ptree,
                          services_fn=lambda: [to_port(s) for s in svc],
                          **kw)
    if reason == "profile-mixed":
        profs = [{"schedulerName": "default-scheduler"},
                 {"schedulerName": "packer", "priorities": {
                     "MostRequestedPriority": 1}}]
        jax_s.set_profiles(JProfileSet.from_dict({"profiles": profs}))
        port.set_profiles(PProfileSet.from_dict({"profiles": profs}))
        pods = [mkpod("a", cpu=400, priority=9),
                mkpod("b", cpu=400, priority=9)]
        pods[1].scheduler_name = "packer"
    if jtree is not None:
        names = jtree.list_names()
        assert ptree.list_names() == names
    assert jax_s.preempt_pressure_burst(pods, infos, names, []) is None
    obs.reset()
    assert port.preempt_pressure_burst([to_port(p) for p in pods],
                                       port_infos(infos), names,
                                       []) is None
    assert obs.family("refusal") == {reason: 1}


def test_fused_window_refuses_with_nominated_pods():
    infos = snapshot([mknode("n0")], {})
    segs = [([mkpod("a", cpu=100)], False)]
    assert TPUScheduler(nominated=_Nominated()).schedule_burst_fused(
        segs, infos, ["n0"]) is None
    obs.reset()
    port = TorchScheduler(nominated=_Nominated(), device="cpu")
    assert port.schedule_burst_fused(
        [([to_port(p) for p in s], g) for s, g in segs], port_infos(infos),
        ["n0"]) is None
    assert obs.family("refusal") == {"fused-nominated-ghosts": 1}


# ---------------------------------------------------------------------------
# the persistent victim table
# ---------------------------------------------------------------------------
VT_PLANES = ("cpu", "mem", "eph", "prio", "start", "valid", "viol", "aff",
             "ports", "scalar", "count", "overflow")


def _vt_pair(jenc, penc, infos, pinfos, names, pdbs, ppdbs):
    jb = jenc.encode(infos, names)
    pb = penc.encode(pinfos, names)
    jvt = jenc.victim_table(infos, jb, pdbs)
    pvt = penc.victim_table(pinfos, pb, ppdbs)
    assert pvt.P == jvt.P
    for k in VT_PLANES:
        assert_same(getattr(pvt, k), getattr(jvt, k), k)
    assert {n: [p.name for p in s] for n, s in pvt.slots.items()} == \
        {n: [p.name for p in s] for n, s in jvt.slots.items()}
    jd, pd_ = jvt.dirty_rows, pvt.dirty_rows
    assert (pd_ is None) == (jd is None) and (pd_ or []) == (jd or [])
    return jvt, pvt, jb, pb


def test_victim_table_matches_jax():
    rng = random.Random(42)
    sel = LabelSelector(match_labels=(("app", "db"),))
    pdbs = [PodDisruptionBudget(name="b", selector=sel,
                                disruptions_allowed=0)]
    nodes = [mknode(f"n{i}") for i in range(5)]
    by_node, uid = {}, 0
    for n in nodes:
        pods = []
        for _ in range(rng.randint(0, 9)):
            uid += 1
            pods.append(mkpod(
                f"p{uid}", priority=rng.randint(0, 5),
                labels={"app": rng.choice(["db", "web"])},
                start=rng.choice([None, float(rng.randint(1, 50))])))
        by_node[n.name] = pods
    by_node["n1"][0].affinity = _anti("a", "b")
    infos = snapshot(nodes, by_node)
    pinfos = port_infos(infos)
    names = [n.name for n in nodes]
    ppdbs = to_port(pdbs)
    jenc, penc = JEncoder(), PEncoder()
    jvt, pvt, _jb, _pb = _vt_pair(jenc, penc, infos, pinfos, names, pdbs, ppdbs)
    jvt.dirty_rows, pvt.dirty_rows = [], []
    # a bound pod bumps one generation: exactly that row re-sorts
    newpod = mkpod("c", priority=0, start=3.0)
    newpod.node_name = "n3"
    infos["n3"].add_pod(newpod)
    pinfos["n3"].add_pod(to_port(newpod))
    jvt, pvt, _jb, pb = _vt_pair(jenc, penc, infos, pinfos, names, pdbs, ppdbs)
    assert pvt.dirty_rows == [pb.index["n3"]]
    # a PDB-set change re-sorts every row
    pvt.dirty_rows, jvt.dirty_rows = [], []
    before = obs.get("encoder.victim_row_resorts")
    jvt, pvt, _jb, _pb = _vt_pair(jenc, penc, infos, pinfos, names, [], [])
    assert obs.get("encoder.victim_row_resorts") - before == len(names)
    assert sorted(pvt.dirty_rows) == list(range(len(names)))


def test_victim_table_rotation_permute_matches_jax():
    nodes = [mknode(f"n{i}") for i in range(3)]
    infos = snapshot(nodes, {
        "n0": [mkpod("a", priority=1)],
        "n1": [mkpod("b", priority=2), mkpod("c", priority=0)], "n2": []})
    pinfos = port_infos(infos)
    jenc, penc = JEncoder(), PEncoder()
    jvt, pvt, _jb, _pb = _vt_pair(jenc, penc, infos, pinfos,
                                  ["n0", "n1", "n2"], [], [])
    jvt.dirty_rows, pvt.dirty_rows = [], []
    # a rotated enumeration of the same nodes permutes the mirror AND the
    # victim rows; the device copy must re-upload whole (dirty_rows None)
    jvt, pvt, _jb, pb = _vt_pair(jenc, penc, infos, pinfos,
                                 ["n1", "n2", "n0"], [], [])
    assert pvt.dirty_rows is None
    i1 = pb.index["n1"]
    assert int(pvt.count[i1]) == 2 and pvt.prio[i1, 0] == 2
    # a new node set rebuilds the table from scratch
    infos["n3"] = snapshot([mknode("n3")], {})["n3"]
    pinfos["n3"] = port_infos({"n3": infos["n3"]})["n3"]
    _vt_pair(jenc, penc, infos, pinfos, ["n0", "n1", "n2", "n3"], [], [])


def test_victim_planes_upload_then_scatter():
    """A full upload once, then one K4 scatter of the dirty rows, and the
    resident planes equal the host table."""
    infos, names, inc, pdbs = _world_basic()
    pinfos = port_infos(infos)
    port = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu")
    obs.reset()
    port.prewarm_preempt(pinfos, names, [])
    assert obs.get("dispatch.vic_upload") == 1
    victim = pinfos["n0"].pods[1]
    pinfos["n0"].remove_pod(victim)
    perr = PFitError(to_port(inc), 3, {n: ["InsufficientResource:cpu"]
                                       for n in names})
    port.preempt(to_port(inc), pinfos, names, perr, [])
    assert obs.get("dispatch.vic_upload") == 1
    assert obs.get("dispatch.vic_scatter") == 1
    vt = port.encoder._vt
    for k, f in port._VIC_FIELDS:
        assert_same(port._dev_vic[k], getattr(vt, f), k)
    dbg = port.debug_state()
    assert dbg["victim_table"]["resident"] and dbg["victim_table"]["P"] == 8
    assert set(dbg["launches"]) >= {"preempt_scan", "pressure_batch"}


# ---------------------------------------------------------------------------
# carry: a wave begun on JAX, the next wave on the port
# ---------------------------------------------------------------------------
def test_state_from_jax_after_a_wave_takes_the_next_wave_alike():
    rng = random.Random(11)
    infos, names, pdbs = _random_pressure_world(rng)
    nodes = [mknode(f"m{i}", cpu=1000) for i in range(3)]
    extra = snapshot(nodes, {})
    infos.update(extra)
    names = names + [n.name for n in nodes]
    jax_s = TPUScheduler(percentage_of_nodes_to_score=50)
    wave1 = [mkpod(f"a{j}", cpu=300, priority=9) for j in range(6)]
    out1 = jax_s.preempt_pressure_burst(wave1, infos, names, pdbs)
    assert out1 is not None and any(o[0] == "bound" for o in out1)
    # the shell assumes the bound pods in both caches
    pinfos = port_infos(infos)
    bound = [(p, o[1]) for p, o in zip(wave1, out1) if o[0] == "bound"]
    gens = []
    for p, host in bound:
        placed = copy.deepcopy(p)
        placed.node_name = host
        infos[host].add_pod(placed)
        pinfos[host].add_pod(to_port(placed))
        gens.append(infos[host].generation)
    jax_s.note_burst_assumed_many([p for p, _h in bound],
                                  [h for _p, h in bound], gens)
    state = state_from_jax(
        {k: np.asarray(jax_s._dev_nodes[k]) for k in NODE_FIELDS},
        jax_s.last_index, jax_s.last_node_index, device="cpu")
    port = TorchScheduler(percentage_of_nodes_to_score=50, device="cpu")
    port.load_state(state, pinfos, names)
    assert (port.last_index, port.last_node_index) == \
        (jax_s.last_index, jax_s.last_node_index)
    wave2 = [mkpod(f"b{j}", cpu=rng.choice([300, 700]), priority=8)
             for j in range(6)]
    want = jax_s.preempt_pressure_burst(wave2, infos, names, pdbs)
    got = port.preempt_pressure_burst([to_port(p) for p in wave2], pinfos,
                                      names, to_port(pdbs))
    assert _norm(got) == _norm(want)
    assert (port.last_index, port.last_node_index) == \
        (jax_s.last_index, jax_s.last_node_index)
    for k in PK._MUTABLE:
        assert_same(port._dev_nodes[k], np.asarray(jax_s._dev_nodes[k]), k)
