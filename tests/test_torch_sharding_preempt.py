"""Device preemption over the port's node-axis mesh (K13 the sharded
pressure wave, K14 the sharded victim scan) and the serial cycle's
nominated-ghost fit, against the JAX package on the CPU.

The port's mesh is `["cpu"] * D` (D in 1, 2, 4); JAX runs on conftest's
virtual 8-device CPU mesh. Kernel level: the same numpy inputs, made from
a seed, go through `preemption_scan(mesh=JS.make_mesh(D))` /
`pressure_batch(mesh=)` in JAX, through the port's sharded programs (the
plain versions of K13a/b and K14a/b with an all-gather between them) and
through the port's single-device plain K7 / K8. Scheduler level: a mesh
TorchScheduler beside `TPUScheduler(mesh=make_mesh(4))`, the oracle
Preemptor and the serial schedule-else-preempt loop; and
`TorchScheduler(nominated=...).schedule` on one device and on a 4-shard
mesh beside `TPUScheduler(nominated=...)` and the oracle
`GenericScheduler(nominated_pods_fn=...)` (a cycle the device ghost
cannot express on the host twin). Every comparison is exact.
"""
import copy
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import (
    Affinity, Container, ContainerPort, LabelSelector, PodAffinityTerm,
    PodAntiAffinity, PodDisruptionBudget, VolumeSource, LABEL_HOSTNAME)
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.oracle import predicates as jpreds
from kubernetes_tpu.oracle.generic_scheduler import (
    FitError as JFitError, GenericScheduler)
from kubernetes_tpu.oracle.preemption import Preemptor
from kubernetes_tpu.parallel import sharding as JS
from kubernetes_tpu.queue.scheduling_queue import NominatedPodMap
from tests.test_preemption import mknode, mkpod, snapshot
from tests.test_torch_encoders import to_port
from tests.test_torch_preempt import (
    PREEMPT_WORLDS, PRESSURE_WORLDS, _check_pressure, _names, _norm,
    _pressure_inputs, _pressure_world, _random_pressure_world, assert_same,
    both, oracle_serial, port_infos, rand_victims, victim_nodes)

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    FitError as PFitError)
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


GI = 1024 ** 3


# ---------------------------------------------------------------------------
# C1: the serial cycle with nominated pods (the two-pass ghost fit)
# ---------------------------------------------------------------------------
def _nominee(name, cpu, prio, node, mem_gi=0):
    p = mkpod(name, cpu=cpu, priority=prio)
    if mem_gi:
        p.containers = (Container.make(name="c", requests={
            "cpu": cpu, "memory": mem_gi * GI}),)
    p.nominated_node_name = node
    return p


def _nominated_world(seed):
    """Nodes filled close to their CPU, nominees of priorities 2-8 on most
    of them (one on a node outside the snapshot), and incoming pods of
    priority 1, 5 and 9, one of them nominated itself."""
    rng = random.Random(seed)
    n_nodes = rng.randint(9, 14)
    nodes = [mknode(f"n{i}", cpu=rng.choice([2000, 3000, 4000]),
                    pods=rng.choice([4, 6, 110])) for i in range(n_nodes)]
    by_node = {}
    for n in nodes:
        cap = n.allocatable["cpu"]
        by_node[n.name] = [mkpod(f"{n.name}-b{k}", cpu=rng.choice(
            [cap // 4, cap // 3]), priority=rng.randint(0, 9))
            for k in range(rng.randint(1, 3))]
    infos = snapshot(nodes, by_node)
    names = [n.name for n in nodes]
    nominees = []
    for j in range(rng.randint(n_nodes // 2, n_nodes)):
        node = rng.choice(names)
        nominees.append(_nominee(f"nom{j}", rng.choice([300, 700, 1200]),
                                 rng.choice([2, 5, 8]), node,
                                 mem_gi=rng.choice([0, 0, 4])))
    nominees.append(_nominee("nom-gone", 500, 9, "not-in-snapshot"))
    incoming = [mkpod(f"in{j}", cpu=rng.choice([400, 800, 1500]),
                      priority=rng.choice([1, 5, 9])) for j in range(8)]
    # the pod's own nomination never counts against it
    own = copy.copy(incoming[2])
    own.nominated_node_name = names[0]
    nominees.append(own)
    return infos, names, nominees, incoming


def _nom_map(pods):
    m = NominatedPodMap()
    for p in pods:
        m.add(p)
    return m


def _result(fn):
    """A ScheduleResult's fields, or the FitError's node count and
    reasons."""
    try:
        r = fn()
    except (JFitError, PFitError) as e:
        return ("fit-error", e.num_all_nodes,
                {k: list(v) for k, v in e.failed_predicates.items()})
    return (r.suggested_host, r.evaluated_nodes, r.feasible_nodes,
            [tuple(x) for x in r.host_priority],
            {k: list(v) for k, v in r.failed_predicates.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_with_nominated_pods_matches_jax_and_oracle(seed):
    """`schedule` with nominees of higher, equal and lower priority (and
    the pod's own nomination) on one device and on a 4-shard mesh equals
    TPUScheduler(nominated=...) (its host twin) and the oracle's two-pass
    fit, result for result, with the binds assumed in between."""
    infos, names, nominees, incoming = _nominated_world(seed)
    jnom = _nom_map(nominees)
    pnom = _nom_map([to_port(p) for p in nominees])
    oracle = GenericScheduler(nominated_pods_fn=jnom.pods_for_node)
    jax_s = TPUScheduler(nominated=jnom)
    single = TorchScheduler(nominated=pnom, device="cpu")
    mesh = TorchScheduler(nominated=pnom, device="cpu",
                          mesh=PS.Mesh(["cpu"] * 4))
    pinfos = port_infos(infos)
    obs.reset()
    ghosts = 0
    outcomes = set()
    for pod in incoming:
        ppod = to_port(pod)
        want = _result(lambda: oracle.schedule(
            pod, infos, names,
            predicate_funcs=jpreds.default_predicate_set(infos)))
        assert _result(lambda: jax_s.schedule(pod, infos, names)) == want
        before = obs.get("dispatch.cycle_ghost")
        assert _result(lambda: single.schedule(ppod, pinfos, names)) == want
        assert _result(lambda: mesh.schedule(ppod, pinfos, names)) == want
        ghosts += obs.get("dispatch.cycle_ghost") - before
        outcomes.add(want[0] == "fit-error")
        for s in (jax_s, single, mesh):
            assert (s.last_index, s.last_node_index) == \
                (oracle.last_index, oracle.last_node_index)
        if want[0] != "fit-error":
            placed = copy.deepcopy(pod)
            placed.node_name = want[0]
            infos[want[0]].add_pod(placed)
            pinfos[want[0]].add_pod(to_port(placed))
    assert ghosts > 0
    assert obs.family("refusal") == {}


def test_nominated_ghost_changes_the_decision():
    """A nominee of higher priority holds the only node with room: the pod
    fails where it would bind without the nomination, and binds when the
    nominee is of lower priority."""
    infos = snapshot([mknode("n0", cpu=2000), mknode("n1", cpu=2000)], {
        "n0": [mkpod("a", cpu=1500)], "n1": [mkpod("b", cpu=500)]})
    names = ["n0", "n1"]
    for prio, want in ((9, None), (1, "n1")):
        nom = _nominee("nom", 1200, prio, "n1")
        port = TorchScheduler(nominated=_nom_map([to_port(nom)]),
                              device="cpu")
        pod = to_port(mkpod("in", cpu=800, priority=5))
        got = _result(lambda: port.schedule(pod, port_infos(infos), names))
        if want is None:
            assert got[0] == "fit-error"
            assert "n1" in got[2]
        else:
            assert got[0] == want


@pytest.mark.parametrize("gate", ["pod volumes", "pod affinity",
                                  "nominee ports", "nominee scalar"])
def test_nominated_ghost_gate_raises(gate):
    """A ghost the resource rows cannot express once raised
    NotImplementedError naming the gate; the cycle now goes to the host
    twin (`twin.nominated-ghosts`), as TPUScheduler sends every nominated
    cycle to its own, and equals it (tests/test_torch_host_twin.py holds
    the twin on larger worlds and meshes)."""
    infos = snapshot([mknode("n0", cpu=4000)], {})
    pod = mkpod("in", cpu=100, priority=5)
    nom = _nominee("nom", 100, 9, "n0")
    if gate == "pod volumes":
        pod.volumes = (VolumeSource(name="v", pvc="c"),)
    if gate == "pod affinity":
        pod.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(
            required=(PodAffinityTerm(label_selector=LabelSelector(
                match_labels=(("a", "b"),)), topology_key=LABEL_HOSTNAME),)))
    if gate == "nominee ports":
        nom.containers = (Container.make(name="c", requests={"cpu": 100},
                                         ports=(ContainerPort(
                                             host_port=80,
                                             container_port=80),)),)
    if gate == "nominee scalar":
        nom.containers = (Container.make(name="c", requests={
            "cpu": 100, "example.com/gpu": 1}),)
    jax_s = TPUScheduler(nominated=_nom_map([nom]))
    port = TorchScheduler(nominated=_nom_map([to_port(nom)]), device="cpu")
    obs.reset()
    want = _result(lambda: jax_s.schedule(pod, infos, ["n0"]))
    got = _result(lambda: port.schedule(to_port(pod), port_infos(infos),
                                        ["n0"]))
    assert got == want
    assert (port.last_index, port.last_node_index) == \
        (jax_s.last_index, jax_s.last_node_index)
    assert obs.family("twin") == {"nominated-ghosts": 1}
    assert obs.get("dispatch.cycle") == 0


# ---------------------------------------------------------------------------
# K14: the sharded victim scan (K14a on every shard, K14b over the records)
# ---------------------------------------------------------------------------
SHARDS = [1, 2, 4]
SCAN_CASES = ["default", "ties across shards", "zero-victim win",
              "no candidate", "P16 odd n_real"]


def _scan_inputs(case):
    rng = np.random.default_rng(700 + SCAN_CASES.index(case))
    n_pad = 64
    n_real = 41 if case == "P16 odd n_real" else 40
    P = 16 if case == "P16 odd n_real" else 8
    vic = rand_victims(rng, n_pad, P)
    nodes = victim_nodes(rng, vic, n_pad, n_real)
    feas = rng.random(n_pad) < 0.85
    # the candidate order is not the row order: the lowest ranks sit on
    # the last shards
    rank = np.full(n_pad, 1 << 30, np.int64)
    rank[:n_real] = rng.permutation(n_real)[::-1]
    pod = {"req_cpu": np.int64(900), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI)}
    if case == "ties across shards":
        # every node a copy of a row with a victim below priority 6, full:
        # the five criteria tie on every shard
        j0 = int(np.argmax((vic["valid"] & (vic["prio"] < 6)).any(1)))
        for k in vic:
            vic[k] = np.ascontiguousarray(np.repeat(vic[k][j0:j0 + 1],
                                                    n_pad, 0))
        for k in nodes:
            if k != "valid":
                nodes[k] = np.ascontiguousarray(
                    np.repeat(nodes[k][j0:j0 + 1], n_pad, 0))
        nodes["req_cpu"][:] = nodes["alloc_cpu"][0]
        pod = {"req_cpu": np.int64(1), "req_mem": np.int64(0),
               "req_eph": np.int64(0)}
    if case == "zero-victim win":
        nodes["req_cpu"] = nodes["req_cpu"] // 4
    if case == "no candidate":
        feas[:] = False
    return nodes, vic, pod, feas, rank, n_real


@pytest.mark.parametrize("case", SCAN_CASES)
def test_sharded_preempt_matches_jax(case):
    """`preemption_scan(mesh=)`: the port's K14a/b plain versions on 1, 2
    and 4 CPU shards equal JAX's `sharded_preempt_fn` on the same mesh
    size and the single-device plain K7, block for block."""
    nodes, vic, pod, feas, rank, n_real = _scan_inputs(case)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    single = PK.preemption_scan(pn, vic, pod, feas, rank, n_real, True,
                                True, 6)
    for d in SHARDS:
        want = np.asarray(JK.preemption_scan(
            jn, jv, pod, jnp.asarray(feas), jnp.asarray(rank), n_real, True,
            True, 6, mesh=JS.make_mesh(d)))
        mesh = PS.Mesh(["cpu"] * d)
        got = PK.preemption_scan(PS.shard_node_arrays(mesh, pn),
                                 PS.shard_victim_planes(mesh, vic), pod,
                                 feas, rank, n_real, True, True, 6,
                                 mesh=mesh)
        assert got.dtype == torch.int32
        assert_same(got, want, f"{case} D={d}")
        assert_same(got, single, f"{case} D={d} vs K7")
    if case == "no candidate":
        assert want[0] == -1
    if case == "zero-victim win":
        assert want[0] >= 0 and want[1] == 0
    if case == "ties across shards":
        # the tie falls to the lowest rank, which lies past the first of
        # four shards while every shard holds tied rows
        assert want[0] == int(np.argmin(np.where(
            feas[:n_real], rank[:n_real], 1 << 60)))
        assert want[0] >= 16


def test_shard_candidate_records_decide_like_every_row():
    """The D-record pick alone: K14b over K14a's records of a 4-shard
    split equals `_pick_one_node` over every row, with its flags."""
    nodes, vic, pod, feas, rank, n_real = _scan_inputs("default")
    _jn, pn = both(nodes)
    pv = PK._vic_tensors(vic, "cpu")
    mesh = PS.Mesh(["cpu"] * 4)
    shards = PS.shard_node_arrays(mesh, pn)
    vics = PS.shard_victim_planes(mesh, vic)
    recs = [PK.shard_preempt_local_plain(sh, vc, pod, torch.as_tensor(
        feas[16 * s: 16 * s + 16]), torch.as_tensor(rank[16 * s: 16 * s + 16]),
        16 * s, n_real, True, True, 6)
        for s, (sh, vc) in enumerate(zip(shards, vics))]
    assert all(r.numel() == PK.cand_record_bytes(8) for r in recs)
    out = PK.preempt_pick_plain(torch.stack(recs), 8)
    want = PK._preempt_scan_core_plain(
        pn, pv, pod, torch.as_tensor(feas), torch.as_tensor(rank), n_real,
        6, True, True)
    assert_same(out, want)


# ---------------------------------------------------------------------------
# K13: the sharded pressure wave (K13a on every shard, K13b per device)
# ---------------------------------------------------------------------------
WAVE_CASES = ["plain", "dense masks", "ghost carried in", "skip padding",
              "P16"]


def _wave(case):
    """The K8 test chunks of tests/test_torch_preempt.py (16 pods over 60
    of 64 nodes, binds then nominations then failures)."""
    nodes, vic, stacked, ghost, n_real = _pressure_inputs(
        {"P16": "P16"}.get(case, case))
    return nodes, vic, stacked, ghost, n_real


def _jax_wave(nodes, vic, stacked, ghost, n_real, li, lni, ntf, d,
              mut=None):
    jn, _pn = both(nodes)
    jv, _pv = both(vic)
    jg, _pg = both(ghost) if isinstance(ghost, dict) and isinstance(
        next(iter(ghost.values())), np.ndarray) else (ghost, None)
    jmut = mut or {k: jn[k] for k in PK._MUTABLE}
    return JK.pressure_batch(jn, jmut, jg, {k: jnp.asarray(v) for k, v in
                                            stacked.items()}, jv, li, lni,
                             ntf, n_real, 4, mesh=JS.make_mesh(d))


def _port_wave(nodes, vic, stacked, ghost, n_real, li, lni, ntf, d,
               mut=None):
    _jn, pn = both(nodes)
    mesh = PS.Mesh(["cpu"] * d)
    return PK.pressure_batch(
        PS.shard_node_arrays(mesh, pn),
        mut if mut is not None else {k: pn[k] for k in PK._MUTABLE},
        ghost, {k: torch.as_tensor(v) for k, v in stacked.items()}, vic, li,
        lni, ntf, n_real, 4, mesh=mesh)


def _whole(rows_list):
    return {k: torch.cat([r[k] for r in rows_list]) for k in rows_list[0]}


def _check_wave(got, want):
    """A sharded wave (per-shard rows and ghost) against a whole one."""
    pm, pg, pli, plni, po = got
    _check_pressure((_whole(pm) if isinstance(pm, list) else pm,
                     _whole(pg) if isinstance(pg, list) else pg, pli, plni,
                     po), want)


@pytest.mark.parametrize("case", WAVE_CASES)
def test_sharded_pressure_matches_jax(case):
    """`pressure_batch(mesh=)`: the port's K13a/b plain versions on 2 and
    4 CPU shards equal JAX's `sharded_pressure_fn` and the single-device
    plain K8: rows, ghost, li, lni, every outcome and the packed block,
    skip padding rows included."""
    nodes, vic, stacked, ghost, n_real = _wave(case)
    ntf = 11 if case == "plain" else n_real
    _jn, pn = both(nodes)
    _jg, pg = both(ghost)
    single = PK.pressure_batch(pn, {k: pn[k] for k in PK._MUTABLE}, pg,
                               {k: torch.as_tensor(v) for k, v in
                                stacked.items()}, vic, 7, 3, ntf, n_real, 4)
    for d in (2, 4):
        want = _jax_wave(nodes, vic, stacked, ghost, n_real, 7, 3, ntf, d)
        got = _port_wave(nodes, vic, stacked, ghost, n_real, 7, 3, ntf, d)
        _check_wave(got, want)
        assert_same(got[4]["packed"], single[4]["packed"], f"D={d} vs K8")
    win = np.asarray(want[4]["winner"])
    if case == "plain":
        assert (win == -2).any() and (win >= 0).any() and (win == -1).any()
        assert np.asarray(want[4]["any_cand"]).any()
        assert not np.asarray(want[4]["any_cand"])[win == -2].any()
        # nominations land on more than one shard of four, and the later
        # pods read each shard's ghost load
        assert len({int(w) // 16 for w in win[win >= 0]}) > 1
    if case == "skip padding":
        assert (win[11:] == -1).all()


def test_sharded_pressure_chunks_chain_like_jax():
    """Two chunks chained on the per-shard carries, li / lni handed over
    as device scalars: the second chunk sees the first one's nominations,
    as the JAX chain does."""
    nodes, vic, stacked, ghost, n_real = _wave("plain")
    want1 = _jax_wave(nodes, vic, stacked, ghost, n_real, 0, 0, n_real, 4)
    got1 = _port_wave(nodes, vic, stacked, ghost, n_real, 0, 0, n_real, 4)
    _check_wave(got1, want1)
    want2 = _jax_wave(nodes, vic, stacked, want1[1], n_real, want1[2],
                      want1[3], n_real, 4, mut=want1[0])
    got2 = _port_wave(nodes, vic, stacked, got1[1], n_real, got1[2],
                      got1[3], n_real, 4, mut=got1[0])
    _check_wave(got2, want2)
    assert int(np.asarray(want2[1]["cnt"]).sum()) > int(
        np.asarray(want1[1]["cnt"]).sum())


# ---------------------------------------------------------------------------
# mesh TorchScheduler: preempt, prewarm_preempt, preempt_pressure_burst
# against TPUScheduler(mesh=make_mesh(4)) and the oracle
# ---------------------------------------------------------------------------
def _mesh_pair(pct=100):
    return (TPUScheduler(percentage_of_nodes_to_score=pct,
                         mesh=JS.make_mesh(4)),
            TorchScheduler(percentage_of_nodes_to_score=pct, device="cpu",
                           mesh=PS.Mesh(["cpu"] * 4)))


def _mesh_preempt(infos, names, inc, pdbs, msg=""):
    err = JFitError(inc, len(names), {
        n: ["InsufficientResource:cpu"] for n in names})
    oracle = Preemptor(pdbs_fn=lambda: pdbs).preempt(inc, infos, names, err)
    jax_s, port = _mesh_pair()
    want = jax_s.preempt(inc, infos, names, err, pdbs)
    obs.reset()
    got = port.preempt(to_port(inc), port_infos(infos), names, PFitError(
        to_port(inc), len(names), {n: ["InsufficientResource:cpu"]
                                   for n in names}), to_port(pdbs))
    assert got is not None and want is not None, msg
    for res in (want, oracle):
        assert (got.node.name if got.node else None) == \
            (res.node.name if res.node else None), msg
        assert _names(got.victims) == _names(res.victims), msg
    if got.node is not None:
        assert obs.get("gather.preempt") > 0, msg
    assert obs.family("refusal") == {}
    return got


@pytest.mark.parametrize("world", sorted(PREEMPT_WORLDS))
def test_mesh_preempt_matches_jax_and_oracle(world):
    infos, names, inc, pdbs = PREEMPT_WORLDS[world]()
    got = _mesh_preempt(infos, names, inc, pdbs, world)
    if world == "pdb steering":
        assert got.node.name == "n1"


def test_mesh_preempt_randomized_parity():
    rng = random.Random(20261017)
    for trial in range(6):
        n_nodes = rng.randint(3, 9)
        nodes = [mknode(f"n{i}", cpu=rng.choice([1000, 2000, 4000]))
                 for i in range(n_nodes)]
        by_node, uid = {}, 0
        for n in nodes:
            pods = []
            for _ in range(rng.randint(0, 5)):
                uid += 1
                pods.append(mkpod(
                    f"p{uid}", cpu=rng.choice([200, 500, 1000]),
                    priority=rng.randint(0, 6),
                    labels={"app": rng.choice(["db", "web"])},
                    start=rng.choice([None, float(rng.randint(1, 9))])))
            by_node[n.name] = pods
        infos = snapshot(nodes, by_node)
        pdbs = [PodDisruptionBudget(
            name="b", selector=LabelSelector(match_labels=(("app", "db"),)),
            disruptions_allowed=rng.randint(0, 2))]
        inc = mkpod("hi", cpu=rng.choice([1000, 1500, 2000]), priority=7)
        _mesh_preempt(infos, [n.name for n in nodes], inc, pdbs,
                      f"trial={trial}")


def test_mesh_prewarm_then_scatter_on_the_owning_shard():
    """prewarm_preempt uploads the victim planes per shard once; a victim
    leaving one node re-sorts one row, scattered (K4) into the shard that
    owns it only; the resident planes equal the host table."""
    nodes = [mknode(f"n{i}", cpu=2000) for i in range(8)]
    infos = snapshot(nodes, {f"n{i}": [mkpod(f"v{i}", cpu=1500,
                                             priority=1)]
                             for i in range(8)})
    names = [n.name for n in nodes]
    pinfos = port_infos(infos)
    _jax_s, port = _mesh_pair()
    obs.reset()
    port.prewarm_preempt(pinfos, names, [])
    assert obs.get("dispatch.vic_upload") == 1
    before = [{k: v.clone() for k, v in d.items()} for d in port._dev_vic]
    victim = pinfos["n5"].pods[0]
    pinfos["n5"].remove_pod(victim)
    inc = to_port(mkpod("hi", cpu=1500, priority=9))
    res = port.preempt(inc, pinfos, names, PFitError(inc, 8, {
        n: ["InsufficientResource:cpu"] for n in names}), [])
    assert res.node is not None and res.node.name == "n5" and not res.victims
    assert obs.get("dispatch.vic_upload") == 1
    assert obs.get("dispatch.vic_scatter") == 1
    vt = port.encoder._vt
    row = port.encoder._batch.index["n5"]
    per = port.mesh.rows(vt.valid.shape[0])
    for s, (d, b) in enumerate(zip(port._dev_vic, before)):
        changed = any(not torch.equal(d[k], b[k]) for k in d)
        assert changed == (s == row // per)
    for k, f in port._VIC_FIELDS:
        np.testing.assert_array_equal(
            torch.cat([d[k] for d in port._dev_vic]).numpy(),
            getattr(vt, f), err_msg=k)


def _mesh_pressure(pods, infos, names, pdbs, msg="", b_cap=None):
    jax_s, port = _mesh_pair()
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
    assert obs.get("steps.pressure") > 0
    assert obs.family("refusal") == {}
    assert isinstance(port._dev_nodes, list) and len(port._dev_nodes) == 4
    for k in PK._MUTABLE:
        assert_same(torch.cat([d[k] for d in port._dev_nodes]),
                    np.asarray(jax_s._dev_nodes[k]), k)
    ph = port.last_preempt_phases
    assert ph["gather_bytes"] > 0 and ph["steps"] == obs.get(
        "steps.pressure")
    return _norm(got)


@pytest.mark.parametrize("world", PRESSURE_WORLDS)
def test_mesh_pressure_burst_matches_jax_and_oracle(world):
    pods, infos, names, pdbs = _pressure_world(world)
    out = _mesh_pressure(pods, infos, names, pdbs, world)
    kinds = [o[0] for o in out]
    if world == "identical preemptors spread nominations":
        assert kinds == ["nominated"] * 6
    if world == "mixed bind and preempt":
        assert "bound" in kinds and "nominated" in kinds
    if world == "no candidates":
        assert out == [("failed", False)]


def test_mesh_pressure_burst_randomized_parity():
    rng = random.Random(20261018)
    for trial in range(5):
        infos, names, pdbs = _random_pressure_world(rng)
        pres = [mkpod(f"hi{j}", cpu=rng.choice([300, 600, 900]),
                      priority=rng.choice([6, 7, 8, 9]))
                for j in range(rng.randint(2, 8))]
        pres.sort(key=lambda p: -p.priority)
        _mesh_pressure(pres, infos, names, pdbs, f"trial={trial}")


def test_mesh_pressure_burst_chunks_and_padding():
    """21 pods in chunks of 8, the last padded with skip pods: rows,
    ghost, li and lni chain on the device across the chunks, one fetch
    for the wave."""
    rng = random.Random(7)
    infos, names, pdbs = _random_pressure_world(rng)
    pres = [mkpod(f"hi{j}", cpu=rng.choice([100, 300, 600]),
                  priority=9 - j // 6) for j in range(21)]
    out = _mesh_pressure(pres, infos, names, pdbs, b_cap=8)
    assert len(out) == 21
    assert obs.get("steps.pressure") == 24
