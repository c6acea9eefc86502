"""The port's flight recorder (`kubernetes_tpu_torch.obs.flight`) against
the JAX package's, on the CPU.

Each world runs in two shells, built from the same JAX-package objects
(`tests/test_torch_shell.Shell`): the port's `Scheduler(use_device=True,
device="cpu")` over the plain versions of its kernels, and the JAX
package's `Scheduler(use_tpu=True)` on JAX's CPU backend. Both recorders
run in replay mode. The port's records must equal JAX's record for record
(kind, pods, names, walk counters, rotation cursor, every fetched block,
the outcome; a block's selections index each package's own node axis, so
they are held by name in the outcome, and bit for bit in the uniform
world, where both axes agree), and every replayable record must re-derive
through the port's oracle with no violation. Worlds: a uniform burst cut into five
16-pod chunks at `launch_depth` 3 (each chunk's block is copied out of the
pinned ring slot the next chunk but two reuses), a mixed-workload scan, a
gang drain window of fused segments, and the preempt-baseline pressure
wave. Also: digest mode, the JSON dump, the bounded ring, a tampered
record failing replay, the crash notes.
"""
import json

import numpy as np
import pytest

from kubernetes_tpu.api import types as JT
from kubernetes_tpu.coscheduling import types as JC
from kubernetes_tpu.obs import flight as JF
from kubernetes_tpu.store import store as JS
from tests.test_torch_shell import Shell, baseline_world, mixed_world
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import chaos as pchaos
from kubernetes_tpu_torch.obs import flight as PF

GI = 1024 ** 3
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = JT.LABEL_ZONE_FAILURE_DOMAIN
RECORDERS = {"port": PF.RECORDER, "jax": JF.RECORDER}


@pytest.fixture
def replay_mode():
    for rec in RECORDERS.values():
        rec.configure(mode="replay", capacity=64)
        rec.clear()
    yield
    for rec in RECORDERS.values():
        rec.configure(mode="digest", capacity=8)
        rec.clear()


def node(i, cpu=4000, zones=2):
    return JT.Node(name=f"n{i}",
                   labels={LABEL_HOSTNAME: f"n{i}",
                           LABEL_ZONE: f"z{i % zones}"},
                   allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def pod(name, cpu=100, **kw):
    return JT.Pod(name=name, containers=(JT.Container.make(
        name="c", requests={"cpu": cpu}),), **kw)


def uniform_world(kind):
    """80 identical pods on 5 nodes: one uniform burst in five chunks of
    16 (a chunk's least size), three in flight."""
    sh = Shell(kind)
    for i in range(5):
        sh.create(JS.NODES, node(i))
    sh.start()
    sh.sched.algorithm.launch_depth = 3
    sh.sched.algorithm.launch_cap = 16
    for j in range(80):
        sh.create(JS.PODS, pod(f"u{j}", labels={"app": "x"}))
    sh.sched.pump()
    sh.drain(128)
    sh.sched.pump()
    return sh


def scan_world(kind):
    nodes, pods = mixed_world(11)
    sh = Shell(kind)
    for n in nodes:
        sh.create(JS.NODES, n)
    sh.start()
    for p in pods:
        sh.create(JS.PODS, p)
    sh.sched.pump()
    sh.drain(32)
    sh.sched.pump()
    return sh


def fused_world(kind):
    """Two gangs that fit, one that is rejected whole, and singletons of
    three specs, in fused windows."""
    def member(name, group, cpu):
        return pod(name, cpu, labels={JC.LABEL_POD_GROUP: group})

    sh = Shell(kind)
    for i in range(5):
        sh.create(JS.NODES, node(i, cpu=2000))
    for g in (JC.PodGroup(name="ok", min_member=3),
              JC.PodGroup(name="big", min_member=6),
              JC.PodGroup(name="ok2", min_member=2)):
        sh.create(JS.PODGROUPS, g)
    sh.start(wave_size=3, fused_run_split=3)
    pods = [member(f"ok-{r}", "ok", 300) for r in range(3)]
    pods += [member(f"big-{r}", "big", 2000) for r in range(6)]
    pods += [member(f"ok2-{r}", "ok2", 500) for r in range(2)]
    pods += [pod(f"s{j}", 200 + 100 * (j % 3)) for j in range(7)]
    for p in pods:
        sh.create(JS.PODS, p)
    sh.rounds(16, 6, idle_limit=2)
    return sh


def pressure_world(kind):
    nodes, victims, preemptors = baseline_world(12, 16)
    sh = Shell(kind)
    for n in nodes:
        sh.create(JS.NODES, n)
    for v in victims:
        sh.create(JS.PODS, v)
    sh.start()
    for p in preemptors:
        sh.create(JS.PODS, p)
    sh.rounds(128, 6, idle_limit=2)
    return sh


WORLDS = {"uniform": uniform_world, "scan": scan_world,
          "fused": fused_world, "pressure": pressure_world}


def block_digest(kind: str, block: np.ndarray) -> tuple:
    """A fetched block without its node indices: the selections index
    each package's own node axis (the decided hosts are in the outcome by
    name), so they enter as decided / not decided; every walk counter
    plane stays whole."""
    n_sel = {"uniform": len(block) - 1, "scan": len(block) // 3,
             "fused": len(block) // 4}[kind]
    return ((block[:n_sel] >= 0).tolist(), block[n_sel:].tolist())


def digest(rec) -> dict:
    """What a record pins, without the device-matrix epoch and the victim
    table's shape (each package's own bookkeeping)."""
    return {
        "kind": rec.kind,
        "segments": [([p.key for p in seg], g) for seg, g in rec.segments],
        "names": list(rec.names),
        "li": rec.li, "lni": rec.lni, "zone_index": rec.zone_index,
        "tree_epoch": rec.tree_epoch,
        "blocks": [block_digest(rec.kind, b) for b in rec.blocks],
        "outcome": rec.outcome,
        "notes": list(rec.notes),
    }


def run_both(world) -> dict:
    out = {}
    for kind, rec in RECORDERS.items():
        rec.clear()
        world(kind)
        out[kind] = rec.records()
    return out


@pytest.mark.parametrize("kind", list(WORLDS))
def test_records_equal_jax_and_replay_clean(kind, replay_mode):
    recs = run_both(WORLDS[kind])
    assert any(r.kind == kind for r in recs["port"]), \
        [r.kind for r in recs["port"]]
    assert [digest(r) for r in recs["port"]] \
        == [digest(r) for r in recs["jax"]]
    assert PF.RECORDER.replay_all() == []


def test_ring_blocks_at_launch_depth_3(replay_mode):
    """Each chunk's block is copied once its copy completed: at depth 3
    the slot of chunk k is reused by chunk k + 3, and the record must
    still hold chunk k's own bits, equal to JAX's block for that chunk."""
    recs = run_both(uniform_world)
    (pr,), (jr,) = recs["port"], recs["jax"]
    assert pr.kind == "uniform" and len(pr.blocks) == 5
    for k, (pb, jb) in enumerate(zip(pr.blocks, jr.blocks)):
        assert np.array_equal(pb, jb), k
    # the chunks decided different pods on different nodes: no two blocks
    # alias one buffer
    assert len({b.tobytes() for b in pr.blocks}) > 1
    assert len(pr.outcome["hosts"]) == 80


def test_digest_mode_records_without_capture():
    rec = PF.RECORDER
    rec.configure(mode="digest", capacity=8)
    rec.clear()
    uniform_world("port")
    (r,) = rec.records()
    assert r.kind == "uniform" and len(r.pods) == 80
    assert r.blocks and r.outcome is not None
    assert r.capture is None
    with pytest.raises(ValueError):
        rec.replay(r)
    rec.clear()


def test_off_mode_records_nothing():
    rec = PF.RECORDER
    rec.configure(mode="off")
    rec.clear()
    try:
        uniform_world("port")
        assert rec.records() == []
    finally:
        rec.configure(mode="digest")
    with pytest.raises(ValueError):
        rec.configure(mode="bogus")


def test_dump_is_json_artifact(replay_mode, tmp_path):
    uniform_world("port")
    path = tmp_path / "flight.json"
    assert PF.dump(str(path)) == str(path)
    doc = json.loads(path.read_text())
    (r0,) = doc["flight_records"]
    for key in ("kind", "segments", "last_index", "last_node_index",
                "dev_epoch", "node_tree_epoch", "victim_table",
                "blocks", "outcome", "replayable", "notes"):
        assert key in r0, key
    assert r0["replayable"] is True
    assert r0["segments"][0]["pods"][0] == "default/u0"
    assert PF.dump() == doc


def test_ring_is_bounded(replay_mode):
    PF.RECORDER.configure(capacity=2)
    for _ in range(3):
        scan_world("port")
    assert len(PF.RECORDER.records()) == 2


@pytest.mark.parametrize("kind", ["uniform", "scan", "fused"])
def test_tampered_record_fails_replay(kind, replay_mode):
    WORLDS[kind]("port")
    rec = next(r for r in PF.RECORDER.records() if r.kind == kind)
    if kind == "fused":
        hosts = next(s["hosts"] for s in rec.outcome["segments"]
                     if s.get("hosts"))
    else:
        hosts = rec.outcome["hosts"]
    assert hosts
    assert PF.RECORDER.replay(rec) == []
    hosts[0] = "n-bogus"
    assert PF.RECORDER.replay(rec), "a tampered record replayed clean"


def test_pressure_records_are_dump_only(replay_mode):
    pressure_world("port")
    rec = next(r for r in PF.RECORDER.records() if r.kind == "pressure")
    assert rec.outcome["outcomes"]
    with pytest.raises(ValueError):
        PF.RECORDER.replay(rec)
    docs = PF.dump()["flight_records"]
    assert all(d["replayable"] is (d["kind"] != "pressure") for d in docs)


def test_crash_notes(replay_mode):
    """`note_crash` marks the newest record; a chaos injection marks the
    record of the burst it hit."""
    uniform_world("port")
    PF.RECORDER.note_crash("commit-wave-crash")
    assert PF.RECORDER.records()[-1].notes == ["commit-wave-crash"]
    PF.RECORDER.clear()
    pchaos.plan(seed=1, rates={"device.fetch": 1.0}, limit=1)
    try:
        scan_world("port")
    finally:
        pchaos.disable()
    notes = [n for r in PF.RECORDER.records() for n in r.notes]
    assert "chaos:device.fetch" in notes
    assert PF.RECORDER.replay_all() == []
