"""The port's host copies under the shell, and its device-fault degrade.

- The port's `Store`, informers and `PriorityQueue` against the JAX
  package's on one recorded op sequence: the resource versions each write
  returns, the watch events, the informer handlers' calls, the queue's pop
  order, its backoff and its nominated pods.
- `DeviceCircuitBreaker` against the JAX package's on one fault sequence.
- The degrade of `TorchScheduler` (`device="cpu"`): a DeviceFault at the
  `device.dispatch` or `device.fetch` point of each seam (`schedule`, the
  uniform and scan bursts, `schedule_burst_fused`, `preempt`,
  `preempt_pressure_burst`) gives the decisions of the undisturbed run and
  is counted (`twin.device-fault` / `refusal.device-fault` and the
  breaker); consecutive faults open the circuit and a probe closes it.
  Nothing but the injected DeviceFault is absorbed: a CUDA error of a
  launch or of a fetch, and a RuntimeError of the build or of the stamp
  check, propagate.
"""
import random

import pytest
import torch

from kubernetes_tpu.api import types as JT
from kubernetes_tpu.core import breaker as JB
from kubernetes_tpu.queue.scheduling_queue import PriorityQueue as JQueue
from kubernetes_tpu.store import informer as JI
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
from tests.test_torch_encoders import to_port
from tests.test_torch_shell import Shell, baseline_world
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import chaos, obs
from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.core import breaker as PB
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
from kubernetes_tpu_torch.oracle.preemption import Preemptor
from kubernetes_tpu_torch.queue.scheduling_queue import PriorityQueue as PQueue
from kubernetes_tpu_torch.store import informer as PI
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.utils.clock import FakeClock as PFakeClock

GI = 1024 ** 3
LABEL_HOSTNAME = "kubernetes.io/hostname"


# ---------------------------------------------------------------------------
# Store, informers and queue on one recorded op sequence
# ---------------------------------------------------------------------------
def store_ops(S, T, conv):
    """One op sequence on a fresh store of package `S` (api types `T`,
    objects through `conv`): every write's resource version, then the
    watch's events and an informer's handler calls."""
    st = S.Store(watch_log_size=4096)
    w = st.watch(S.PODS)
    calls = []
    inf_mod = PI if S is PS else JI
    inf = inf_mod.InformerFactory(st).informer(S.PODS)
    inf.add_event_handler(
        on_add=lambda p: calls.append(("add", p.key, p.node_name)),
        on_update=lambda o, n: calls.append(("update", n.key, n.node_name,
                                             n.nominated_node_name)),
        on_delete=lambda p: calls.append(("delete", p.key)))
    inf.sync()
    rvs = []
    rvs.append(st.create(S.NODES, conv(JT.Node(
        name="n0", allocatable={"cpu": 4000, "memory": GI, "pods": 10}))
    ).resource_version)
    for j in range(6):
        rvs.append(st.create(S.PODS, conv(JT.Pod(
            name=f"p{j}", priority=j % 3, containers=(JT.Container.make(
                name="c", requests={"cpu": 100 * (j + 1)}),)))
        ).resource_version)
    rvs.append(st.bind_pod("default/p0", "n0").resource_version)
    rvs.append(st.set_nominated_node_name("default/p1", "n0")
               .resource_version)
    st.commit_wave([("default/p2", "n0"), ("default/p3", "n0")])
    st.fanout_wave()
    rvs.append(st.resource_version())
    rvs.append(st.delete(S.PODS, "default/p4").resource_version)

    def relabel(p):
        p.labels = {"x": "y"}
        return p
    rvs.append(st.guaranteed_update(S.PODS, "default/p5", relabel)
               .resource_version)
    with pytest.raises(S.ConflictError):
        st.update(S.PODS, st.get(S.PODS, "default/p5"), expect_rv=1)
    events = [(e.type, e.obj.key, e.obj.node_name, e.obj.resource_version)
              for e in w.drain()]
    inf.pump()
    listed = sorted((p.key, p.node_name, p.resource_version)
                    for p in st.list(S.PODS)[0])
    return rvs, events, calls, listed, st.resource_version()


def test_store_and_informer_equal_on_a_recorded_sequence():
    j = store_ops(JS, JT, lambda o: o)
    p = store_ops(PS, PT, to_port)
    assert p == j
    assert len(p[1]) >= 10 and len(p[2]) >= 8


def queue_ops(Q, clock, conv):
    """Adds, pops, failed re-entries with backoff, a move to active, a
    flush after the backoff expires, and nominations, on one queue."""
    q = Q(clock=clock)
    rng = random.Random(5)
    pods = [conv(JT.Pod(name=f"q{j}", priority=rng.choice([0, 1, 5]),
                        containers=(JT.Container.make(
                            name="c", requests={"cpu": 100}),)))
            for j in range(12)]
    q.add_many(pods[:6])
    for p in pods[6:]:
        q.add(p)
    order = []
    popped = []
    for _ in range(5):
        p = q.pop(timeout=0)
        order.append(p.key)
        popped.append((p, q.scheduling_cycle))
    # three fail: backoff (a move request after their cycle) or
    # unschedulable
    for p, cyc in popped[:2]:
        q.add_unschedulable_if_not_present(p, cyc)
    q.move_all_to_active()
    q.add_unschedulable_if_not_present(popped[2][0], popped[2][1])
    state = [sorted(p.key for p in v)
             for _k, v in sorted(q.pending_pods().items())]
    backoff = [q._backoff.backoff_time(p.key) for p, _ in popped[:3]]
    n1 = conv(JT.Pod(name="q3", priority=pods[3].priority,
                     nominated_node_name="n1",
                     containers=pods[3].containers))
    q.nominated.add(n1, "n1")
    nominated = sorted(p.key for p in q.nominated.pods_for_node("n1"))
    clock.step(30.0)
    q.flush()
    while True:
        p = q.pop(timeout=0)
        if p is None:
            break
        order.append(p.key)
    return order, state, backoff, nominated, q.nominated.has_any()


def test_queue_equal_on_a_recorded_sequence():
    j = queue_ops(JQueue, JFakeClock(100.0), lambda o: o)
    p = queue_ops(PQueue, PFakeClock(100.0), to_port)
    assert p == j
    assert len(p[0]) >= 11 and p[3] == ["default/q3"]


# ---------------------------------------------------------------------------
# the breaker against the JAX package's
# ---------------------------------------------------------------------------
def test_breaker_equal_on_a_fault_sequence():
    rng = random.Random(3)
    seq = [rng.choice(["gate", "gate", "fault", "ok"]) for _ in range(400)]
    trace = {}
    for name, B in (("jax", JB), ("port", PB)):
        b = B.DeviceCircuitBreaker(fault_threshold=3, probe_after=4)
        out = []
        for op in seq:
            if op == "gate":
                out.append(b.allow_device())
            elif op == "fault":
                b.record_fault("device.fetch")
            else:
                b.record_success()
            out.append(b.state)
        trace[name] = (out, b.debug_state())
    assert trace["port"] == trace["jax"]
    assert trace["port"][1]["trips_total"] > 1
    assert trace["port"][1]["promotions_total"] > 1


# ---------------------------------------------------------------------------
# the device-fault degrade
# ---------------------------------------------------------------------------
@pytest.fixture
def fresh():
    """Zeroed counts and no chaos plan, before and after."""
    obs.reset()
    chaos.disable()
    yield
    chaos.disable()
    obs.reset()


def plan_one(point: str, skip: int = 0):
    """A chaos plan whose `point` fires once, after `skip` quiet draws."""
    p = chaos.plan(seed=0, rates={point: 1.0}, limit=1)
    orig = p.should
    state = {"seen": 0}

    def should(seam):
        if seam == point:
            state["seen"] += 1
            if state["seen"] <= skip:
                return False
        return orig(seam)
    p.should = should
    return p


def shell_world(kind: str):
    """The port's shell on one of four worlds, each reaching one seam of
    the burst route: "uniform" (spec-identical pods, K3), "scan" (mixed
    plain pods, K5), "fused" (a gang drain window, K6), "pressure" (the
    preempt-baseline world, K8)."""
    sh = Shell("port")
    nodes = [JT.Node(name=f"n{i}", labels={
        LABEL_HOSTNAME: f"n{i}",
        "failure-domain.beta.kubernetes.io/zone": f"z{i % 2}"},
        allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(8)]
    if kind == "pressure":
        nodes, victims, pods = baseline_world(8, 12)
    for n in nodes:
        sh.create(JS.NODES, n)
    if kind == "pressure":
        for v in victims:
            sh.create(JS.PODS, v)
    if kind == "fused":
        from kubernetes_tpu.coscheduling.types import (LABEL_POD_GROUP,
                                                       PodGroup)
        sh.create(JS.PODGROUPS, PodGroup(name="g", min_member=3))
    sh.start()
    if kind == "uniform":
        pods = [JT.Pod(name=f"u{j}", containers=(JT.Container.make(
            name="c", requests={"cpu": 300}),)) for j in range(40)]
    elif kind == "scan":
        pods = [JT.Pod(name=f"s{j}", containers=(JT.Container.make(
            name="c", requests={"cpu": 100 * (1 + j % 4)}),))
            for j in range(40)]
    elif kind == "fused":
        pods = [JT.Pod(name=f"g{r}", labels={LABEL_POD_GROUP: "g"},
                       containers=(JT.Container.make(
                           name="c", requests={"cpu": 700}),))
                for r in range(3)]
        pods += [JT.Pod(name=f"s{j}", containers=(JT.Container.make(
            name="c", requests={"cpu": 200 + 100 * (j % 2)}),))
            for j in range(10)]
    for p in pods:
        sh.create(JS.PODS, p)
    return sh


COUNTER = {"uniform": "dispatch.burst_uniform",
           "scan": "dispatch.burst_scan",
           "fused": "dispatch.burst_fused",
           "pressure": "dispatch.pressure_batch"}


@pytest.mark.parametrize("point", ["device.dispatch", "device.fetch"])
@pytest.mark.parametrize("world", ["uniform", "scan", "fused", "pressure"])
def test_burst_seams_degrade_to_the_same_decisions(world, point, fresh):
    sh = shell_world(world)
    sh.rounds(64, 20, idle_limit=3)
    want = sh.outcome()
    assert obs.get(COUNTER[world]) > 0
    assert obs.get("twin.device-fault") == 0
    obs.reset()
    sh = shell_world(world)
    # the preempt-baseline world's first launch is the failing burst: the
    # fault goes to the pressure wave behind it
    plan_one(point, skip=1 if world == "pressure" else 0)
    sh.rounds(64, 20, idle_limit=3)
    chaos.disable()
    assert sh.outcome() == want
    label = "refusal.device-fault" if world == "pressure" \
        else "twin.device-fault"
    assert obs.get(label) == 1, dict(obs.COUNTS)
    br = sh.sched.algorithm.breaker.debug_state()
    assert br["faults_total"] == 1 and br["state"] == "closed"
    assert sh.sched.algorithm.debug_state()["breaker"] == br


def world_infos(n: int = 12):
    nodes = [PT.Node(name=f"n{i}", labels={LABEL_HOSTNAME: f"n{i}"},
                     allocatable={"cpu": 2000, "memory": 8 * GI,
                                  "pods": 110}) for i in range(n)]
    infos = {nd.name: NodeInfo(nd) for nd in nodes}
    uid = 0
    for i, nd in enumerate(nodes):
        for k in range(4):
            uid += 1
            infos[nd.name].add_pod(PT.Pod(
                name=f"v{uid}", node_name=nd.name, priority=1 + (k + i) % 3,
                start_time=float(uid), containers=(PT.Container.make(
                    name="c", requests={"cpu": 500}),)))
    return infos, [nd.name for nd in nodes]


def pod(name, cpu, priority=0):
    return PT.Pod(name=name, priority=priority, containers=(
        PT.Container.make(name="c", requests={"cpu": cpu}),))


@pytest.mark.parametrize("point", ["device.dispatch", "device.fetch"])
def test_serial_cycle_degrades_to_the_host_twin(point, fresh):
    infos, names = world_infos()
    infos["n3"].remove_pod(infos["n3"].pods[0])
    infos["n7"].remove_pod(infos["n7"].pods[0])
    pods = [pod(f"c{j}", 300 + 100 * (j % 3)) for j in range(6)]

    def run(fault):
        ts = TorchScheduler(device="cpu", percentage_of_nodes_to_score=100)
        out = []
        for j, p in enumerate(pods):
            if fault and j == 2:
                plan_one(point)
            out.append((ts.schedule(p, infos, names).suggested_host,
                        ts.last_index, ts.last_node_index))
        chaos.disable()
        return out, ts

    want, _ = run(False)
    assert obs.get("dispatch.cycle") == len(pods)
    assert obs.get("twin.device-fault") == 0
    got, ts = run(True)
    assert got == want
    assert obs.get("twin.device-fault") == 1
    assert ts.breaker.faults_total == 1
    assert ts.breaker.debug_state()["state"] == "closed"


@pytest.mark.parametrize("point", ["device.dispatch", "device.fetch"])
def test_preempt_degrades_to_the_oracle_preemptor(point, fresh):
    infos, names = world_infos()
    p = pod("hi", 1500, priority=9)
    ts = TorchScheduler(device="cpu", percentage_of_nodes_to_score=100)
    with pytest.raises(FitError) as err:
        ts.schedule(p, infos, names)
    want = ts.preempt(p, infos, names, err.value, [])
    assert want is not None and want.node is not None and want.victims
    assert obs.get("dispatch.preempt_scan") == 1
    plan_one(point)
    assert ts.preempt(p, infos, names, err.value, []) is None
    chaos.disable()
    assert obs.get("twin.device-fault") == 1
    assert ts.breaker.faults_total == 1
    got = Preemptor().preempt(p, infos, names, err.value)
    assert got.node.name == want.node.name
    assert [v.name for v in got.victims] == [v.name for v in want.victims]


def test_circuit_opens_and_a_probe_closes_it(fresh):
    """Three faults in a row open the circuit: the next bursts refuse
    before any launch and the serial cycles run on the host twin, with
    the same decisions; after `probe_after` refused gates one probe runs on
    the device, and its success closes the circuit."""
    sh = shell_world("scan")
    sh.rounds(8, 30, idle_limit=3)
    want = sh.outcome()
    obs.reset()
    sh = shell_world("scan")
    br = sh.sched.algorithm.breaker
    br.probe_after = 6
    chaos.plan(seed=0, rates={"device.dispatch": 1.0}, limit=3)
    sh.rounds(8, 30, idle_limit=3)
    chaos.disable()
    assert sh.outcome() == want
    st = br.debug_state()
    assert st["faults_total"] == 3 and st["trips_total"] == 1
    assert st["promotions_total"] == 1 and st["state"] == "closed"
    assert obs.get("twin.circuit-open") > 0
    assert obs.get("twin.device-fault") >= 1


def test_a_launch_cuda_error_propagates(fresh, monkeypatch):
    """A CUDA error code from a launch (`_check`) stops the run: the
    breaker absorbs the injected DeviceFault only, so a card that faulted
    never hands its decisions to the host twin unseen."""
    infos, names = world_infos()
    assert chaos.device_fault_types() == (chaos.DeviceFault,)

    def failing(*_a, **_k):
        K._check(700, "schedule_cycle")
    monkeypatch.setattr(K, "schedule_cycle", failing)
    ts = TorchScheduler(device="cpu")
    with pytest.raises(RuntimeError) as e:
        ts.schedule(pod("x", 300), infos, names)
    assert "cudaError 700" in str(e.value)
    assert ts.breaker.faults_total == 0
    assert obs.get("twin.device-fault") == 0


def test_a_fetch_cuda_error_propagates(fresh, monkeypatch):
    """A CUDA error that a burst's device-to-host copy reports (where an
    earlier launch's fault surfaces) stops the run as well: the shell's
    burst is not replayed on the host."""
    sh = shell_world("scan")

    def failing(self, packed, slot):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(TorchScheduler, "_fetch", failing)
    with pytest.raises(RuntimeError) as e:
        sh.rounds(64, 20, idle_limit=3)
    assert "illegal memory access" in str(e.value)
    assert sh.sched.algorithm.breaker.faults_total == 0
    assert obs.get("twin.device-fault") == 0
    assert obs.get("refusal.device-fault") == 0


@pytest.mark.parametrize("where", ["build", "stamp"])
def test_build_and_stamp_errors_propagate(where, fresh, monkeypatch,
                                          tmp_path):
    """A kernel that does not build (the build's own error: a compiler
    that exits 1), or a select that finds a stamp missing, stops the run:
    a plain RuntimeError is never degraded."""
    from kubernetes_tpu_torch.ops import _build
    infos, names = world_infos()
    if where == "build":
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "nvcc", lambda: "false")

        def failing(*_a, **_k):
            _build.build_all(["schedule_cycle"])
        monkeypatch.setattr(K, "schedule_cycle", failing)
    else:
        def failing(*_a, **_k):
            K._await_round(torch.zeros((2, 4), dtype=torch.int64), 0, 1,
                           "shard_cycle_select")
        monkeypatch.setattr(K, "schedule_cycle", failing)
    ts = TorchScheduler(device="cpu")
    with pytest.raises(RuntimeError) as e:
        ts.schedule(pod("x", 300), infos, names)
    assert ("nvcc failed" if where == "build" else "stamps") in str(e.value)
    assert ts.breaker.faults_total == 0
    assert obs.get("twin.device-fault") == 0
