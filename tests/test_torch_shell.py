"""The port's scheduler shell (`kubernetes_tpu_torch.scheduler`) against the
JAX package's, on the CPU.

Every case runs one world, made from a seed, in three shells: the port's
`Scheduler(use_device=True, device="cpu")` over the plain versions of its
kernels, the JAX package's `Scheduler(use_tpu=True)` (its device path on
JAX's CPU backend) and its oracle shell `Scheduler(use_tpu=False)`. Worlds
are built from JAX-package objects and rebuilt field for field as the
port's (`tests/test_torch_encoders.to_port`). Bindings, nominations,
evictions and PodGroup phases must be exactly equal in all three.

Cases: the mixed-workload fuzz of `tests/test_tpu_parity.py` (plain,
selector, toleration, anti-affinity, zone affinity, host port and priority
pods) on three seeds with and without 4-pod commit windows, one seed on a
4-shard CPU mesh of the port, one world of two scheduling profiles; the
preemption-pressure fuzz on two seeds; one gang drain window with fused
segments and a rejected gang; and a `recover()` after a crash between two
commit windows of the port's shell.
"""
import dataclasses
import random

import pytest

from kubernetes_tpu.api import types as JT
from kubernetes_tpu.coscheduling import types as JC
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import chaos as pchaos
from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.coscheduling import types as PC
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.utils.clock import FakeClock as PFakeClock

GI = 1024 ** 3
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = JT.LABEL_ZONE_FAILURE_DOMAIN
KINDS = ("port", "jax", "oracle")


def convert(obj):
    """A JAX-package object as the port's: api types by `to_port`, a
    PodGroup field for field."""
    if isinstance(obj, JC.PodGroup):
        return PC.PodGroup(**{f.name: getattr(obj, f.name)
                              for f in dataclasses.fields(obj)})
    return to_port(obj)


class Shell:
    """One world in one shell: "port", "jax" (the JAX device shell) or
    "oracle" (the JAX oracle shell). Objects are given as JAX-package
    objects and converted for the port."""

    def __init__(self, kind: str, clock_start: float = 100.0):
        self.kind = kind
        port = kind == "port"
        self.S = PS if port else JS
        self.clock = (PFakeClock if port else JFakeClock)(clock_start)
        self.store = self.S.Store(watch_log_size=65536)
        self.created: list[str] = []
        self.sched = None

    def create(self, kind: str, obj) -> None:
        self.store.create(kind, convert(obj) if self.kind == "port" else obj)
        if kind == JS.PODS:
            self.created.append(obj.key)

    def start(self, wave_size=None, mesh=None, profiles=None,
              fused_run_split=None, **kw) -> None:
        kw.update(clock=self.clock, percentage_of_nodes_to_score=100,
                  profiles=profiles)
        if self.kind == "port":
            self.sched = PScheduler(self.store, use_device=True,
                                    device="cpu", mesh=mesh, **kw)
        else:
            self.sched = JScheduler(self.store,
                                    use_tpu=self.kind == "jax", **kw)
        if self.kind != "oracle":
            if wave_size:
                self.sched.algorithm.wave_size = wave_size
            if fused_run_split:
                self.sched.fused_run_split = fused_run_split
        self.sched.sync()

    def drain(self, max_pods: int) -> None:
        if self.kind == "oracle":
            while self.sched.schedule_one(timeout=0.0):
                pass
        else:
            while self.sched.schedule_burst(max_pods=max_pods):
                pass

    def rounds(self, max_pods: int, n_rounds: int, idle_limit: int = 8,
               check=None) -> None:
        """The fuzzes' deterministic round structure: pump, drain, pump,
        then 2 s of the fake clock (backoff expiry), until `idle_limit`
        rounds in a row bind nothing."""
        idle = 0
        for _ in range(n_rounds):
            self.sched.pump()
            before = self.sched.metrics.schedule_attempts["scheduled"]
            self.drain(max_pods)
            self.sched.pump()
            if check is not None:
                check(self.store)
            idle = 0 if self.sched.metrics.schedule_attempts["scheduled"] \
                > before else idle + 1
            if idle >= idle_limit:
                break
            self.clock.step(2.0)

    def outcome(self) -> dict:
        pods = self.store.list(self.S.PODS)[0]
        groups = self.store.list(self.S.PODGROUPS)[0]
        present = {p.key for p in pods}
        return {
            "bindings": sorted((p.key, p.node_name) for p in pods),
            "nominations": sorted((p.key, p.nominated_node_name)
                                  for p in pods if p.nominated_node_name),
            "evictions": sorted(k for k in self.created if k not in present),
            "podgroups": sorted((g.key, g.phase) for g in groups),
        }


def assert_same(outs: dict, what: str) -> None:
    for kind in ("jax", "oracle"):
        for key in outs["port"]:
            assert outs["port"][key] == outs[kind][key], (
                f"{what}: {key} of the port's shell differs from {kind}'s: "
                f"{[a for a in outs['port'][key] if a not in outs[kind][key]][:6]}"
                f" vs {[b for b in outs[kind][key] if b not in outs['port'][key]][:6]}")


# ---------------------------------------------------------------------------
# the mixed-workload fuzz (tests/test_tpu_parity.py:693-830)
# ---------------------------------------------------------------------------
def mixed_world(seed: int, profiles: bool = False):
    """Nodes and pods of one mixed-workload world (JAX-package objects)."""
    rng = random.Random(seed)
    n_nodes = rng.randint(8, 24)
    zones = rng.choice([1, 2, 3])
    nodes = []
    for i in range(n_nodes):
        labels = {LABEL_HOSTNAME: f"n{i}", LABEL_ZONE: f"z{i % zones}"}
        if i % 3 == 0:
            labels["disk"] = "ssd"
        taints = (JT.Taint(key="ded", value="x", effect=JT.NO_SCHEDULE),) \
            if i % 5 == 0 else ()
        nodes.append(JT.Node(
            name=f"n{i}", labels=labels, taints=taints,
            allocatable={"cpu": rng.choice([2000, 4000]),
                         "memory": 8 * GI, "pods": 110}))
    pods = []
    for j in range(rng.randint(25, 50)):
        cls = rng.choice(["plain", "plain", "selector", "tolerate", "anti",
                          "aff", "port", "prio"])
        kw = {"labels": {"app": cls}}
        if cls == "selector":
            kw["node_selector"] = {"disk": "ssd"}
        elif cls == "tolerate":
            kw["tolerations"] = (JT.Toleration(
                key="ded", value="x", effect=JT.NO_SCHEDULE),)
        elif cls == "anti":
            kw["labels"] = {"name": "t", "color": "green"}
            kw["affinity"] = JT.Affinity(
                pod_anti_affinity=JT.PodAntiAffinity(required=(
                    JT.PodAffinityTerm(
                        label_selector=JT.LabelSelector(
                            match_labels=(("color", "green"),)),
                        topology_key=LABEL_HOSTNAME),)))
        elif cls == "aff":
            kw["labels"] = {"foo": ""}
            kw["affinity"] = JT.Affinity(pod_affinity=JT.PodAffinity(
                required=(JT.PodAffinityTerm(
                    label_selector=JT.LabelSelector(
                        match_labels=(("foo", ""),)),
                    topology_key=LABEL_ZONE),)))
        elif cls == "port":
            kw["containers"] = (JT.Container.make(
                name="c", requests={"cpu": 100},
                ports=(JT.ContainerPort(host_port=8080,
                                        container_port=8080),)),)
        elif cls == "prio":
            kw["priority"] = rng.randint(1, 3)
        if "containers" not in kw:
            kw["containers"] = (JT.Container.make(
                name="c", requests={"cpu": rng.choice([100, 300, 700]),
                                    "memory": GI}),)
        if profiles:
            kw["scheduler_name"] = rng.choice(
                ["default-scheduler", "tenant-most"])
        pods.append(JT.Pod(name=f"p{j}", **kw))
    return nodes, pods


def two_profiles(kind: str):
    """Two scheduling profiles with distinct weight rows, in the shell's
    own package."""
    if kind == "port":
        from kubernetes_tpu_torch.profiles import (ProfileSet,
                                                   SchedulingProfile)
    else:
        from kubernetes_tpu.profiles import ProfileSet, SchedulingProfile
    return ProfileSet([
        SchedulingProfile("default-scheduler"),
        SchedulingProfile("tenant-most", weights=(
            ("MostRequestedPriority", 2),
            ("BalancedResourceAllocation", 1))),
    ])


def run_mixed(seed: int, wave_size=None, mesh_fn=None, profiles=False):
    nodes, pods = mixed_world(seed, profiles)
    outs = {}
    for kind in KINDS:
        sh = Shell(kind)
        for n in nodes:
            sh.create(JS.NODES, n)
        sh.start(wave_size=wave_size,
                 mesh=mesh_fn() if (kind == "port" and mesh_fn) else None,
                 profiles=two_profiles(kind) if profiles else None)
        for p in pods:
            sh.create(JS.PODS, p)
        sh.sched.pump()
        sh.drain(32)
        sh.sched.pump()
        outs[kind] = sh.outcome()
    assert any(h for _k, h in outs["port"]["bindings"])
    return outs


@pytest.mark.parametrize("wave_size", [None, 4])
@pytest.mark.parametrize("seed", [11, 23, 47])
def test_mixed_workload_bindings_equal(seed, wave_size):
    obs.reset()
    outs = run_mixed(seed, wave_size)
    assert_same(outs, f"mixed seed {seed} wave {wave_size}")
    # the port's shell drove its device paths, and no fault was absorbed
    assert obs.get("dispatch.burst_uniform") + obs.get("dispatch.burst_scan") \
        > 0
    assert obs.get("twin.device-fault") == 0


def test_mixed_workload_on_a_mesh():
    from kubernetes_tpu_torch.parallel import sharding as S
    obs.reset()
    outs = run_mixed(23, 4, mesh_fn=lambda: S.make_mesh(
        devices=["cpu"] * 4))
    assert_same(outs, "mixed seed 23 on 4 CPU shards")
    assert obs.get("steps.burst_scan") + obs.get("passes.burst_uniform") > 0


def test_two_profile_world():
    outs = run_mixed(47, 4, profiles=True)
    assert_same(outs, "two profiles, seed 47")


# ---------------------------------------------------------------------------
# the preemption-pressure fuzz (tests/test_tpu_parity.py:960-1036)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [3, 7])
def test_preemption_pressure_equal(seed):
    rng = random.Random(seed)
    n_nodes = rng.randint(3, 8)
    cap = rng.choice([1000, 2000])
    nodes = [JT.Node(name=f"n{i}",
                     labels={LABEL_HOSTNAME: f"n{i}", LABEL_ZONE: f"z{i % 2}"},
                     allocatable={"cpu": cap, "memory": 8 * GI, "pods": 110})
             for i in range(n_nodes)]
    pods = [JT.Pod(name=f"p{j}", labels={"app": "x"},
                   priority=rng.choice([0, 0, 0, 5, 9]),
                   containers=(JT.Container.make(name="c", requests={
                       "cpu": rng.choice([300, 500, 900])}),))
            for j in range(rng.randint(10, 25))]
    obs.reset()
    outs = {}
    for kind in KINDS:
        sh = Shell(kind)
        for n in nodes:
            sh.create(JS.NODES, n)
        sh.start(wave_size=3)
        for p in pods:
            sh.create(JS.PODS, p)
        sh.rounds(8, 60)
        outs[kind] = sh.outcome()
    assert_same(outs, f"pressure seed {seed}")
    # capacity-starved: pods are left pending, after the pressure wave
    # (seed 3) or the serial loop a rotating tree sends them to (seed 7)
    assert not all(h for _k, h in outs["port"]["bindings"])
    assert obs.get("dispatch.pressure_batch") \
        + obs.get("refusal.tree-rotation") > 0


def baseline_world(n_nodes: int, n_preemptors: int):
    """BASELINE.json configs[3]'s shape (preempt-baseline), scaled: nodes of
    4 CPU with ten bound victims of 400m at priority 1 each, and
    preemptors of 400m at priority 10."""
    nodes = [JT.Node(name=f"node-{i}", allocatable={
        "cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(n_nodes)]
    victims = [JT.Pod(name=f"victim-{i * 10 + k}", priority=1,
                      node_name=f"node-{i}", containers=(JT.Container.make(
                          name="c", requests={"cpu": 400}),))
               for i in range(n_nodes) for k in range(10)]
    preemptors = [JT.Pod(name=f"hi-{k}", priority=10, containers=(
        JT.Container.make(name="c", requests={"cpu": 400}),))
        for k in range(n_preemptors)]
    return nodes, victims, preemptors


def test_preempt_baseline_world():
    """The preempt-baseline world through the shell: the burst fails, the
    pressure tail nominates and evicts, and the preemptors bind."""
    nodes, victims, preemptors = baseline_world(12, 16)
    obs.reset()
    outs = {}
    for kind in KINDS:
        sh = Shell(kind)
        for n in nodes:
            sh.create(JS.NODES, n)
        for v in victims:
            sh.create(JS.PODS, v)
        sh.start()
        for p in preemptors:
            sh.create(JS.PODS, p)
        sh.rounds(128, 20, idle_limit=3)
        outs[kind] = sh.outcome()
    assert_same(outs, "preempt-baseline")
    assert len(outs["port"]["evictions"]) == 16
    bound = dict(outs["port"]["bindings"])
    assert all(bound[f"default/hi-{k}"] for k in range(16))
    assert obs.get("dispatch.pressure_batch") > 0


# ---------------------------------------------------------------------------
# a gang drain window: fused segments and a rejected gang
# ---------------------------------------------------------------------------
def assert_no_partial_gang(store) -> None:
    by_group: dict = {}
    for p in store.list(JS.PODS)[0]:
        g = p.labels.get(JC.LABEL_POD_GROUP)
        if g:
            by_group.setdefault(g, []).append(bool(p.node_name))
    for g, flags in by_group.items():
        assert all(flags) or not any(flags), f"partially bound gang {g}"


def test_gang_drain_window():
    def member(name, group, cpu):
        return JT.Pod(name=name, labels={JC.LABEL_POD_GROUP: group},
                      containers=(JT.Container.make(
                          name="c", requests={"cpu": cpu}),))

    nodes = [JT.Node(name=f"n{i}",
                     labels={LABEL_HOSTNAME: f"n{i}", LABEL_ZONE: f"z{i % 2}"},
                     allocatable={"cpu": 2000, "memory": 32 * GI,
                                  "pods": 110})
             for i in range(5)]
    groups = [JC.PodGroup(name="ok", min_member=3),
              JC.PodGroup(name="big", min_member=6),
              JC.PodGroup(name="ok2", min_member=2)]
    pods = [member(f"ok-{r}", "ok", 300) for r in range(3)]
    # six members of a whole node each on five nodes: rejected whole
    pods += [member(f"big-{r}", "big", 2000) for r in range(6)]
    pods += [member(f"ok2-{r}", "ok2", 500) for r in range(2)]
    pods += [JT.Pod(name=f"s{j}", containers=(JT.Container.make(
        name="c", requests={"cpu": 200 + 100 * (j % 3)}),))
        for j in range(7)]
    obs.reset()
    outs = {}
    for kind in KINDS:
        sh = Shell(kind)
        for n in nodes:
            sh.create(JS.NODES, n)
        for g in groups:
            sh.create(JS.PODGROUPS, g)
        sh.start(wave_size=3, fused_run_split=3)
        for p in pods:
            sh.create(JS.PODS, p)
        sh.rounds(16, 12, idle_limit=3, check=assert_no_partial_gang)
        outs[kind] = sh.outcome()
    assert_same(outs, "gang drain window")
    bound = dict(outs["port"]["bindings"])
    assert all(bound[f"default/ok-{r}"] for r in range(3))
    assert not any(bound[f"default/big-{r}"] for r in range(6))
    assert obs.get("dispatch.burst_fused") > 0


# ---------------------------------------------------------------------------
# recover() after a crash between two commit windows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("crash_seed", [2, 5])
def test_recover_after_crash_between_windows(crash_seed):
    """The port's shell dies at the `sched.crash` seam inside a burst's
    commit (seed 2: after the in-flight window landed; seed 5: before),
    recovers from the store, and ends with the bindings of the JAX shells
    that never crashed."""
    rng = random.Random(7)
    nodes = []
    for i in range(6):
        nodes.append(JT.Node(
            name=f"n{i}", labels={LABEL_HOSTNAME: f"n{i}",
                                  LABEL_ZONE: f"z{i % 4}"},
            allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110}))
    pods = [JT.Pod(name=f"p{j}", containers=(JT.Container.make(
        name="c", requests={"cpu": rng.choice([100, 200, 400, 800])}),))
        for j in range(24)]
    outs = {}
    report = None
    for kind in KINDS:
        sh = Shell(kind)
        for n in nodes:
            sh.create(JS.NODES, n)
        sh.start(wave_size=4)
        for p in pods:
            sh.create(JS.PODS, p)
        sh.sched.pump()
        if kind == "port":
            pchaos.plan(seed=crash_seed, rates={"sched.crash": 0.3}, limit=1)
            crashed = 0
            try:
                while True:
                    try:
                        n = sh.sched.schedule_burst(max_pods=16)
                    except pchaos.SchedulerCrash:
                        crashed += 1
                        pchaos.disable()
                        report = sh.sched.recover()
                        continue
                    if n == 0:
                        break
                    sh.sched.pump()
            finally:
                pchaos.disable()
            assert crashed == 1, "the crash seam never fired"
        else:
            sh.drain(16)
        sh.sched.pump()
        outs[kind] = sh.outcome()
    assert report is not None and report["exact"], report
    assert report["window_landed"] is (crash_seed == 2)
    assert all(h for _k, h in outs["port"]["bindings"])
    assert_same(outs, f"recover, crash seed {crash_seed}")
