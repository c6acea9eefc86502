"""The port's serving path (`kubernetes_tpu_torch.serve`) against the JAX
package's, on the CPU.

- `BackpressureGate` and `fleet_gate`: the same depth and in-flight
  sequences, and the same `serve.shed` schedule, give the same admits,
  sheds, Retry-After values and shed counts by reason as JAX's gates.
- `ArrivalGenerator`: with the same seed, fed the same accept / shed
  answers by a scripted store, the port's generator makes the same
  creates in the same batches and keeps the same accounts.
- `ServeLoop` over the port's `Scheduler(use_device=True, device="cpu")`
  against JAX's `ServeLoop` over `Scheduler(use_tpu=True)` on the worlds
  of `tests/test_serve.py`'s TestServeWindowParity, at window / depth
  (64, 1) and (32, 3) with `launch_cap` 16, and on the same worlds with
  the serve cell's identical pods in place of the mixed ones, whose
  uniform bursts go out in 16-pod chunks, up to `depth` in flight:
  the binding maps, `windows_cut`, `idle_ticks` and the sequence of
  values `inflight_launches` takes must be equal. Variants: a node that
  dies between a launch and its fetch (the `node.dead` seam at the
  `dispatch-fetch` point, in both worlds), deterministic `serve.shed`
  sheds in both worlds, and DeviceFaults injected in the port's world
  only, which must give the decisions of the undisturbed worlds.
"""
import dataclasses
import random

import pytest

import tests.test_serve as TS
from kubernetes_tpu import chaos as jchaos
from kubernetes_tpu.api import types as JT
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.serve import arrivals as JA
from kubernetes_tpu.serve import backpressure as JB
from kubernetes_tpu.serve.loop import ServeLoop as JServeLoop
from kubernetes_tpu.store import store as JS
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import chaos as pchaos
from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.serve import arrivals as PA
from kubernetes_tpu_torch.serve import backpressure as PB
from kubernetes_tpu_torch.serve.loop import ServeLoop as PServeLoop
from kubernetes_tpu_torch.store import store as PS

GI = 1024 ** 3
PKG = {
    "port": {"B": PB, "A": PA, "S": PS, "chaos": pchaos},
    "jax": {"B": JB, "A": JA, "S": JS, "chaos": jchaos},
}


def gate_pod(kind, name):
    p = JT.Pod(name=name, containers=(JT.Container.make(
        name="c", requests={"cpu": 100}),))
    return to_port(p) if kind == "port" else p


# ---------------------------------------------------------------------------
# the admission gate
# ---------------------------------------------------------------------------
def gate_trace(kind: str, seed: int, shed_rate: float) -> list:
    """Admits and batched admits against a scripted depth / in-flight
    sequence; every answer as (admitted, retry_after)."""
    B, S, chaos = PKG[kind]["B"], PKG[kind]["S"], PKG[kind]["chaos"]
    rng = random.Random(seed)
    state = {"depth": 0, "inflight": 0}
    gate = B.BackpressureGate(lambda: state["depth"], max_depth=12,
                              inflight_fn=lambda: state["inflight"],
                              max_inflight=3, retry_after_base=0.05,
                              retry_after_max=0.4)
    reasons = ("queue-depth", "inflight-windows", "injected")
    before = [B.ADMISSION_REJECTED.labels(r).value for r in reasons]
    if shed_rate:
        chaos.plan(seed=seed, rates={"serve.shed": shed_rate})
    out = []
    try:
        for step in range(60):
            state["depth"] = rng.choice([0, 3, 11, 12, 30, 70])
            state["inflight"] = rng.choice([0, 1, 2, 3, 5])
            if rng.random() < 0.5:
                try:
                    gate.admit(gate_pod(kind, f"a{step}"))
                    out.append(("admit", True, None))
                except S.BackpressureError as e:
                    out.append(("admit", False, e.retry_after))
            else:
                pods = [gate_pod(kind, f"b{step}-{i}")
                        for i in range(rng.randint(1, 9))]
                out.append(("many",) + tuple(gate.admit_many(pods)))
    finally:
        chaos.disable()
    out.append(("counts", gate.admitted, gate.rejected,
                tuple(B.ADMISSION_REJECTED.labels(r).value - b
                      for r, b in zip(reasons, before))))
    out.append(("debug", sorted(gate.debug_state().items())))
    return out


@pytest.mark.parametrize("shed_rate", [0.0, 0.3])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_gate_equal(seed, shed_rate):
    port, jax = gate_trace("port", seed, shed_rate), \
        gate_trace("jax", seed, shed_rate)
    assert port == jax
    assert any(not a[1] for a in port if a[0] == "admit")
    if shed_rate:
        assert port[-2][3][2] > 0     # the seam shed something


class FakeInformer:
    def __init__(self, backlog):
        self.n = backlog

    def backlog(self):
        return self.n


class FakeLoop:
    """What `fleet_gate` reads of a serve loop."""

    def __init__(self, depth, active, backlog, inflight):
        queue = type("Q", (), {"active_depth": lambda _s: active})()
        informers = type("I", (), {
            "informer": lambda _s, _kind: FakeInformer(backlog)})()
        self.sched = type("S", (), {"queue": queue,
                                    "informers": informers})()
        self.depth = depth
        self._inflight = inflight

    def inflight_windows(self):
        return self._inflight


@pytest.mark.parametrize("seed", [4, 5])
def test_fleet_gate_equal(seed):
    rng = random.Random(seed)
    worlds = []
    for _ in range(24):
        worlds.append([(rng.randint(1, 3), rng.randint(0, 40),
                        rng.randint(0, 20), rng.randint(0, 6))
                       for _ in range(rng.randint(1, 4))])
    outs = {}
    for kind in PKG:
        B, S = PKG[kind]["B"], PKG[kind]["S"]
        got = []
        for w, loops in enumerate(worlds):
            gate = B.fleet_gate([FakeLoop(*lp) for lp in loops],
                                max_depth=25, retry_after_base=0.1)
            try:
                gate.admit(gate_pod(kind, f"f{w}"))
                got.append((True, None))
            except S.BackpressureError as e:
                got.append((False, e.retry_after))
            got.append(gate.admit_many([gate_pod(kind, f"g{w}-{i}")
                                        for i in range(8)]))
            got.append((gate.max_inflight, gate.depth_fn(),
                        gate.inflight_fn()))
        outs[kind] = got
    assert outs["port"] == outs["jax"]
    assert any(a[0] is False for a in outs["port"][0::3])


# ---------------------------------------------------------------------------
# the arrival generator
# ---------------------------------------------------------------------------
class ScriptedStore:
    """A store that answers creates from a seeded script: a batch lands
    whole, or its prefix lands and the tail is shed with Retry-After; a
    single create lands or is shed. Every call is logged."""

    def __init__(self, kind, seed):
        self.S = PKG[kind]["S"]
        self.rng = random.Random(seed)
        self.log = []
        self.names = set()

    def _answer(self, n):
        r = self.rng.random()
        if r < 0.5:
            return n, None
        return self.rng.randint(0, n - 1), self.rng.choice([0.01, 0.05,
                                                             0.2])

    def create(self, kind, pod):
        self.log.append(("create", pod.name))
        if pod.name in self.names:
            raise self.S.AlreadyExistsError(pod.name)
        k, ra = self._answer(1)
        if ra is not None:
            raise self.S.BackpressureError("shed", retry_after=ra)
        self.names.add(pod.name)

    def create_many(self, kind, pods):
        self.log.append(("many", [p.name for p in pods]))
        k, ra = self._answer(len(pods))
        self.names.update(p.name for p in pods[:k])
        if ra is not None:
            raise self.S.BackpressureError("shed", retry_after=ra,
                                           accepted=k)


def arrival_trace(kind, seed, total):
    A = PKG[kind]["A"]
    store = ScriptedStore(kind, seed)
    gen = A.ArrivalGenerator(store, rate=900.0, total=total, seed=seed,
                             give_up_after=4)
    now = 0.0
    while not gen.finished() and now < 5.0:
        gen.tick(now)
        now += 0.013
    return store.log, gen.stats(), gen.finished()


@pytest.mark.parametrize("seed,total", [(1, 60), (6, 200), (9, None)])
def test_arrivals_equal(seed, total):
    port, jax = arrival_trace("port", seed, total), \
        arrival_trace("jax", seed, total)
    assert port == jax
    log, stats, _done = port
    assert stats["rejected_429"] > 0
    assert any(verb == "many" for verb, _n in log)
    pod, ref = PA.default_pod("x"), JA.default_pod("x")
    assert pod.labels == ref.labels == {"app": "serve"}
    assert pod.containers[0].requests == ref.containers[0].requests


# ---------------------------------------------------------------------------
# the serve loop over the shell, against JAX's
# ---------------------------------------------------------------------------
def trace_inflight(algo) -> list:
    """Every value the launch driver gives `inflight_launches`, in order."""
    seq: list = []
    base = type(algo)

    class Traced(base):
        @property
        def inflight_launches(self):
            return self.__dict__.get("_inflight_traced", 0)

        @inflight_launches.setter
        def inflight_launches(self, v):
            seq.append(int(v))
            self.__dict__["_inflight_traced"] = v

    algo.__class__ = Traced
    return seq


def serve_world(kind, seed, window, depth, death=False, shed_rate=0.0,
                faults=None, uniform=False):
    """TestServeWindowParity's world for `seed`, served at `window` /
    `depth` with `launch_cap` 16; returns what must be equal. `uniform`:
    each round's arrivals are four times as many identical serve pods
    (the serve cell's), on the world's nodes without their taints, so
    every window is one uniform burst."""
    port = kind == "port"
    S, chaos = PKG[kind]["S"], PKG[kind]["chaos"]
    rng = random.Random(seed)
    n_nodes = rng.randint(8, 24)
    zones = rng.choice([1, 2, 3])
    rounds = rng.randint(4, 7)
    per_round = [rng.randint(3, 12) for _ in range(rounds)]
    rng.choice([4, 8])
    rng.choice([2, 3])
    kill_round = rng.randrange(1, rounds) if death else None
    store = S.Store(watch_log_size=1 << 16)
    nodes = TS.TestServeWindowParity._build_nodes(None, rng, n_nodes, zones)
    if uniform:
        # the serve cell's nodes carry no taint (a tainted node gives the
        # pods a taint score the uniform kernel does not model)
        nodes = [dataclasses.replace(n, taints=()) for n in nodes]
    for node in nodes:
        store.create(S.NODES, to_port(node) if port else node.clone())
    if port:
        sched = PScheduler(store, use_device=True, device="cpu",
                           percentage_of_nodes_to_score=100)
        loop = PServeLoop(sched, window_size=window, depth=depth)
    else:
        sched = JScheduler(store, use_tpu=True,
                           percentage_of_nodes_to_score=100)
        loop = JServeLoop(sched, window_size=window, depth=depth)
    sched.sync()
    sched.algorithm.launch_cap = 16
    seq = trace_inflight(sched.algorithm)
    pending = []
    if death:
        def hook(point):
            if point == "dispatch-fetch" and pending:
                try:
                    store.delete(S.NODES, pending.pop())
                except S.NotFoundError:
                    pass
        chaos.plan(seed=seed, rates={"node.dead": 1.0})
        chaos.set_node_hook(hook)
    gate = None
    if shed_rate:
        gate = loop.attach_gate(max_depth=1 << 30)
        chaos.plan(seed=seed, rates={"serve.shed": shed_rate})
    if faults:
        chaos.plan(seed=seed, rates=faults)
    try:
        j = u = 0
        carry = []
        def admit(pods):
            for pod in pods:
                try:
                    store.create(S.PODS, to_port(pod) if port
                                 else pod.clone())
                except S.BackpressureError:
                    carry.append(pod)

        for r in range(rounds):
            arrivals, carry = carry, []
            carry_u = [p for p in arrivals if p.name.startswith("u")]
            for _ in range(per_round[r]):
                arrivals.append(TS.TestServeWindowParity._mixed_pod(
                    None, rng, j))
                j += 1
            if uniform:
                # the serve cell's arrivals instead: identical pods, one
                # uniform burst a window, in chunks of `launch_cap`
                fresh = 4 * per_round[r]
                arrivals = carry_u + [JA.default_pod(f"u{u + k}")
                                      for k in range(fresh)]
                u += fresh
            admit(arrivals)
            if kill_round is not None and r == kill_round:
                pending.append(rng.choice(sorted(
                    n.name for n in store.list(S.NODES)[0])))
            loop.step()
            if pending:
                store.delete(S.NODES, pending.pop())
        for pod in carry:
            try:
                store.create(S.PODS, to_port(pod) if port else pod.clone())
            except S.BackpressureError:
                pass
        while loop.step() > 0:
            pass
        sched.pump()
    finally:
        chaos.disable()
        chaos.set_node_hook(None)
    return {
        "bindings": {p.key: p.node_name for p in store.list(S.PODS)[0]},
        "windows_cut": loop.windows_cut,
        "idle_ticks": loop.idle_ticks,
        "pods_bound": loop.pods_bound,
        "inflight": seq,
        "sheds": None if gate is None else gate.rejected,
        "nodes": len(store.list(S.NODES)[0]),
    }


def assert_serve_equal(port, jax, what):
    diff = {k: (port["bindings"].get(k), jax["bindings"].get(k))
            for k in set(port["bindings"]) | set(jax["bindings"])
            if port["bindings"].get(k) != jax["bindings"].get(k)}
    assert not diff, f"{what}: {len(diff)} differ: {sorted(diff.items())[:6]}"
    for key in ("windows_cut", "idle_ticks", "pods_bound", "inflight",
                "sheds", "nodes"):
        assert port[key] == jax[key], (what, key, port[key], jax[key])


@pytest.mark.parametrize("window,depth", [(64, 1), (32, 3)])
@pytest.mark.parametrize("seed", [7, 19, 43])
def test_serve_stream_equal(seed, window, depth):
    obs.reset()
    port = serve_world("port", seed, window, depth)
    jax = serve_world("jax", seed, window, depth)
    assert_serve_equal(port, jax, f"seed {seed} at {window}/{depth}")
    assert any(h for h in port["bindings"].values())
    assert obs.get("dispatch.burst_scan") > 0


@pytest.mark.parametrize("window,depth", [(64, 1), (32, 3)])
@pytest.mark.parametrize("seed", [7, 19])
def test_serve_uniform_stream_equal(seed, window, depth):
    """The serve cell's arrivals: every window one uniform burst in
    16-pod chunks, up to `depth` of them in flight."""
    obs.reset()
    port = serve_world("port", seed, window, depth, uniform=True)
    jax = serve_world("jax", seed, window, depth, uniform=True)
    assert_serve_equal(port, jax, f"uniform seed {seed} at {window}/{depth}")
    assert obs.get("dispatch.burst_uniform") >= port["windows_cut"]
    assert max(port["inflight"]) == depth
    if depth > 1:
        assert obs.get("dispatch.burst_uniform") > port["windows_cut"]
    assert port["inflight"][-1] == 0


def test_serve_mid_window_node_death():
    """A node dies between a launch and its fetch in both worlds: the
    launch refuses whole and replans against the world without it."""
    obs.reset()
    port = serve_world("port", 19, 32, 3, death=True, uniform=True)
    jax = serve_world("jax", 19, 32, 3, death=True, uniform=True)
    assert_serve_equal(port, jax, "seed 19 with a node death")
    assert port["nodes"] == serve_world("port", 19, 32, 3)["nodes"] - 1
    mixed = [serve_world(k, 43, 32, 3, death=True) for k in PKG]
    assert_serve_equal(*mixed, "seed 43 with a node death")


def test_serve_deterministic_sheds():
    port = serve_world("port", 7, 32, 3, shed_rate=0.3)
    jax = serve_world("jax", 7, 32, 3, shed_rate=0.3)
    assert_serve_equal(port, jax, "seed 7 with sheds")
    assert port["sheds"] > 0


def test_serve_device_faults_keep_decisions():
    """DeviceFaults at the launch and fetch seams of the port's world
    cost launches, never a decision: the bindings equal the undisturbed
    JAX world's."""
    obs.reset()
    for uniform in (False, True):
        port = serve_world("port", 43, 32, 3, uniform=uniform,
                           faults={"device.dispatch": 0.2,
                                   "device.fetch": 0.2})
        jax = serve_world("jax", 43, 32, 3, uniform=uniform)
        assert port["bindings"] == jax["bindings"], uniform
    assert obs.get("twin.device-fault") > 0
