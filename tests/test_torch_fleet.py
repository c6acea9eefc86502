"""The port's active-active fleet (`kubernetes_tpu_torch.fleet`), its
leader election and the kernel build lock, against the JAX package's, on
the CPU.

- Partition math: `shard_of`, the lease names and `preferred_owner` equal
  JAX's over many namespaces, shard counts and live sets.
- `LeaderElector`: three candidates of each package on one FakeClock
  script (steps, clock steps, releases, store outages) give the same
  leadership and the same Lease records.
- The store's fencing through the port's store: a stale token rejects a
  wave or a bind whole, as JAX's twin store does on the same calls.
- The fleet differential of `tests/test_fleet.py`: `run_fleet_trial`'s
  trials (seeds 3 and 11, a kill, a kill then a restart, a zombie of the
  `fleet.lease-loss` seam, a crash of the `sched.crash` seam) on the
  port's FleetManager, with the port's FleetInstances over its oracle
  shell, as JAX's run over its own: the bind streams of every step equal
  JAX's for the same seed, with no double bind, claims disjoint at every
  probe, and every surviving instance replaying bit-identically through
  the port's `replay_instance`. One trial runs the instances on the
  device path (`use_device=True, device="cpu"`, the plain versions)
  against JAX's device shell, and one runs two instances on threads of
  their own over one store, as the fleet cell does on the card.
- `ops/_build.py`'s lock: two threads that load one (fake) library at
  once compile it once, into a temporary file of their own, and load it
  once; the flat counters lose no increment of twelve threads.
"""
import random
import threading
import time
import zlib

import pytest

from kubernetes_tpu import chaos as jchaos
from kubernetes_tpu import fleet as JF
from kubernetes_tpu.api import types as JT
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils import clock as JC
from kubernetes_tpu.utils import leader_election as JLE
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import chaos as pchaos
from kubernetes_tpu_torch import fleet as PF
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.utils import clock as PC
from kubernetes_tpu_torch.utils import leader_election as PLE

GI = 1024 ** 3
PROFILE = "default-scheduler"
PKG = {
    "port": {"F": PF, "S": PS, "C": PC, "LE": PLE, "chaos": pchaos},
    "jax": {"F": JF, "S": JS, "C": JC, "LE": JLE, "chaos": jchaos},
}


def mknode(i, cpu=4000):
    return JT.Node(name=f"n{i}",
                   labels={"kubernetes.io/hostname": f"n{i}",
                           "failure-domain.beta.kubernetes.io/zone":
                           f"z{i % 3}"},
                   allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def mkpod(name, ns="default", cpu=100, **kw):
    kw.setdefault("uid", f"{ns}/{name}/fixed")
    return JT.Pod(name=name, namespace=ns, containers=(
        JT.Container.make(name="c", requests={"cpu": cpu}),), **kw)


def as_kind(kind, obj):
    return to_port(obj) if kind == "port" else obj


# ---------------------------------------------------------------------------
# partition math and leader election
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 4, 8, 13])
def test_partition_math_equal(n_shards):
    rng = random.Random(n_shards)
    spaces = ["default", ""] + [f"ns-{i}" for i in range(200)] \
        + ["".join(rng.choice("abcxyz-0189") for _ in range(12))
           for _ in range(50)]
    assert [PF.shard_of(s, n_shards) for s in spaces] \
        == [JF.shard_of(s, n_shards) for s in spaces]
    for _ in range(40):
        live = rng.sample([f"i{k}" for k in range(8)], rng.randint(0, 5))
        for shard in range(n_shards):
            assert PF.preferred_owner(shard, live) \
                == JF.preferred_owner(shard, live)
    assert PF.shard_lease_name("p", 3) == JF.shard_lease_name("p", 3)
    assert PF.heartbeat_lease_name("p", "a") \
        == JF.heartbeat_lease_name("p", "a")
    assert PF.DEFAULT_SHARDS == JF.DEFAULT_SHARDS
    assert PF.shard_of("default", 8) == 7


class FlakyStore:
    """A store that fails every call while `down` is set."""

    def __init__(self, store):
        self.store = store
        self.down = False

    def __getattr__(self, name):
        attr = getattr(self.store, name)
        if not callable(attr):
            return attr

        def call(*a, **kw):
            if self.down:
                raise ConnectionError("store unreachable")
            return attr(*a, **kw)
        return call


def election_trace(kind, seed):
    P = PKG[kind]
    clock = P["C"].FakeClock(50.0)
    store = FlakyStore(P["S"].Store())
    events = []
    electors = [P["LE"].LeaderElector(store, P["LE"].LeaderElectionConfig(
        lock_name="lk", identity=f"c{i}", lease_duration=6.0,
        renew_deadline=4.0, retry_period=0.5,
        on_started_leading=lambda i=i: events.append(("start", i)),
        on_stopped_leading=lambda i=i: events.append(("stop", i))),
        clock=clock) for i in range(3)]
    rng = random.Random(seed)
    out = []
    for _ in range(80):
        r = rng.random()
        if r < 0.55:
            e = electors[rng.randrange(3)]
            out.append(("step", e.config.identity, e.step()))
        elif r < 0.8:
            clock.step(rng.choice([0.5, 1.0, 3.0, 7.0]))
        elif r < 0.9 and not store.down:
            e = electors[rng.randrange(3)]
            e.release()
            out.append(("release", e.config.identity, e.is_leader))
        else:
            store.down = not store.down
        lease = None
        if not store.down:
            try:
                got = store.get(P["S"].LEASES, "lk")
                lease = (got.holder, got.leader_transitions,
                         got.resource_version, got.acquire_time,
                         got.renew_time)
            except P["S"].NotFoundError:
                pass
        out.append((lease, tuple(e.is_leader for e in electors)))
    out.append(tuple(events))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_leader_election_equal(seed):
    port, jax = election_trace("port", seed), election_trace("jax", seed)
    assert port == jax
    assert any(any(v[1]) for v in port[:-1] if isinstance(v[1], tuple))
    with pytest.raises(ValueError):
        PLE.LeaderElector(PS.Store(), PLE.LeaderElectionConfig(
            lease_duration=4.0, renew_deadline=4.0))


# ---------------------------------------------------------------------------
# fencing in the port's store
# ---------------------------------------------------------------------------
def fencing_trace(kind):
    S = PKG[kind]["S"]
    store = S.Store()
    for j in range(3):
        store.create(S.PODS, as_kind(kind, mkpod(f"p{j}")))
    out = [store.advance_fence("fleet-x-s0", 50),
           store.advance_fence("fleet-x-s0", 49)]
    rv0 = store.resource_version()
    for fence in (("fleet-x-s0", 49), [("fleet-x-s0", 60),
                                       ("fleet-x-s1", 9)]):
        store.advance_fence("fleet-x-s1", 10)
        try:
            store.commit_wave([("default/p0", "n0"), ("default/p1", "n1")],
                              event_spec={"component": "f"}, fence=fence)
            out.append("landed")
        except S.FencedError:
            out.append("fenced")
        out.append(store.resource_version() - rv0)
    out.append(store.commit_wave([("default/p0", "n0")],
                                 event_spec={"component": "f"},
                                 fence=("fleet-x-s0", 50)))
    store.fanout_wave()
    try:
        store.bind_pod("default/p2", "n2", fence=("fleet-x-s1", 3))
    except S.FencedError:
        out.append("bind fenced")
    store.bind_pod("default/p2", "n2", fence=("fleet-x-s1", 11))
    try:
        store.bind_pod("default/p2", "n1")
    except S.ConflictError:
        out.append("cas conflict")
    out.append(sorted(store.fence_table().items()))
    out.append(sorted((p.key, p.node_name)
                      for p in store.list(S.PODS)[0]))
    out.append(store.resource_version())
    return out


def test_store_fencing_equal():
    port = fencing_trace("port")
    assert port == fencing_trace("jax")
    assert port[2:6] == ["fenced", 0, "fenced", 0]


# ---------------------------------------------------------------------------
# the fleet differential
# ---------------------------------------------------------------------------
def fleet_trial(kind, seed, n_instances=None, kill=False, zombie=False,
                restart=False, crash=False, device=False, rounds=None):
    """`tests/test_fleet.run_fleet_trial` in package `kind`: the same
    seeded world, arrivals, kills and seams; returns the manager, the
    store and the instance names after its liveness, double-bind and
    disjointness asserts."""
    P = PKG[kind]
    F, S, chaos = P["F"], P["S"], P["chaos"]
    rng = random.Random(seed)
    n_instances = n_instances or rng.randint(2, 4)
    n_nodes = rng.randint(6, 14)
    rounds = rounds or rng.randint(5, 8)
    per_round = [rng.randint(3, 8) for _ in range(rounds)]
    window = rng.choice([4, 8])
    clock = P["C"].FakeClock(100.0)
    store = S.Store(watch_log_size=1 << 17)
    for i in range(n_nodes):
        store.create(S.NODES, as_kind(kind, mknode(i)))
    idents = [f"i{k}" for k in range(n_instances)]

    def mk(ident):
        return F.FleetInstance(store, ident, idents, clock=clock,
                               window=window, depth=2,
                               percentage_of_nodes_to_score=100,
                               disable_preemption=True,
                               **device_kw(kind, device))
    if zombie:
        chaos.plan(seed=seed, rates={"fleet.lease-loss": 0.1}, limit=2)
    if crash:
        chaos.plan(seed=seed, rates={"sched.crash": 0.05},
                   limits={"sched.crash": 1})
    mgr = F.FleetManager(store, idents, mk, clock=clock, record=True)
    kill_round = rng.randrange(1, rounds) if kill else None
    restart_round = (kill_round + rng.randint(2, 4)
                     if kill and restart else None)
    victim = rng.choice(idents) if kill else None
    j = 0
    classes = ["plain", "plain", "selector", "tolerate", "prio"]
    try:
        for r in range(rounds):
            pods = []
            for _ in range(per_round[r]):
                cls = rng.choice(classes)
                kw = {"labels": {"app": cls}}
                if cls == "selector":
                    kw["node_selector"] = {"kubernetes.io/hostname":
                                           f"n{rng.randrange(n_nodes)}"}
                elif cls == "tolerate":
                    kw["tolerations"] = (JT.Toleration(key="k",
                                                       op="Exists"),)
                elif cls == "prio":
                    kw["priority"] = rng.randint(1, 3)
                pods.append(as_kind(kind, mkpod(
                    f"p{j}", ns=f"ns-{j % (3 * n_instances)}",
                    cpu=rng.choice([100, 300]),
                    creation_timestamp=clock.now(), **kw)))
                j += 1
            mgr.create_pods(pods)
            if kill_round is not None and r == kill_round:
                mgr.kill(victim)
            if restart_round is not None and r == restart_round:
                mgr.restart(victim)
            mgr.step_all()
            assert mgr.owned_disjoint()
            mgr.advance_clock(rng.choice([1.0, 1.5, 2.0]))
        for _ in range(24):
            mgr.step_all()
            mgr.advance_clock(1.5)
            if all(p.node_name for p in store.list(S.PODS)[0]):
                break
    finally:
        chaos.disable()
    mgr.auditor.scan()
    unbound = [p.key for p in store.list(S.PODS)[0] if not p.node_name]
    assert not unbound, f"{kind} seed={seed}: never bound: {unbound[:5]}"
    assert not mgr.auditor.violations, mgr.auditor.violations
    assert mgr.owned_disjoint()
    return mgr, store, idents


def device_kw(kind, device):
    if kind == "port":
        return {"use_device": True, "device": "cpu"} if device \
            else {"use_device": False}
    return {"use_tpu": bool(device)}


def stream(mgr) -> list:
    """Every step's instance, claims, fence table and binds, in order."""
    return [(e["inst"], sorted(e["claims"].items()),
             sorted(e["fences"].items()), e["binds"], e.get("crashed"))
            for e in mgr.timeline if e["op"] == "step"]


def replay_survivors(kind, mgr, idents, device=False):
    F = PKG[kind]["F"]
    crashed = set(mgr.crashes)
    compared = 0
    for ident in idents:
        if ident in crashed:
            continue

        def mk_solo(st, ck, _ident=ident):
            return F.FleetInstance(
                st, _ident, idents, clock=ck,
                window=mgr.instances[_ident].loop.window_size, depth=2,
                percentage_of_nodes_to_score=100, disable_preemption=True,
                claims=F.ScriptedClaims(PROFILE, F.DEFAULT_SHARDS),
                **device_kw(kind, device))
        rep = F.replay_instance(mgr.timeline, ident, mk_solo)
        assert not rep["mismatches"], (ident, rep["mismatches"][:2])
        assert not rep["replay_double_binds"]
        assert rep["compared"] > 0
        compared += rep["compared"]
    return compared


TRIALS = {
    "seed3": dict(seed=3),
    "seed11": dict(seed=11),
    "kill": dict(seed=19, n_instances=3, kill=True),
    "kill-restart": dict(seed=23, n_instances=3, kill=True, restart=True),
    "zombie": dict(seed=7, n_instances=2, zombie=True, rounds=8),
    "crash": dict(seed=31, n_instances=3, crash=True),
    "device": dict(seed=5, n_instances=2, device=True, rounds=4),
}


@pytest.mark.parametrize("trial", list(TRIALS))
def test_fleet_trial_equal_and_replays(trial):
    kw = TRIALS[trial]
    mgr, store, idents = fleet_trial("port", **kw)
    jmgr, _jstore, _ = fleet_trial("jax", **kw)
    assert stream(mgr) == stream(jmgr)
    assert mgr.crashes == jmgr.crashes
    assert sorted((p.key, p.node_name) for p in store.list(PS.PODS)[0]) \
        == sorted((p.key, p.node_name)
                  for p in _jstore.list(JS.PODS)[0])
    assert replay_survivors("port", mgr, idents,
                            device=kw.get("device", False)) > 0
    if trial == "kill":
        assert sum(getattr(i.claims, "failovers", 0)
                   for i in mgr.live_instances()) >= 1
    if trial == "crash":
        assert mgr.crashes
    if trial == "zombie":
        assert sum(i.sched.fenced_waves for i in mgr.instances.values()) \
            == sum(i.sched.fenced_waves for i in jmgr.instances.values())
    if trial == "device":
        algo = mgr.instances[idents[0]].sched.algorithm
        assert type(algo).__name__ == "TorchScheduler"
        assert algo.device.type == "cpu"


def test_fleet_instance_defaults_to_the_device():
    import inspect
    sig = inspect.signature(PF.FleetInstance.__init__).parameters
    assert sig["use_device"].default is True
    assert sig["device"].default is None
    assert "use_tpu" not in sig
    inst = PF.FleetInstance(PS.Store(), "a", ["a"], profile="tenant-x",
                            device="cpu", clock=PC.FakeClock(10.0),
                            claims=PF.ScriptedClaims("tenant-x", 4))
    assert inst.sched.algorithm.device.type == "cpu"
    inst.apply_claims({PF.shard_of("default", 4): 1})
    assert inst.sched._responsible_for(
        to_port(mkpod("m", scheduler_name="tenant-x")))
    assert not inst.sched._responsible_for(
        to_port(mkpod("o", scheduler_name="tenant-y")))
    inst.apply_claims({})
    assert not inst.sched._responsible_for(
        to_port(mkpod("m", scheduler_name="tenant-x")))


def test_threaded_fleet_cell_small():
    """The fleet cell's shape at a small size: two instances on threads
    of their own over one store (the device path on the CPU), one fleet
    gate, namespace-spread arrivals; no double bind, every admitted
    arrival bound, claims disjoint at every probe."""
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.serve import ArrivalGenerator, fleet_gate
    store = PS.Store(watch_log_size=1 << 16)
    for i in range(12):
        store.create(PS.NODES, to_port(mknode(i)))
    idents = ["sched-0", "sched-1"]
    fleet = [PF.FleetInstance(store, ident, idents, device="cpu",
                              window=32, depth=3, n_shards=8,
                              lease_duration=5.0, renew_deadline=3.0,
                              percentage_of_nodes_to_score=100)
             for ident in idents]
    for inst in fleet:
        inst.sync()
    for _ in range(3):
        for inst in fleet:
            inst.step()

    def mk(name):
        ns = f"ns-{zlib.crc32(name.encode()) % 32}"
        return Pod(name=name, namespace=ns, labels={"app": "fleet"},
                   containers=(Container.make(
                       name="c", requests={"cpu": 100}),))

    auditor = PF.BindAuditor(store)
    store.admission_gate = fleet_gate([inst.loop for inst in fleet],
                                      max_depth=64)
    gen = ArrivalGenerator(store, rate=2000.0, total=240, pod_fn=mk,
                           name_prefix="fl-", seed=0)
    stop = threading.Event()
    errors = []

    def drive(inst):
        try:
            while not stop.is_set():
                if inst.step() == 0:
                    time.sleep(0.001)
        except BaseException as e:   # surfaced below: the test fails
            errors.append(e)
            raise

    threads = [threading.Thread(target=drive, args=(inst,), daemon=True)
               for inst in fleet]
    for th in threads:
        th.start()
    overlap = False
    deadline = time.perf_counter() + 60.0
    try:
        while time.perf_counter() < deadline:
            gen.tick()
            gen.flush_retries(timeout=0.01)
            auditor.scan()
            seen: set = set()
            for inst in fleet:
                owned = inst.claims.owned()
                overlap |= bool(owned & seen)
                seen |= owned
            pods = [p for p in store.list(PS.PODS)[0]
                    if p.name.startswith("fl-")]
            if gen.finished() and pods and all(p.node_name for p in pods):
                break
            time.sleep(0.005)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
    auditor.scan()
    auditor.stop()
    assert not errors, errors
    g = gen.stats()
    pods = [p for p in store.list(PS.PODS)[0] if p.name.startswith("fl-")]
    assert len(pods) == g["created"] and all(p.node_name for p in pods)
    assert g["attempted"] == g["created"] + g["gave_up"] \
        + g["pending_retry"]
    assert not auditor.violations and not overlap
    assert all(inst.loop.pods_bound > 0 for inst in fleet)


def test_counts_hold_under_threads():
    """The flat counters are shared by a fleet's threads: with the
    interpreter switching threads every microsecond, no increment of
    twelve threads is lost."""
    import sys
    from kubernetes_tpu_torch import obs
    obs.reset("stress.")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(4000):
                obs.inc("stress.n")
                obs.inc("stress.m", 2)

        ths = [threading.Thread(target=bump) for _ in range(12)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60.0)
    finally:
        sys.setswitchinterval(before)
    assert not any(th.is_alive() for th in ths)
    assert obs.family("stress") == {"n": 48000, "m": 96000}
    obs.reset("stress.")


# ---------------------------------------------------------------------------
# the kernel build lock
# ---------------------------------------------------------------------------
def test_build_lock_two_threads_load_once(monkeypatch, tmp_path):
    """Two threads reach a kernel's first use together: one compile, each
    into a temporary file named for its process and thread, one load."""
    built, tmps, loaded = [], [], []
    lock_probe = threading.Barrier(2)

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_kw):
            self.out = cmd[cmd.index("-o") + 1]
            tmps.append((self.out, threading.get_ident()))

        def communicate(self):
            time.sleep(0.05)      # a compile that takes a while
            with open(self.out, "wb") as f:
                f.write(b"lib")
            built.append(self.out)
            return "", None

        def poll(self):
            return 0

    class FakeLib:
        def __init__(self, path):
            time.sleep(0.02)
            loaded.append(path)
            self.fake_launch = lambda *a: 0
            self.fake_clusters = lambda *a: 0

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_digest", lambda name: "0123")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setitem(_build.SIGNATURES, "fake", [])
    monkeypatch.setitem(_build.QUERIES, "fake",
                        {"fake_clusters": []})
    monkeypatch.setattr(_build, "_LIBS", {})
    got = []

    def first_use():
        lock_probe.wait()
        got.append(_build.load("fake"))

    ths = [threading.Thread(target=first_use) for _ in range(2)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=10.0)
    assert len(got) == 2 and got[0] is got[1]
    assert len(built) == 1 and len(loaded) == 1
    (tmp, ident), = tmps
    assert f".{ident}.tmp.so" in tmp
    assert (tmp_path / "fake-0123.so").exists()
    # a second round finds the library built and loaded
    assert _build.load("fake") is got[0]
    assert len(built) == 1 and len(loaded) == 1
