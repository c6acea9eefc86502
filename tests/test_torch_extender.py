"""The port's extender passes against the JAX package's, on the CPU.

`kubernetes_tpu_torch.core.extender` (SchedulerExtender, both transports),
the generic scheduler's filter and prioritize passes, the preempt verb and
the shell's route, held against `kubernetes_tpu`:
- `tests/test_aux.py`'s TestExtender cases and its managed-resources
  binder case on the port, each decision case over callable endpoints and
  over a local HTTP endpoint (the urllib transport);
- the same worlds, built from numpy seeds, through both packages' shells
  with a filter, a prioritize with weight 3 and ties, an ignorable
  failure, and a preempt verb that trims victims: bindings, nominations
  and evictions equal, each once with callable endpoints and once over
  HTTP;
- the route: a decision extender sends `Scheduler(use_device=True)` to
  the generic scheduler with the reference's warning, as JAX's
  `Scheduler(use_tpu=True)`; a bind-only extender keeps the device (the
  plain versions on the CPU) and binds the pods it manages, with the same
  calls and bindings as JAX's TPUScheduler shell.
Every HTTP endpoint listens on 127.0.0.1 port 0 and is stopped by its
fixture; every urllib call of the transport carries its 5 s timeout.
"""
import dataclasses
import json
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from kubernetes_tpu.api import types as JT
from kubernetes_tpu.apis import policy as jpolicy
from kubernetes_tpu.core import extender as jext
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.oracle.generic_scheduler import (
    GenericScheduler as JGeneric)
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch.api.types import Container, Node, Pod
from kubernetes_tpu_torch.apis.policy import ExtenderConfig
from kubernetes_tpu_torch.core import extender as pext
from kubernetes_tpu_torch.core.extender import (
    ExtenderError, SchedulerExtender)
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    GenericScheduler as PGeneric)
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.store.store import NODES, PODS, Store
from kubernetes_tpu_torch.utils.clock import FakeClock

GI = 1024 ** 3
GPU = "example.com/gpu"
ROUTE_WARNING = "extenders configured"


class Endpoint:
    """A local HTTP extender: POST /<verb> answers verbs[verb](payload)
    as JSON; an endpoint that raises answers 500."""

    def __init__(self, verbs):
        self.verbs = verbs
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(n) or b"{}")
                try:
                    body = json.dumps(outer.verbs[
                        self.path.rsplit("/", 1)[-1]](payload)).encode()
                    code = 200
                except Exception as e:   # noqa: BLE001 — a broken extender
                    body, code = str(e).encode(), 500
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture()
def endpoints():
    """Starts Endpoints on demand; stops every one after the test."""
    made = []

    def start(verbs):
        ep = Endpoint(verbs)
        made.append(ep)
        return ep
    yield start
    for ep in made:
        ep.stop()


def make_extender(pkg, endpoints, transport, verbs, **cfg):
    """`pkg`'s SchedulerExtender with `cfg`, its verbs answered in-process
    (callable endpoints) or by a local HTTP endpoint."""
    mod = pext if pkg == "port" else jext
    conf = (ExtenderConfig if pkg == "port" else jpolicy.ExtenderConfig)
    if transport == "callable":
        return mod.SchedulerExtender(conf(url_prefix="inproc://e", **cfg),
                                     endpoints=dict(verbs))
    return mod.SchedulerExtender(conf(url_prefix=endpoints(verbs).url,
                                      **cfg))


def mknode(name, cpu=4000, extra=None):
    return Node(name=name, allocatable={"cpu": cpu, "memory": 32 * GI,
                                        "pods": 110, **(extra or {})})


def mkpod(name, cpu=100):
    return Pod(name=name, containers=(
        Container.make(name="c", requests={"cpu": cpu}),))


# -- tests/test_aux.py TestExtender on the port --------------------------------
def cluster(extender):
    store = Store()
    for i in range(4):
        store.create(NODES, mknode(f"n{i}"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sched = Scheduler(store, percentage_of_nodes_to_score=100,
                          extenders=[extender], clock=FakeClock(),
                          device="cpu")
    sched.sync()
    return store, sched


def schedule(store, sched, name="p1"):
    store.create(PODS, mkpod(name))
    sched.pump()
    sched.schedule_one(timeout=0.0)
    sched.pump()
    return store.get(PODS, f"default/{name}").node_name


@pytest.mark.parametrize("transport", ["callable", "http"])
def test_filter_restricts_nodes(transport, endpoints):
    calls = []

    def filter_ep(payload):
        calls.append(payload)
        keep = [n for n in payload["nodes"] if n in ("n1", "n2")]
        return {"nodeNames": keep,
                "failedNodes": {n: "ExtenderVetoed" for n in payload["nodes"]
                                if n not in keep}}
    ext = make_extender("port", endpoints, transport, {"filter": filter_ep},
                        filter_verb="filter")
    store, sched = cluster(ext)
    assert schedule(store, sched) in ("n1", "n2")
    assert calls and set(calls[0]["nodes"]) == {"n0", "n1", "n2", "n3"}


@pytest.mark.parametrize("transport", ["callable", "http"])
def test_prioritize_steers_choice(transport, endpoints):
    def prio_ep(payload):
        return {"hostPriorityList": [
            {"host": n, "score": 10 if n == "n3" else 0}
            for n in payload["nodes"]]}
    ext = make_extender("port", endpoints, transport,
                        {"prioritize": prio_ep},
                        prioritize_verb="prioritize", weight=100)
    store, sched = cluster(ext)
    assert schedule(store, sched) == "n3"


@pytest.mark.parametrize("transport", ["callable", "http"])
def test_ignorable_extender_failure_is_tolerated(transport, endpoints):
    def broken(payload):
        raise RuntimeError("down")
    ext = make_extender("port", endpoints, transport, {"filter": broken},
                        filter_verb="filter", ignorable=True)
    store, sched = cluster(ext)
    assert schedule(store, sched)


@pytest.mark.parametrize("transport", ["callable", "http"])
def test_non_ignorable_failure_raises(transport, endpoints):
    def broken(payload):
        raise RuntimeError("down")
    ext = make_extender("port", endpoints, transport, {"filter": broken},
                        filter_verb="filter")
    with pytest.raises(ExtenderError):
        ext.filter(mkpod("p"), [mknode("n0")])


def test_unreachable_extender_raises_within_its_timeout():
    """The urllib transport against a port nothing listens on: an
    ExtenderError, not a hang."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ext = SchedulerExtender(ExtenderConfig(
        url_prefix=f"http://127.0.0.1:{port}", filter_verb="filter"))
    with pytest.raises(ExtenderError):
        ext.filter(mkpod("p"), [mknode("n0")])


def test_binder_extender_owns_the_write():
    bound = []
    store = Store()

    def bind_ep(payload):
        bound.append((payload["pod"], payload["node"]))
        store.bind_pod(payload["pod"], payload["node"])
        return {}
    ext = SchedulerExtender(
        ExtenderConfig(url_prefix="inproc://b", bind_verb="bind"),
        endpoints={"bind": bind_ep})
    store.create(NODES, mknode("n0"))
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      extenders=[ext], clock=FakeClock(), device="cpu")
    assert isinstance(sched.algorithm, TorchScheduler)
    sched.sync()
    assert schedule(store, sched) == "n0"
    assert bound == [("default/p1", "n0")]


def test_managed_resources_gate_binder():
    """A binder extender with managed_resources only binds pods that
    request one of them."""
    bound = []
    store = Store()

    def bind_ep(payload):
        bound.append(payload["pod"])
        store.bind_pod(payload["pod"], payload["node"])
        return {}
    ext = SchedulerExtender(
        ExtenderConfig(url_prefix="inproc://b", bind_verb="bind",
                       managed_resources=(GPU,)),
        endpoints={"bind": bind_ep})
    store.create(NODES, mknode("n0", extra={GPU: 4}))
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      extenders=[ext], clock=FakeClock(), device="cpu")
    sched.sync()
    store.create(PODS, mkpod("plain"))
    store.create(PODS, Pod(name="gpu", containers=(
        Container.make(name="c", requests={"cpu": 100, GPU: 1}),)))
    sched.pump()
    while sched.schedule_one(timeout=0.0):
        pass
    sched.pump()
    assert store.get(PODS, "default/plain").node_name == "n0"
    assert store.get(PODS, "default/gpu").node_name == "n0"
    assert bound == ["default/gpu"]


def test_is_interested_and_flags_equal_the_reference():
    for cfg in ({}, {"managed_resources": (GPU,)},
                {"bind_verb": "bind", "ignorable": True, "weight": 7}):
        p = SchedulerExtender(ExtenderConfig(url_prefix="u", **cfg))
        j = jext.SchedulerExtender(jpolicy.ExtenderConfig(url_prefix="u",
                                                          **cfg))
        for pod in (mkpod("a"), Pod(name="g", containers=(
                Container.make(name="c", requests={GPU: 1}),)),
                Pod(name="i", init_containers=(
                    Container.make(name="c", requests={GPU: 2}),))):
            assert p.is_interested(pod) == j.is_interested(
                to_jax(pod))
        assert (p.is_binder, p.is_ignorable, p.weight) == \
            (j.is_binder, j.is_ignorable, j.weight)


def to_jax(obj):
    """A port api object rebuilt as the JAX package's class of the same
    name (the inverse of tests/test_torch_encoders.to_port)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(JT, type(obj).__name__)
        fields = dataclasses.fields(obj)
        new = cls(**{f.name: to_jax(getattr(obj, f.name))
                     for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(new, f.name, to_jax(getattr(obj, f.name)))
        return new
    if isinstance(obj, tuple):
        return tuple(to_jax(x) for x in obj)
    if isinstance(obj, list):
        return [to_jax(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_jax(v) for k, v in obj.items()}
    return obj


# -- parity with the JAX package -------------------------------------------------
def idx(name):
    return int(name.rsplit("-", 1)[1])


def seeded_world(seed, n_nodes=24, n_pods=40, fillers=0):
    """Nodes of 2-8 CPU, pods of 100-1500m at priorities 0-3, from a numpy
    seed; with `fillers`, that many nodes hold a low-priority pod that
    leaves 300m free and as many 2-CPU pods at priority 100 must preempt
    (JAX-package objects: each run converts them to the port's)."""
    rng = np.random.default_rng(seed)
    nodes = [JT.Node(name=f"node-{i}", labels={"pool": "small"
                                                if i < fillers else "big"},
                     allocatable={"cpu": int(rng.choice([2000, 4000, 8000])),
                                  "memory": 32 * GI, "pods": 110})
             for i in range(n_nodes)]
    bound = [JT.Pod(name=f"filler-{i}", node_name=f"node-{i}", priority=0,
                    containers=(JT.Container.make(name="c", requests={
                        "cpu": nodes[i].allocatable["cpu"] - 300}),))
             for i in range(fillers)]
    pods = [JT.Pod(name=f"pod-{j}", priority=int(rng.integers(0, 4)),
                   containers=(JT.Container.make(name="c", requests={
                       "cpu": int(rng.choice([100, 300, 700, 1500]))}),))
            for j in range(n_pods)]
    pods += [JT.Pod(name=f"urgent-{j}", priority=100,
                    node_selector={"pool": "small"},
                    containers=(JT.Container.make(
                        name="c", requests={"cpu": 2000}),))
             for j in range(fillers)]
    return nodes, bound, pods


def run_shell(pkg, world, extenders, use_device=False):
    """The world through `pkg`'s shell (the port on device="cpu"): rounds
    of pump, schedule_one until idle, pump and 2 s of a fake clock until
    three rounds bind nothing. Returns the algorithm, the warnings, the
    bindings, nominations and evictions."""
    nodes, bound, pods = world
    port = pkg == "port"
    S = PS if port else JS
    conv = to_port if port else (lambda o: o)
    store = S.Store()
    for n in nodes:
        store.create(S.NODES, conv(n))
    for p in bound:
        store.create(S.PODS, conv(p))
    clock = (FakeClock if port else JFakeClock)(100.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if port:
            sched = Scheduler(store, percentage_of_nodes_to_score=100,
                              clock=clock, use_device=use_device,
                              device="cpu", extenders=extenders)
        else:
            sched = JScheduler(store, percentage_of_nodes_to_score=100,
                               clock=clock, use_tpu=use_device,
                               extenders=extenders)
    sched.sync()
    for p in pods:
        store.create(S.PODS, conv(p))
    idle = 0
    for _ in range(30):
        sched.pump()
        before = sched.metrics.schedule_attempts["scheduled"]
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        idle = 0 if sched.metrics.schedule_attempts["scheduled"] > before \
            else idle + 1
        if idle >= 3:
            break
        clock.step(2.0)
    listed = store.list(S.PODS)[0]
    names = {p.name for p in listed}
    return {"algorithm": sched.algorithm,
            "warnings": [str(w.message) for w in caught],
            "bindings": sorted((p.name, p.node_name) for p in listed),
            "nominations": sorted((p.name, p.nominated_node_name)
                                  for p in listed if p.nominated_node_name),
            "evictions": sorted(p.name for p in bound
                                if p.name not in names)}


def filter_verb(calls):
    def ep(p):
        calls.append(("filter", p["pod"]))
        keep = [n for n in p["nodes"] if idx(n) % 3]
        return {"nodeNames": keep,
                "failedNodes": {n: "ExtenderVetoed" for n in p["nodes"]
                                if not idx(n) % 3}}
    return ep


def prioritize_verb(calls):
    def ep(p):
        calls.append(("prioritize", p["pod"]))
        # three score levels: most nodes tie with others
        return {"hostPriorityList": [{"host": n, "score": 5 * (idx(n) % 3)}
                                     for n in p["nodes"]]}
    return ep


def flaky_verb(calls):
    def ep(p):
        calls.append(("filter", p["pod"]))
        if idx(p["pod"]) % 3 == 0:
            raise RuntimeError("extender down")
        return {"nodeNames": [n for n in p["nodes"] if idx(n) % 2]}
    return ep


def preempt_verb(calls):
    def ep(p):
        calls.append(("preempt", p["pod"]))
        return {"nodeNameToVictims": {
            n: v for n, v in p["nodeNameToVictims"].items()
            if idx(n) % 2 == 1}}
    return ep


CASES = {
    "filter": (lambda c: {"filter": filter_verb(c)},
               {"filter_verb": "filter"}, 0),
    "prioritize-weight-3-ties": (lambda c: {"prioritize": prioritize_verb(c)},
                                 {"prioritize_verb": "prioritize",
                                  "weight": 3}, 0),
    "ignorable-failure": (lambda c: {"filter": flaky_verb(c)},
                          {"filter_verb": "filter", "ignorable": True}, 0),
    "preempt-trims-victims": (lambda c: {"filter": filter_verb(c),
                                         "preempt": preempt_verb(c)},
                              {"filter_verb": "filter",
                               "preempt_verb": "preempt"}, 6),
}


@pytest.mark.parametrize("transport", ["callable", "http"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decision_extender_bindings_equal_the_reference(case, transport,
                                                        endpoints):
    verbs_of, cfg, fillers = CASES[case]
    world = seeded_world(7 + len(case), fillers=fillers)
    out, calls = {}, {}
    for pkg in ("port", "jax"):
        calls[pkg] = []
        ext = make_extender(pkg, endpoints, transport,
                            verbs_of(calls[pkg]), **cfg)
        out[pkg] = run_shell(pkg, world, [ext], use_device=True)
    p, j = out["port"], out["jax"]
    assert isinstance(p["algorithm"], PGeneric)
    assert isinstance(j["algorithm"], JGeneric)
    assert any(ROUTE_WARNING in w for w in p["warnings"])
    assert any(ROUTE_WARNING in w for w in j["warnings"])
    for key in ("bindings", "nominations", "evictions"):
        assert p[key] == j[key], key
    assert calls["port"] == calls["jax"]
    if not fillers:
        assert all(h for _n, h in p["bindings"])
        return
    # the preempt verb kept only odd nodes' victims, and the filter verb
    # drops every third node: urgent pods bind only where both allow
    assert any(v == "preempt" for v, _ in calls["port"])
    assert p["evictions"] and all(idx(f) % 2 == 1 for f in p["evictions"])
    urgent = [h for n, h in p["bindings"] if n.startswith("urgent") and h]
    assert urgent and all(idx(h) % 2 == 1 and idx(h) % 3 for h in urgent)


def test_extender_prioritize_order_and_last_node_index_equal_the_reference():
    """The prioritize pass rebuilds host_priority in the filtered order and
    select_host walks the ties round-robin: the same decisions and the
    same last_node_index, pod after pod, in both generic schedulers."""
    from kubernetes_tpu.cache.node_info import NodeInfo as JNodeInfo
    from kubernetes_tpu.oracle.generic_scheduler import (
        PriorityConfig as JPC)
    from kubernetes_tpu.oracle import priorities as jprios
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    from kubernetes_tpu_torch.oracle.generic_scheduler import PriorityConfig
    from kubernetes_tpu_torch.oracle import priorities as pprios
    nodes, _b, pods = seeded_world(3, n_nodes=12, n_pods=24)
    res = {}
    for pkg in ("port", "jax"):
        port = pkg == "port"
        conv = to_port if port else (lambda o: o)
        NI = NodeInfo if port else JNodeInfo
        infos = {}
        for n in nodes:
            ni = NI()
            ni.set_node(conv(n))
            infos[n.name] = ni
        g = (PGeneric if port else JGeneric)(percentage_of_nodes_to_score=100)
        calls = []
        g.extenders = [make_extender(pkg, None, "callable",
                                     {"prioritize": prioritize_verb(calls)},
                                     prioritize_verb="prioritize", weight=3)]
        pr = pprios if port else jprios
        configs = [(PriorityConfig if port else JPC)(
            name="LeastRequestedPriority", weight=1,
            map_fn=pr.least_requested_map)]
        trail = []
        for pod in pods:
            pod = conv(pod)
            r = g.schedule(pod, infos, list(infos),
                           priority_configs=configs)
            trail.append((r.suggested_host, g.last_node_index))
            infos[r.suggested_host].add_pod(
                dataclasses.replace(pod, node_name=r.suggested_host))
        res[pkg] = (trail, calls)
    assert res["port"] == res["jax"]


def test_bind_only_extender_keeps_the_device_route_equal_to_the_reference():
    """A bind-only extender: the port stays on TorchScheduler (the plain
    versions here), JAX on TPUScheduler; bursts decide, the binder writes
    the managed pods, the rest commit in waves; the same bindings and the
    same binder calls in both."""
    out = {}
    for pkg in ("port", "jax"):
        port = pkg == "port"
        S = PS if port else JS
        T = __import__("kubernetes_tpu_torch.api.types" if port
                       else "kubernetes_tpu.api.types", fromlist=["Pod"])
        store = S.Store()
        bound = []

        def bind_ep(payload, store=store, bound=bound):
            bound.append((payload["pod"], payload["node"]))
            store.bind_pod(payload["pod"], payload["node"])
            return {}
        ext = make_extender(pkg, None, "callable", {"bind": bind_ep},
                            bind_verb="bind", managed_resources=(GPU,))
        for i in range(16):
            store.create(S.NODES, T.Node(name=f"node-{i}", allocatable={
                "cpu": 4000, "memory": 32 * GI, "pods": 110, GPU: 4}))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sched = (Scheduler(store, percentage_of_nodes_to_score=100,
                               clock=FakeClock(), device="cpu",
                               extenders=[ext]) if port
                     else JScheduler(store, percentage_of_nodes_to_score=100,
                                     clock=JFakeClock(), use_tpu=True,
                                     extenders=[ext]))
        assert not any(ROUTE_WARNING in str(w.message) for w in caught)
        assert isinstance(sched.algorithm,
                          TorchScheduler if port else TPUScheduler)
        sched.sync()
        for j in range(30):
            req = {"cpu": 100, "memory": 500 * 1024 ** 2}
            if j >= 20:
                req[GPU] = 1
            store.create(S.PODS, T.Pod(name=f"pod-{j}", containers=(
                T.Container.make(name="c", requests=req),)))
        sched.pump()
        while sched.schedule_burst(max_pods=64):
            pass
        sched.pump()
        out[pkg] = (sorted((p.name, p.node_name)
                           for p in store.list(S.PODS)[0]), bound)
    assert out["port"] == out["jax"]
    assert all(h for _n, h in out["port"][0])
    assert [k for k, _h in out["port"][1]] == \
        [f"default/pod-{j}" for j in range(20, 30)]
