"""The port's scheduler command against the JAX package's, on the CPU.

`kubernetes_tpu_torch.cmd.scheduler.main` with `--device cpu` (the plain
versions of the kernels) on cluster specs built by `models/hollow`, held
against the JAX package's `main` on the same spec: the same `--once`
summary line and the same pod on the same node, with and without
`--burst`, under a config file, a Policy file and a leader-elected run.
Also: the HTTP routes of `serve_http` (`tests/test_aux.py:238` and
`tests/test_timeseries.py:414` on the port, and every other route), the
flag the port leaves out (`--profile-dir`, refused by argparse),
`--server` / `--token` against the JAX package's over each package's
apiserver, `--api-port`'s REST surface, the reference's refusals of
`--server` with `--api-port` or `--cluster-spec`, an error of the loop
ending the command, and `models/hollow` building the reference's nodes and
pods for the same seeds.
"""
import dataclasses
import io
import json
import socket
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest

from kubernetes_tpu.cmd import scheduler as jcmd
from kubernetes_tpu.models import hollow as jhollow
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils import features as jfeatures
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch.apis.config import SchedulerConfiguration
from kubernetes_tpu_torch.cmd import scheduler as pcmd
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.models import hollow as phollow
from kubernetes_tpu_torch.obs import timeseries as ts
from kubernetes_tpu_torch.oracle.generic_scheduler import GenericScheduler
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.utils import features as pfeatures
from kubernetes_tpu_torch.utils.clock import FakeClock

GI = 1024 ** 3


@pytest.fixture(autouse=True)
def restore_gates():
    """`create_scheduler` sets both packages' process-global gates."""
    yield
    jfeatures.reset()
    pfeatures.reset()


SPECS = {
    "plain": {"nodes": [{"count": 4, "zones": 2}],
              "pending_pods": [{"count": 10, "name_prefix": "cli-pod"}]},
    "mixed": {"nodes": [{"count": 9, "zones": 3,
                         "label_fracs": {"disktype": ["ssd", 0.34]}}],
              "existing_pods": [{"count": 6, "cpu": 1000,
                                 "name_prefix": "old"}],
              "pending_pods": [
                  {"count": 8},
                  {"count": 6, "cpu": 250, "mem": GI, "name_prefix": "mid"},
                  {"count": 5, "cpu": 500, "mem": 2 * GI,
                   "name_prefix": "ssd", "node_affinity_key": "disktype",
                   "node_affinity_values": ["ssd"]},
                  {"count": 4, "cpu": 1000, "mem": 4 * GI,
                   "name_prefix": "big"}]},
    "spread": {"nodes": [{"count": 6, "zones": 3}],
               "pending_pods": [{"count": 6, "name_prefix": "anti",
                                 "labels": {"app": "anti"},
                                 "anti_affinity_topology":
                                     "kubernetes.io/hostname"},
                                {"count": 3, "name_prefix": "none",
                                 "cpu": 5000}]},
}


def write(tmp_path, name, doc):
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


def run_port(argv):
    state = {}
    out = io.StringIO()
    with redirect_stdout(out):
        rc = pcmd.main(argv + ["--device", "cpu"], state=state)
    store = state["store"]
    hosts = {p.key: p.node_name for p in store.list(PS.PODS)[0]}
    return rc, out.getvalue().strip().splitlines()[-1], state, hosts


def run_jax(argv, monkeypatch):
    """The JAX package's main; its store is caught from create_scheduler.
    Its command passes a spec's JSON list of node-affinity values to
    PodStrategy as it is (and then fails hashing the term): here it gets
    the tuple the strategy declares, as the port's command makes it."""
    caught = {}
    real = jcmd.create_scheduler

    def catching(store, cfg, **kw):
        caught["store"] = store
        return real(store, cfg, **kw)

    def strategy(**kw):
        if isinstance(kw.get("node_affinity_values"), list):
            kw["node_affinity_values"] = tuple(kw["node_affinity_values"])
        return jhollow.PodStrategy(**kw)
    with monkeypatch.context() as mp:
        mp.setattr(jcmd, "create_scheduler", catching)
        mp.setattr(jcmd, "PodStrategy", strategy)
        out = io.StringIO()
        with redirect_stdout(out):
            rc = jcmd.main(argv)
    hosts = {p.key: p.node_name for p in caught["store"].list(JS.PODS)[0]}
    return rc, out.getvalue().strip().splitlines()[-1], hosts


@pytest.mark.parametrize("burst", [0, 4])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_once_equals_the_reference(spec, burst, tmp_path, monkeypatch):
    argv = ["--cluster-spec", write(tmp_path, "spec.json", SPECS[spec]),
            "--once", "--percentage-of-nodes-to-score", "100"]
    if burst:
        argv += ["--burst", str(burst)]
    rc, line, state, hosts = run_port(argv)
    jrc, jline, jhosts = run_jax(argv, monkeypatch)
    assert rc == jrc == 0
    assert json.loads(line) == json.loads(jline)
    assert hosts == jhosts
    a = state["scheduler"].algorithm
    assert isinstance(a, TorchScheduler) and a.device.type == "cpu"
    summary = json.loads(line)
    assert summary["errors"] == 0
    assert summary["scheduled"] == sum(1 for h in hosts.values() if h) - \
        sum(p.get("count", 0) for p in SPECS[spec].get("existing_pods", []))


@pytest.mark.parametrize("how", ["config", "policy", "provider", "gate_off"])
def test_config_sources_equal_the_reference(how, tmp_path, monkeypatch):
    spec = write(tmp_path, "spec.json", SPECS["mixed"])
    argv = ["--cluster-spec", spec, "--once", "--burst", "8"]
    if how == "config":
        argv += ["--config", write(tmp_path, "cfg.json", {
            "percentage_of_nodes_to_score": 100,
            "algorithm_source": {"provider": "ClusterAutoscalerProvider"}})]
    elif how == "policy":
        argv += ["--policy-config-file", write(tmp_path, "policy.json", {
            "predicates": [{"name": n} for n in
                           ("GeneralPredicates", "PodToleratesNodeTaints",
                            "CheckNodeUnschedulable")],
            "priorities": [{"name": "LeastRequestedPriority", "weight": 1},
                           {"name": "NodeAffinityPriority", "weight": 2}]}),
            "--percentage-of-nodes-to-score", "100"]
    elif how == "provider":
        argv += ["--algorithm-provider", "ClusterAutoscalerProvider"]
    else:
        argv += ["--feature-gates", "TPUScoring=false"]
    rc, line, state, hosts = run_port(argv)
    jrc, jline, jhosts = run_jax(argv, monkeypatch)
    assert (rc, json.loads(line), hosts) == (jrc, json.loads(jline), jhosts)
    algo = state["scheduler"].algorithm
    assert isinstance(algo, GenericScheduler if how == "gate_off"
                      else TorchScheduler)


def test_leader_elected_once_run(tmp_path, monkeypatch):
    spec = write(tmp_path, "spec.json", SPECS["plain"])
    cfg = write(tmp_path, "cfg.json", {
        "percentage_of_nodes_to_score": 100,
        "leader_election": {"leader_elect": True, "lease_duration": 1.0,
                            "renew_deadline": 0.5, "retry_period": 0.05}})
    argv = ["--cluster-spec", spec, "--config", cfg, "--once",
            "--leader-elect-identity", "sched-a"]
    rc, line, state, hosts = run_port(argv)
    jrc, jline, jhosts = run_jax(argv, monkeypatch)
    assert (rc, json.loads(line), hosts) == (jrc, json.loads(jline), jhosts)
    assert json.loads(line)["scheduled"] == 10
    assert state["config"].leader_election.leader_elect
    # the lease was taken by this identity and released at the end
    leases = state["store"].list(PS.LEASES)[0]
    assert [ls.name for ls in leases] == ["kube-scheduler"]
    assert leases[0].holder in ("", None)


@pytest.mark.parametrize("leader", [False, True])
def test_an_error_of_the_loop_ends_the_command(leader, tmp_path,
                                               monkeypatch):
    """A kernel's error (here raised by the shell's cycle) ends `main`
    with that error, on the elected loop's thread too: no quiet exit."""
    argv = ["--cluster-spec", write(tmp_path, "spec.json", SPECS["plain"]),
            "--once", "--device", "cpu"]
    if leader:
        argv += ["--config", write(tmp_path, "cfg.json", {
            "leader_election": {"leader_elect": True,
                                "lease_duration": 1.0,
                                "renew_deadline": 0.5,
                                "retry_period": 0.05}})]

    def boom(self, timeout=0.05):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(Scheduler, "schedule_one", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pcmd.main(argv)


@pytest.mark.parametrize("flag", [["--profile-dir", "d"]])
def test_left_out_flags_are_refused(flag, capsys):
    with pytest.raises(SystemExit) as ei:
        pcmd.main(["--once", "--device", "cpu"] + flag)
    assert ei.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--server", "http://127.0.0.1:1", "--api-port", "8080"],
    ["--server", "http://127.0.0.1:1", "--cluster-spec", "spec.json"],
    ["--server", "http://127.0.0.1:1", "--token", "t", "--api-port", "1"],
])
def test_server_flag_refusals_equal_the_reference(argv):
    """--server and --api-port exclude each other, and --cluster-spec
    needs the embedded store: the reference's messages, before any
    request is sent."""
    with pytest.raises(SystemExit) as pe:
        pcmd.main(argv + ["--once", "--device", "cpu"])
    with pytest.raises(SystemExit) as je:
        jcmd.main(argv + ["--once"])
    assert str(pe.value) == str(je.value)
    assert ("--cluster-spec" if "--cluster-spec" in argv
            else "--api-port") in str(pe.value)


@pytest.mark.parametrize("token", [None, "sched-token"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_server_run_equals_the_reference(spec, token, tmp_path,
                                         monkeypatch):
    """`main --server URL [--token T] --once --burst 4`: the port's
    command against the port's apiserver, the JAX package's against its
    own, over stores loaded from the same spec: the same summary line and
    the same pod on the same node, also equal to the port's embedded run;
    with a token, the servers authenticate system:kube-scheduler and
    authorize with the default RBAC roles."""
    from kubernetes_tpu.apiserver import auth as jauth
    from kubernetes_tpu.apiserver.server import APIServer as JAPIServer
    from kubernetes_tpu_torch.apiserver import auth as pauth
    from kubernetes_tpu_torch.apiserver.server import APIServer as PAPIServer
    path = write(tmp_path, "spec.json", SPECS[spec])
    once = ["--once", "--burst", "4", "--percentage-of-nodes-to-score",
            "100"]

    def strategy(**kw):
        if isinstance(kw.get("node_affinity_values"), list):
            kw["node_affinity_values"] = tuple(kw["node_affinity_values"])
        return jhollow.PodStrategy(**kw)
    out = {}
    for pkg, auth, Server in (("port", pauth, PAPIServer),
                              ("jax", jauth, JAPIServer)):
        store = (PS if pkg == "port" else JS).Store(watch_log_size=65536)
        if pkg == "port":
            pcmd.load_cluster_spec(store, path)
        else:
            with monkeypatch.context() as mp:
                mp.setattr(jcmd, "PodStrategy", strategy)
                jcmd.load_cluster_spec(store, path)
        kw = {}
        if token:
            roles, binds = auth.default_roles()
            kw = {"authenticator": auth.TokenAuthenticator(
                      {token: auth.UserInfo("system:kube-scheduler")}),
                  "authorizer": auth.RBACAuthorizer(roles=roles,
                                                    bindings=binds)}
        argv = once + (["--token", token] if token else [])
        with Server(store, **kw) as srv:
            buf = io.StringIO()
            if pkg == "port":
                state = {}
                try:
                    with redirect_stdout(buf):
                        rc = pcmd.main(["--server", srv.url] + argv
                                       + ["--device", "cpu"], state=state)
                finally:
                    if "scheduler" in state:
                        state["scheduler"].informers.stop_all()
            else:
                with redirect_stdout(buf):
                    rc = jcmd.main(["--server", srv.url] + argv)
        S = PS if pkg == "port" else JS
        out[pkg] = (rc, json.loads(buf.getvalue().strip().splitlines()[-1]),
                    {p.key: p.node_name for p in store.list(S.PODS)[0]})
    assert out["port"] == out["jax"]
    _rc, line, _state, embedded = run_port(
        ["--cluster-spec", path] + once)
    assert out["port"][1] == json.loads(line)
    assert out["port"][2] == embedded


def test_api_port_serves_the_rest_surface(tmp_path):
    """`main --api-port P` (no --once) on a thread: the REST surface over
    the command's store answers a list and a resumed watch, the command's
    scheduler binds a pod created over HTTP, and the command ends when its
    scheduler stops, its apiserver with it."""
    import threading
    from kubernetes_tpu_torch.api import serde
    from kubernetes_tpu_torch.api.types import Container, Pod
    path = write(tmp_path, "spec.json", SPECS["plain"])
    port = free_port()
    state, err = {}, []

    def run():
        try:
            with redirect_stdout(io.StringIO()):
                pcmd.main(["--api-port", str(port), "--cluster-spec", path,
                           "--device", "cpu"], state=state)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        for _ in range(600):
            if "api_server" in state or err:
                break
            t.join(0.05)
        assert not err and "api_server" in state
        doc = json.load(get(port, "/api/v1/nodes"))
        assert len(doc["items"]) == 4
        rv = doc["resourceVersion"]
        body = json.dumps(serde.to_dict(Pod(name="late", containers=(
            Container.make(name="c", requests={"cpu": 100}),)))).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v1/pods", data=body,
            method="POST", headers={"Content-Type": "application/json"}),
            timeout=30).read()
        seen = []
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v1/pods?watch=true"
                f"&resourceVersion={rv}", timeout=30) as resp:
            for raw in resp:
                if not raw.strip():
                    continue
                ev = json.loads(raw)
                if ev["object"]["name"] == "late":
                    seen.append((ev["type"], ev["object"]["node_name"]))
                    if ev["object"]["node_name"]:
                        break
        assert seen[0] == ("ADDED", "") and seen[-1][0] == "MODIFIED"
        assert seen[-1][1].startswith("hollow-node-")
        assert isinstance(state["scheduler"].algorithm, TorchScheduler)
    finally:
        if "scheduler" in state:
            state["scheduler"].stop()
        t.join(timeout=30)
    assert not t.is_alive() and not err
    with pytest.raises(urllib.error.URLError):
        get(port, "/healthz")


def test_device_route_without_a_torch_scheduler_raises():
    """The device route that ends up on another algorithm stops: no
    quiet run on the host."""
    from kubernetes_tpu_torch.factory import create_scheduler
    with pytest.raises(RuntimeError, match="TorchScheduler"):
        create_scheduler(PS.Store(), SchedulerConfiguration(),
                         device="cpu", algorithm=GenericScheduler())


# -- HTTP ---------------------------------------------------------------------
def mknode(name):
    from kubernetes_tpu_torch.api.types import Node
    return Node(name=name, allocatable={"cpu": 4000, "memory": 32 * GI,
                                        "pods": 110})


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=30)


def test_http_endpoints():
    """tests/test_aux.py:238 on the port."""
    store = PS.Store()
    store.create(PS.NODES, mknode("n0"))
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      clock=FakeClock(), device="cpu")
    sched.sync()
    port = free_port()
    server = pcmd.serve_http(sched, SchedulerConfiguration(), port)
    try:
        assert get(port, "/healthz").read() == b"ok"
        metrics = get(port, "/metrics").read().decode()
        assert "scheduler_cache_nodes 1" in metrics
        configz = json.loads(get(port, "/configz").read())
        assert configz["scheduler_name"] == "default-scheduler"
        assert configz == SchedulerConfiguration().to_dict()
    finally:
        server.shutdown()
        server.server_close()


def test_every_route_of_the_command(tmp_path):
    """The routes of the reference's command (`/healthz`, `/metrics`,
    `/debug/traces`, `/debug/timeseries`, `/debug/sched`, `/configz`,
    DELETE `/metrics`) over a create_scheduler scheduler on port 0, after
    a burst; the scheduler command route of tests/test_timeseries.py:414."""
    from kubernetes_tpu.obs.lint import lint_exposition
    from kubernetes_tpu_torch.factory import create_scheduler
    store = PS.Store()
    phollow.populate_store(store, [phollow.NodeStrategy(count=4, zones=2)])
    cfg = SchedulerConfiguration(percentage_of_nodes_to_score=100)
    sched = create_scheduler(store, cfg, device="cpu")
    sched.sync()
    for pod in phollow.make_pods(phollow.PodStrategy(count=6)):
        store.create(PS.PODS, pod)
    sched.pump()
    while sched.schedule_burst(max_pods=8):
        pass
    sched.pump()
    ts.SCRAPER.reset(capacity=32)
    ts.SCRAPER.sample()
    ts.SCRAPER.sample()
    server = pcmd.serve_http(sched, cfg, 0)
    port = server.server_address[1]
    try:
        text = get(port, "/metrics").read().decode()
        for fam in ("scheduler_schedule_attempts_total",
                    "process_resident_memory_bytes", "process_open_fds",
                    "python_gc_pause_seconds", "timeseries_samples_total",
                    "pod_startup_seconds_p99_windowed"):
            assert fam in text, fam
        assert 'scheduler_schedule_attempts_total{result="scheduled"} 6' \
            in text
        assert lint_exposition(text) == []
        doc = json.load(get(port, "/debug/timeseries?window=1"))
        assert doc["window"] == 1
        assert "process_resident_memory_bytes" in doc["families"]
        one = json.load(get(port, "/debug/timeseries"
                                  "?family=process_resident_memory_bytes"))
        assert list(one["families"]) == ["process_resident_memory_bytes"]
        for bad in ("/debug/timeseries?window=bogus",
                    "/debug/timeseries?window=-1",
                    "/debug/traces?limit=x"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                get(port, bad)
            assert ei.value.code == 400
        traces = json.load(get(port, "/debug/traces?limit=5"))
        assert isinstance(traces, (dict, list))
        snap = json.load(get(port, "/debug/sched"))
        assert snap["scheduler"]["name"] == "default-scheduler"
        assert json.load(get(port, "/configz")) == cfg.to_dict()
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(port, "/nope")
        assert ei.value.code == 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics",
                                     method="DELETE")
        assert urllib.request.urlopen(req, timeout=30).read() == b"reset"
        assert sched.metrics.schedule_attempts["scheduled"] == 0
        assert 'scheduler_schedule_attempts_total{result="scheduled"} 0' \
            in get(port, "/metrics").read().decode()
    finally:
        server.shutdown()
        server.server_close()
        ts.SCRAPER.reset()


# -- models/hollow ------------------------------------------------------------
def plain(obj):
    d = dataclasses.asdict(obj)
    d.pop("uid", None)             # a process-wide counter in both
    return d


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kw", [
    {"count": 30},
    {"count": 40, "zones": 3, "label_fracs": {"disktype": ("ssd", 0.33),
                                              "tier": ("gold", 0.5)}},
    {"count": 25, "zones": 2, "taint_frac": 0.4, "name_prefix": "t",
     "cpu": 8000, "pods": 60},
], ids=["plain", "labels", "taints"])
def test_hollow_nodes_equal_the_reference(kw, seed):
    from kubernetes_tpu.api.types import Taint as JTaint
    from kubernetes_tpu_torch.api.types import Taint as PTaint
    pkw, jkw = dict(kw), dict(kw)
    if "taint_frac" in kw:
        jkw["taint"] = JTaint(key="k", value="v", effect="NoSchedule")
        pkw["taint"] = PTaint(key="k", value="v", effect="NoSchedule")
    p = phollow.make_hollow_nodes(phollow.NodeStrategy(**pkw), seed=seed,
                                  start_index=3)
    j = jhollow.make_hollow_nodes(jhollow.NodeStrategy(**jkw), seed=seed,
                                  start_index=3)
    assert [plain(n) for n in p] == [plain(to_port(n)) for n in j]


@pytest.mark.parametrize("kw", [
    {"count": 5},
    {"count": 4, "cpu": 500, "mem": 2 * GI, "node_affinity_key": "disktype",
     "node_affinity_values": ("ssd",), "priority": 7, "namespace": "ns"},
    {"count": 3, "anti_affinity_topology": "kubernetes.io/hostname",
     "affinity_topology": "zone", "host_port": 8080,
     "labels": {"app": "x"}},
], ids=["plain", "node_affinity", "pod_affinity"])
def test_hollow_pods_equal_the_reference(kw):
    p = phollow.make_pods(phollow.PodStrategy(**kw), start_index=2)
    j = jhollow.make_pods(jhollow.PodStrategy(**kw), start_index=2)
    assert [plain(x) for x in p] == [plain(to_port(x)) for x in j]


def test_populate_store_equals_the_reference():
    nodes = [dict(count=6, zones=3), dict(count=4, name_prefix="b",
                                          label_fracs={"a": ("1", 0.5)})]
    pods = [dict(count=7, cpu=200), dict(count=3, name_prefix="q")]
    pstore, jstore = PS.Store(), JS.Store()
    pn = phollow.populate_store(
        pstore, [phollow.NodeStrategy(**n) for n in nodes],
        [phollow.PodStrategy(**p) for p in pods], seed=4)
    jn = jhollow.populate_store(
        jstore, [jhollow.NodeStrategy(**n) for n in nodes],
        [jhollow.PodStrategy(**p) for p in pods], seed=4)
    assert pn == jn == (10, 10)
    for kind in ("NODES", "PODS"):
        got = sorted((plain(o) for o in pstore.list(getattr(PS, kind))[0]),
                     key=lambda d: d["name"])
        want = sorted((plain(to_port(o))
                       for o in jstore.list(getattr(JS, kind))[0]),
                      key=lambda d: d["name"])
        for d in got + want:
            d.pop("resource_version", None)
            d.pop("creation_timestamp", None)
        assert got == want
