"""The cluster-in-a-process on the port, on the CPU.

`kubernetes_tpu_torch.cmd.cluster` (the kubeadm analog) and
`kubernetes_tpu_torch.cmd.kubectl`:
- `tests/test_apiserver.py`'s TestKubectl, TestClusterInAProcess,
  TestKubectlApply and TestDrainHonorsPDB with the port's imports; the
  threaded cluster's scheduler decides on the kernels' plain versions
  (`device="cpu"`);
- parity with the JAX package (`TestSteppedClusterParity`): the same
  cluster pumped by hand in a fixed order with no threads, through
  `chip_smoke.ClusterSteps` (the `[cluster]` phase's driver) given each
  package's modules, with every one of the 20 controllers changing
  objects; after each stage every object of every kind and every
  proxier's table must be equal between the two stores, and so must
  kubectl's output over each package's apiserver. The pod-name counters
  (`controllers/replicaset.py`, `controllers/job.py`), the pod-uid
  counter (`api/types.py`) and the event-name sequence
  (`store/record.py`) are process-global: both packages' are reset before
  each run;
- `chip_smoke.py`'s `[cluster]` phase at a small size on the CPU.
Every server listens on 127.0.0.1 port 0 and is stopped by its test.
"""
import contextlib
import importlib
import io
import itertools
import json
import urllib.request
from types import SimpleNamespace

import pytest

from kubernetes_tpu_torch.api.types import Container, LabelSelector, Node, Pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.store.store import NODES, PODS, Store
from tests.torch_threads import one_torch_thread  # noqa: F401

GI = 1024 ** 3
MI = 1024 ** 2


# -- tests/test_apiserver.py's kubectl and cluster cases ----------------------
@pytest.fixture()
def server():
    store = Store()
    with APIServer(store) as srv:
        yield store, srv.url


def req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


class TestKubectl:
    def _run(self, url, *argv):
        import contextlib
        from kubernetes_tpu_torch.cmd import kubectl
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = kubectl.main(["--server", url, *argv])
        assert rc == 0
        return out.getvalue()

    def test_get_describe_delete_drain(self, server, tmp_path):
        store, url = server
        store.create(NODES, Node(
            name="n0", allocatable={"cpu": 4000, "memory": GI, "pods": 10}))
        manifest = {"items": [
            {"kind": "pods", "name": "web-1", "labels": {"app": "web"},
             "containers": [{"name": "c",
                             "requests": [["cpu", 100]]}]},
        ]}
        f = tmp_path / "m.json"
        f.write_text(json.dumps(manifest))
        out = self._run(url, "create", "-f", str(f))
        assert "pods/web-1 created" in out
        store.bind_pod("default/web-1", "n0")
        out = self._run(url, "get", "pods")
        assert "web-1" in out and "n0" in out
        out = self._run(url, "get", "nodes")
        assert "n0" in out and "Ready" in out
        out = self._run(url, "describe", "pods", "default/web-1")
        assert "node_name: n0" in out
        out = self._run(url, "cordon", "n0")
        assert "cordoned" in out
        assert store.get(NODES, "n0").unschedulable
        out = self._run(url, "drain", "n0")
        assert "pod/default/web-1 evicted" in out
        assert not store.list(PODS)[0]
        out = self._run(url, "uncordon", "n0")
        assert not store.get(NODES, "n0").unschedulable


class TestClusterInAProcess:
    """kubeadm-analog bootstrap (cmd/cluster.py): every control-plane
    component live over one store, driven purely through kubectl + REST —
    ReplicaSet create -> controller creates pods -> scheduler binds ->
    hollow kubelets run them -> disruption controller reconciles the PDB."""

    def test_kubectl_driven_end_to_end(self, tmp_path):
        from kubernetes_tpu_torch.cmd.cluster import Cluster
        from kubernetes_tpu_torch.cmd import kubectl
        import contextlib

        def kc(url, *argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = kubectl.main(["--server", url, *argv])
            assert rc == 0
            return out.getvalue()

        with Cluster(n_nodes=6, api_port=0, device="cpu",
                     kubelet_interval=0.05) as cluster:
            url = cluster.url
            manifest = {"items": [
                {"kind": "replicasets", "name": "web",
                 "selector": {"match_labels": [["app", "web"]]},
                 "replicas": 4},
                {"kind": "poddisruptionbudgets", "name": "web-pdb",
                 "selector": {"match_labels": [["app", "web"]]},
                 "min_available": 3},
            ]}
            f = tmp_path / "m.json"
            f.write_text(json.dumps(manifest))
            kc(url, "create", "-f", str(f))

            def all_running():
                _, lst = req(f"{url}/api/v1/pods")
                pods = lst["items"]
                return len(pods) == 4 and all(
                    p["node_name"] and p["phase"] == "Running"
                    for p in pods)
            assert cluster.wait_for(all_running, timeout=15), \
                req(f"{url}/api/v1/pods")[1]

            def pdb_reconciled():
                _, pdb = req(f"{url}/api/v1/poddisruptionbudgets/default/web-pdb")
                return (pdb["current_healthy"], pdb["disruptions_allowed"]) \
                    == (4, 1)
            assert cluster.wait_for(pdb_reconciled, timeout=10)

            # kill a pod through kubectl: the RS controller replaces it and
            # the scheduler + kubelet bring it back to Running
            _, lst = req(f"{url}/api/v1/pods")
            victim = lst["items"][0]
            kc(url, "delete", "pods",
               f"{victim['namespace']}/{victim['name']}")
            assert cluster.wait_for(all_running, timeout=15)
            out = kc(url, "get", "replicasets")
            assert "web" in out


class TestKubectlApply:
    def test_apply_creates_then_configures(self, server, tmp_path):
        store, url = server
        import contextlib
        from kubernetes_tpu_torch.cmd import kubectl

        def kc(*argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert kubectl.main(["--server", url, *argv]) == 0
            return out.getvalue()

        f = tmp_path / "rs.json"
        f.write_text(json.dumps({"kind": "replicasets", "name": "web",
                                 "selector": {"match_labels": [["app", "web"]]},
                                 "replicas": 2}))
        assert "created" in kc("apply", "-f", str(f))
        from kubernetes_tpu_torch.store.store import REPLICASETS
        assert store.get(REPLICASETS, "default/web").replicas == 2
        f.write_text(json.dumps({"kind": "replicasets", "name": "web",
                                 "selector": {"match_labels": [["app", "web"]]},
                                 "replicas": 5}))
        assert "configured" in kc("apply", "-f", str(f))
        assert store.get(REPLICASETS, "default/web").replicas == 5


class TestDrainHonorsPDB:
    """drain consults the disruption controller's reconciled
    disruptions_allowed like the eviction subresource (reference:
    pkg/registry/core/pod/rest/eviction.go); --disable-eviction keeps the
    unconditional-delete mode."""

    def _drain(self, url, *argv):
        import contextlib
        from kubernetes_tpu_torch.cmd import kubectl
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = kubectl.main(["--server", url, "drain", *argv])
        return rc, out.getvalue(), err.getvalue()

    def test_drain_refuses_when_budget_exhausted(self, server):
        from kubernetes_tpu_torch.api.types import PodDisruptionBudget
        from kubernetes_tpu_torch.store.store import PDBS
        store, url = server
        store.create(NODES, Node(
            name="n0", allocatable={"cpu": 4000, "memory": GI, "pods": 10}))
        # PDB allows ONE disruption across the two web pods
        store.create(PDBS, PodDisruptionBudget(
            name="web-pdb",
            selector=LabelSelector(match_labels=(("app", "web"),)),
            min_available=1, disruptions_allowed=1,
            current_healthy=2, desired_healthy=1, expected_pods=2))
        for n in ("w0", "w1"):
            store.create(PODS, Pod(
                name=n, node_name="n0", labels={"app": "web"},
                containers=(Container.make(name="c"),)))
        # an unbudgeted pod drains freely
        store.create(PODS, Pod(
            name="loose", node_name="n0", labels={"app": "batch"},
            containers=(Container.make(name="c"),)))
        rc, out, err = self._drain(url, "n0")
        assert rc == 1            # one eviction refused
        assert "pod/default/loose evicted" in out
        assert out.count("evicted") == 2   # loose + exactly one web pod
        assert "violate the pod's disruption budget" in err
        remaining = [p.name for p in store.list(PODS)[0]]
        assert len(remaining) == 1 and remaining[0].startswith("w")
        assert store.get(NODES, "n0").unschedulable
        # --disable-eviction clears the survivor unconditionally
        rc, out, _err = self._drain(url, "n0", "--disable-eviction")
        assert rc == 0 and not store.list(PODS)[0]


# -- parity with the JAX package ---------------------------------------------
WEB = {"cpu": 100, "memory": 500 * MI}
ROLLED = {"cpu": 250, "memory": GI}
REPLICAS = 40
AGG = {"rbac.example.com/aggregate-to-monitoring": "true"}


def _modules(pkg):
    """One package's modules, under the names `chip_smoke.ClusterSteps`
    reads them by and the ones the parity run adds."""
    imp = importlib.import_module
    return SimpleNamespace(
        pkg=pkg, cluster=imp(f"{pkg}.cmd.cluster"),
        T=imp(f"{pkg}.api.types"), S=imp(f"{pkg}.store.store"),
        serde=imp(f"{pkg}.api.serde"), clock=imp(f"{pkg}.utils.clock"),
        record=imp(f"{pkg}.store.record"),
        auth=imp(f"{pkg}.apiserver.auth"),
        server=imp(f"{pkg}.apiserver.server"),
        kubectl=imp(f"{pkg}.cmd.kubectl"),
        gang=imp(f"{pkg}.coscheduling.types"),
        rs=imp(f"{pkg}.controllers.replicaset"),
        job=imp(f"{pkg}.controllers.job"))


def reset_counters(monkeypatch, m):
    """The process-global pod-name and pod-uid counters and the event-name
    sequence of one package, from 1 again (names enter the queue's order,
    so bindings depend on them)."""
    monkeypatch.setattr(m.T, "_pod_uid_counter", itertools.count(1))
    monkeypatch.setattr(m.rs, "_suffix", itertools.count(1))
    monkeypatch.setattr(m.job, "_suffix", itertools.count(1))
    monkeypatch.setattr(m.record, "_seq_val", 0)


def containers(T, req):
    return (T.Container.make(name="c", requests=dict(req)),)


def template(T, app, req):
    return T.PodTemplate(labels={"app": app}, containers=containers(T, req))


def create_workloads(s):
    """Beside chip_smoke's web Service, PDB and Deployment: a Job, a
    DaemonSet, a StatefulSet and a CronJob; a Deployment under a
    HorizontalPodAutoscaler; two PersistentVolumes and a claim; a
    ResourceQuota; a namespace with a pod in it; a gang of three pods
    under a PodGroup; two ClusterRoles aggregated into a third; and a
    one-pod Job with a TTL after it finishes."""
    import chip_smoke as cs
    m, store = s.m, s.c.store
    T, S = m.T, m.S
    for kind, obj in cs.cluster_objects(m, REPLICAS, WEB):
        store.create(kind, obj)
    store.create(S.JOBS, T.Job(name="crunch",
                               template=template(T, "batch", {"cpu": 200}),
                               completions=3, parallelism=3))
    store.create(S.JOBS, T.Job(name="once",
                               template=template(T, "once", {"cpu": 100}),
                               ttl_seconds_after_finished=200.0))
    store.create(S.DAEMONSETS, T.DaemonSet(
        name="agent", selector=T.LabelSelector.from_dict({"app": "agent"}),
        template=template(T, "agent", {"cpu": 50})))
    store.create(S.STATEFULSETS, T.StatefulSet(
        name="db", replicas=3, service_name="db",
        selector=T.LabelSelector.from_dict({"app": "db"}),
        template=template(T, "db", {"cpu": 300})))
    store.create(S.CRONJOBS, T.CronJob(
        name="report", schedule="*/5 * * * *", concurrency_policy="Forbid",
        template=template(T, "report", {"cpu": 100})))
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="api", replicas=2,
        selector=T.LabelSelector.from_dict({"app": "api"}),
        template=template(T, "api", {"cpu": 200})))
    store.create(S.HPAS, T.HorizontalPodAutoscaler(
        name="api", scale_target_ref=("Deployment", "api"), min_replicas=1,
        max_replicas=6, target_cpu_utilization=50))
    store.create(S.PVS, T.PersistentVolume(name="pv-big", capacity=100 * GI))
    store.create(S.PVS, T.PersistentVolume(name="pv-small",
                                           capacity=10 * GI))
    store.create(S.PVCS, T.PersistentVolumeClaim(name="data",
                                                 request=5 * GI))
    store.create(S.PVCS, T.PersistentVolumeClaim(name="archive",
                                                 request=500 * GI))
    store.create(S.RESOURCEQUOTAS, T.ResourceQuota(
        name="q", hard={"cpu": 100_000, "pods": 500}))
    store.create(S.NAMESPACES, T.Namespace(name="team"))
    store.create(S.PODS, T.Pod(name="solo", namespace="team",
                               labels={"app": "solo"},
                               containers=containers(T, {"cpu": 100})))
    store.create(S.PODGROUPS, m.gang.PodGroup(name="gang", min_member=3))
    for i in range(3):
        store.create(S.PODS, T.Pod(
            name=f"gang-{i}",
            labels={"app": "gang", m.gang.LABEL_POD_GROUP: "gang"},
            containers=containers(T, {"cpu": 500})))
    Role, Rule = m.auth.Role, m.auth.PolicyRule
    store.create(S.CLUSTERROLES, Role(name="monitoring",
                                      aggregation_labels=dict(AGG)))
    store.create(S.CLUSTERROLES, Role(
        name="pods-reader", labels=dict(AGG),
        rules=(Rule(verbs=("get", "list"), resources=("pods",)),)))
    store.create(S.CLUSTERROLES, Role(
        name="nodes-reader", labels=dict(AGG),
        rules=(Rule(verbs=("get",), resources=("nodes",)),)))


def running(s, app, n):
    pods = s.pods(app)
    return len(pods) == n and all(p.node_name and p.phase == "Running"
                                  for p in pods)


def scaled_up(s):
    """Every workload's pods Running and every controller's object
    written: the gang Scheduled, the claim on the small volume, the
    aggregated role holding both rules, the quota's usage counted."""
    store, S = s.c.store, s.m.S
    roles = {r.name: r for r in store.list(S.CLUSTERROLES)[0]}
    quota = store.get(S.RESOURCEQUOTAS, "default/q")
    return (s.web_ready(REPLICAS, WEB["cpu"])
            and running(s, "api", 2) and running(s, "gang", 3)
            and running(s, "once", 1) and running(s, "solo", 1)
            and store.get(S.PODGROUPS, "default/gang").phase == "Scheduled"
            and store.get(S.PVCS, "default/data").volume_name == "pv-small"
            and len(roles["monitoring"].rules) == 2
            and quota.used.get("pods", 0) > 0)


def load_api_and_finish(s):
    """The api pods report 150 % of their request; the one-pod Job's pod
    succeeds; the namespace `team` is deleted; one source role loses its
    aggregation label; a volume large enough for the second claim
    appears."""
    m, store = s.m, s.c.store
    T, S = m.T, m.S
    for p in s.pods("api"):
        store.create(S.PODMETRICS, T.PodMetrics(name=p.name, cpu_usage=300))

    def succeed(pod):
        pod.phase = "Succeeded"
        return pod
    for p in s.pods("once"):
        store.guaranteed_update(S.PODS, p.key, succeed)

    def terminate(ns):
        ns.phase = "Terminating"
        return ns
    store.guaranteed_update(S.NAMESPACES, "team", terminate)

    def unlabel(role):
        role.labels = {}
        return role
    store.guaranteed_update(S.CLUSTERROLES, "nodes-reader", unlabel)
    store.create(S.PVS, T.PersistentVolume(name="pv-huge",
                                           capacity=1000 * GI))


def settled(s):
    """The HPA scaled api to its six Running replicas; the finished Job
    and its pod are gone after their TTL; the namespace and everything
    in it are gone; the aggregated role lost the unlabelled role's rule;
    the second claim is bound."""
    store, S = s.c.store, s.m.S
    roles = {r.name: r for r in store.list(S.CLUSTERROLES)[0]}
    return (running(s, "api", 6) and not s.pods("once")
            and "default/once" not in {j.key for j in
                                       store.list(S.JOBS)[0]}
            and not any(n.name == "team"
                        for n in store.list(S.NAMESPACES)[0])
            and not any(p.namespace == "team"
                        for p in store.list(S.PODS)[0])
            and len(roles["monitoring"].rules) == 1
            and store.get(S.PVCS, "default/archive").volume_name
            == "pv-huge")


def objects(s):
    """{kind: {key: serde dict}} of every kind in the store."""
    serde = s.m.serde
    return {kind: {o.key: serde.to_dict(o)
                   for o in s.c.store.list(kind)[0]}
            for kind in serde.KIND_TYPES}


def snapshot(s, stage):
    return (stage, s.rounds, objects(s),
            [(p.node_name, p.rules()) for p in s.c.proxies])


def remove_node(s, dead):
    """A live node holding web pods goes away: its kubelet stops and its
    Node object is deleted. Pod GC deletes the pods still bound to it
    (NodeLost), the controllers replace them and the scheduler binds
    them elsewhere. Returns the node's name and the stage's end."""
    S = s.m.S
    name = sorted({p.node_name for p in s.pods("web")} - set(dead))[0]
    for k in s.c.kubelets:
        if k.node_name == name:
            k.stop()
    s.c.store.delete(S.NODES, name)

    def done():
        return (s.web_ready(REPLICAS, ROLLED["cpu"], dead + [name])
                and not any(p.node_name == name
                            for p in s.c.store.list(S.PODS)[0]))
    return name, done


def stepped_run(m, n_nodes, **sched_kw):
    """The scale-up, the autoscale and the deletions, the rollout, the
    node death and a dead node's removal, through chip_smoke's driver;
    after each stage the objects and the proxier tables."""
    import chip_smoke as cs
    s = cs.ClusterSteps(m, n_nodes, 3, **sched_kw)
    create_workloads(s)
    stages = []
    s.until("scale-up", lambda: scaled_up(s))
    stages.append(snapshot(s, "scale-up"))
    load_api_and_finish(s)
    s.until("autoscale", lambda: settled(s))
    stages.append(snapshot(s, "autoscale"))
    s.roll(ROLLED)
    s.until("rollout", lambda: s.web_ready(REPLICAS, ROLLED["cpu"]))
    stages.append(snapshot(s, "rollout"))
    dead = s.kill(1)
    s.until("node death", lambda: s.web_ready(REPLICAS, ROLLED["cpu"],
                                              dead))
    stages.append(snapshot(s, "node death"))
    gone, done = remove_node(s, dead)
    s.until("node removal", done)
    stages.append(snapshot(s, "node removal"))
    assert s.scheduled_once() == ([], [])
    return s, dead + [gone], stages


#: kubectl's reads of the stepped run's store, then its writes
KUBECTL_READS = [
    *(["get", kind] for kind in (
        "pods", "nodes", "events", "poddisruptionbudgets", "replicasets",
        "deployments", "jobs", "daemonsets", "statefulsets", "cronjobs",
        "services", "endpoints", "resourcequotas", "persistentvolumes",
        "persistentvolumeclaims", "horizontalpodautoscalers", "podgroups",
        "clusterroles", "namespaces", "serviceaccounts", "leases")),
    ["get", "pods", "-o", "wide"], ["get", "pods", "-o", "json"],
    ["get", "deployments", "default/web", "-o", "json"],
    ["get", "nodes", "hollow-node-0"],
    ["describe", "deployments", "default/web"],
    ["describe", "horizontalpodautoscalers", "default/api"],
    ["describe", "podgroups", "default/gang"],
    ["describe", "clusterroles", "monitoring"],
    ["get", "pods", "default/no-such-pod"],
]


def kubectl_session(m, store, dead, tmp):
    """The commands' exit codes, stdout and stderr against an apiserver of
    package `m` over `store`: the reads, then create and apply from a
    manifest, cordon, a drain the web PDB stops, the same drain with
    --disable-eviction, uncordon and delete."""
    out = []

    def kc(url, *argv):
        o, e = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            try:
                rc = m.kubectl.main(["--server", url, *argv])
            except SystemExit as exc:     # an error from the server
                rc = f"exit {exc.code}"
        shown = ["MANIFEST" if a == str(manifest) else a for a in argv]
        out.append((shown, rc, o.getvalue(), e.getvalue()))
    manifest = tmp / f"{m.pkg}.json"
    T = m.T
    cm = {"kind": "configmaps", "name": "settings", "data": {"a": "1"}}
    manifest.write_text(json.dumps({"items": [
        cm, dict(m.serde.to_dict(T.Pod(name="extra",
                                       containers=containers(T, WEB))),
                 kind="pods")]}))
    busy = sorted({p.node_name for p in store.list(m.S.PODS)[0]
                   if p.labels.get("app") == "web"})[0]
    with m.server.APIServer(store) as srv:
        for argv in KUBECTL_READS:
            kc(srv.url, *argv)
        kc(srv.url, "create", "-f", str(manifest))
        cm["data"] = {"a": "2"}
        manifest.write_text(json.dumps(cm))
        kc(srv.url, "apply", "-f", str(manifest))
        kc(srv.url, "cordon", busy)
        kc(srv.url, "drain", busy)
        kc(srv.url, "drain", busy, "--disable-eviction")
        kc(srv.url, "uncordon", busy)
        kc(srv.url, "delete", "pods", "default/extra")
        kc(srv.url, "get", "configmaps", "-o", "json")
        kc(srv.url, "get", "nodes", dead[0])
        kc(srv.url, "get", "nodes", dead[-1])
    return out


class TestSteppedClusterParity:
    """The stepped cluster of `chip_smoke.ClusterSteps` on both packages:
    12 hollow nodes in 3 zones; the web Deployment of 40 replicas with a
    Service and a PDB, a Job, a DaemonSet, a StatefulSet and a CronJob, a
    Deployment under an HPA fed PodMetrics, a PV binder's claims, a
    ResourceQuota, a namespace deleted with its pod and ServiceAccount, a
    PodGroup's gang, an aggregated ClusterRole and a Job deleted by its
    TTL; a rollout; the kubelets of 3 nodes stop and the FakeClock runs
    past the grace period and the pods' tolerations until their pods are
    evicted, replaced and bound again; then a live node's kubelet stops
    and its Node is deleted, and pod GC takes its pods. After each stage every object of
    every kind (each package's `serde.to_dict`) and every proxier's table
    is equal between the two stores. Afterwards kubectl's output over
    each package's apiserver is equal, and so are the stores after its
    writes. The port's scheduler runs on `device="cpu"`, JAX's with
    `use_tpu=True` on JAX's CPU; the kubelets and every controller run on
    one FakeClock, the schedulers on their real clocks, which write no
    field of any object here (no pod is ever unschedulable, so no
    backoff; the PodGroup controller writes the gang's phases)."""

    def test_port_equals_the_jax_package(self, monkeypatch, tmp_path):
        import chip_smoke as cs
        jm, pm = _modules("kubernetes_tpu"), _modules("kubernetes_tpu_torch")
        reset_counters(monkeypatch, jm)
        js, jdead, jstages = stepped_run(jm, 12, use_tpu=True)
        reset_counters(monkeypatch, pm)
        ps, pdead, pstages = stepped_run(pm, 12, use_device=True,
                                         device="cpu")
        from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
        assert isinstance(ps.c.scheduler.algorithm, TorchScheduler)
        assert ps.c.scheduler.algorithm.device.type == "cpu"
        assert pdead == jdead and len(pdead) == 4
        for (jn, jr, jo, jt), (pn, pr, po, pt) in zip(jstages, pstages):
            assert (pn, pr) == (jn, jr)
            assert cs.summary_diff(po, jo) is None, (
                pn, cs.summary_diff(po, jo))
            assert pt == jt, pn
        assert [st[0] for st in pstages] == [
            "scale-up", "autoscale", "rollout", "node death",
            "node removal"]
        objs = pstages[-1][2]
        apps = {}
        for d in objs["pods"].values():
            apps[d["labels"].get("app")] = apps.get(d["labels"].get("app"),
                                                    0) + 1
        assert apps["web"] == 40 and apps["batch"] == 3 and apps["db"] == 3
        assert apps["api"] == 6 and apps["report"] == 1
        # one DaemonSet pod a node that is up and still exists
        assert apps["agent"] == 12 - 4
        lost = [d for d in objs["events"].values()
                if d["reason"] == "NodeLost"]
        assert lost and all(pdead[-1] in d["message"] for d in lost)
        # the gang formed; its pods on the dead nodes were evicted, and
        # nothing replaces a pod no controller owns
        first_objs = pstages[0][2]
        first = first_objs["podgroups"]["default/gang"]
        assert (first["phase"], first["scheduled"]) == ("Scheduled", 3)
        gang = objs["podgroups"]["default/gang"]
        assert gang["members"] == gang["scheduled"] == apps.get("gang", 0)
        assert "once" not in apps and "solo" not in apps
        assert objs["deployments"]["default/api"]["replicas"] == 6
        assert len(objs["replicasets"]) == 2 and len(objs["cronjobs"]) == 1
        assert {d["name"] for d in objs["endpoints"].values()} >= {"web"}
        # the namespace's ServiceAccount was provisioned, then went with it
        assert "team/default" in first_objs["serviceaccounts"]
        assert "team" not in objs["namespaces"]
        assert "team/default" not in objs["serviceaccounts"]
        assert [r["resources"] for r in
                objs["clusterroles"]["monitoring"]["rules"]] == [["pods"]]
        nodes = objs["nodes"].values()     # the TTL and IPAM controllers
        assert all(n["annotations"]["node.alpha.kubernetes.io/ttl"] == "0"
                   for n in nodes)
        assert len({n["pod_cidr"] for n in nodes}) == len(nodes) == 11
        used = objs["resourcequotas"]["default/q"]["used"]
        assert used["pods"] == sum(apps.values())
        # kubectl over each package's apiserver
        jout = kubectl_session(jm, js.c.store, jdead, tmp_path)
        pout = kubectl_session(pm, ps.c.store, pdead, tmp_path)
        assert len(pout) == len(jout)
        for p, j in zip(pout, jout):
            assert p == j, cs.summary_diff(p, j)
        rcs = [rc for _argv, rc, _o, _e in pout]
        # the drain the PDB stopped; the missing pod and the deleted node
        assert rcs.count(1) == 1 and rcs.count("exit 1") == 2
        jo, po = objects(js), objects(ps)
        assert cs.summary_diff(po, jo) is None, cs.summary_diff(po, jo)


class TestClusterEntryPoints:
    def test_cluster_defaults_to_cuda(self):
        """`Cluster` and `main` decide on the card unless asked for the
        CPU: without a card the default raises."""
        import inspect
        from kubernetes_tpu_torch.cmd import cluster
        sig = inspect.signature(cluster.Cluster)
        assert sig.parameters["device"].default == "cuda"
        assert sig.parameters["use_device"].default is True
        import torch
        if not torch.cuda.is_available():
            with pytest.raises(Exception):
                cluster.Cluster(n_nodes=2, api_port=-1)

    def test_main_device_flags(self, monkeypatch):
        from kubernetes_tpu_torch.cmd import cluster
        seen = {}

        class Stop(Exception):
            pass

        class Fake:
            def __init__(self, **kw):
                seen.update(kw)

            def start(self):
                raise Stop

        monkeypatch.setattr(cluster, "Cluster", Fake)
        for argv, want in (([], ("cuda", True)),
                           (["--device", "cpu"], ("cpu", True)),
                           (["--no-device"], ("cuda", False))):
            seen.clear()
            with pytest.raises(Stop):
                cluster.main(["--api-port", "0", *argv])
            assert (seen["device"], seen["use_device"]) == want


class TestChipSmokeClusterPhase:
    """`chip_smoke.py`'s `[cluster]` runs at a small size on the
    kernels' plain versions: part (a)'s stepped run converges through
    its three stages with no double bind, and two runs agree summary for
    summary; part (b)'s threaded run over HTTP reports every pod."""

    def test_stepped_run(self, monkeypatch):
        import chip_smoke as cs
        m = _modules("kubernetes_tpu_torch")
        reset_counters(monkeypatch, m)
        a = cs.cluster_stepped("cpu", 24, 3, 16, 1, 8)
        reset_counters(monkeypatch, m)
        b = cs.cluster_stepped("cpu", 24, 3, 16, 1, 8)
        assert [s[:2] for s in a["stages"]] == [s[:2] for s in b["stages"]]
        assert [s[0] for s in a["stages"]] == ["scale-up", "rollout",
                                               "node death"]
        for (_n, _r, x), (_m, _q, y) in zip(a["stages"], b["stages"]):
            for part in ("pods", "replicasets", "endpoints", "tables"):
                assert cs.summary_diff(x[part], y[part]) is None, part
        assert len(a["dead"]) == 3 and not a["twice"] and not a["wrong"]
        assert a["route"] == "TorchScheduler on cpu"
        last = a["stages"][-1][2]
        web = [p for p in last["pods"] if p[0].startswith("default/web-")]
        assert len(web) == 16 and all(p[1] not in a["dead"]
                                      and p[2] == "Running" for p in web)
        assert len(last["tables"]) == 24
        assert sum(1 for p in last["pods"]
                   if p[0].startswith("default/batch-")) == 8
        assert cs.summary_diff({"k": 1}, {"k": 2}) == (("k",), 1, 2)
        assert cs.summary_diff({"k": [1, {"n": 2}]},
                               {"k": [1, {"n": 3}]}) == (("k", 1, "n"), 2, 3)
        assert cs.summary_diff({"k": 1}, {}) == (("k",), 1, None)
        assert cs.summary_diff([1, 2], [1, 2, 3]) == (("length",), 2, 3)

    def test_threaded_run(self):
        import chip_smoke as cs
        b = cs.cluster_threaded("cpu", 6, 12)
        assert b["n"] == 12 and b["route"] == "TorchScheduler on cpu"
        assert b["said"] == ["services/web created",
                             "poddisruptionbudgets/web created",
                             "deployments/web created"]
        assert 0 < b["p50"] <= b["p99"] and b["pods_s"] > 0
