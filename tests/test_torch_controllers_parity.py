"""The port's controllers, proxier, hollow kubelet and cron parser against
the JAX package's, on the CPU.

Each scenario is written once over a package's modules and runs on
`kubernetes_tpu` and on `kubernetes_tpu_torch` with the same inputs: the
cases of `tests/test_torch_controllers.py` (the JAX package's controller
tests with the port's imports), each driving one controller (or the
proxier, the hollow kubelet, the cron parser) through its states. Every
controller that reads a clock gets a FakeClock at the same start. After a
scenario, every object of every kind in its store (each package's
`serde.to_dict`) and what the scenario read along the way (pump counts,
routes, schedule times, refusals) must be equal between the packages. The
process-global pod-name and pod-uid counters and the event-name sequence
are reset before each run (`test_torch_cluster.reset_counters`).
"""
import contextlib
import importlib
import io
import json
import urllib.error
import urllib.request

import pytest

from tests.test_torch_cluster import _modules, reset_counters

GI = 1024 ** 3
PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")


def ctl(m, name):
    """Package `m`'s `controllers.<name>` module."""
    return importlib.import_module(f"{m.pkg}.controllers.{name}")


def mod(m, path):
    return importlib.import_module(f"{m.pkg}.{path}")


def dump(m, store):
    """{kind: {key: serde dict}} of every kind in `store`."""
    return {kind: {o.key: m.serde.to_dict(o) for o in store.list(kind)[0]}
            for kind in m.serde.KIND_TYPES}


def sel(m, **labels):
    return m.T.LabelSelector(match_labels=tuple(labels.items()))


def node(m, name, **kw):
    kw.setdefault("allocatable", {"cpu": 4000, "memory": 8 * GI,
                                  "pods": 110})
    return m.T.Node(name=name, **kw)


def bound_pod(m, name, node_name, labels=None, owner=None, cpu=100, **kw):
    return m.T.Pod(name=name, node_name=node_name, labels=labels or {},
                   owner_ref=owner, containers=(m.T.Container.make(
                       name="c", requests={"cpu": cpu}),), **kw)


def template(m, app, cpu=None, **kw):
    containers = (m.T.Container.make(name="c", requests={"cpu": cpu}),) \
        if cpu is not None else ()
    return m.T.PodTemplate(labels={"app": app}, containers=containers, **kw)


def set_phase(m, store, key, phase):
    def mutate(cur):
        cur.phase = phase
        return cur
    store.guaranteed_update(m.S.PODS, key, mutate)


def update(m, store, kind, key, **fields):
    def mutate(cur):
        for f, v in fields.items():
            setattr(cur, f, v)
        return cur
    store.guaranteed_update(kind, key, mutate)


def pod_keys(m, store):
    return sorted(p.key for p in store.list(m.S.PODS)[0])


# -- the scenarios: each returns ({name: store}, what it read) ---------------
def disruption(m):
    """tests/test_controllers.py TestPDBStatusMath: min_available as a count
    and as a percent of the controller's scale, max_unavailable, a percent
    with no controller (fails closed), an unready pod, a spec-less PDB,
    then a pod deleted."""
    T, S = m.T, m.S
    store = m.S.Store()
    dc = ctl(m, "disruption").DisruptionController(store)
    store.create(S.REPLICASETS, T.ReplicaSet(
        name="rs", selector=sel(m, app="pct"), replicas=4))
    store.create(S.REPLICASETS, T.ReplicaSet(
        name="rs5", selector=sel(m, app="mu"), replicas=5))
    for name, app, kw in (("int", "db", {"min_available": 2}),
                          ("pct", "pct", {"min_available": "50%"}),
                          ("mu", "mu", {"max_unavailable": 1}),
                          ("closed", "lone", {"min_available": "50%",
                                              "disruptions_allowed": 7}),
                          ("ready", "rdy", {"min_available": 1}),
                          ("bare", "db", {"disruptions_allowed": 3})):
        store.create(S.PDBS, T.PodDisruptionBudget(
            name=name, selector=sel(m, app=app), **kw))
    for i in range(3):
        store.create(S.PODS, bound_pod(m, f"db{i}", f"n{i}", {"app": "db"}))
        store.create(S.PODS, bound_pod(m, f"pct{i}", f"n{i}", {"app": "pct"},
                                       owner=("ReplicaSet", "rs", "u1")))
    for i in range(5):
        store.create(S.PODS, bound_pod(m, f"mu{i}", f"n{i}", {"app": "mu"},
                                       owner=("ReplicaSet", "rs5", "u2")))
    store.create(S.PODS, bound_pod(m, "lone", "n0", {"app": "lone"}))
    store.create(S.PODS, bound_pod(m, "rdy0", "n0", {"app": "rdy"},
                                   conditions=(T.PodCondition(
                                       type="Ready", status="False"),)))
    store.create(S.PODS, bound_pod(m, "rdy1", "n1", {"app": "rdy"}))
    dc.sync()
    seen = []
    store.delete(S.PODS, "default/db2")
    seen += [dc.pump(), dc.pump(), dc.pump()]
    return {"store": store}, seen


def nodelifecycle(m):
    """TestNodeLifecycle: a node NotReady gets its taints and loses them
    when Ready again; a node Unknown evicts the pods that do not tolerate
    it at once, the ones with tolerationSeconds when those run out."""
    T, S = m.T, m.S
    nl = ctl(m, "nodelifecycle")
    store = S.Store()
    ready = (T.NodeCondition(type="Ready", status="True"),)
    for name in ("n0", "n1", "n2"):
        store.create(S.NODES, node(m, name, conditions=ready))
    clock = m.clock.FakeClock(1000.0)
    c = nl.NodeLifecycleController(store, clock=clock, eviction_rate=1.0)
    forever = T.Toleration(key=nl.TAINT_UNREACHABLE,
                           op=T.TOLERATION_OP_EXISTS, effect="NoExecute")
    five = T.Toleration(key=nl.TAINT_UNREACHABLE, op=T.TOLERATION_OP_EXISTS,
                        effect="NoExecute", toleration_seconds=5)
    store.create(S.PODS, bound_pod(m, "doomed", "n0"))
    store.create(S.PODS, bound_pod(m, "tolerant", "n0",
                                   tolerations=(forever,)))
    store.create(S.PODS, bound_pod(m, "bounded", "n0", tolerations=(five,)))
    c.sync()
    seen = []
    for name, status in (("n2", "False"), ("n0", "Unknown")):
        update(m, store, S.NODES, name,
               conditions=(T.NodeCondition(type="Ready", status=status),))
    seen.append(c.pump())
    seen.append(pod_keys(m, store))
    clock.step(6)
    seen.append(c.pump())
    seen.append(pod_keys(m, store))
    update(m, store, S.NODES, "n2", conditions=ready)
    seen.append(c.pump())
    return {"store": store}, seen


def podgc(m):
    """TestPodGC and TestPodGCNodeLost: the orphan of a gone node, a
    terminating pod never scheduled, terminated pods over the threshold;
    then a node deleted under a running pod."""
    S = m.S
    store = S.Store()
    store.create(S.NODES, node(m, "n0"))
    store.create(S.NODES, node(m, "n1"))
    store.create(S.PODS, bound_pod(m, "orphan", "ghost-node"))
    t = m.T.Pod(name="terminating")
    t.deleted = True
    store.create(S.PODS, t)
    for i, ts in ((0, 5.0), (1, 9.0)):
        store.create(S.PODS, bound_pod(m, f"done{i}", "n0", phase="Succeeded",
                                       creation_timestamp=ts))
    store.create(S.PODS, bound_pod(m, "runner", "n1", phase="Running"))
    gc = ctl(m, "podgc").PodGCController(store, terminated_pod_threshold=1)
    gc.sync()
    seen = [pod_keys(m, store)]
    store.delete(S.NODES, "n1")
    seen.append(gc.pump())
    return {"store": store}, seen


def replicaset(m):
    """TestReplicaSetController: a scale-up of owned pods, a scale-down
    that takes the unscheduled pod first and then the youngest, and a
    vanished pod replaced."""
    T, S = m.T, m.S
    store = S.Store()
    rsc = ctl(m, "replicaset").ReplicaSetController(store)
    store.create(S.PODS, bound_pod(m, "old", "n0", {"app": "web"},
                                   creation_timestamp=1.0))
    store.create(S.PODS, bound_pod(m, "young", "n1", {"app": "web"},
                                   creation_timestamp=9.0))
    store.create(S.PODS, T.Pod(name="pending", labels={"app": "web"}))
    store.create(S.REPLICASETS, T.ReplicaSet(
        name="web", selector=sel(m, app="web"), replicas=2))
    store.create(S.REPLICASETS, T.ReplicaSet(
        name="api", selector=sel(m, app="api"), replicas=3,
        template=template(m, "api", 100)))
    rsc.sync()
    seen = [pod_keys(m, store)]
    update(m, store, S.REPLICASETS, "default/web", replicas=1)
    seen.append(rsc.pump())
    store.delete(S.PODS, [k for k in pod_keys(m, store)
                          if k.startswith("default/api-")][0])
    seen.append(rsc.pump())
    return {"store": store}, seen


def deployment(m):
    """TestDeploymentController: create, scale and status; a rolling
    update inside its surge / unavailable envelope (the live pods after
    each pump); Recreate; a both-zero envelope's InvalidSpec event."""
    T, S = m.T, m.S
    store = S.Store()
    dc = ctl(m, "deployment").DeploymentController(store)
    rsc = ctl(m, "replicaset").ReplicaSetController(store)
    dc.sync()
    rsc.sync()
    seen = []

    def run_all():
        for p in store.list(S.PODS)[0]:
            if p.phase != "Running":
                set_phase(m, store, p.key, "Running")

    def pump(rounds=20):
        for _ in range(rounds):
            n = dc.pump() + rsc.pump()
            seen.append((n, len([p for p in store.list(S.PODS)[0]
                                 if not p.deleted])))
            run_all()
            if n == 0:
                return
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="web", replicas=3, selector=sel(m, app="web"),
        template=template(m, "web"), max_surge=1, max_unavailable=1))
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="db", replicas=2, selector=sel(m, app="db"),
        template=template(m, "db"), strategy="Recreate"))
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="bad", replicas=2, selector=sel(m, app="bad"),
        template=template(m, "bad"), max_surge=0, max_unavailable=0))
    pump()
    update(m, store, S.DEPLOYMENTS, "default/web", replicas=5)
    pump()
    update(m, store, S.DEPLOYMENTS, "default/web",
           template=template(m, "web", 250))
    update(m, store, S.DEPLOYMENTS, "default/db",
           template=template(m, "db", 300))
    pump()
    return {"store": store}, seen


def job(m):
    """TestJobController: completions under a parallelism cap, a backoff
    limit that fails the Job, and a TTL after it finishes."""
    T, S = m.T, m.S
    store = S.Store()
    clock = m.clock.FakeClock(100.0)
    jc = ctl(m, "job").JobController(store, clock=clock)
    jc.sync()
    store.create(S.JOBS, T.Job(name="work", completions=5, parallelism=2,
                               template=template(m, "work")))
    store.create(S.JOBS, T.Job(name="flaky", completions=1, parallelism=1,
                               backoff_limit=2,
                               template=template(m, "flaky")))
    store.create(S.JOBS, T.Job(name="gone", completions=1, parallelism=1,
                               ttl_seconds_after_finished=30,
                               template=template(m, "gone")))
    seen = [jc.pump()]
    for _ in range(6):
        for p in store.list(S.PODS)[0]:
            if p.phase == "Pending":
                set_phase(m, store, p.key, "Failed"
                          if p.labels["app"] == "flaky" else "Succeeded")
        clock.step(10)
        seen.append((jc.pump(), pod_keys(m, store)))
    clock.step(31)
    seen.append(jc.pump())
    return {"store": store}, seen


def daemonset(m):
    """TestDaemonSetController and TestDaemonSetPredicateDrift: one pod a
    node the selector and taints admit, a toleration that admits a
    tainted node, a node joining and leaving."""
    T, S = m.T, m.S
    store = S.Store()
    for i in range(4):
        taints = (T.Taint(key="gpu", value="true", effect=T.NO_SCHEDULE),) \
            if i == 3 else ()
        store.create(S.NODES, node(
            m, f"n{i}", taints=taints,
            labels={"role": "worker" if i < 3 else "infra"}))
    store.create(S.NODES, node(m, "t0", taints=(T.Taint(
        key="ded", value="x", effect=T.NO_SCHEDULE),)))
    store.create(S.NODES, node(m, "small", labels={"role": "worker"},
                               allocatable={"cpu": 50, "memory": GI,
                                            "pods": 110}))
    dsc = ctl(m, "daemonset").DaemonSetController(store)
    dsc.sync()
    store.create(S.DAEMONSETS, T.DaemonSet(
        name="agent", selector=sel(m, app="agent"),
        template=template(m, "agent", 100,
                          node_selector={"role": "worker"})))
    store.create(S.DAEMONSETS, T.DaemonSet(
        name="log", selector=sel(m, app="log"),
        template=template(m, "log", tolerations=(T.Toleration(
            key="ded", value="x", effect=T.NO_SCHEDULE),))))
    seen = [dsc.pump()]
    store.create(S.NODES, node(m, "n9", labels={"role": "worker"}))
    seen.append(dsc.pump())
    store.delete(S.NODES, "n9")
    seen.append(dsc.pump())
    return {"store": store}, seen


def statefulset(m):
    """TestStatefulSetController: ordered, readiness-gated scale-up and a
    scale-down from the highest ordinal."""
    T, S = m.T, m.S
    store = S.Store()
    sc = ctl(m, "statefulset").StatefulSetController(store)
    sc.sync()
    store.create(S.STATEFULSETS, T.StatefulSet(
        name="db", replicas=3, selector=sel(m, app="db"),
        template=template(m, "db")))
    seen = [sc.pump(), pod_keys(m, store)]
    for i in range(3):
        set_phase(m, store, f"default/db-{i}", "Running")
        seen += [sc.pump(), pod_keys(m, store)]
    update(m, store, S.STATEFULSETS, "default/db", replicas=1)
    seen += [sc.pump(), sc.pump(), pod_keys(m, store)]
    return {"store": store}, seen


def endpoints_and_proxier(m):
    """TestEndpointsController, TestProxierTable and
    TestEndpointsToProxyFlow: the Endpoints follow the Service's ready
    pods, every node's table follows the Endpoints, routes round-robin,
    a Service without endpoints rejects, a deleted Service's chain goes."""
    T, S = m.T, m.S
    store = S.Store()
    for i in range(3):
        store.create(S.NODES, node(m, f"n{i}"))
    epc = ctl(m, "endpoints").EndpointsController(store)
    store.create(S.SERVICES, T.Service(name="web", selector={"app": "web"}))
    store.create(S.SERVICES, T.Service(name="idle", selector={"app": "no"}))
    for i in range(3):
        store.create(S.PODS, bound_pod(m, f"w{i}", f"n{i}", {"app": "web"}))
    store.create(S.PODS, bound_pod(m, "sick", "n0", {"app": "web"},
                                   conditions=(T.PodCondition(
                                       type="Ready", status="False"),)))
    store.create(S.PODS, T.Pod(name="unbound", labels={"app": "web"}))
    epc.sync()
    proxies = [mod(m, "proxy.proxier").VirtualProxier(store, f"n{i}")
               for i in range(3)]
    for p in proxies:
        p.sync()
    seen = [[p.rules() for p in proxies],
            [proxies[0].route("default/web") for _ in range(5)],
            proxies[1].route("default/idle")]
    store.delete(S.PODS, "default/w1")
    update(m, store, S.PODS, "default/sick",
           conditions=(T.PodCondition(type="Ready", status="True"),))
    seen.append(epc.pump())
    seen.append([p.pump() for p in proxies])
    seen.append([p.backends("default/web") for p in proxies])
    store.delete(S.SERVICES, "default/web")
    seen += [epc.pump(), [p.pump() for p in proxies],
             [p.rules() for p in proxies], proxies[2].route("default/web")]
    return {"store": store}, seen


def resourcequota(m):
    """TestResourceQuota and TestQuotaAdmissionCAS: the usage reconciled,
    a create over the quota refused by the apiserver's admission (its
    status and message), one inside it admitted, a terminated pod leaving
    the usage."""
    T, S = m.T, m.S
    store = S.Store()
    rqc = ctl(m, "resourcequota").ResourceQuotaController(store)
    store.create(S.RESOURCEQUOTAS, T.ResourceQuota(
        name="q", hard={"cpu": 1000, "pods": 3}))
    store.create(S.PODS, bound_pod(m, "a", "n0", cpu=400))
    store.create(S.PODS, bound_pod(m, "b", "n0", cpu=400))
    rqc.sync()
    seen = []
    with m.server.APIServer(store) as srv:
        for name, cpu in (("c", 300), ("d", 150), ("e", 10)):
            body = json.dumps(m.serde.to_dict(
                bound_pod(m, name, "", cpu=cpu))).encode()
            req = urllib.request.Request(
                f"{srv.url}/api/v1/pods", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as resp:
                    seen.append((name, resp.status))
            except urllib.error.HTTPError as e:
                seen.append((name, e.code,
                             json.loads(e.read())["message"]))
    seen.append(rqc.pump())
    set_phase(m, store, "default/a", "Succeeded")
    seen.append(rqc.pump())
    return {"store": store}, seen


def namespace(m):
    """TestNamespaceLifecycle: the ServiceAccount controller provisions a
    new namespace's default account; the apiserver's DELETE marks the
    namespace Terminating and the namespace controller empties and
    removes it, leaving other namespaces alone."""
    T, S = m.T, m.S
    ns = ctl(m, "namespace")
    store = S.Store()
    nc, sac = ns.NamespaceController(store), ns.ServiceAccountController(store)
    nc.sync()
    sac.sync()
    store.create(S.NAMESPACES, T.Namespace(name="team-a"))
    store.create(S.NAMESPACES, T.Namespace(name="team-b"))
    seen = [sac.pump()]
    store.create(S.PODS, bound_pod(m, "p1", "n0"))
    for n in ("team-a", "team-b"):
        store.create(S.PODS, bound_pod(m, "p2", "n0", namespace=n))
        store.create(S.CONFIGMAPS, T.ConfigMap(name="cfg", namespace=n))
    with m.server.APIServer(store) as srv:
        urllib.request.urlopen(urllib.request.Request(
            f"{srv.url}/api/v1/namespaces/team-a", method="DELETE"))
    seen.append(store.get(S.NAMESPACES, "team-a").phase)
    seen += [nc.pump(), sac.pump()]
    return {"store": store}, seen


def garbagecollector(m):
    """TestGarbageCollector and TestCronSchedule's GC case: a deleted
    Deployment cascades to its ReplicaSet and pods, a deleted ReplicaSet
    to its pods, a deleted CronJob to its Jobs and their pods."""
    T, S = m.T, m.S
    store = S.Store()
    clock = m.clock.FakeClock(30.0)
    dc = ctl(m, "deployment").DeploymentController(store)
    rsc = ctl(m, "replicaset").ReplicaSetController(store)
    jc = ctl(m, "job").JobController(store, clock=clock)
    cjc = ctl(m, "cronjob").CronJobController(store, clock=clock)
    gc = ctl(m, "garbagecollector").GarbageCollector(store)
    loops = (dc, rsc, jc, cjc, gc)
    for c in loops:
        c.sync()
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="web", replicas=3, selector=sel(m, app="web"),
        template=template(m, "web")))
    store.create(S.REPLICASETS, T.ReplicaSet(
        name="app", selector=sel(m, app="app"), replicas=2,
        template=template(m, "app")))
    store.create(S.CRONJOBS, T.CronJob(name="t", schedule="*/10 * * * *",
                                       template=template(m, "t", 50)))
    seen = []
    for _ in range(4):
        seen.append([c.pump() for c in loops])
        clock.step(600.0)
    seen.append(dump(m, store))
    store.delete(S.DEPLOYMENTS, "default/web")
    store.delete(S.REPLICASETS, "default/app")
    store.delete(S.CRONJOBS, "default/t")
    seen += [gc.pump(), gc.pump()]
    return {"store": store}, seen


def cronjob(m):
    """TestCronJobController: runs on schedule and not twice a minute;
    Forbid, Replace and Allow against an active Job; 200 missed minutes
    reset the cursor; a prefix-named sibling's Jobs are not adopted; a
    suspended CronJob runs nothing."""
    T, S = m.T, m.S
    store = S.Store()
    clock = m.clock.FakeClock(30.0)
    c = ctl(m, "cronjob").CronJobController(store, clock=clock)
    c.sync()
    for name, kw in (("tick", {}), ("forbid", {"concurrency_policy":
                                               "Forbid"}),
                     ("build", {"concurrency_policy": "Replace"}),
                     ("build-nightly", {}),
                     ("idle", {"suspend": True})):
        store.create(S.CRONJOBS, T.CronJob(name=name,
                                           schedule="*/10 * * * *",
                                           template=template(m, name, 50),
                                           **kw))
    store.create(S.CRONJOBS, T.CronJob(name="minutely", schedule="* * * * *",
                                       template=template(m, "min", 50)))
    seen = [c.pump()]
    for step in (600.0, 0.0, 600.0, 200 * 60.0, 60.0):
        clock.step(step)
        seen.append((c.pump(), sorted(j.name for j in
                                      store.list(S.JOBS)[0])))
    return {"store": store}, seen


def ttl(m):
    """TestTTLController: the annotation by cluster size, stepping up past
    a boundary's sizeMax and down only below its sizeMin."""
    S = m.S
    store = S.Store()
    for i in range(5):
        store.create(S.NODES, node(m, f"n{i}"))
    c = ctl(m, "ttl").TTLController(store)
    c.sync()
    seen = []
    for i in range(5, 120):
        store.create(S.NODES, node(m, f"n{i}"))
    seen.append(c.pump())
    for lo, hi in ((95, 120), (85, 95)):
        for i in range(lo, hi):
            store.delete(S.NODES, f"n{i}")
        seen.append(c.pump())
    return {"store": store}, seen


def pvbinder(m):
    """TestPersistentVolumeBinder: the smallest fitting volume, a claim
    pending until a volume appears, storage-class and capacity filters,
    a released volume not bound again."""
    T, S = m.T, m.S
    store = S.Store()
    for name, cap, cls in (("big", 100, ""), ("small", 10, ""),
                           ("fast", 10, "ssd"), ("tiny", 1, "")):
        store.create(S.PVS, T.PersistentVolume(name=name, capacity=cap * GI,
                                               storage_class=cls))
    c = ctl(m, "pvbinder").PersistentVolumeBinder(store)
    c.sync()
    for name, req, cls in (("c1", 5, ""), ("c2", 5, "ssd"),
                           ("c3", 200, ""), ("c4", 5, "gold")):
        store.create(S.PVCS, T.PersistentVolumeClaim(
            name=name, request=req * GI, storage_class=cls))
    seen = [c.pump()]
    store.create(S.PVS, T.PersistentVolume(name="huge", capacity=300 * GI))
    seen.append(c.pump())
    store.delete(S.PVCS, "default/c1")
    store.create(S.PVCS, T.PersistentVolumeClaim(name="c5", request=5 * GI))
    seen.append(c.pump())
    return {"store": store}, seen


def hpa(m):
    """TestHPAController: a scale-up on high utilization, inside the
    tolerance band and just past it, a scale-down clamped at the minimum and a scale-up at the
    maximum, metric-less pods counted as full on the way down."""
    T, S = m.T, m.S
    store = S.Store()
    clock = m.clock.FakeClock(1000.0)
    c = ctl(m, "hpa").HorizontalPodAutoscalerController(store, clock=clock)
    c.sync()
    for app, replicas in (("up", 3), ("band", 4), ("edge", 4), ("down", 8),
                          ("gaps", 4)):
        store.create(S.DEPLOYMENTS, T.Deployment(
            name=app, replicas=replicas, selector=T.LabelSelector.from_dict(
                {"app": app}), template=template(m, app, 200)))
        for i in range(replicas):
            store.create(S.PODS, T.Pod(
                name=f"{app}-{i}", labels={"app": app},
                containers=(T.Container.make(name="c",
                                             requests={"cpu": 200}),)))
        store.create(S.HPAS, T.HorizontalPodAutoscaler(
            name=app, scale_target_ref=("Deployment", app), min_replicas=1,
            max_replicas=10, target_cpu_utilization=50))
    usage = {"up": [200] * 3, "band": [105] * 4, "edge": [115] * 4,
             "down": [10] * 8, "gaps": [20, 20]}
    for app, values in usage.items():
        for i, u in enumerate(values):
            store.create(S.PODMETRICS, T.PodMetrics(name=f"{app}-{i}",
                                                    cpu_usage=u))
    seen = [c.pump()]
    clock.step(600.0)
    for i in range(8):
        update(m, store, S.PODMETRICS, f"default/down-{i}", cpu_usage=2000)
    seen.append(c.pump())
    return {"store": store}, seen


def podgroup(m):
    """TestPodGroupController: Pending, PreScheduling and Scheduled with
    live counts, back below minMember when a member goes; a group that
    times out is Unschedulable with a GangTimeout event, and recovers
    when its members bind."""
    T, S, G = m.T, m.S, m.gang
    store = S.Store(watch_log_size=65536)
    clock = m.clock.FakeClock(100.0)
    c = ctl(m, "podgroup").PodGroupController(store, clock=clock)
    store.create(S.PODGROUPS, G.PodGroup(name="g", min_member=2,
                                         creation_timestamp=100.0))
    store.create(S.PODGROUPS, G.PodGroup(name="late", min_member=3,
                                         schedule_timeout_seconds=30.0,
                                         creation_timestamp=100.0))
    c.sync()

    def member(name, group, **kw):
        return T.Pod(name=name, labels={G.LABEL_POD_GROUP: group},
                     containers=(T.Container.make(
                         name="c", requests={"cpu": 100}),), **kw)
    seen = []
    for name, group in (("m0", "g"), ("l0", "late"), ("m1", "g")):
        store.create(S.PODS, member(name, group))
        seen.append(c.pump())
    for j in range(2):
        store.bind_pod(f"default/m{j}", "n0")
    seen.append(c.pump())
    store.delete(S.PODS, "default/m1")
    clock.step(31.0)
    store.create(S.PODS, member("l1", "late"))
    seen.append(c.pump())
    for j in range(2):
        store.bind_pod(f"default/l{j}", "n0")
    store.create(S.PODS, member("l2", "late", node_name="n1"))
    seen.append(c.pump())
    return {"store": store}, seen


def aggregation(m):
    """TestStoreBackedRBAC's aggregation case: the aggregated role holds
    the union of the labelled roles' rules, a new labelled role adds its
    rules, a role that loses its label or is deleted takes them away."""
    S, A = m.S, m.auth
    store = S.Store()
    c = ctl(m, "clusterrole_aggregation").ClusterRoleAggregationController(
        store)
    c.sync()
    agg = {"rbac/aggregate": "true"}
    store.create(S.CLUSTERROLES, A.Role(name="admin",
                                        aggregation_labels=dict(agg)))
    store.create(S.CLUSTERROLES, A.Role(name="view",
                                        aggregation_labels={"rbac/v": "1"}))
    seen = []
    for name, verbs, res in (("pods-reader", ("get",), ("pods",)),
                             ("both", ("get",), ("pods",)),
                             ("nodes-reader", ("list",), ("nodes",))):
        store.create(S.CLUSTERROLES, A.Role(
            name=name, labels={**agg, "rbac/v": "1"},
            rules=(A.PolicyRule(verbs=verbs, resources=res),)))
        seen.append(c.pump())
    update(m, store, S.CLUSTERROLES, "nodes-reader", labels={"rbac/v": "1"})
    seen.append(c.pump())
    store.delete(S.CLUSTERROLES, "pods-reader")
    seen.append(c.pump())
    return {"store": store}, seen


def nodeipam(m):
    """TestNodeIpam: disjoint /24s, a deleted node's range reused by a
    newcomer."""
    S = m.S
    store = S.Store()
    for i in range(5):
        store.create(S.NODES, node(m, f"n{i}"))
    c = ctl(m, "nodeipam").NodeIpamController(store)
    c.sync()
    store.delete(S.NODES, "n2")
    store.create(S.NODES, node(m, "n9"))
    store.create(S.NODES, node(m, "n10"))
    return {"store": store}, [c.pump()]


def hollow_kubelet(m):
    """TestHollowKubeletRunsPods and TestHeartbeatLeases: the kubelet's
    heartbeat renews its lease and keeps its node Ready, runs the Pending
    pods bound to it; a stopped kubelet renews nothing."""
    T, S = m.T, m.S
    hollow = mod(m, "models.hollow")
    store = S.Store()
    clock = m.clock.FakeClock(500.0)
    for i in range(2):
        store.create(S.NODES, node(m, f"n{i}"))
    kubelets = [hollow.HollowKubelet(store, f"n{i}", clock=clock)
                for i in range(2)]
    store.create(S.PODS, bound_pod(m, "a", "n0"))
    store.create(S.PODS, bound_pod(m, "b", "n1"))
    store.create(S.PODS, T.Pod(name="pending"))
    for k in kubelets:
        k.heartbeat()
    clock.step(10.0)
    kubelets[1].stop()
    store.create(S.PODS, bound_pod(m, "c", "n1"))
    for k in kubelets:
        k.heartbeat()
    return {"store": store}, []


def cron(m):
    """TestCronSchedule: matches, the next run after a time, parse errors,
    Sunday as 7, day-of-week ranges through 7, UTC, a star step counting
    as a star for the day-of-month / day-of-week rule."""
    cs = mod(m, "utils.cron")
    seen = []
    for expr in ("* * * * *", "*/15 * * * *", "30 2 * * *", "0 0 1 1 *",
                 "0-10/5 * * * *", "* * * * 4", "* * * * 5", "* * 1 * 5",
                 "0 12 * * 7", "0 0 * * 5-7", "*/2 * */3 * *",
                 "0 9 * * 1-5", "15,45 */6 13 * 0"):
        s = cs.CronSchedule(expr)
        seen.append([expr, [s.matches(t) for t in
                            range(0, 8 * 86400, 3 * 3600 + 7 * 60)],
                     s.next_after(0), s.next_after(1_000_000.0)])
    for expr in ("", "* * * *", "60 * * * *", "* 24 * * *", "*/0 * * * *",
                 "a * * * *", "5-1 * * * *", "* * 0 * *", "* * * 13 *"):
        try:
            cs.CronSchedule(expr)
            seen.append([expr, None])
        except cs.CronParseError as e:
            seen.append([expr, str(e)])
    return {}, seen


def manager(m):
    """The controller manager: every controller of CONTROLLER_INITIALIZERS,
    in its order, over one store, pumped until it settles: a Deployment
    rolled out to its pods, a DaemonSet's pods, a Service's Endpoints, a
    PDB's status beside them."""
    T, S = m.T, m.S
    store = S.Store()
    for i in range(3):
        store.create(S.NODES, node(m, f"n{i}"))
    mgr = ctl(m, "manager").ControllerManager(store)
    clock = m.clock.FakeClock(0.0)
    for c in mgr.controllers.values():
        if hasattr(c, "clock"):
            c.clock = clock
    mgr.sync()
    store.create(S.DEPLOYMENTS, T.Deployment(
        name="web", replicas=3, selector=sel(m, app="web"),
        template=template(m, "web", 100)))
    store.create(S.DAEMONSETS, T.DaemonSet(
        name="agent", selector=sel(m, app="agent"),
        template=template(m, "agent", 50)))
    store.create(S.SERVICES, T.Service(name="web", selector={"app": "web"}))
    store.create(S.PDBS, T.PodDisruptionBudget(
        name="web", selector=sel(m, app="web"), min_available=2))
    seen = [list(mgr.controllers)]
    for _ in range(8):
        clock.step(10.0)
        seen.append(mgr.pump())
        for p in store.list(S.PODS)[0]:
            if p.phase == "Pending":
                store.bind_pod(p.key, p.node_name or "n0")
                set_phase(m, store, p.key, "Running")
    return {"store": store}, seen


SCENARIOS = [disruption, nodelifecycle, podgc, replicaset, deployment, job,
             daemonset, statefulset, endpoints_and_proxier, resourcequota,
             namespace, garbagecollector, cronjob, ttl, pvbinder, hpa,
             podgroup, aggregation, nodeipam, hollow_kubelet, cron, manager]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_equals_the_jax_package(monkeypatch, scenario):
    import chip_smoke as cs
    runs = []
    for pkg in PACKAGES:
        m = _modules(pkg)
        reset_counters(monkeypatch, m)
        out = io.StringIO()
        with contextlib.redirect_stderr(out):
            stores, seen = scenario(m)
        runs.append(({k: dump(m, s) for k, s in stores.items()},
                     json.loads(json.dumps(seen, default=repr))))
    (jstores, jseen), (pstores, pseen) = runs
    assert cs.summary_diff(pstores, jstores) is None, \
        cs.summary_diff(pstores, jstores)
    assert cs.summary_diff(pseen, jseen) is None, \
        cs.summary_diff(pseen, jseen)
    # the scenario wrote something, and read what it meant to
    assert any(objs for s in pstores.values() for objs in s.values()) \
        or pseen
