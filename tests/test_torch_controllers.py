"""The port's controllers, proxier, cron parser and hollow kubelet on the
CPU: the JAX package's controller tests with the port's imports.

Sections, each a copy of the named cases with its module helpers
prefixed (so the sections' helpers of the same name do not collide):
- tests/test_controllers.py: every case;
- tests/test_autoscaling.py: every case (cron, CronJob, TTL, PV binder, HPA);
- tests/test_proxy.py: every case;
- tests/test_node_churn.py: the controller and hollow-kubelet classes;
- tests/test_coscheduling.py: TestPodGroupController and the manager case;
- tests/test_auth.py: TestNodeIpam and the clusterrole aggregation controller;
- tests/test_remote.py: the controller manager over HTTP.

Where a case runs a scheduler on the device route, it runs on the
kernels' plain versions (`device="cpu"`); a case on the oracle route
(`use_device=False`) stays there. Every server listens on 127.0.0.1
port 0 and is stopped by its test.
"""
import random
import threading
import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container, CronJob, Deployment, Endpoints, HorizontalPodAutoscaler,
    LABEL_HOSTNAME, LABEL_ZONE_FAILURE_DOMAIN, LabelSelector, Lease,
    NO_EXECUTE, NO_SCHEDULE, Node, NodeCondition, PersistentVolume,
    PersistentVolumeClaim, Pod, PodCondition, PodDisruptionBudget,
    PodMetrics, PodTemplate, ReplicaSet, Service, TOLERATION_OP_EXISTS,
    Taint, Toleration, node_lease_key,
)
from kubernetes_tpu_torch.apiserver.auth import PolicyRule, Role
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.manager import ControllerManager
from kubernetes_tpu_torch.coscheduling.types import (
    LABEL_POD_GROUP, PHASE_PENDING, PHASE_PRESCHEDULING, PHASE_SCHEDULED,
    PHASE_UNSCHEDULABLE, PodGroup,
)
from kubernetes_tpu_torch.proxy.proxier import VirtualProxier
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store.remote import RemoteStore
from kubernetes_tpu_torch.store.store import (
    CRONJOBS, DEPLOYMENTS, DisruptionBudgetError, ENDPOINTS, EVENTS, HPAS,
    JOBS, LEASES, NODES, NotFoundError, PDBS, PODGROUPS, PODMETRICS, PODS,
    PVCS, PVS, REPLICASETS, SERVICES, Store,
)
from kubernetes_tpu_torch.utils.clock import FakeClock
from kubernetes_tpu_torch.utils.cron import CronParseError, CronSchedule
from tests.torch_threads import one_torch_thread  # noqa: F401

GI = 1024 ** 3


# -- tests/test_controllers.py: every case -------------------------------------
def ctl_sel(**labels):
    return LabelSelector(match_labels=tuple(labels.items()))


def ctl_bound_pod(name, node, labels=None, owner=None, priority=0, cpu=100):
    return Pod(name=name, node_name=node, labels=labels or {},
               owner_ref=owner, priority=priority,
               containers=(Container.make(name="c", requests={"cpu": cpu}),))


def ctl_status(node):
    for c in node.conditions:
        if c.type == "Ready":
            return c.status
    return "True"


class TestPDBStatusMath:
    def _reconcile(self, store):
        dc = DisruptionController(store)
        dc.sync()
        return store

    def test_min_available_int(self):
        store = Store()
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available=2))
        for i in range(3):
            store.create(PODS, ctl_bound_pod(f"p{i}", f"n{i}", {"app": "db"}))
        self._reconcile(store)
        pdb = store.get(PDBS, "default/b")
        assert (pdb.expected_pods, pdb.current_healthy,
                pdb.desired_healthy, pdb.disruptions_allowed) == (3, 3, 2, 1)

    def test_min_available_percent_uses_controller_scale(self):
        store = Store()
        store.create(REPLICASETS, ReplicaSet(
            name="rs", selector=ctl_sel(app="db"), replicas=4))
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available="50%"))
        for i in range(3):   # only 3 of the expected 4 exist
            store.create(PODS, ctl_bound_pod(
                f"p{i}", f"n{i}", {"app": "db"}, owner=("ReplicaSet", "rs", "u1")))
        self._reconcile(store)
        pdb = store.get(PDBS, "default/b")
        # expected = scale 4; desired = ceil(50% of 4) = 2; healthy = 3
        assert (pdb.expected_pods, pdb.current_healthy,
                pdb.desired_healthy, pdb.disruptions_allowed) == (4, 3, 2, 1)

    def test_max_unavailable(self):
        store = Store()
        store.create(REPLICASETS, ReplicaSet(
            name="rs", selector=ctl_sel(app="db"), replicas=5))
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), max_unavailable=1))
        for i in range(5):
            store.create(PODS, ctl_bound_pod(
                f"p{i}", f"n{i}", {"app": "db"}, owner=("ReplicaSet", "rs", "u1")))
        self._reconcile(store)
        pdb = store.get(PDBS, "default/b")
        assert (pdb.expected_pods, pdb.desired_healthy,
                pdb.disruptions_allowed) == (5, 4, 1)

    def test_percent_scale_without_controller_fails_closed(self):
        store = Store()
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available="50%",
            disruptions_allowed=7))
        store.create(PODS, ctl_bound_pod("p0", "n0", {"app": "db"}))  # no owner
        self._reconcile(store)
        assert store.get(PDBS, "default/b").disruptions_allowed == 0

    def test_unready_pod_not_healthy(self):
        store = Store()
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available=1))
        p = ctl_bound_pod("p0", "n0", {"app": "db"})
        p.conditions = (PodCondition(type="Ready", status="False"),)
        store.create(PODS, p)
        store.create(PODS, ctl_bound_pod("p1", "n1", {"app": "db"}))
        self._reconcile(store)
        pdb = store.get(PDBS, "default/b")
        assert (pdb.current_healthy, pdb.disruptions_allowed) == (1, 0)

    def test_specless_pdb_untouched(self):
        store = Store()
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), disruptions_allowed=3))
        self._reconcile(store)
        assert store.get(PDBS, "default/b").disruptions_allowed == 3

    def test_pod_events_retrigger(self):
        store = Store()
        dc = DisruptionController(store)
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available=2))
        for i in range(3):
            store.create(PODS, ctl_bound_pod(f"p{i}", f"n{i}", {"app": "db"}))
        dc.sync()
        assert store.get(PDBS, "default/b").disruptions_allowed == 1
        store.delete(PODS, "default/p2")
        dc.pump()
        pdb = store.get(PDBS, "default/b")
        assert (pdb.current_healthy, pdb.disruptions_allowed) == (2, 0)
        # no-op pumps settle (status writes don't loop the controller)
        assert dc.pump() <= 1 and dc.pump() == 0


class TestPreemptionFollowsLiveStatus:
    """VERDICT round-3 #6 done-condition: PDB status changes mid-stream and
    the preemption victim choice follows."""

    def test_victim_choice_tracks_reconciled_pdb(self):
        from kubernetes_tpu_torch.oracle.preemption import Preemptor
        from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
        from kubernetes_tpu_torch.factory import build_predicate_set

        store = Store()
        mgr = ControllerManager(store)
        for n in ("nA", "nB", "nC"):   # podgc reaps pods on absent nodes
            store.create(NODES, Node(
                name=n, allocatable={"cpu": 1000 if n != "nC" else 4000,
                                     "memory": 8 * GI, "pods": 110}))
        store.create(PDBS, PodDisruptionBudget(
            name="db-budget", selector=ctl_sel(app="db"), min_available=2))
        # victims: vA (priority 1, PDB-covered) on nA; vB (priority 2) on nB
        va = ctl_bound_pod("va", "nA", {"app": "db"}, priority=1, cpu=1000)
        vb = ctl_bound_pod("vb", "nB", {"app": "web"}, priority=2, cpu=1000)
        extra = [ctl_bound_pod(f"db{i}", "nC", {"app": "db"}, cpu=10)
                 for i in range(2)]
        for p in (va, vb, *extra):
            store.create(PODS, p)
        mgr.sync()
        assert store.get(PDBS, "default/db-budget").disruptions_allowed == 1

        def infos():
            out = {}
            for n in ("nA", "nB", "nC"):
                out[n] = NodeInfo(Node(
                    name=n, allocatable={"cpu": 1000 if n != "nC" else 4000,
                                         "memory": 8 * GI, "pods": 110}))
            for p in store.list(PODS)[0]:
                if p.node_name in out:
                    out[p.node_name].add_pod(p)
            return out

        incoming = Pod(name="hi", priority=10, containers=(
            Container.make(name="c", requests={"cpu": 1000}),))
        err = FitError(incoming, 2, {
            "nA": ["InsufficientResource:cpu"],
            "nB": ["InsufficientResource:cpu"]})

        def preempt_once():
            pre = Preemptor(pdbs_fn=lambda: store.list(PDBS)[0])
            ni = infos()
            return pre.preempt(
                incoming, ni, ["nA", "nB"], err,
                predicate_set_fn=lambda i: build_predicate_set(
                    ["GeneralPredicates"], i))

        # allowed=1: evicting va violates nothing; va's lower priority wins
        # the minHighestVictimPriority criterion
        r1 = preempt_once()
        assert r1.node is not None and r1.node.name == "nA"

        # a covered pod disappears -> allowed drops to 0 -> va now counts as
        # a PDB violation and the choice flips to nB
        store.delete(PODS, "default/db0")
        mgr.pump()
        assert store.get(PDBS, "default/db-budget").disruptions_allowed == 0
        r2 = preempt_once()
        assert r2.node is not None and r2.node.name == "nB"


class TestNodeLifecycle:
    """Condition->taint sync + NoExecute eviction (pkg/controller/
    nodelifecycle with TaintBasedEvictions/TaintNodesByCondition on)."""

    def _store(self):
        from kubernetes_tpu_torch.api.types import Node, NodeCondition
        store = Store()
        store.create(NODES, Node(
            name="n0", allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110},
            conditions=(NodeCondition(type="Ready", status="True"),)))
        return store

    def test_not_ready_gets_taints_and_back(self):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController, TAINT_NOT_READY)
        from kubernetes_tpu_torch.api.types import NodeCondition
        store = self._store()
        c = NodeLifecycleController(store)
        c.sync()
        assert store.get(NODES, "n0").taints == ()

        def flip(status):
            def mutate(n):
                n.conditions = (NodeCondition(type="Ready", status=status),)
                return n
            store.guaranteed_update(NODES, "n0", mutate)

        flip("False")
        c.pump()
        taints = store.get(NODES, "n0").taints
        assert {t.key for t in taints} == {TAINT_NOT_READY}
        assert {t.effect for t in taints} == {"NoSchedule", "NoExecute"}
        flip("True")
        c.pump()
        assert store.get(NODES, "n0").taints == ()

    def test_unreachable_evicts_intolerant_pods(self):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController, TAINT_UNREACHABLE)
        from kubernetes_tpu_torch.api.types import (
            NodeCondition, Toleration, TOLERATION_OP_EXISTS)
        from kubernetes_tpu_torch.utils.clock import FakeClock
        store = self._store()
        # a second healthy node keeps the zone out of FullDisruption (a
        # fully-disrupted zone performs zero evictions by contract);
        # eviction_rate=1.0 covers the second (tolerationSeconds) eviction
        # within the test's 6s clock step
        store.create(NODES, Node(
            name="n1", allocatable={"cpu": 4000, "memory": 8 * GI,
                                    "pods": 110},
            conditions=(NodeCondition(type="Ready", status="True"),)))
        clock = FakeClock(1000.0)
        c = NodeLifecycleController(store, clock=clock, eviction_rate=1.0)
        tol_forever = Toleration(key=TAINT_UNREACHABLE,
                                 op=TOLERATION_OP_EXISTS, effect="NoExecute")
        tol_5s = Toleration(key=TAINT_UNREACHABLE, op=TOLERATION_OP_EXISTS,
                            effect="NoExecute", toleration_seconds=5)
        store.create(PODS, ctl_bound_pod("doomed", "n0"))
        p2 = ctl_bound_pod("tolerant", "n0")
        p2.tolerations = (tol_forever,)
        store.create(PODS, p2)
        p3 = ctl_bound_pod("bounded", "n0")
        p3.tolerations = (tol_5s,)
        store.create(PODS, p3)
        c.sync()

        def mutate(n):
            n.conditions = (NodeCondition(type="Ready", status="Unknown"),)
            return n
        store.guaranteed_update(NODES, "n0", mutate)
        c.pump()
        keys = {p.key for p in store.list(PODS)[0]}
        assert "default/doomed" not in keys       # evicted immediately
        assert {"default/tolerant", "default/bounded"} <= keys
        clock.step(6)
        c.pump()
        keys = {p.key for p in store.list(PODS)[0]}
        assert "default/bounded" not in keys      # tolerationSeconds expired
        assert "default/tolerant" in keys


class TestPodGC:
    def test_three_sweeps(self):
        from kubernetes_tpu_torch.controllers.podgc import PodGCController
        from kubernetes_tpu_torch.api.types import Node
        store = Store()
        store.create(NODES, Node(name="n0", allocatable={"cpu": 1}))
        # orphaned (node gone)
        store.create(PODS, ctl_bound_pod("orphan", "ghost-node"))
        # terminating, never scheduled
        t = Pod(name="terminating")
        t.deleted = True
        store.create(PODS, t)
        # terminated beyond threshold=1 (older one goes)
        for i, ts in ((0, 5.0), (1, 9.0)):
            p = ctl_bound_pod(f"done{i}", "n0")
            p.phase = "Succeeded"
            p.creation_timestamp = ts
            store.create(PODS, p)
        gc = PodGCController(store, terminated_pod_threshold=1)
        gc.sync()
        keys = {p.key for p in store.list(PODS)[0]}
        assert keys == {"default/done1"}


class TestFailureDetectionEndToEnd:
    """kubelet heartbeat -> lease staleness -> Ready=Unknown ->
    unreachable taints -> eviction -> rescheduling elsewhere: the full
    failure-detection/recovery story (nodelifecycle monitorNodeHealth +
    NoExecuteTaintManager + the scheduler shell)."""

    def test_node_failure_evicts_and_reschedules(self):
        from kubernetes_tpu_torch.models.hollow import HollowKubelet
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController, TAINT_UNREACHABLE)
        from kubernetes_tpu_torch.scheduler import Scheduler
        from kubernetes_tpu_torch.utils.clock import FakeClock

        clock = FakeClock(1000.0)
        store = Store()
        for name in ("n0", "n1"):
            store.create(NODES, Node(
                name=name,
                allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
        kubelets = {n: HollowKubelet(store, n, clock=clock)
                    for n in ("n0", "n1")}
        for k in kubelets.values():
            k.heartbeat()
        lifecycle = NodeLifecycleController(store, clock=clock)
        lifecycle.sync()
        sched = Scheduler(store, use_device=False, clock=clock,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        store.create(PODS, Pod(name="w", labels={"app": "w"}, containers=(
            Container.make(name="c", requests={"cpu": 100}),)))
        sched.pump()
        assert sched.schedule_one(timeout=0.0)
        sched.pump()
        first_node = store.get(PODS, "default/w").node_name
        assert first_node in ("n0", "n1")

        # the hosting node's kubelet dies; the survivor keeps heartbeating
        kubelets[first_node].stop()
        for _ in range(3):
            clock.step(20)
            for k in kubelets.values():
                k.heartbeat()
            lifecycle.pump()
        node = store.get(NODES, first_node)
        assert any(c.type == "Ready" and c.status == "Unknown"
                   for c in node.conditions)
        assert {t.key for t in node.taints} == {TAINT_UNREACHABLE}
        # the pod was evicted and recreated by its "controller" (here: us)
        assert "default/w" not in {p.key for p in store.list(PODS)[0]}
        store.create(PODS, Pod(name="w2", labels={"app": "w"}, containers=(
            Container.make(name="c", requests={"cpu": 100}),)))
        sched.pump()
        assert sched.schedule_one(timeout=0.0)
        sched.pump()
        other = store.get(PODS, "default/w2").node_name
        assert other != first_node   # tainted node avoided

        # recovery: kubelet returns, heartbeat restores Ready, taints clear
        kubelets[first_node]._stopped = False
        kubelets[first_node].heartbeat()
        lifecycle.pump()
        node = store.get(NODES, first_node)
        assert ctl_status(node) == "True"
        assert node.taints == ()


class TestReplicaSetController:
    """Workload reconciliation (pkg/controller/replicaset): scale up by
    creating owned pods, scale down deleting the least keep-worthy, and
    replace pods that vanish — feeding the scheduler + PDB scale walk."""

    def test_scale_up_schedule_and_replace(self):
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        from kubernetes_tpu_torch.scheduler import Scheduler
        store = Store()
        for i in range(3):
            store.create(NODES, Node(
                name=f"n{i}",
                allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
        rsc = ReplicaSetController(store)
        store.create(REPLICASETS, ReplicaSet(
            name="web", selector=ctl_sel(app="web"), replicas=3))
        rsc.sync()
        pods = store.list(PODS)[0]
        assert len(pods) == 3
        assert all(p.owner_ref == ("ReplicaSet", "web", "rs-web")
                   and p.labels == {"app": "web"} for p in pods)
        sched = Scheduler(store, use_device=False,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        sched.pump()
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        assert all(p.node_name for p in store.list(PODS)[0])
        # a pod vanishes (node failure / eviction): the controller replaces it
        gone = store.list(PODS)[0][0]
        store.delete(PODS, gone.key)
        rsc.pump()
        assert len(store.list(PODS)[0]) == 3

    def test_scale_down_prefers_unscheduled_then_youngest(self):
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        store = Store()
        rsc = ReplicaSetController(store)
        old = ctl_bound_pod("old", "n0", {"app": "web"})
        old.creation_timestamp = 1.0
        young = ctl_bound_pod("young", "n1", {"app": "web"})
        young.creation_timestamp = 9.0
        pending = Pod(name="pending", labels={"app": "web"})
        for p in (old, young, pending):
            store.create(PODS, p)
        store.create(REPLICASETS, ReplicaSet(
            name="web", selector=ctl_sel(app="web"), replicas=2))
        rsc.sync()
        keys = {p.key for p in store.list(PODS)[0]}
        assert keys == {"default/old", "default/young"}  # pending went first
        def shrink(r):
            r.replicas = 1
            return r
        store.guaranteed_update(REPLICASETS, "default/web", shrink)
        rsc.pump()
        keys = {p.key for p in store.list(PODS)[0]}
        assert keys == {"default/old"}                  # youngest next


class TestHollowKubeletRunsPods:
    """Scheduled pods become Running/Ready via the hollow kubelet's sync
    tick, and the disruption controller's healthy count follows — the full
    bind -> run -> status -> PDB pipeline."""

    def test_pod_lifecycle_feeds_pdb_health(self):
        from kubernetes_tpu_torch.models.hollow import HollowKubelet
        from kubernetes_tpu_torch.scheduler import Scheduler
        from kubernetes_tpu_torch.utils.clock import FakeClock
        clock = FakeClock(50.0)
        store = Store()
        store.create(NODES, Node(
            name="n0", allocatable={"cpu": 4000, "memory": 8 * GI,
                                    "pods": 110}))
        store.create(PDBS, PodDisruptionBudget(
            name="b", selector=ctl_sel(app="db"), min_available=1))
        for j in range(2):
            store.create(PODS, Pod(
                name=f"db{j}", labels={"app": "db"}, containers=(
                    Container.make(name="c", requests={"cpu": 100}),)))
        sched = Scheduler(store, use_device=False, clock=clock,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        sched.pump()
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        kubelet = HollowKubelet(store, "n0", clock=clock)
        kubelet.heartbeat()
        pods = store.list(PODS)[0]
        assert all(p.phase == "Running" and p.start_time == 50.0
                   and any(c.type == "Ready" and c.status == "True"
                           for c in p.conditions) for p in pods)
        dc = DisruptionController(store)
        dc.sync()
        pdb = store.get(PDBS, "default/b")
        assert (pdb.current_healthy, pdb.disruptions_allowed) == (2, 1)
        # the kubelet's status write must not disturb the scheduler's
        # assumed-pod cache (skipPodUpdate strips the whole status)
        sched.pump()
        assert sched.metrics.schedule_attempts["error"] == 0


class TestEndpointsController:
    def test_service_endpoints_track_ready_pods(self):
        from kubernetes_tpu_torch.api.types import Service, PodCondition
        from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
        from kubernetes_tpu_torch.store.store import SERVICES, ENDPOINTS
        store = Store()
        ec = EndpointsController(store)
        store.create(SERVICES, Service(name="db", selector={"app": "db"}))
        a = ctl_bound_pod("a", "n0", {"app": "db"})
        b = ctl_bound_pod("b", "n1", {"app": "db"})
        b.conditions = (PodCondition(type="Ready", status="False"),)
        pending = Pod(name="c", labels={"app": "db"})   # unbound
        for p in (a, b, pending):
            store.create(PODS, p)
        ec.sync()
        ep = store.get(ENDPOINTS, "default/db")
        assert ep.addresses == (("default/a", "n0"),)
        # pod becomes ready -> endpoint appears; service delete -> cleanup
        def ready(cur):
            cur.conditions = (PodCondition(type="Ready", status="True"),)
            return cur
        store.guaranteed_update(PODS, "default/b", ready)
        ec.pump()
        assert store.get(ENDPOINTS, "default/db").addresses == (
            ("default/a", "n0"), ("default/b", "n1"))
        store.delete(SERVICES, "default/db")
        ec.pump()
        import pytest as _pytest
        from kubernetes_tpu_torch.store.store import NotFoundError
        with _pytest.raises(NotFoundError):
            store.get(ENDPOINTS, "default/db")


class TestHollowProxy:
    def test_routing_table_follows_endpoints(self):
        from kubernetes_tpu_torch.api.types import Service
        from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
        from kubernetes_tpu_torch.models.hollow import HollowProxy
        from kubernetes_tpu_torch.store.store import SERVICES
        store = Store()
        ec = EndpointsController(store)
        proxy = HollowProxy(store)
        proxy.sync()
        store.create(SERVICES, Service(name="db", selector={"app": "db"}))
        store.create(PODS, ctl_bound_pod("a", "n0", {"app": "db"}))
        store.create(PODS, ctl_bound_pod("b", "n1", {"app": "db"}))
        ec.sync()
        proxy.pump()
        picks = {proxy.route("default/db") for _ in range(4)}
        assert picks == {("default/a", "n0"), ("default/b", "n1")}
        store.delete(PODS, "default/a")
        ec.pump()
        proxy.pump()
        assert proxy.backends("default/db") == (("default/b", "n1"),)
        store.delete(SERVICES, "default/db")
        ec.pump()
        proxy.pump()
        assert proxy.route("default/db") is None


class TestResourceQuota:
    def test_usage_reconciled_and_enforced(self):
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.controllers.resourcequota import (
            ResourceQuotaController)
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.api import serde
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        import urllib.request, urllib.error, json as _json

        store = Store()
        rqc = ResourceQuotaController(store)
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="q", hard={"cpu": 1000, "pods": 3}))
        store.create(PODS, ctl_bound_pod("a", "n0", cpu=400))
        store.create(PODS, ctl_bound_pod("b", "n0", cpu=400))
        rqc.sync()
        q = store.get(RESOURCEQUOTAS, "default/q")
        assert q.used == {"cpu": 800, "pods": 2}

        with APIServer(store) as srv:
            def post(pod):
                data = _json.dumps(serde.to_dict(pod)).encode()
                req = urllib.request.Request(
                    f"{srv.url}/api/v1/pods", data=data, method="POST",
                    headers={"Content-Type": "application/json"})
                return urllib.request.urlopen(req)
            # 300m would exceed the 1000m cap (800 used) -> 422
            import pytest as _pytest
            with _pytest.raises(urllib.error.HTTPError) as e:
                post(ctl_bound_pod("c", "", cpu=300))
            assert e.value.code == 422
            assert "exceeded quota" in _json.loads(e.value.read())["message"]
            # 150m fits
            assert post(ctl_bound_pod("d", "", cpu=150)).status == 201
        rqc.pump()
        q = store.get(RESOURCEQUOTAS, "default/q")
        assert q.used == {"cpu": 950, "pods": 3}
        # terminated pods leave the quota
        def finish(cur):
            cur.phase = "Succeeded"
            return cur
        store.guaranteed_update(PODS, "default/a", finish)
        rqc.pump()
        assert store.get(RESOURCEQUOTAS, "default/q").used == \
            {"cpu": 550, "pods": 2}


class TestQuotaAdmissionCAS:
    """Admission commits quota usage synchronously via CAS (the reference's
    checkQuotas evaluator commit), so a rapid burst of creates cannot
    overshoot hard caps before the controller reconciles."""

    def _post(self, url, pod):
        import urllib.request, urllib.error, json as _json
        from kubernetes_tpu_torch.api import serde
        data = _json.dumps(serde.to_dict(pod)).encode()
        req = urllib.request.Request(
            f"{url}/api/v1/pods", data=data, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    def test_burst_creates_cannot_overshoot(self):
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        store = Store()
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="q", hard={"pods": 3, "cpu": 10_000}))
        with APIServer(store) as srv:
            codes = [self._post(srv.url, ctl_bound_pod(f"p{i}", "", cpu=100))
                     for i in range(6)]
        # NO controller pump between creates: admission alone must stop
        # the overshoot at exactly the hard cap
        assert codes.count(201) == 3 and codes.count(422) == 3
        q = store.get(RESOURCEQUOTAS, "default/q")
        assert q.used == {"pods": 3, "cpu": 300}
        assert len(store.list(PODS)[0]) == 3

    def test_rejection_refunds_earlier_quota_charges(self):
        """Two quotas in one namespace: the second rejecting must refund
        the first's already-committed charge."""
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.apiserver.admission import (
            AdmissionChain, AdmissionError)
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        store = Store()
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="a-wide", hard={"pods": 100}))
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="b-tight", hard={"cpu": 50}))
        chain = AdmissionChain()
        with pytest.raises(AdmissionError):
            chain.admit(PODS, ctl_bound_pod("p", "", cpu=100), store)
        assert store.get(RESOURCEQUOTAS, "default/a-wide").used \
            == {"pods": 0}


class TestControllerWritesPassAdmission:
    """Controller-originated pod creates run the same admission chain as
    user writes (the reference routes every controller write through
    apiserver admission), so scale-up pods get LimitRanger defaults and
    quota enforcement."""

    def test_rs_pods_get_limitranger_defaults(self):
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        store = Store()
        rsc = ReplicaSetController(store)
        store.create(REPLICASETS, ReplicaSet(
            name="web", selector=ctl_sel(app="web"), replicas=2))
        rsc.sync()
        pods = store.list(PODS)[0]
        assert len(pods) == 2
        for p in pods:
            reqs = dict(p.containers[0].requests)
            assert reqs.get("cpu") == 100
            assert reqs.get("memory") == 200 * 1024 ** 2

    def test_rs_scale_up_respects_quota(self):
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS, EVENTS
        store = Store()
        store.create(RESOURCEQUOTAS, ResourceQuota(name="q", hard={"pods": 2}))
        rsc = ReplicaSetController(store)
        store.create(REPLICASETS, ReplicaSet(
            name="web", selector=ctl_sel(app="web"), replicas=5))
        rsc.sync()
        assert len(store.list(PODS)[0]) == 2
        evs = [e for e in store.list(EVENTS)[0]
               if e.reason == "FailedCreate"]
        assert evs and "exceeded quota" in evs[0].message

    def test_failed_create_refunds_charge(self):
        """AlreadyExists after a successful admit must refund the quota
        charge — otherwise every create retry leaks usage permanently."""
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        store = Store()
        store.create(RESOURCEQUOTAS, ResourceQuota(name="q", hard={"pods": 5}))
        with APIServer(store) as srv:
            p = TestQuotaAdmissionCAS()
            assert p._post(srv.url, ctl_bound_pod("dup", "")) == 201
            for _ in range(3):   # duplicate creates: 409, no charge leak
                assert p._post(srv.url, ctl_bound_pod("dup", "")) == 409
        assert store.get(RESOURCEQUOTAS, "default/q").used == {"pods": 1}


class TestDeploymentController:
    """Rollout over owned ReplicaSets (pkg/controller/deployment): create,
    scale, rolling template update inside the surge/unavailable envelope,
    Recreate, and status."""

    def _mk(self, store):
        from kubernetes_tpu_torch.controllers.deployment import DeploymentController
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        return DeploymentController(store), ReplicaSetController(store)

    def _pump(self, *ctrls, rounds=8):
        for _ in range(rounds):
            if sum(c.pump() for c in ctrls) == 0:
                break

    def _set_running(self, store, selector=None):
        for p in store.list(PODS)[0]:
            if p.phase != "Running":
                def mutate(cur):
                    cur.phase = "Running"
                    return cur
                store.guaranteed_update(PODS, p.key, mutate)

    def test_create_scale_and_status(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS, REPLICASETS
        store = Store()
        dc, rsc = self._mk(store)
        dc.sync(); rsc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="web", replicas=3, selector=ctl_sel(app="web"),
            template=PodTemplate(labels={"app": "web"})))
        self._pump(dc, rsc)
        sets = store.list(REPLICASETS)[0]
        assert len(sets) == 1 and sets[0].replicas == 3
        assert sets[0].owner_ref[:2] == ("Deployment", "web")
        pods = store.list(PODS)[0]
        assert len(pods) == 3
        assert all(p.labels.get("pod-template-hash") for p in pods)
        # scale up via spec
        def scale(cur):
            cur.replicas = 5
            return cur
        store.guaranteed_update(DEPLOYMENTS, "default/web", scale)
        self._pump(dc, rsc)
        assert len(store.list(PODS)[0]) == 5
        self._set_running(store)
        self._pump(dc, rsc)
        dep = store.get(DEPLOYMENTS, "default/web")
        assert dep.ready_replicas == 5 and dep.updated_replicas == 5

    def test_rolling_update_respects_envelope(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate, Container
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS, REPLICASETS
        store = Store()
        dc, rsc = self._mk(store)
        dc.sync(); rsc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="web", replicas=4, selector=ctl_sel(app="web"),
            template=PodTemplate(labels={"app": "web"}),
            max_surge=1, max_unavailable=1))
        self._pump(dc, rsc)
        self._set_running(store)
        self._pump(dc, rsc)
        rev1 = store.list(REPLICASETS)[0][0].name
        # template change -> new RS; total pods never exceed 4+1
        def retemplate(cur):
            cur.template = PodTemplate(
                labels={"app": "web"},
                containers=(Container.make(name="c",
                                           requests={"cpu": 250}),))
            return cur
        store.guaranteed_update(DEPLOYMENTS, "default/web", retemplate)
        for _ in range(20):
            n = dc.pump() + rsc.pump()
            live = [p for p in store.list(PODS)[0] if not p.deleted]
            assert len(live) <= 5, "surge envelope violated"
            self._set_running(store)
            if n == 0:
                break
        sets = store.list(REPLICASETS)[0]
        assert len(sets) == 1 and sets[0].name != rev1   # old RS cleaned up
        pods = store.list(PODS)[0]
        assert len(pods) == 4
        assert all(dict(p.containers[0].requests).get("cpu") == 250
                   for p in pods)

    def test_recreate_strategy(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate, Container
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS
        store = Store()
        dc, rsc = self._mk(store)
        dc.sync(); rsc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="db", replicas=2, selector=ctl_sel(app="db"),
            template=PodTemplate(labels={"app": "db"}),
            strategy="Recreate"))
        self._pump(dc, rsc)
        self._set_running(store)
        def retemplate(cur):
            cur.template = PodTemplate(
                labels={"app": "db"},
                containers=(Container.make(name="c",
                                           requests={"cpu": 300}),))
            return cur
        store.guaranteed_update(DEPLOYMENTS, "default/db", retemplate)
        # first passes: old scaled to 0 and drained BEFORE new comes up
        seen_empty = False
        for _ in range(20):
            n = dc.pump() + rsc.pump()
            pods = [p for p in store.list(PODS)[0]]
            if not pods:
                seen_empty = True
            self._set_running(store)
            if n == 0:
                break
        assert seen_empty, "Recreate must drain old pods before new ones"
        pods = store.list(PODS)[0]
        assert len(pods) == 2
        assert all(dict(p.containers[0].requests).get("cpu") == 300
                   for p in pods)

    def test_both_zero_envelope_rejected(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS, EVENTS
        store = Store()
        dc, _rsc = self._mk(store)
        dc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="bad", replicas=2, selector=ctl_sel(app="bad"),
            template=PodTemplate(labels={"app": "bad"}),
            max_surge=0, max_unavailable=0))
        dc.pump()
        evs = [e for e in store.list(EVENTS)[0] if e.reason == "InvalidSpec"]
        assert evs, "both-zero rolling envelope must be surfaced"


class TestJobController:
    def test_completions_and_parallelism(self):
        from kubernetes_tpu_torch.api.types import Job, PodTemplate
        from kubernetes_tpu_torch.controllers.job import JobController
        from kubernetes_tpu_torch.store.store import JOBS
        store = Store()
        jc = JobController(store)
        jc.sync()
        store.create(JOBS, Job(name="work", completions=5, parallelism=2,
                               template=PodTemplate(labels={"app": "work"})))
        jc.pump()
        active = store.list(PODS)[0]
        assert len(active) == 2          # parallelism cap
        assert all(p.labels["job-name"] == "work" for p in active)
        # finish pods one wave at a time until completions reached
        done = 0
        for _ in range(6):
            for p in store.list(PODS)[0]:
                if p.phase == "Pending" and done < 5:
                    def finish(cur):
                        cur.phase = "Succeeded"
                        return cur
                    store.guaranteed_update(PODS, p.key, finish)
                    done += 1
            jc.pump()
            job = store.get(JOBS, "default/work")
            if job.complete:
                break
        job = store.get(JOBS, "default/work")
        assert job.complete and job.succeeded == 5
        assert job.completion_time is not None

    def test_backoff_limit_fails_job(self):
        from kubernetes_tpu_torch.api.types import Job, PodTemplate
        from kubernetes_tpu_torch.controllers.job import JobController
        from kubernetes_tpu_torch.store.store import JOBS, EVENTS
        store = Store()
        jc = JobController(store)
        jc.sync()
        store.create(JOBS, Job(name="flaky", completions=1, parallelism=1,
                               backoff_limit=2,
                               template=PodTemplate(labels={"app": "flaky"})))
        jc.pump()
        for _ in range(4):
            for p in store.list(PODS)[0]:
                if p.phase == "Pending":
                    def fail(cur):
                        cur.phase = "Failed"
                        return cur
                    store.guaranteed_update(PODS, p.key, fail)
            jc.pump()
        job = store.get(JOBS, "default/flaky")
        assert job.job_failed and job.failed > 2
        evs = [e for e in store.list(EVENTS)[0]
               if e.reason == "BackoffLimitExceeded"]
        assert evs

    def test_ttl_after_finished(self):
        from kubernetes_tpu_torch.api.types import Job, PodTemplate
        from kubernetes_tpu_torch.controllers.job import JobController
        from kubernetes_tpu_torch.store.store import JOBS
        from kubernetes_tpu_torch.utils.clock import FakeClock
        store = Store()
        clock = FakeClock(100.0)
        jc = JobController(store, clock=clock)
        jc.sync()
        store.create(JOBS, Job(name="gone", completions=1, parallelism=1,
                               ttl_seconds_after_finished=30,
                               template=PodTemplate(labels={"app": "gone"})))
        jc.pump()
        for p in store.list(PODS)[0]:
            def finish(cur):
                cur.phase = "Succeeded"
                return cur
            store.guaranteed_update(PODS, p.key, finish)
        jc.pump()
        assert store.get(JOBS, "default/gone").complete
        clock.step(31)
        jc.pump()
        import pytest as _pytest
        from kubernetes_tpu_torch.store.store import NotFoundError
        with _pytest.raises(NotFoundError):
            store.get(JOBS, "default/gone")


class TestDaemonSetController:
    def test_one_pod_per_eligible_node(self):
        from kubernetes_tpu_torch.api.types import (
            DaemonSet, PodTemplate, Taint, Toleration, NO_SCHEDULE)
        from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
        from kubernetes_tpu_torch.store.store import DAEMONSETS
        store = Store()
        for i in range(4):
            taints = (Taint(key="gpu", value="true", effect=NO_SCHEDULE),) \
                if i == 3 else ()
            store.create(NODES, Node(
                name=f"n{i}", taints=taints,
                labels={"role": "worker" if i < 3 else "infra"},
                allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
        dsc = DaemonSetController(store)
        dsc.sync()
        store.create(DAEMONSETS, DaemonSet(
            name="agent", selector=ctl_sel(app="agent"),
            template=PodTemplate(labels={"app": "agent"},
                                 node_selector={"role": "worker"})))
        dsc.pump()
        pods = store.list(PODS)[0]
        # n3 excluded twice over (selector + taint); DS controller SCHEDULES:
        # node_name set directly, no scheduler involved
        assert sorted(p.node_name for p in pods) == ["n0", "n1", "n2"]
        ds = store.get(DAEMONSETS, "default/agent")
        assert ds.desired_number_scheduled == 3
        assert ds.current_number_scheduled == 3
        # node joins -> pod appears; node leaves -> pod goes
        store.create(NODES, Node(
            name="n9", labels={"role": "worker"},
            allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
        dsc.pump()
        assert any(p.node_name == "n9" for p in store.list(PODS)[0])
        store.delete(NODES, "n9")
        dsc.pump()
        assert not any(p.node_name == "n9" for p in store.list(PODS)[0])

    def test_toleration_admits_tainted_node(self):
        from kubernetes_tpu_torch.api.types import (
            DaemonSet, PodTemplate, Taint, Toleration, NO_SCHEDULE)
        from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
        from kubernetes_tpu_torch.store.store import DAEMONSETS
        store = Store()
        store.create(NODES, Node(
            name="t0", taints=(Taint(key="ded", value="x",
                                     effect=NO_SCHEDULE),),
            allocatable={"cpu": 4000, "memory": 8 * GI, "pods": 110}))
        dsc = DaemonSetController(store)
        dsc.sync()
        store.create(DAEMONSETS, DaemonSet(
            name="log", selector=ctl_sel(app="log"),
            template=PodTemplate(
                labels={"app": "log"},
                tolerations=(Toleration(key="ded", value="x",
                                        effect=NO_SCHEDULE),))))
        dsc.pump()
        assert [p.node_name for p in store.list(PODS)[0]] == ["t0"]


class TestStatefulSetController:
    def test_ordered_ready_scale_up_down(self):
        from kubernetes_tpu_torch.api.types import StatefulSet, PodTemplate
        from kubernetes_tpu_torch.controllers.statefulset import (
            StatefulSetController)
        from kubernetes_tpu_torch.store.store import STATEFULSETS
        store = Store()
        sc = StatefulSetController(store)
        sc.sync()
        store.create(STATEFULSETS, StatefulSet(
            name="db", replicas=3, selector=ctl_sel(app="db"),
            template=PodTemplate(labels={"app": "db"})))
        sc.pump()
        pods = store.list(PODS)[0]
        assert [p.name for p in pods] == ["db-0"]   # gated on readiness
        def run(key):
            def m(cur):
                cur.phase = "Running"
                return cur
            store.guaranteed_update(PODS, key, m)
        run("default/db-0"); sc.pump()
        assert sorted(p.name for p in store.list(PODS)[0]) == ["db-0", "db-1"]
        run("default/db-1"); sc.pump()
        run("default/db-2"); sc.pump()
        assert sorted(p.name for p in store.list(PODS)[0]) == \
            ["db-0", "db-1", "db-2"]
        # scale down deletes the HIGHEST ordinal first
        def scale(cur):
            cur.replicas = 1
            return cur
        store.guaranteed_update(STATEFULSETS, "default/db", scale)
        sc.pump()
        assert sorted(p.name for p in store.list(PODS)[0]) == ["db-0", "db-1"]
        sc.pump()
        assert sorted(p.name for p in store.list(PODS)[0]) == ["db-0"]
        sts = store.get(STATEFULSETS, "default/db")
        assert sts.current_replicas == 1


class TestNamespaceLifecycle:
    def test_delete_namespace_cascades(self):
        from kubernetes_tpu_torch.api.types import Namespace
        from kubernetes_tpu_torch.controllers.namespace import (
            NamespaceController, ServiceAccountController)
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.store import (
            NAMESPACES, SERVICEACCOUNTS, NotFoundError)
        import urllib.request
        store = Store()
        nc = NamespaceController(store)
        sac = ServiceAccountController(store)
        nc.sync(); sac.sync()
        store.create(NAMESPACES, Namespace(name="team-a"))
        sac.pump()
        # serviceaccount controller provisioned the default SA
        assert store.get(SERVICEACCOUNTS, "team-a/default")
        store.create(PODS, ctl_bound_pod("p1", "n0"))
        p2 = ctl_bound_pod("p2", "n0")
        p2.namespace = "team-a"
        store.create(PODS, p2)
        with APIServer(store) as srv:
            req = urllib.request.Request(
                f"{srv.url}/api/v1/namespaces/team-a", method="DELETE")
            urllib.request.urlopen(req)
        # DELETE only marks Terminating; the controller finalizes
        assert store.get(NAMESPACES, "team-a").phase == "Terminating"
        nc.pump()
        import pytest as _pytest
        with _pytest.raises(NotFoundError):
            store.get(NAMESPACES, "team-a")
        keys = [p.key for p in store.list(PODS)[0]]
        assert keys == ["default/p1"]    # other namespaces untouched
        with _pytest.raises(NotFoundError):
            store.get(SERVICEACCOUNTS, "team-a/default")


class TestGarbageCollector:
    def test_owner_cascade(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate
        from kubernetes_tpu_torch.controllers.deployment import DeploymentController
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        from kubernetes_tpu_torch.controllers.garbagecollector import (
            GarbageCollector)
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS, REPLICASETS
        store = Store()
        dc = DeploymentController(store)
        rsc = ReplicaSetController(store)
        gc = GarbageCollector(store)
        dc.sync(); rsc.sync(); gc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="web", replicas=3, selector=ctl_sel(app="web"),
            template=PodTemplate(labels={"app": "web"})))
        for _ in range(4):
            dc.pump(); rsc.pump()
        assert len(store.list(PODS)[0]) == 3
        # deleting the Deployment cascades: RS on pass 1, pods on pass 2
        store.delete(DEPLOYMENTS, "default/web")
        gc.pump()
        assert not store.list(REPLICASETS)[0]
        assert not store.list(PODS)[0]

    def test_rs_delete_no_longer_orphans_pods(self):
        """VERDICT r03 missing #2: ReplicaSet deletion used to orphan pods."""
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        from kubernetes_tpu_torch.controllers.garbagecollector import (
            GarbageCollector)
        store = Store()
        rsc = ReplicaSetController(store)
        gc = GarbageCollector(store)
        rsc.sync(); gc.sync()
        store.create(REPLICASETS, ReplicaSet(
            name="app", selector=ctl_sel(app="app"), replicas=2))
        rsc.pump()
        assert len(store.list(PODS)[0]) == 2
        store.delete(REPLICASETS, "default/app")
        gc.pump()
        assert not store.list(PODS)[0]


class TestJobCompletionIsTerminal:
    def test_deleted_succeeded_pods_do_not_rerun_job(self):
        """A completed Job whose Succeeded pods are later deleted (PodGC,
        namespace sweep, user) must stay complete and create nothing."""
        from kubernetes_tpu_torch.api.types import Job, PodTemplate
        from kubernetes_tpu_torch.controllers.job import JobController
        from kubernetes_tpu_torch.store.store import JOBS
        store = Store()
        jc = JobController(store)
        jc.sync()
        store.create(JOBS, Job(name="once", completions=2, parallelism=2,
                               template=PodTemplate(labels={"app": "once"})))
        jc.pump()
        for p in store.list(PODS)[0]:
            def fin(cur):
                cur.phase = "Succeeded"
                return cur
            store.guaranteed_update(PODS, p.key, fin)
        jc.pump()
        assert store.get(JOBS, "default/once").complete
        for p in store.list(PODS)[0]:
            store.delete(PODS, p.key)
        jc.pump()
        job = store.get(JOBS, "default/once")
        assert job.complete and job.succeeded == 2
        assert not store.list(PODS)[0], "terminal job must not re-run"


class TestRecreateDoesNotLeakReplicaSets:
    def test_old_rs_deleted_after_recreate_rollout(self):
        from kubernetes_tpu_torch.api.types import Deployment, PodTemplate, Container
        from kubernetes_tpu_torch.controllers.deployment import DeploymentController
        from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS, REPLICASETS
        store = Store()
        dc = DeploymentController(store)
        rsc = ReplicaSetController(store)
        dc.sync(); rsc.sync()
        store.create(DEPLOYMENTS, Deployment(
            name="db", replicas=2, selector=ctl_sel(app="db"),
            template=PodTemplate(labels={"app": "db"}), strategy="Recreate"))
        for rev in (100, 200, 300):    # three template revisions
            def rt(cur, rev=rev):
                cur.template = PodTemplate(
                    labels={"app": "db"},
                    containers=(Container.make(
                        name="c", requests={"cpu": rev}),))
                return cur
            store.guaranteed_update(DEPLOYMENTS, "default/db", rt)
            for _ in range(10):
                if dc.pump() + rsc.pump() == 0:
                    break
        sets = store.list(REPLICASETS)[0]
        assert len(sets) == 1, [r.name for r in sets]


class TestDaemonSetPredicateDrift:
    """Tripwire for VERDICT r4 weak #8: the DS controller re-implements
    taint/selector eligibility when placing pods directly (faithful to
    this snapshot, daemon_controller.go:81); this fuzz pins its copy to
    the oracle predicate table so the two cannot drift silently."""

    def test_eligibility_matches_predicates(self):
        import random
        from kubernetes_tpu_torch.api.types import (
            DaemonSet, Taint, Toleration, PodTemplate, NO_SCHEDULE,
            NO_EXECUTE, PREFER_NO_SCHEDULE)
        from kubernetes_tpu_torch.cache.node_info import NodeInfo
        from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
        from kubernetes_tpu_torch.oracle import predicates as preds
        rng = random.Random(20260802)
        ctl = DaemonSetController(Store())
        for trial in range(40):
            labels = {}
            if rng.random() < 0.5:
                labels["disk"] = rng.choice(["ssd", "hdd"])
            taints = tuple(
                Taint(key=f"k{i}", value=rng.choice(["a", "b"]),
                      effect=rng.choice([NO_SCHEDULE, NO_EXECUTE,
                                         PREFER_NO_SCHEDULE]))
                for i in range(rng.randint(0, 2)))
            node = Node(name="n", labels=labels, taints=taints,
                        allocatable={"cpu": 4000, "memory": GI, "pods": 110})
            tols = tuple(
                Toleration(key=f"k{i}", op="Equal", value=rng.choice(["a", "b"]),
                           effect=rng.choice(["", NO_SCHEDULE, NO_EXECUTE]))
                for i in range(rng.randint(0, 2)))
            nsel = {"disk": rng.choice(["ssd", "hdd"])} \
                if rng.random() < 0.5 else {}
            tmpl = PodTemplate(labels={"app": "ds"}, node_selector=nsel,
                               tolerations=tols,
                               containers=(Container.make(
                                   name="c", requests={"cpu": 100}),))
            ds = DaemonSet(name="d", selector=ctl_sel(app="ds"), template=tmpl)
            got = ctl._eligible(ds, node)
            # the oracle's verdict: the same template pod through the
            # predicate table's selector + taint checks
            probe = Pod(name="probe", labels=dict(tmpl.labels),
                        node_selector=dict(tmpl.node_selector),
                        tolerations=tmpl.tolerations,
                        containers=tmpl.containers)
            ni = NodeInfo(node)
            sel_ok, _ = preds.pod_match_node_selector(probe, ni)
            taint_ok, _ = preds.pod_tolerates_node_taints(probe, ni)
            want = sel_ok and taint_ok
            assert got == want, (
                f"trial={trial}: DS controller eligibility {got} != "
                f"predicate table {want} (labels={labels}, taints={taints}, "
                f"ctl_sel={nsel}, tols={tols})")


# -- tests/test_autoscaling.py: every case (cron, CronJob, TTL, PV binder, HPA) ---
def auto_mknode(name):
    return Node(name=name,
                allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})


def auto_mkdep(name="web", replicas=3, cpu=200):
    return Deployment(
        name=name, replicas=replicas,
        selector=LabelSelector.from_dict({"app": name}),
        template=PodTemplate(labels={"app": name},
                             containers=(Container.make(
                                 name="c", requests={"cpu": cpu}),)))


class TestCronSchedule:
    @pytest.mark.parametrize("expr,ts,want", [
        ("* * * * *", 0, True),
        ("*/15 * * * *", 15 * 60, True),
        ("*/15 * * * *", 16 * 60, False),
        ("30 2 * * *", 2 * 3600 + 30 * 60, True),       # 02:30 Jan 1 1970
        ("30 2 * * *", 3 * 3600, False),
        ("0 0 1 1 *", 0, True),                          # Jan 1 midnight
        ("0-10/5 * * * *", 5 * 60, True),
        ("0-10/5 * * * *", 7 * 60, False),
        ("* * * * 4", 0, True),     # 1970-01-01 was a Thursday (dow 4)
        ("* * * * 5", 0, False),
        ("* * 1 * 5", 0, True),     # dom OR dow when both restricted
    ])
    def test_matches(self, expr, ts, want):
        assert CronSchedule(expr).matches(ts) is want, (expr, ts)

    def test_next_after(self):
        s = CronSchedule("*/10 * * * *")
        assert s.next_after(0) == 600.0
        assert s.next_after(599) == 600.0
        assert s.next_after(600) == 1200.0

    @pytest.mark.parametrize("expr", ["* * * *", "61 * * * *", "a * * * *",
                                      "*/0 * * * *", "5-1 * * * *"])
    def test_parse_errors(self, expr):
        with pytest.raises(CronParseError):
            CronSchedule(expr)

    def test_sunday_as_7(self):
        s = CronSchedule("* * * * 7")
        # 1970-01-04 was a Sunday
        assert s.matches(3 * 86400)

    def test_dow_ranges_through_seven(self):
        # vixie semantics: 0-7 and 1-7 are every day; 5-7 is Fri/Sat/Sun
        assert CronSchedule("* * * * 0-7").dow == frozenset(range(7))
        assert CronSchedule("* * * * 1-7").dow == frozenset(range(7))
        assert CronSchedule("* * * * 5-7").dow == frozenset({5, 6, 0})

    def test_schedule_is_utc_not_localtime(self):
        """Pin the documented UTC contract (utils/cron.py): a schedule
        matches the UTC wall clock regardless of the process TZ. Evaluated
        under a shifted TZ so a localtime regression cannot pass."""
        import os
        import time as _t
        s = CronSchedule("0 12 * * *")
        noon_utc = 12 * 3600            # 1970-01-01 12:00:00 UTC
        old = os.environ.get("TZ")
        os.environ["TZ"] = "America/Los_Angeles"   # UTC-8 on that date
        _t.tzset()
        try:
            assert s.matches(noon_utc)                   # 04:00 local
            assert not s.matches(noon_utc + 8 * 3600)    # 12:00 local
            # next_after stays UTC-anchored too
            assert s.next_after(0) == float(noon_utc)
        finally:
            if old is None:
                os.environ.pop("TZ", None)
            else:
                os.environ["TZ"] = old
            _t.tzset()

    def test_star_step_counts_as_star_for_or_rule(self):
        # robfig: '*/2' in dom keeps AND semantics with a restricted dow
        s = CronSchedule("0 0 */2 * 4")        # odd days AND Thursdays
        assert s.matches(0)                    # Thu Jan 1 1970
        assert not s.matches(86400)            # Fri Jan 2: dom ok, dow no

    def test_job_owner_ref_survives_serde(self):
        """The remote transport must preserve the typed owner tuple or
        Forbid/Replace degrade to Allow over HTTP."""
        from kubernetes_tpu_torch.api import serde
        from kubernetes_tpu_torch.api.types import Job
        j = Job(name="b-10", owner_ref=("CronJob", "b", ""))
        back = serde.from_dict("jobs", serde.to_dict(j))
        assert back.owner_ref == ("CronJob", "b", "")
        assert isinstance(back.owner_ref, tuple)

    def test_gc_cascades_cronjob_to_jobs(self):
        """Deleting a CronJob garbage-collects its owned Jobs (and their
        pods cascade through the existing Job edge)."""
        from kubernetes_tpu_torch.controllers.cronjob import CronJobController
        from kubernetes_tpu_torch.controllers.garbagecollector import (
            GarbageCollector)
        store = Store()
        clock = FakeClock(30.0)
        ctl = CronJobController(store, clock=clock)
        ctl.sync()
        gc = GarbageCollector(store)
        gc.sync()
        store.create(CRONJOBS, CronJob(
            name="t", schedule="*/10 * * * *",
            template=PodTemplate(labels={"app": "t"},
                                 containers=(Container.make(
                                     name="c", requests={"cpu": 50}),))))
        ctl.pump()
        clock.step(600.0)
        ctl.pump()
        assert len(store.list(JOBS)[0]) == 1
        store.delete(CRONJOBS, "default/t")
        gc.pump()
        assert store.list(JOBS)[0] == []


class TestCronJobController:
    def _mk(self, store, t0=0.0):
        from kubernetes_tpu_torch.controllers.cronjob import CronJobController
        clock = FakeClock(t0)
        return CronJobController(store, clock=clock), clock

    def test_fires_on_schedule(self):
        store = Store()
        ctl, clock = self._mk(store, t0=30.0)
        ctl.sync()
        store.create(CRONJOBS, CronJob(
            name="tick", schedule="*/10 * * * *",
            template=PodTemplate(labels={"app": "tick"},
                                 containers=(Container.make(
                                     name="c", requests={"cpu": 50}),))))
        ctl.pump()                      # first sight: cursor starts
        assert store.list(JOBS)[0] == []
        clock.step(600.0)               # crosses 10:00
        ctl.pump()
        jobs = store.list(JOBS)[0]
        assert len(jobs) == 1 and jobs[0].name.startswith("tick-")
        ctl.pump()                      # same minute: no duplicate
        assert len(store.list(JOBS)[0]) == 1
        clock.step(600.0)
        ctl.pump()
        assert len(store.list(JOBS)[0]) == 2

    def test_forbid_and_replace_policies(self):
        from kubernetes_tpu_torch.controllers.cronjob import CronJobController
        for policy, want_jobs in (("Forbid", 1), ("Replace", 1), ("Allow", 2)):
            store = Store()
            ctl, clock = self._mk(store, t0=30.0)
            ctl.sync()
            store.create(CRONJOBS, CronJob(
                name="t", schedule="*/10 * * * *",
                concurrency_policy=policy,
                template=PodTemplate(labels={"app": "t"},
                                     containers=(Container.make(
                                         name="c", requests={"cpu": 50}),))))
            ctl.pump()
            clock.step(600.0)
            ctl.pump()                  # first run (stays active: no kubelet)
            clock.step(600.0)
            ctl.pump()                  # second tick against an active job
            jobs = store.list(JOBS)[0]
            assert len(jobs) == want_jobs, policy
            if policy == "Replace":
                # the active first job was deleted, the new one remains
                assert jobs[0].name.endswith(str(int(clock.now()) // 60))

    def test_too_many_missed_resets_cursor(self):
        store = Store()
        ctl, clock = self._mk(store, t0=30.0)
        ctl.sync()
        store.create(CRONJOBS, CronJob(
            name="t", schedule="* * * * *",
            template=PodTemplate(labels={"app": "t"},
                                 containers=(Container.make(
                                     name="c", requests={"cpu": 50}),))))
        ctl.pump()
        clock.step(200 * 60.0)          # 200 missed minutes
        ctl.pump()
        assert store.list(JOBS)[0] == []   # reset, no catch-up storm
        clock.step(60.0)
        ctl.pump()
        assert len(store.list(JOBS)[0]) == 1

    def test_prefix_named_sibling_not_adopted(self):
        """'build' must not adopt (or Replace-delete) 'build-nightly's
        jobs: ownership is by owner_ref, not name prefix."""
        store = Store()
        ctl, clock = self._mk(store, t0=30.0)
        ctl.sync()
        tmpl = PodTemplate(labels={"app": "b"},
                           containers=(Container.make(
                               name="c", requests={"cpu": 50}),))
        store.create(CRONJOBS, CronJob(name="build", schedule="*/10 * * * *",
                                       concurrency_policy="Replace",
                                       template=tmpl))
        store.create(CRONJOBS, CronJob(name="build-nightly",
                                       schedule="*/10 * * * *",
                                       template=tmpl))
        ctl.pump()
        clock.step(600.0)
        ctl.pump()
        names = sorted(j.name for j in store.list(JOBS)[0])
        assert len(names) == 2
        clock.step(600.0)
        ctl.pump()      # build's Replace must only replace build's OWN job
        jobs = store.list(JOBS)[0]
        nightly = [j for j in jobs
                   if j.owner_ref[:2] == ("CronJob", "build-nightly")]
        mine = [j for j in jobs if j.owner_ref[:2] == ("CronJob", "build")]
        assert len(nightly) == 2   # Allow policy ran twice, none replaced
        assert len(mine) == 1      # Replace swapped build's own job only

    def test_suspend(self):
        store = Store()
        ctl, clock = self._mk(store, t0=30.0)
        ctl.sync()
        store.create(CRONJOBS, CronJob(
            name="t", schedule="* * * * *", suspend=True,
            template=PodTemplate(labels={"app": "t"},
                                 containers=(Container.make(
                                     name="c", requests={"cpu": 50}),))))
        ctl.pump()
        clock.step(300.0)
        ctl.pump()
        assert store.list(JOBS)[0] == []


class TestTTLController:
    def _sizes(self, store, n, prefix="n"):
        for i in range(n):
            store.create(NODES, auto_mknode(f"{prefix}{i}"))

    def test_annotates_by_cluster_size(self):
        from kubernetes_tpu_torch.controllers.ttl import (TTLController,
                                                    TTL_ANNOTATION)
        store = Store()
        self._sizes(store, 5)
        ctl = TTLController(store)
        ctl.sync()
        assert all(n.annotations[TTL_ANNOTATION] == "0"
                   for n in store.list(NODES)[0])
        # grow past the first boundary (sizeMax 100)
        self._sizes(store, 120, prefix="m")
        ctl.pump()
        assert all(n.annotations[TTL_ANNOTATION] == "15"
                   for n in store.list(NODES)[0])

    def test_hysteresis(self):
        from kubernetes_tpu_torch.controllers.ttl import (TTLController,
                                                    TTL_ANNOTATION)
        store = Store()
        self._sizes(store, 120)
        ctl = TTLController(store)
        ctl.sync()
        assert store.list(NODES)[0][0].annotations[TTL_ANNOTATION] == "15"
        # dip to 95: inside the hysteresis band (sizeMin 90) — stays 15
        for i in range(95, 120):
            store.delete(NODES, f"n{i}")
        ctl.pump()
        assert store.list(NODES)[0][0].annotations[TTL_ANNOTATION] == "15"
        # drop below sizeMin 90: steps back down to 0
        for i in range(85, 95):
            store.delete(NODES, f"n{i}")
        ctl.pump()
        assert store.list(NODES)[0][0].annotations[TTL_ANNOTATION] == "0"


class TestPersistentVolumeBinder:
    def _mk(self, store):
        from kubernetes_tpu_torch.controllers.pvbinder import PersistentVolumeBinder
        return PersistentVolumeBinder(store)

    def test_binds_smallest_fitting_pv(self):
        store = Store()
        store.create(PVS, PersistentVolume(name="big", capacity=100 * GI))
        store.create(PVS, PersistentVolume(name="small", capacity=10 * GI))
        ctl = self._mk(store)
        ctl.sync()
        store.create(PVCS, PersistentVolumeClaim(name="c1", request=5 * GI))
        ctl.pump()
        pvc = store.get(PVCS, "default/c1")
        assert pvc.volume_name == "small"
        assert store.get(PVS, "small").claim_ref == "default/c1"
        assert store.get(PVS, "big").claim_ref == ""

    def test_pending_until_pv_appears(self):
        store = Store()
        ctl = self._mk(store)
        ctl.sync()
        store.create(PVCS, PersistentVolumeClaim(name="c1", request=GI))
        ctl.pump()
        assert store.get(PVCS, "default/c1").volume_name == ""
        store.create(PVS, PersistentVolume(name="pv1", capacity=2 * GI))
        ctl.pump()     # the PV event re-dirties pending claims
        assert store.get(PVCS, "default/c1").volume_name == "pv1"

    def test_storage_class_and_capacity_filters(self):
        store = Store()
        store.create(PVS, PersistentVolume(name="fast", capacity=10 * GI,
                                           storage_class="ssd"))
        store.create(PVS, PersistentVolume(name="tiny", capacity=1 * GI))
        ctl = self._mk(store)
        ctl.sync()
        store.create(PVCS, PersistentVolumeClaim(name="c1", request=5 * GI))
        ctl.pump()
        # no classless PV is big enough; the ssd one is class-mismatched
        assert store.get(PVCS, "default/c1").volume_name == ""

    def test_released_pv_not_rebound(self):
        """Retain reclaim: a PV whose claim was deleted stays Released."""
        store = Store()
        store.create(PVS, PersistentVolume(name="pv1", capacity=2 * GI))
        ctl = self._mk(store)
        ctl.sync()
        store.create(PVCS, PersistentVolumeClaim(name="c1", request=GI))
        ctl.pump()
        assert store.get(PVCS, "default/c1").volume_name == "pv1"
        store.delete(PVCS, "default/c1")
        store.create(PVCS, PersistentVolumeClaim(name="c2", request=GI))
        ctl.pump()
        assert store.get(PVCS, "default/c2").volume_name == ""
        assert store.get(PVS, "pv1").claim_ref == "default/c1"  # Released

    def test_pvc_binds_outside_scheduling_cycle(self):
        """The VERDICT gap: nothing reconciled unbound PVCs outside a
        scheduling cycle. Now a pod whose PVC the binder already bound
        schedules via the BOUND path (NoVolumeZoneConflict et al.), no
        scheduler-side assume needed."""
        from kubernetes_tpu_torch.api.types import VolumeSource
        from kubernetes_tpu_torch.scheduler import Scheduler
        store = Store()
        store.create(NODES, auto_mknode("n1"))
        store.create(PVS, PersistentVolume(name="pv1", capacity=10 * GI))
        ctl = self._mk(store)
        ctl.sync()
        store.create(PVCS, PersistentVolumeClaim(name="data", request=GI))
        ctl.pump()
        assert store.get(PVCS, "default/data").volume_name == "pv1"
        sched = Scheduler(store, use_device=False,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        store.create(PODS, Pod(
            name="p1", volumes=(VolumeSource(name="v", pvc="data"),),
            containers=(Container.make(name="c", requests={"cpu": 100}),)))
        sched.pump()
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        assert store.get(PODS, "default/p1").node_name == "n1"


class TestHPAController:
    def _mk(self, store, t0=1000.0):
        from kubernetes_tpu_torch.controllers.hpa import (
            HorizontalPodAutoscalerController)
        clock = FakeClock(t0)
        return HorizontalPodAutoscalerController(store, clock=clock), clock

    def _world(self, store, replicas=3, cpu_req=200):
        store.create(DEPLOYMENTS, auto_mkdep(replicas=replicas, cpu=cpu_req))
        for i in range(replicas):
            store.create(PODS, Pod(
                name=f"web-{i}", labels={"app": "web"},
                containers=(Container.make(
                    name="c", requests={"cpu": cpu_req}),)))
        store.create(HPAS, HorizontalPodAutoscaler(
            name="web", scale_target_ref=("Deployment", "web"),
            min_replicas=1, max_replicas=10, target_cpu_utilization=50))

    def _feed(self, store, usage_milli):
        for i in range(len([p for p in store.list(PODS)[0]])):
            key = f"web-{i}"
            try:
                store.get(PODMETRICS, f"default/{key}")
                store.guaranteed_update(
                    PODMETRICS, f"default/{key}",
                    lambda m: (setattr(m, "cpu_usage", usage_milli), m)[1])
            except Exception:
                store.create(PODMETRICS, PodMetrics(name=key,
                                                    cpu_usage=usage_milli))

    def test_scales_up_on_high_utilization(self):
        store = Store()
        ctl, clock = self._mk(store)
        ctl.sync()
        self._world(store, replicas=3, cpu_req=200)
        self._feed(store, 200)   # 100% of request vs 50% target -> ratio 2
        ctl.pump()
        dep = store.get(DEPLOYMENTS, "default/web")
        assert dep.replicas == 6
        hpa = store.get(HPAS, "default/web")
        assert hpa.desired_replicas == 6
        assert hpa.current_cpu_utilization == 100
        assert hpa.last_scale_time == clock.now()

    def test_tolerance_band_holds_replicas(self):
        store = Store()
        ctl, clock = self._mk(store)
        ctl.sync()
        self._world(store, replicas=4, cpu_req=200)
        self._feed(store, 105)   # 52.5% vs 50% target: ratio 1.05 < 1.1
        ctl.pump()
        assert store.get(DEPLOYMENTS, "default/web").replicas == 4

    def test_scales_down_and_clamps(self):
        store = Store()
        ctl, clock = self._mk(store)
        ctl.sync()
        self._world(store, replicas=8, cpu_req=200)
        self._feed(store, 10)    # 5% vs 50%: ratio 0.1 -> ceil(0.8) = 1
        ctl.pump()
        assert store.get(DEPLOYMENTS, "default/web").replicas == 1
        # and the max clamp
        self._feed(store, 2000)  # ratio 20 -> clamped to max 10
        ctl.pump()
        assert store.get(DEPLOYMENTS, "default/web").replicas == 10

    def test_scale_down_fills_missing_metrics_with_full_utilization(self):
        """replica_calculator.go:106: on the way DOWN a metric-less pod
        counts as 100% of its request — filling with the target value
        over-shrinks during rollouts (the fresh pods have no samples yet).
        Here 2 of 4 pods report 10% utilization: the 100% fill lands the
        rebased average at exactly the tolerance edge, so the move is
        discarded; the old target-fill would have shrunk to 3."""
        store = Store()
        ctl, clock = self._mk(store)
        ctl.sync()
        self._world(store, replicas=4, cpu_req=200)
        for i in range(2):   # only the first two pods have samples
            store.create(PODMETRICS, PodMetrics(name=f"web-{i}",
                                                cpu_usage=20))
        ctl.pump()
        assert store.get(DEPLOYMENTS, "default/web").replicas == 4

    def test_scale_down_with_missing_metrics_still_moves_when_warranted(self):
        """Deep over-provisioning scales down even after the conservative
        100% fill: 3 idle pods + 1 metric-less -> (0*3 + 100)/4 = 25% vs
        the 50% target -> ceil(4 * 0.5) = 2 replicas."""
        store = Store()
        ctl, clock = self._mk(store)
        ctl.sync()
        self._world(store, replicas=4, cpu_req=200)
        for i in range(3):
            store.create(PODMETRICS, PodMetrics(name=f"web-{i}",
                                                cpu_usage=0))
        ctl.pump()
        assert store.get(DEPLOYMENTS, "default/web").replicas == 2

    def test_end_to_end_scale_then_schedule(self):
        """The VERDICT done criterion: metrics source -> HPA scales the
        Deployment -> the deployment/replicaset controllers stamp pods ->
        the TPU burst schedules the delta."""
        from kubernetes_tpu_torch.controllers.manager import ControllerManager
        from kubernetes_tpu_torch.scheduler import Scheduler
        store = Store(watch_log_size=65536)
        for i in range(4):
            store.create(NODES, auto_mknode(f"n{i}"))
        mgr = ControllerManager(store, enabled=[
            "horizontalpodautoscaling", "deployment", "replicaset"])
        mgr.sync()
        sched = Scheduler(store, use_device=True, device="cpu",
                          percentage_of_nodes_to_score=100)
        sched.sync()

        def settle():
            for _ in range(8):
                mgr.pump()
                sched.pump()
                while sched.schedule_burst(max_pods=32):
                    pass
                sched.pump()
        store.create(DEPLOYMENTS, auto_mkdep(replicas=2, cpu=200))
        store.create(HPAS, HorizontalPodAutoscaler(
            name="web", scale_target_ref=("Deployment", "web"),
            min_replicas=1, max_replicas=8, target_cpu_utilization=50))
        settle()
        pods = [p for p in store.list(PODS)[0] if not p.deleted]
        assert len(pods) == 2 and all(p.node_name for p in pods)
        # saturate: every pod at 150% of request
        for p in pods:
            store.create(PODMETRICS, PodMetrics(name=p.name,
                                                cpu_usage=300))
        settle()
        pods = [p for p in store.list(PODS)[0] if not p.deleted]
        assert store.get(DEPLOYMENTS, "default/web").replicas == 6
        assert len(pods) == 6
        assert all(p.node_name for p in pods), "TPU burst scheduled the delta"


# -- tests/test_proxy.py: every case -------------------------------------------
def prox_mknode(name):
    return Node(name=name,
                allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})


def prox_mkpod(name, node="", labels=None, ready=True):
    p = Pod(name=name, node_name=node, labels=labels or {"app": "web"},
            containers=(Container.make(name="c", requests={"cpu": 100}),))
    if not ready:
        p.conditions = (PodCondition(type="Ready", status="False"),)
    return p


class TestProxierTable:
    def test_rules_follow_endpoints(self):
        store = Store()
        store.create(SERVICES, Service(name="web", selector={"app": "web"}))
        store.create(ENDPOINTS, Endpoints(
            name="web", addresses=(("default/p1", "n1"),
                                   ("default/p2", "n2"))))
        prox = VirtualProxier(store, "n1")
        prox.sync()
        assert prox.backends("default/web") == (("default/p1", "n1"),
                                                ("default/p2", "n2"))
        # endpoint churn resyncs the table
        store.guaranteed_update(
            ENDPOINTS, "default/web",
            lambda e: (setattr(e, "addresses", (("default/p2", "n2"),)), e)[1])
        prox.pump()
        assert prox.backends("default/web") == (("default/p2", "n2"),)

    def test_service_without_endpoints_rejects(self):
        store = Store()
        store.create(SERVICES, Service(name="web", selector={"app": "web"}))
        prox = VirtualProxier(store, "n1")
        prox.sync()
        assert prox.backends("default/web") == ()
        assert prox.route("default/web") is None   # REJECT, like iptables

    def test_route_round_robin(self):
        store = Store()
        store.create(SERVICES, Service(name="web", selector={"app": "web"}))
        store.create(ENDPOINTS, Endpoints(
            name="web", addresses=(("default/a", "n1"), ("default/b", "n2"),
                                   ("default/c", "n3"))))
        prox = VirtualProxier(store, "n1")
        prox.sync()
        picks = [prox.route("default/web")[0] for _ in range(6)]
        assert picks == ["default/a", "default/b", "default/c"] * 2

    def test_full_resync_semantics(self):
        """Service deletion drops its chain entirely (the reference's
        rebuild-everything sync, not incremental patching)."""
        store = Store()
        store.create(SERVICES, Service(name="web", selector={"app": "web"}))
        store.create(ENDPOINTS, Endpoints(
            name="web", addresses=(("default/a", "n1"),)))
        prox = VirtualProxier(store, "n1")
        prox.sync()
        assert "default/web" in prox.rules()
        store.delete(SERVICES, "default/web")
        store.delete(ENDPOINTS, "default/web")
        prox.pump()
        assert prox.rules() == {}
        assert prox.route("default/web") is None


class TestEndpointsToProxyFlow:
    def test_propagation_through_controller(self):
        """Service -> ready pods -> endpoints controller -> every node's
        forwarding table, including readiness filtering and pod removal."""
        store = Store()
        for i in range(3):
            store.create(NODES, prox_mknode(f"n{i}"))
        epc = EndpointsController(store)
        epc.sync()
        proxies = [VirtualProxier(store, f"n{i}") for i in range(3)]
        for p in proxies:
            p.sync()
        store.create(SERVICES, Service(name="web", selector={"app": "web"}))
        store.create(PODS, prox_mkpod("p1", node="n0"))
        store.create(PODS, prox_mkpod("p2", node="n1"))
        store.create(PODS, prox_mkpod("unready", node="n2", ready=False))
        store.create(PODS, prox_mkpod("other", node="n2", labels={"app": "db"}))
        epc.pump()
        for p in proxies:
            p.pump()
            assert p.backends("default/web") == (("default/p1", "n0"),
                                                 ("default/p2", "n1")), \
                f"node {p.node_name} table diverged"
        # pod deletion propagates to every table
        store.delete(PODS, "default/p1")
        epc.pump()
        for p in proxies:
            p.pump()
            assert p.backends("default/web") == (("default/p2", "n1"),)

    def test_cluster_in_a_process_flow(self):
        """The whole pipeline through cluster.py: a Deployment's pods are
        scheduled, run by hollow kubelets, collected into Endpoints, and
        appear in every node's proxier — then route() balances across
        them."""
        from kubernetes_tpu_torch.cmd.cluster import Cluster
        from kubernetes_tpu_torch.api.types import (Deployment, LabelSelector,
                                              PodTemplate)
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS
        with Cluster(n_nodes=4, api_port=-1, device="cpu",
                     kubelet_interval=0.02) as cluster:
            cluster.store.create(SERVICES, Service(
                name="web", selector={"app": "web"}))
            cluster.store.create(DEPLOYMENTS, Deployment(
                name="web", replicas=3,
                selector=LabelSelector.from_dict({"app": "web"}),
                template=PodTemplate(labels={"app": "web"},
                                     containers=(Container.make(
                                         name="c", requests={"cpu": 100}),))))

            def propagated():
                return all(len(p.backends("default/web")) == 3
                           for p in cluster.proxies)
            assert cluster.wait_for(propagated, timeout=30.0)
            prox = cluster.proxies[0]
            picks = {prox.route("default/web")[0] for _ in range(3)}
            assert len(picks) == 3   # spread across all three backends


# -- tests/test_node_churn.py: the controller and hollow-kubelet classes -------
def churn_make_node(name, zone=None, ready="True", cpu=4000):
    labels = {LABEL_HOSTNAME: name}
    if zone is not None:
        labels[LABEL_ZONE_FAILURE_DOMAIN] = zone
    return Node(name=name, labels=labels,
                allocatable={"cpu": cpu, "memory": 8 * GI, "pods": 110},
                conditions=(NodeCondition(type="Ready", status=ready),))


def churn_bound_pod(name, node, labels=None, tolerations=(), ct=0.0):
    p = Pod(name=name, node_name=node, labels=labels or {},
            tolerations=tolerations,
            containers=(Container.make(name="c", requests={"cpu": 100}),))
    p.creation_timestamp = ct
    return p


def churn_flip_ready(store, name, status):
    def mutate(n):
        n.conditions = (NodeCondition(type="Ready", status=status),)
        return n
    store.guaranteed_update(NODES, name, mutate)


class TestLeaseKind:
    def test_lease_serde_roundtrip(self):
        from kubernetes_tpu_torch.api import serde
        lease = Lease(name="node-n0", holder="n0", acquire_time=1.0,
                      renew_time=2.0, lease_duration=40.0)
        d = serde.to_dict(lease)
        back = serde.from_dict(LEASES, d)
        assert back == lease

    def test_lease_kind_registered_and_leader_election_alias(self):
        from kubernetes_tpu_torch.api import serde
        from kubernetes_tpu_torch.utils import leader_election
        assert serde.KIND_TYPES[LEASES] is Lease
        # back-compat: the resourcelock import path is the same class
        assert leader_election.Lease is Lease

    def test_lease_served_over_http(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store = Store()
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            remote.create(LEASES, Lease(name="node-w0", holder="w0",
                                        renew_time=5.0))
            got = remote.get(LEASES, "node-w0")
            assert got.holder == "w0" and got.renew_time == 5.0

            def renew(l):
                l.renew_time = 9.0
                return l
            remote.guaranteed_update(LEASES, "node-w0", renew)
            assert store.get(LEASES, "node-w0").renew_time == 9.0
            objs, _rv = remote.list(LEASES)
            assert [o.name for o in objs] == ["node-w0"]
            remote.delete(LEASES, "node-w0")
            with pytest.raises(NotFoundError):
                store.get(LEASES, "node-w0")


class TestHeartbeatLeases:
    def test_heartbeat_renews_and_counts(self):
        from kubernetes_tpu_torch.models.hollow import HollowKubelet, LEASE_RENEWS
        clock = FakeClock(100.0)
        store = Store()
        store.create(NODES, churn_make_node("n0"))
        k = HollowKubelet(store, "n0", clock=clock)
        created0 = LEASE_RENEWS.labels("created").value
        renewed0 = LEASE_RENEWS.labels("renewed").value
        k.heartbeat()
        assert LEASE_RENEWS.labels("created").value == created0 + 1
        lease = store.get(LEASES, node_lease_key("n0"))
        assert lease.holder == "n0" and lease.renew_time == 100.0
        clock.step(10)
        k.heartbeat()
        assert LEASE_RENEWS.labels("renewed").value == renewed0 + 1
        assert store.get(LEASES, node_lease_key("n0")).renew_time == 110.0

    def test_monitor_grades_unknown_from_lease_staleness(self):
        from kubernetes_tpu_torch.models.hollow import HollowKubelet
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController, TAINT_UNREACHABLE)
        clock = FakeClock(100.0)
        store = Store()
        for n in ("n0", "n1"):
            store.create(NODES, churn_make_node(n))
        kubelets = {n: HollowKubelet(store, n, clock=clock)
                    for n in ("n0", "n1")}
        for k in kubelets.values():
            k.heartbeat()
        c = NodeLifecycleController(store, clock=clock,
                                    node_monitor_grace=30.0)
        c.sync()
        # inside grace: nothing graded
        clock.step(20)
        kubelets["n1"].heartbeat()
        c.pump()
        assert all(cond.status == "True"
                   for n in store.list(NODES)[0] for cond in n.conditions
                   if cond.type == "Ready")
        # n0 silent past the grace period -> Unknown + unreachable taints
        clock.step(20)
        kubelets["n1"].heartbeat()
        c.pump()
        n0 = store.get(NODES, "n0")
        assert any(cond.type == "Ready" and cond.status == "Unknown"
                   for cond in n0.conditions)
        assert {t.key for t in n0.taints} == {TAINT_UNREACHABLE}
        # the healthy heartbeater stays Ready
        assert store.get(NODES, "n1").taints == ()

    def test_clock_jump_chaos_covers_heartbeat(self):
        """A chaos clock jump swallows the grace period between two
        heartbeats: the lease goes stale through no fault of the kubelet
        and the monitor grades Unknown — the heartbeat plane is covered
        by the clock.jump seam like every other lease consumer."""
        from kubernetes_tpu_torch import chaos
        from kubernetes_tpu_torch.models.hollow import HollowKubelet
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController)
        base = FakeClock(100.0)
        chaos.plan(seed=7, rates={"clock.jump": 1.0},
                   jump_range=(50.0, 50.0))
        try:
            clock = chaos.wrap_clock(base)
            store = Store()
            store.create(NODES, churn_make_node("n0"))
            k = HollowKubelet(store, "n0", clock=base)   # kubelet: real time
            k.heartbeat()
            c = NodeLifecycleController(store, clock=clock,
                                        node_monitor_grace=30.0)
            c.sync()
            c.pump()   # monitor's now() jumped +50s past the renew
            n0 = store.get(NODES, "n0")
            assert any(cond.type == "Ready" and cond.status == "Unknown"
                       for cond in n0.conditions)
        finally:
            chaos.disable()


class TestEvictionDeadlineTable:
    TAINT = Taint(key="node.kubernetes.io/unreachable", effect=NO_EXECUTE)

    def _deadline(self, tolerations, since=100.0):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController)
        pod = Pod(name="p", tolerations=tolerations)
        return NodeLifecycleController._eviction_deadline(
            pod, [self.TAINT], {self.TAINT.key: since})

    def test_no_matching_toleration_evicts_immediately(self):
        assert self._deadline(()) == 0.0

    def test_matching_without_seconds_never_evicts(self):
        tol = Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                         effect=NO_EXECUTE)
        assert self._deadline((tol,)) is None

    def test_zero_seconds_is_immediate(self):
        tol = Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                         effect=NO_EXECUTE, toleration_seconds=0)
        assert self._deadline((tol,)) == 100.0   # since + 0

    def test_negative_seconds_clamps_to_zero(self):
        tol = Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                         effect=NO_EXECUTE, toleration_seconds=-30)
        assert self._deadline((tol,)) == 100.0   # clamped, not since - 30

    def test_positive_seconds_offsets_since(self):
        tol = Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                         effect=NO_EXECUTE, toleration_seconds=7)
        assert self._deadline((tol,)) == 107.0

    def test_min_across_matching_tolerations(self):
        tols = (Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                           effect=NO_EXECUTE, toleration_seconds=30),
                Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                           effect=NO_EXECUTE, toleration_seconds=5))
        assert self._deadline(tols) == 105.0

    def test_must_tolerate_every_noexecute_taint(self):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController)
        other = Taint(key="node.kubernetes.io/not-ready", effect=NO_EXECUTE)
        tol = Toleration(key=self.TAINT.key, op=TOLERATION_OP_EXISTS,
                         effect=NO_EXECUTE)
        pod = Pod(name="p", tolerations=(tol,))
        assert NodeLifecycleController._eviction_deadline(
            pod, [self.TAINT, other],
            {self.TAINT.key: 100.0, other.key: 100.0}) == 0.0


class TestZonePacedEviction:
    def _controller(self, store, clock, **kw):
        from kubernetes_tpu_torch.controllers.nodelifecycle import (
            NodeLifecycleController)
        kw.setdefault("eviction_rate", 0.5)           # 1 eviction / 2s
        kw.setdefault("secondary_eviction_rate", 0.1)  # 1 eviction / 10s
        return NodeLifecycleController(store, clock=clock, **kw)

    def test_normal_zone_paces_at_primary_rate(self):
        clock = FakeClock(1000.0)
        store = Store()
        # zone z0: 1 of 4 nodes dead -> Normal (0.25 < 0.55)
        for i in range(4):
            store.create(NODES, churn_make_node(f"n{i}", zone="z0"))
        for j in range(3):
            store.create(PODS, churn_bound_pod(f"p{j}", "n0", ct=float(j)))
        c = self._controller(store, clock)
        c.sync()
        churn_flip_ready(store, "n0", "False")
        c.pump()
        from kubernetes_tpu_torch.controllers.nodelifecycle import STATE_NORMAL
        assert c._zone_state["z0"] == STATE_NORMAL
        # burst token covers exactly one eviction; the rest are paced
        assert len(store.list(PODS)[0]) == 2
        c.pump()
        assert len(store.list(PODS)[0]) == 2   # no time passed, no token
        clock.step(2.0)
        c.pump()
        assert len(store.list(PODS)[0]) == 1
        clock.step(2.0)
        c.pump()
        assert len(store.list(PODS)[0]) == 0

    def test_partial_zone_drops_to_secondary_rate(self):
        clock = FakeClock(1000.0)
        store = Store()
        # zone z0 healthy; zone z1: 2 of 3 dead -> PartialDisruption
        store.create(NODES, churn_make_node("h0", zone="z0"))
        for i in range(3):
            store.create(NODES, churn_make_node(f"u{i}", zone="z1"))
        for j in range(2):
            store.create(PODS, churn_bound_pod(f"p{j}", "u0", ct=float(j)))
        c = self._controller(store, clock)
        c.sync()
        churn_flip_ready(store, "u0", "False")
        churn_flip_ready(store, "u1", "Unknown")
        c.pump()
        from kubernetes_tpu_torch.controllers.nodelifecycle import STATE_PARTIAL
        assert c._zone_state["z1"] == STATE_PARTIAL
        assert len(store.list(PODS)[0]) == 1   # burst token only
        # primary-rate interval is NOT enough at the secondary rate
        clock.step(2.0)
        c.pump()
        assert len(store.list(PODS)[0]) == 1
        # secondary rate (0.1/s) releases the next token after 10s
        clock.step(8.0)
        c.pump()
        assert len(store.list(PODS)[0]) == 0

    def test_full_disruption_zone_evicts_nothing(self):
        clock = FakeClock(1000.0)
        store = Store()
        store.create(NODES, churn_make_node("h0", zone="z0"))   # healthy zone
        for i in range(2):
            store.create(NODES, churn_make_node(f"d{i}", zone="z1"))
        store.create(PODS, churn_bound_pod("p0", "d0"))
        c = self._controller(store, clock)
        c.sync()
        churn_flip_ready(store, "d0", "False")
        churn_flip_ready(store, "d1", "Unknown")
        c.pump()
        from kubernetes_tpu_torch.controllers.nodelifecycle import STATE_FULL
        assert c._zone_state["z1"] == STATE_FULL
        for _ in range(5):
            clock.step(60.0)
            c.pump()
        # the pod is tainted-intolerant and long past due, but its zone is
        # fully disrupted: ZERO evictions
        assert {p.key for p in store.list(PODS)[0]} == {"default/p0"}
        # one node recovers -> zone leaves FullDisruption -> eviction flows
        churn_flip_ready(store, "d1", "True")
        c.pump()
        assert store.list(PODS)[0] == []

    def test_no_eviction_while_budget_exhausted(self):
        clock = FakeClock(1000.0)
        store = Store()
        store.create(NODES, churn_make_node("h0", zone="z0"))
        for i in range(3):
            store.create(NODES, churn_make_node(f"n{i}", zone="z1"))
        store.create(PODS, churn_bound_pod("w0", "n0", labels={"app": "web"}))
        store.create(PDBS, PodDisruptionBudget(
            name="web", selector=LabelSelector(match_labels=(("app", "web"),)),
            min_available=1, disruptions_allowed=0))
        c = self._controller(store, clock, eviction_rate=10.0)
        c.sync()
        churn_flip_ready(store, "n0", "False")
        for _ in range(4):
            clock.step(30.0)
            c.pump()
        # due for eviction, tokens plentiful — but disruptionsAllowed == 0
        assert "default/w0" in {p.key for p in store.list(PODS)[0]}
        # the budget opens: the queued eviction lands on the next pump
        def open_budget(b):
            b.disruptions_allowed = 1
            return b
        store.guaranteed_update(PDBS, "default/web", open_budget)
        clock.step(1.0)
        c.pump()
        assert "default/w0" not in {p.key for p in store.list(PODS)[0]}

    def test_debug_section_exposes_zone_states_and_tokens(self):
        from kubernetes_tpu_torch import obs
        clock = FakeClock(1000.0)
        store = Store()
        for i in range(2):
            store.create(NODES, churn_make_node(f"n{i}", zone="z0"))
        c = self._controller(store, clock)
        c.sync()
        c.pump()
        snap = obs.debug_snapshot()
        assert "nodelifecycle" in snap
        zones = snap["nodelifecycle"]["zones"]
        assert zones["z0"]["state"] == "Normal"
        assert zones["z0"]["tokens"] is not None
        assert zones["z0"]["queued"] == 0


class TestEvictionSubresource:
    def _cluster(self, store):
        store.create(NODES, churn_make_node("n0"))
        for n in ("w0", "w1"):
            store.create(PODS, churn_bound_pod(n, "n0", labels={"app": "web"}))
        store.create(PDBS, PodDisruptionBudget(
            name="web", selector=LabelSelector(match_labels=(("app", "web"),)),
            min_available=1, disruptions_allowed=1))

    def test_store_verb_charges_budget_atomically(self):
        store = Store()
        self._cluster(store)
        store.evict_pod("default/w0")
        assert store.get(PDBS, "default/web").disruptions_allowed == 0
        with pytest.raises(DisruptionBudgetError):
            store.evict_pod("default/w1")
        assert "default/w1" in {p.key for p in store.list(PODS)[0]}

    def test_concurrent_evictors_budget_of_one(self):
        """Two evictors race a budget of 1 through the live HTTP
        subresource: exactly one 201 and one 429 (+ Retry-After)."""
        import urllib.request
        import urllib.error
        from kubernetes_tpu_torch.apiserver.server import APIServer
        store = Store()
        self._cluster(store)
        results = []
        lock = threading.Lock()

        def evict(url, key):
            req = urllib.request.Request(
                f"{url}/api/v1/pods/{key}/eviction", data=b"{}",
                method="POST", headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as resp:
                    with lock:
                        results.append((resp.status, None))
            except urllib.error.HTTPError as e:
                with lock:
                    results.append((e.code, e.headers.get("Retry-After")))
        with APIServer(store) as srv:
            ts = [threading.Thread(target=evict,
                                   args=(srv.url, f"default/w{i}"))
                  for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(5.0)
        codes = sorted(c for c, _ra in results)
        assert codes == [201, 429]
        retry_after = next(ra for c, ra in results if c == 429)
        assert retry_after is not None and int(retry_after) > 0
        # exactly one web pod survived; the budget reads exhausted
        left = [p for p in store.list(PODS)[0] if p.labels.get("app") == "web"]
        assert len(left) == 1
        assert store.get(PDBS, "default/web").disruptions_allowed == 0

    def test_remote_store_maps_429(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store = Store()
        self._cluster(store)
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            gone = remote.evict_pod("default/w0")
            assert gone.name == "w0"
            with pytest.raises(DisruptionBudgetError) as ei:
                remote.evict_pod("default/w1")
            assert ei.value.retry_after > 0
            with pytest.raises(NotFoundError):
                remote.evict_pod("default/w0")

    def test_disruption_controller_reconciles_after_evictions(self):
        """The eviction charge and the controller recompute share the PDB
        status: after one eviction (2 healthy -> 1, minAvailable 1), the
        recompute re-derives disruptionsAllowed == 0 from pod state."""
        from kubernetes_tpu_torch.controllers.disruption import DisruptionController
        store = Store()
        self._cluster(store)
        dc = DisruptionController(store)
        dc.sync()
        assert store.get(PDBS, "default/web").disruptions_allowed == 1
        store.evict_pod("default/w0")
        dc.pump()
        pdb = store.get(PDBS, "default/web")
        assert pdb.current_healthy == 1
        assert pdb.disruptions_allowed == 0


class TestPodGCNodeLost:
    def test_orphans_force_deleted_with_nodelost_event(self):
        from kubernetes_tpu_torch.controllers.podgc import PodGCController
        from kubernetes_tpu_torch.store.store import EVENTS
        store = Store()
        store.create(NODES, churn_make_node("n0"))
        store.create(PODS, churn_bound_pod("a", "n0"))
        store.create(PODS, churn_bound_pod("b", "ghost"))
        gc = PodGCController(store)
        gc.sync()
        store.delete(NODES, "n0")
        gc.pump()
        assert store.list(PODS)[0] == []
        reasons = {e.reason for e in store.list(EVENTS)[0]}
        assert "NodeLost" in reasons

    def test_recreated_pods_sort_by_creation_in_activeq(self):
        """node dies -> podgc force-deletes its pods (NodeLost) -> the
        workload recreates them -> they must pop from the activeQ in
        CREATION order (the recovery-ordering contract extended to
        the churn path)."""
        from kubernetes_tpu_torch.controllers.podgc import PodGCController
        from kubernetes_tpu_torch.scheduler import Scheduler
        clock = FakeClock(50.0)
        store = Store()
        for i in range(2):
            store.create(NODES, churn_make_node(f"n{i}"))
        for j in range(4):
            store.create(PODS, churn_bound_pod(f"p{j}", "n0", ct=float(j)))
        gc = PodGCController(store)
        gc.sync()
        sched = Scheduler(store, use_device=False, clock=clock,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        store.delete(NODES, "n0")
        assert gc.pump() == 4
        # the "controller" recreates the lost pods (store insertion order
        # IS creation order, like any real workload controller's loop)
        for j in range(4):
            store.create(PODS, Pod(
                name=f"p{j}-r", labels={}, containers=(
                    Container.make(name="c", requests={"cpu": 100}),)))
        sched.pump()
        popped = []
        while True:
            pod = sched.queue.pop(timeout=0.0)
            if pod is None:
                break
            popped.append(pod.name)
        assert popped == [f"p{j}-r" for j in range(4)]


class TestChurnObsEagerRegistration:
    def test_families_render_without_activity(self):
        from kubernetes_tpu_torch import obs
        # import the owners so registration side effects run
        import kubernetes_tpu_torch.models.hollow      # noqa: F401
        import kubernetes_tpu_torch.controllers.nodelifecycle   # noqa: F401
        import kubernetes_tpu_torch.scheduler          # noqa: F401
        import kubernetes_tpu_torch.store.store        # noqa: F401
        text = obs.render_global()
        for family in ("node_lease_renew_total", "zone_disruption_state",
                       "evictions_total", "stale_bind_requeues_total"):
            assert f"# HELP {family} " in text, family


# -- tests/test_coscheduling.py: TestPodGroupController and the manager case ---
def gang_member(name, group, cpu=100, **kw):
    labels = dict(kw.pop("labels", {}))
    labels[LABEL_POD_GROUP] = group
    containers = kw.pop("containers", (
        Container.make(name="c", requests={"cpu": cpu}),))
    return Pod(name=name, labels=labels, containers=containers, **kw)


class TestPodGroupController:
    def _ctl(self, store, clock):
        from kubernetes_tpu_torch.controllers.podgroup import PodGroupController
        return PodGroupController(store, clock=clock)

    def test_phase_progression_and_counts(self):
        clock = FakeClock(100.0)
        store = Store(watch_log_size=65536)
        store.create(PODGROUPS, PodGroup(name="g", min_member=2,
                                         creation_timestamp=100.0))
        ctl = self._ctl(store, clock)
        ctl.sync()
        assert store.get(PODGROUPS, "default/g").phase == PHASE_PENDING
        store.create(PODS, gang_member("m0", "g"))
        ctl.pump()
        g = store.get(PODGROUPS, "default/g")
        assert g.phase == PHASE_PENDING and g.members == 1
        store.create(PODS, gang_member("m1", "g"))
        ctl.pump()
        assert store.get(PODGROUPS, "default/g").phase == PHASE_PRESCHEDULING
        # members bind -> Scheduled with live counts
        for j in range(2):
            store.bind_pod(f"default/m{j}", "n0")
        ctl.pump()
        g = store.get(PODGROUPS, "default/g")
        assert g.phase == PHASE_SCHEDULED
        assert g.members == 2 and g.scheduled == 2
        # a gang_member deleted (evicted) drops it back below minMember
        store.delete(PODS, "default/m1")
        ctl.pump()
        g = store.get(PODGROUPS, "default/g")
        assert g.phase == PHASE_PRESCHEDULING and g.scheduled == 1

    def test_timeout_marks_unschedulable_with_event(self):
        clock = FakeClock(100.0)
        store = Store(watch_log_size=65536)
        store.create(PODGROUPS, PodGroup(name="g", min_member=3,
                                         schedule_timeout_seconds=30.0,
                                         creation_timestamp=100.0))
        ctl = self._ctl(store, clock)
        ctl.sync()
        store.create(PODS, gang_member("m0", "g"))
        ctl.pump()
        assert store.get(PODGROUPS, "default/g").phase == PHASE_PENDING
        clock.step(31.0)
        store.create(PODS, gang_member("m1", "g"))   # still short of minMember
        ctl.pump()
        assert store.get(PODGROUPS, "default/g").phase == PHASE_UNSCHEDULABLE
        events, _ = store.list(EVENTS)
        assert any(e.reason == "GangTimeout" for e in events)
        # a late successful placement recovers the group
        for j in range(2):
            store.bind_pod(f"default/m{j}", "n0")
        store.create(PODS, gang_member("m2", "g", node_name="n1"))
        ctl.pump()
        assert store.get(PODGROUPS, "default/g").phase == PHASE_SCHEDULED

    def test_manager_hosts_podgroup_controller(self):
        from kubernetes_tpu_torch.controllers.manager import (
            CONTROLLER_INITIALIZERS, ControllerManager)
        assert "podgroup" in CONTROLLER_INITIALIZERS
        store = Store()
        mgr = ControllerManager(store, enabled=["podgroup"])
        mgr.sync()


# -- tests/test_auth.py: TestNodeIpam and the clusterrole aggregation controller ---
def auth_mknode(name):
    return Node(name=name,
                allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})


class TestStoreBackedRBAC:
    """RBAC policy as API objects: clusterroles / clusterrolebindings in
    the store drive authorization live, and the aggregation controller
    unions labeled roles (clusterroleaggregation_controller.go)."""

    def test_aggregation_controller_unions_rules(self):
        from kubernetes_tpu_torch.apiserver.auth import Role, PolicyRule
        from kubernetes_tpu_torch.controllers.clusterrole_aggregation import (
            ClusterRoleAggregationController)
        from kubernetes_tpu_torch.store.store import CLUSTERROLES
        store = Store()
        ctl = ClusterRoleAggregationController(store)
        ctl.sync()
        store.create(CLUSTERROLES, Role(
            name="admin", aggregation_labels={"rbac/aggregate": "true"}))
        store.create(CLUSTERROLES, Role(
            name="pods-reader", labels={"rbac/aggregate": "true"},
            rules=(PolicyRule(verbs=("get",), resources=("pods",)),)))
        ctl.pump()
        agg = store.get(CLUSTERROLES, "admin")
        assert agg.rules == (PolicyRule(verbs=("get",),
                                        resources=("pods",)),)
        # a new labeled role re-aggregates
        store.create(CLUSTERROLES, Role(
            name="nodes-reader", labels={"rbac/aggregate": "true"},
            rules=(PolicyRule(verbs=("list",), resources=("nodes",)),)))
        ctl.pump()
        agg = store.get(CLUSTERROLES, "admin")
        assert len(agg.rules) == 2


class TestNodeIpam:
    def test_assigns_disjoint_cidrs(self):
        from kubernetes_tpu_torch.controllers.nodeipam import NodeIpamController
        store = Store()
        for i in range(5):
            store.create(NODES, auth_mknode(f"n{i}"))
        ctl = NodeIpamController(store)
        ctl.sync()
        cidrs = [n.pod_cidr for n in store.list(NODES)[0]]
        assert all(c.endswith("/24") for c in cidrs)
        assert len(set(cidrs)) == 5
        # a deleted node's slot is reused by a newcomer
        freed = store.get(NODES, "n2").pod_cidr
        store.delete(NODES, "n2")
        store.create(NODES, auth_mknode("n9"))
        ctl.pump()
        assert store.get(NODES, "n9").pod_cidr == freed


# -- tests/test_remote.py: the controller manager over HTTP --------------------
def remote_wait_until(cond, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


class TestRemoteScheduler:
    def test_controller_manager_attaches_over_http(self):
        """The controller manager's whole surface (list / get / create /
        update / delete / guaranteed_update + informers) works over the
        remote transport: a Deployment reconciles to pods through HTTP."""
        from kubernetes_tpu_torch.controllers.manager import ControllerManager
        from kubernetes_tpu_torch.api.types import (Deployment, PodTemplate,
                                              LabelSelector)
        from kubernetes_tpu_torch.store.store import DEPLOYMENTS
        store = Store(watch_log_size=65536)
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            mgr = ControllerManager(remote,
                                    enabled=["deployment", "replicaset"])
            mgr.sync()
            remote.create(DEPLOYMENTS, Deployment(
                name="web", replicas=3,
                selector=LabelSelector.from_dict({"app": "web"}),
                template=PodTemplate(
                    labels={"app": "web"},
                    containers=(Container.make(
                        name="c", requests={"cpu": 100}),))))

            def reconciled():
                mgr.pump()
                pods, _ = store.list(PODS)
                return len(pods) == 3
            assert remote_wait_until(reconciled, timeout=20.0)
            assert all(p.labels.get("app") == "web"
                       for p in store.list(PODS)[0])
