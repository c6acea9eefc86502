"""Hollow cluster generators — the kubemark analog.

Mirrors pkg/kubemark (hollow_kubelet.go:44 — real control-plane-visible
nodes with fake substance) and test/utils/runners.go NodePreparer
strategies: thousands of realistic nodes (zones, labels, capacity shapes)
and pod-creation strategies, sourced straight into the store so control
plane scale is testable without machines.

Copied from the reference (`kubernetes_tpu.models.hollow`) with the
port's imports: the generators (`NodeStrategy`, `PodStrategy`,
`make_hollow_nodes`, `make_pods`, `populate_store`), which for the same
strategies and seed build the same nodes and pods as the reference, and
the hollow node agents the cluster-in-a-process runs: `HollowKubelet`
(lease renewal, node Ready, the fake runtime that runs Pending pods,
counted in `LEASE_RENEWS`) and `HollowProxy` (the service routing table).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterable, Optional

from kubernetes_tpu_torch.api.types import (
    Node, Pod, Container, ContainerPort, Taint, Affinity,
    PodAffinity, PodAntiAffinity, PodAffinityTerm,
    NodeAffinity, NodeSelectorTerm, Requirement,
    LabelSelector, IN,
    LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION, LABEL_HOSTNAME,
)
from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.store.store import Store, NODES, PODS

GI = 1024 ** 3
MI = 1024 ** 2

# the scheduler_perf node shape (reference: scheduler_test.go:49-64)
PERF_NODE_CPU = 4000
PERF_NODE_MEM = 32 * GI
PERF_NODE_PODS = 110

# node heartbeat observability (kubelet nodelease controller analog):
# registered at import so /metrics exposes the family before the first
# heartbeat — a fleet whose renewals stop is visible as a flat counter
LEASE_RENEWS = obs.counter(
    "node_lease_renew_total",
    "Node heartbeat Lease renewals by outcome: renewed (CAS on the "
    "existing record), created (first heartbeat), failed (the store "
    "rejected the write — the node will grade Unknown after the "
    "monitor grace period).", ("outcome",))


@dataclass
class NodeStrategy:
    """TestNodePreparer analog: how to shape a batch of hollow nodes."""
    count: int
    cpu: int = PERF_NODE_CPU
    mem: int = PERF_NODE_MEM
    pods: int = PERF_NODE_PODS
    zones: int = 0                 # 0 = unzoned
    region: str = "region-1"
    label_fracs: dict = field(default_factory=dict)   # label -> (value, fraction)
    taint_frac: float = 0.0
    taint: Optional[Taint] = None
    name_prefix: str = "hollow-node"


def make_hollow_nodes(strategy: NodeStrategy, seed: int = 0,
                      start_index: int = 0) -> list[Node]:
    rng = random.Random(seed)
    nodes = []
    for i in range(start_index, start_index + strategy.count):
        name = f"{strategy.name_prefix}-{i}"
        labels = {LABEL_HOSTNAME: name}
        if strategy.zones:
            labels[LABEL_ZONE_FAILURE_DOMAIN] = f"zone-{i % strategy.zones}"
            labels[LABEL_ZONE_REGION] = strategy.region
        for key, (value, frac) in strategy.label_fracs.items():
            if rng.random() < frac:
                labels[key] = value
        taints = ()
        if strategy.taint is not None and rng.random() < strategy.taint_frac:
            taints = (strategy.taint,)
        nodes.append(Node(
            name=name, labels=labels, taints=taints,
            allocatable={"cpu": strategy.cpu, "memory": strategy.mem,
                         "pods": strategy.pods}))
    return nodes


@dataclass
class PodStrategy:
    """TestPodCreator strategy analog (test/utils/runners.go)."""
    count: int
    cpu: int = 100                 # milli
    mem: int = 500 * MI
    name_prefix: str = "pod"
    namespace: str = "default"
    labels: dict = field(default_factory=lambda: {"app": "density"})
    # feature knobs matching scheduler_bench_test.go matrices
    anti_affinity_topology: Optional[str] = None   # e.g. hostname label
    affinity_topology: Optional[str] = None
    node_affinity_key: Optional[str] = None
    node_affinity_values: tuple = ()
    host_port: int = 0
    tolerations: tuple = ()
    priority: int = 0


def make_pods(strategy: PodStrategy, start_index: int = 0) -> list[Pod]:
    pods = []
    for j in range(start_index, start_index + strategy.count):
        kw = {}
        affinity_parts = {}
        if strategy.anti_affinity_topology:
            term = PodAffinityTerm(
                label_selector=LabelSelector.from_dict(dict(strategy.labels)),
                topology_key=strategy.anti_affinity_topology)
            affinity_parts["pod_anti_affinity"] = PodAntiAffinity(required=(term,))
        if strategy.affinity_topology:
            term = PodAffinityTerm(
                label_selector=LabelSelector.from_dict(dict(strategy.labels)),
                topology_key=strategy.affinity_topology)
            affinity_parts["pod_affinity"] = PodAffinity(required=(term,))
        if strategy.node_affinity_key:
            affinity_parts["node_affinity"] = NodeAffinity(
                required=(NodeSelectorTerm(match_expressions=(
                    Requirement(key=strategy.node_affinity_key, op=IN,
                                values=strategy.node_affinity_values),)),))
        if affinity_parts:
            kw["affinity"] = Affinity(**affinity_parts)
        ports = ()
        if strategy.host_port:
            ports = (ContainerPort(host_port=strategy.host_port,
                                   container_port=strategy.host_port),)
        pods.append(Pod(
            name=f"{strategy.name_prefix}-{j}",
            namespace=strategy.namespace,
            labels=dict(strategy.labels),
            tolerations=strategy.tolerations,
            priority=strategy.priority,
            containers=(Container.make(
                name="c", requests={"cpu": strategy.cpu, "memory": strategy.mem},
                ports=ports),),
            **kw))
    return pods


def populate_store(store: Store, node_strategies: Iterable[NodeStrategy],
                   existing_pod_strategies: Iterable[PodStrategy] = (),
                   seed: int = 0) -> tuple[int, int]:
    """Load hollow nodes (and optionally pre-placed pods) into the store.
    Pre-placed pods are spread round-robin across the nodes with node_name
    already set, like the benchmark's 'existing pods' population."""
    all_nodes = []
    idx = 0
    for st in node_strategies:
        batch = make_hollow_nodes(st, seed=seed, start_index=idx)
        idx += st.count
        all_nodes.extend(batch)
        for n in batch:
            store.create(NODES, n)
    placed = 0
    pidx = 0
    for ps in existing_pod_strategies:
        for pod in make_pods(ps, start_index=pidx):
            pod.node_name = all_nodes[placed % len(all_nodes)].name
            store.create(PODS, pod)
            placed += 1
        pidx += ps.count
    return len(all_nodes), placed


class HollowKubelet:
    """Hollow node agent — pkg/kubemark/hollow_kubelet.go:44 plus the node
    heartbeat the real kubelet performs (NodeLease renewal + Ready status,
    pkg/kubelet nodelease/nodestatus): each heartbeat() CASes the node's
    Lease record and asserts Ready=True on the Node through the store.
    `stop()` silences it — the failure-injection switch: the node-lifecycle
    controller's health monitor then grades the node Unknown, taints it,
    and evicts its pods."""

    def __init__(self, store: Store, node_name: str, clock=None):
        from kubernetes_tpu_torch.utils.clock import RealClock
        self.store = store
        self.node_name = node_name
        self.clock = clock or RealClock()
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    def heartbeat(self, pods=None) -> None:
        """One kubelet sync tick: renew the node lease, assert node Ready,
        and 'run' the pods bound here (hollow_kubelet.go's fake runtime:
        Pending pods become Running with Ready=True and a start time — the
        status the disruption controller's healthy count and the reference's
        IsPodReady read).

        A fleet driving thousands of hollow kubelets must store.list(PODS)
        ONCE per round and pass the result as `pods` — otherwise each
        heartbeat lists (clones) the whole pod set itself, making one fleet
        round O(nodes x pods) in pod clones."""
        if self._stopped:
            return
        from kubernetes_tpu_torch.api.types import Lease, NodeCondition, \
            node_lease_key
        from kubernetes_tpu_torch.store.store import LEASES, NotFoundError
        now = self.clock.now()
        self._run_pods(now, pods)
        lease_key = node_lease_key(self.node_name)
        try:
            def renew(lease):
                lease.holder = self.node_name
                lease.renew_time = now
                return lease
            self.store.guaranteed_update(LEASES, lease_key, renew)
            LEASE_RENEWS.labels("renewed").inc()
        except NotFoundError:
            try:
                self.store.create(LEASES, Lease(
                    name=lease_key, holder=self.node_name,
                    acquire_time=now, renew_time=now))
                LEASE_RENEWS.labels("created").inc()
            except Exception:   # lost a create race / store fault
                LEASE_RENEWS.labels("failed").inc()
        except Exception:       # transport/store fault: next tick retries
            LEASE_RENEWS.labels("failed").inc()

        def set_ready(node):
            conds = [c for c in node.conditions if c.type != "Ready"]
            conds.append(NodeCondition(type="Ready", status="True"))
            new = tuple(conds)
            if new == node.conditions:
                return None
            node.conditions = new
            return node
        try:
            self.store.guaranteed_update(NODES, self.node_name, set_ready,
                                         allow_skip=True)
        except NotFoundError:
            pass

    def _run_pods(self, now: float, pods=None) -> None:
        from kubernetes_tpu_torch.api.types import PodCondition
        from kubernetes_tpu_torch.store.store import NotFoundError
        if pods is None:
            pods, _rv = self.store.list(PODS)
        for pod in pods:
            if pod.node_name != self.node_name or pod.deleted \
                    or pod.phase != "Pending":
                continue

            def run(cur, _now=now):
                if cur.phase != "Pending" or not cur.node_name:
                    return None
                cur.phase = "Running"
                cur.start_time = _now
                conds = [c for c in cur.conditions if c.type != "Ready"]
                conds.append(PodCondition(type="Ready", status="True"))
                cur.conditions = tuple(conds)
                return cur
            try:
                self.store.guaranteed_update(PODS, pod.key, run,
                                             allow_skip=True)
            except NotFoundError:
                continue


class HollowProxy:
    """Hollow kube-proxy — pkg/kubemark/hollow_proxy.go:40 over the
    userspace proxier's data structure: an event-driven service -> backends
    routing table fed by Endpoints watches (the reference programs
    iptables/IPVS from the same inputs; with no kernel here, the table IS
    the dataplane). `route(service)` round-robins across ready backends
    like the userspace proxier's LoadBalancerRR."""

    def __init__(self, store: Store):
        from kubernetes_tpu_torch.store.informer import InformerFactory
        from kubernetes_tpu_torch.store.store import ENDPOINTS
        self.store = store
        self.informers = InformerFactory(store)
        self._table: dict[str, tuple] = {}
        self._rr: dict[str, int] = {}
        eps = self.informers.informer(ENDPOINTS)
        eps.add_event_handler(
            on_add=lambda e: self._table.__setitem__(e.key, e.addresses),
            on_update=lambda o, n: self._table.__setitem__(n.key, n.addresses),
            on_delete=lambda e: (self._table.pop(e.key, None),
                                 self._rr.pop(e.key, None)))

    def sync(self) -> None:
        self.informers.sync_all()
        from kubernetes_tpu_torch.store.store import ENDPOINTS
        for e in self.informers.informer(ENDPOINTS).list():
            self._table[e.key] = e.addresses

    def pump(self) -> int:
        return self.informers.pump_all()

    def backends(self, service_key: str) -> tuple:
        return self._table.get(service_key, ())

    def route(self, service_key: str):
        """(pod_key, node_name) of the next backend, or None when the
        service has no ready endpoints."""
        backends = self._table.get(service_key)
        if not backends:
            return None
        i = self._rr.get(service_key, 0) % len(backends)
        self._rr[service_key] = i + 1
        return backends[i]
