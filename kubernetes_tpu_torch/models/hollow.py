"""Hollow cluster generators — the kubemark analog.

Mirrors pkg/kubemark (hollow_kubelet.go:44 — real control-plane-visible
nodes with fake substance) and test/utils/runners.go NodePreparer
strategies: thousands of realistic nodes (zones, labels, capacity shapes)
and pod-creation strategies, sourced straight into the store so control
plane scale is testable without machines.

Copied from the reference (`kubernetes_tpu.models.hollow`) with the
port's imports, cut to the generators the scheduler command and the
benchmark worlds read: `NodeStrategy`, `PodStrategy`,
`make_hollow_nodes`, `make_pods` and `populate_store`. For the same
strategies and seed they build the same nodes and pods as the
reference. The hollow kubelet and proxy (node heartbeats, the service
routing table) are not copied: nothing on the port's paths runs them.
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
from kubernetes_tpu_torch.store.store import Store, NODES, PODS

GI = 1024 ** 3
MI = 1024 ** 2

# the scheduler_perf node shape (reference: scheduler_test.go:49-64)
PERF_NODE_CPU = 4000
PERF_NODE_MEM = 32 * GI
PERF_NODE_PODS = 110


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
