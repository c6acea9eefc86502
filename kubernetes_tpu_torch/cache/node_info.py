"""Per-node aggregate state — the host-side twin of the device row.

Mirrors the semantics of the reference's NodeInfo
(pkg/scheduler/nodeinfo/node_info.go:47): per-node resource sums, port set,
affinity-pod tracking, image states, and a monotonically increasing
generation used for incremental snapshotting (cache.go:210).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import (
    Node, Pod, ResourceAgg, get_pod_nonzero_requests, get_container_ports,
    has_pod_affinity_terms,
)


def calculate_resource(pod: Pod) -> ResourceAgg:
    """Reference: node_info.go:578 calculateResource — sums *regular*
    containers only. Init containers affect the incoming pod's request
    (predicates.GetResourceRequest) but NOT the node's usage aggregate."""
    r = ResourceAgg()
    for c in pod.containers:
        r.add_requests(c.requests_dict())
    return r

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


def normalized_image_name(name: str) -> str:
    """Reference: nodeinfo.node_info.go — append :latest when no tag/digest."""
    if ":" not in name.rsplit("/", 1)[-1] and "@" not in name:
        name = name + ":latest"
    return name


@dataclass(frozen=True)
class ImageStateSummary:
    size_bytes: int
    num_nodes: int


def _sanitize_ip(ip: str) -> str:
    return ip if ip else "0.0.0.0"


class HostPortInfo:
    """Set of used (protocol, hostIP, port) with 0.0.0.0 wildcard conflict
    semantics (reference: nodeinfo/host_ports.go:47 CheckConflict)."""

    def __init__(self):
        # ip -> set of (protocol, port)
        self._by_ip: dict[str, set[tuple[str, int]]] = {}

    def add(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        self._by_ip.setdefault(_sanitize_ip(ip), set()).add((protocol or "TCP", port))

    def remove(self, ip: str, protocol: str, port: int) -> None:
        if port <= 0:
            return
        ip = _sanitize_ip(ip)
        s = self._by_ip.get(ip)
        if s is not None:
            s.discard((protocol or "TCP", port))
            if not s:
                del self._by_ip[ip]

    def check_conflict(self, ip: str, protocol: str, port: int) -> bool:
        if port <= 0:
            return False
        ip = _sanitize_ip(ip)
        key = (protocol or "TCP", port)
        if ip == "0.0.0.0":
            return any(key in s for s in self._by_ip.values())
        return key in self._by_ip.get(ip, set()) or key in self._by_ip.get("0.0.0.0", set())

    def clone(self) -> "HostPortInfo":
        out = HostPortInfo()
        out._by_ip = {ip: set(s) for ip, s in self._by_ip.items()}
        return out

    def __len__(self):
        return sum(len(s) for s in self._by_ip.values())





class NodeInfo:
    """Aggregated node state (reference: node_info.go:47)."""

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = None
        self.pods: list[Pod] = []
        self.pods_with_affinity: list[Pod] = []
        self.used_ports = HostPortInfo()
        self.requested = ResourceAgg()
        self.nonzero_cpu = 0
        self.nonzero_mem = 0
        self.allocatable = ResourceAgg()
        self.taints: tuple = ()
        self.image_states: dict[str, ImageStateSummary] = {}
        # per-cycle transient volume counts, written by the Max*VolumeCount
        # predicates under the BalanceAttachedNodeVolumes gate and read by
        # balanced-allocation's variance scorer (reference: node_info.go
        # TransientInfo; predicates.go:517-521)
        self.transient_allocatable_volumes: Optional[int] = None
        self.transient_requested_volumes: Optional[int] = None
        self.generation = next_generation()
        if node is not None:
            self.set_node(node)

    # -- node ---------------------------------------------------------------
    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = ResourceAgg.from_allocatable(node.allocatable)
        self.taints = node.taints
        # Standalone default: each image counts as present on 1 node. The
        # scheduler Cache overwrites these with cluster-wide summaries
        # (reference: cache.go:88 imageStates).
        self.image_states = {
            normalized_image_name(name): ImageStateSummary(img.size_bytes, 1)
            for img in node.images for name in img.names
        }
        self.generation = next_generation()

    def remove_node(self) -> None:
        self.node = None
        self.allocatable = ResourceAgg()
        self.taints = ()
        self.generation = next_generation()

    # -- pods ---------------------------------------------------------------
    def add_pod(self, pod: Pod) -> None:
        req = calculate_resource(pod)
        self.requested.milli_cpu += req.milli_cpu
        self.requested.memory += req.memory
        self.requested.ephemeral_storage += req.ephemeral_storage
        for k, v in req.scalar.items():
            self.requested.scalar[k] = self.requested.scalar.get(k, 0) + v
        ncpu, nmem = get_pod_nonzero_requests(pod)
        self.nonzero_cpu += ncpu
        self.nonzero_mem += nmem
        self.pods.append(pod)
        if has_pod_affinity_terms(pod):
            self.pods_with_affinity.append(pod)
        for p in get_container_ports(pod):
            self.used_ports.add(p.host_ip, p.protocol, p.host_port)
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, p in enumerate(self.pods):
            if p.uid == pod.uid:
                del self.pods[i]
                break
        else:
            return False
        for i, p in enumerate(self.pods_with_affinity):
            if p.uid == pod.uid:
                del self.pods_with_affinity[i]
                break
        req = calculate_resource(pod)
        self.requested.milli_cpu -= req.milli_cpu
        self.requested.memory -= req.memory
        self.requested.ephemeral_storage -= req.ephemeral_storage
        for k, v in req.scalar.items():
            self.requested.scalar[k] = self.requested.scalar.get(k, 0) - v
        ncpu, nmem = get_pod_nonzero_requests(pod)
        self.nonzero_cpu -= ncpu
        self.nonzero_mem -= nmem
        for p in get_container_ports(pod):
            self.used_ports.remove(p.host_ip, p.protocol, p.host_port)
        self.generation = next_generation()
        return True

    def clone(self) -> "NodeInfo":
        out = NodeInfo()
        out.node = self.node
        out.pods = list(self.pods)
        out.pods_with_affinity = list(self.pods_with_affinity)
        out.used_ports = self.used_ports.clone()
        out.requested = self.requested.clone()
        out.nonzero_cpu = self.nonzero_cpu
        out.nonzero_mem = self.nonzero_mem
        out.allocatable = self.allocatable.clone()
        out.taints = self.taints
        out.image_states = dict(self.image_states)
        out.generation = self.generation
        return out


#: the resources of the utilization sums, in their order
UTILIZATION_RESOURCES = ("cpu", "memory", "ephemeral_storage")


def utilization_of(sums) -> dict:
    """Fill fractions from six sums over the nodes: requested cpu,
    memory and ephemeral storage, then allocatable, in that order (a
    Snapshot keeps them as `sums`)."""
    return {r: (sums[i] / sums[i + 3] if sums[i + 3] > 0 else 0.0)
            for i, r in enumerate(UTILIZATION_RESOURCES)}


def cluster_utilization(node_infos) -> dict:
    """Requested/allocatable fill fractions over a NodeInfo snapshot —
    the `cluster_resource_utilization{resource}` gauge family's source
    and the tuner reward's live input (round 22). Resources with zero
    cluster allocatable read 0.0 (an empty snapshot is 0, not NaN: the
    scraper treats NaN as no-data and the gate must see "empty", not
    "absent")."""
    sums = [0] * 6
    for ni in (node_infos.values() if hasattr(node_infos, "values")
               else node_infos):
        if ni.node is None:
            continue
        q, a = ni.requested, ni.allocatable
        for i, v in enumerate((q.milli_cpu, q.memory, q.ephemeral_storage,
                               a.milli_cpu, a.memory, a.ephemeral_storage)):
            sums[i] += v
    return utilization_of(sums)
