"""Node IPAM controller — pkg/controller/nodeipam (range allocator).

Splits the cluster CIDR into fixed-size per-node subnets and assigns one
to every node missing spec.podCIDR (the RangeAllocator's in-memory bitmap
rebuilt from the live node set on every pass, so restarts and node
deletions release slots for free).

The port's copy of the reference's `controllers/nodeipam.py` with the
port's imports.
"""
from __future__ import annotations

import ipaddress

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, WARNING
from kubernetes_tpu_torch.store.store import Store, NODES, NotFoundError

DEFAULT_CLUSTER_CIDR = "10.0.0.0/16"
DEFAULT_NODE_MASK = 24


class NodeIpamController(DirtyKeyController):
    KIND = NODES

    def __init__(self, store: Store, clock=None,
                 cluster_cidr: str = DEFAULT_CLUSTER_CIDR,
                 node_mask: int = DEFAULT_NODE_MASK):
        super().__init__(store, clock=clock)
        net = ipaddress.ip_network(cluster_cidr)
        self._subnets = [str(s) for s in net.subnets(
            new_prefix=node_mask)]
        self._used: set[str] = set()
        self.recorder = EventRecorder(store, component="node-ipam")

    def reconcile_dirty(self) -> int:
        # ONE store list per drain (the informer cache lags mid-drain
        # assignments); reconcile() keeps the set current incrementally —
        # the per-node store.list would be O(N^2) clones on a full sync
        self._used = {n.pod_cidr for n in self.store.list(NODES)[0]
                      if n.pod_cidr}
        return super().reconcile_dirty()

    def reconcile(self, node: Node) -> None:
        if node.pod_cidr:
            return
        cidr = next((s for s in self._subnets if s not in self._used), None)
        if cidr is None:
            # range exhausted (reference: CIDRNotAvailable event)
            self.recorder.event("Node", node.key, WARNING,
                                "CIDRNotAvailable",
                                "no remaining pod CIDRs in the cluster "
                                "range")
            return

        def mutate(cur, _cidr=cidr):
            if cur.pod_cidr:
                return None
            cur.pod_cidr = _cidr
            return cur
        try:
            updated = self.store.guaranteed_update(NODES, node.key, mutate,
                                                   allow_skip=True)
        except NotFoundError:
            return
        self._used.add(updated.pod_cidr or cidr)
