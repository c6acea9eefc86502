"""TTL controller — pkg/controller/ttl/ttl_controller.go.

Annotates every Node with `node.alpha.kubernetes.io/ttl`: how long its
kubelet may cache secrets/configmaps, scaled to cluster size so the
apiserver isn't hammered by refreshes in large clusters. The reference's
boundary table with hysteresis (ttl_controller.go ttlBoundaries): the TTL
steps up when the cluster grows past sizeMax and back down only below
sizeMin, so oscillating around a boundary doesn't flap the annotation.

The port's copy of the reference's `controllers/ttl.py` with the port's
imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.store import Store, NODES, NotFoundError

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

# (sizeMin, sizeMax, ttlSeconds) — ttl_controller.go:48 ttlBoundaries
BOUNDARIES = [
    (0, 100, 0),
    (90, 500, 15),
    (450, 1000, 30),
    (900, 2000, 60),
    (1800, 10000, 300),
    (9000, 1 << 62, 600),
]


class TTLController(DirtyKeyController):
    KIND = NODES

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        self._boundary = 0   # current index; moves with hysteresis
        self._want: int | None = None   # computed once per pump/sync

    def _desired_ttl(self) -> int:
        size = len(self.informers.informer(NODES).list())
        i = self._boundary
        while i + 1 < len(BOUNDARIES) and size > BOUNDARIES[i][1]:
            i += 1   # grew past sizeMax: step up
        while i > 0 and size < BOUNDARIES[i][0]:
            i -= 1   # shrank below sizeMin: step down
        self._boundary = i
        return BOUNDARIES[i][2]

    def pump(self) -> int:
        self.informers.pump_all()
        want = self._desired_ttl()
        if want != getattr(self, "_last_want", None):
            # the boundary moved: EVERY node's annotation is stale, not
            # just the ones with fresh events
            self._last_want = want
            for n in self.informers.informer(NODES).list():
                self._dirty.add(n.key)
        self._want = want
        return self.reconcile_dirty()

    def sync(self) -> None:
        self.informers.sync_all()
        self._want = self._last_want = self._desired_ttl()
        for n in self.informers.informer(NODES).list():
            self._dirty.add(n.key)
        self.reconcile_dirty()

    def reconcile(self, node: Node) -> None:
        # pump()/sync() computed _want once; recompute only when reconcile
        # is driven some other way (getattr's eager default would re-list
        # all nodes per node — O(N^2) on a boundary step)
        if self._want is None:
            self._want = self._desired_ttl()
        want = str(self._want)
        if node.annotations.get(TTL_ANNOTATION) == want:
            return

        def mutate(cur):
            if cur.annotations.get(TTL_ANNOTATION) == want:
                return None
            cur.annotations = {**cur.annotations, TTL_ANNOTATION: want}
            return cur
        try:
            self.store.guaranteed_update(NODES, node.key, mutate,
                                        allow_skip=True)
        except NotFoundError:
            pass
