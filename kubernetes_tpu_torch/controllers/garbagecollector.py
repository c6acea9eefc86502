"""Garbage collector — pkg/controller/garbagecollector/garbagecollector.go:65.

The ownerReferences cascade: objects whose owner no longer exists are
deleted. The reference builds a live dependency graph from informers and
processes "virtual delete" events; this walks the same ownership edges —
pods owned by ReplicaSets/Jobs/DaemonSets/StatefulSets, ReplicaSets owned
by Deployments — deleting orphaned dependents (cascading: deleting a
Deployment removes its ReplicaSets on the next pass, whose pods go the
pass after; pump_until-style callers converge in <= depth passes, and the
controller marks itself dirty while any deletion happened so ControllerManager
loops converge in one call).

The port's copy of the reference's `controllers/garbagecollector.py`
with the port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.store import (
    Store, PODS, REPLICASETS, DEPLOYMENTS, JOBS, DAEMONSETS, STATEFULSETS,
    CRONJOBS, NotFoundError,
)

# owner kind name (as written in owner_ref[0]) -> store kind
OWNER_KINDS = {
    "ReplicaSet": REPLICASETS,
    "Deployment": DEPLOYMENTS,
    "Job": JOBS,
    "DaemonSet": DAEMONSETS,
    "StatefulSet": STATEFULSETS,
    "CronJob": CRONJOBS,
}
# kinds whose objects may carry owner_ref (the dependents we scan)
DEPENDENT_KINDS = (PODS, REPLICASETS, JOBS)


class GarbageCollector:
    def __init__(self, store: Store, clock=None):
        self.store = store
        self.informers = InformerFactory(store)
        self._deleted_owner = False
        for kind in OWNER_KINDS.values():
            inf = self.informers.informer(kind)
            inf.add_event_handler(on_delete=self._owner_deleted)

    def _owner_deleted(self, _obj) -> None:
        self._deleted_owner = True

    def sync(self) -> None:
        self.informers.sync_all()
        self.collect()

    def pump(self) -> int:
        self.informers.pump_all()
        if not self._deleted_owner:
            return 0
        self._deleted_owner = False
        return self.collect()

    def collect(self) -> int:
        """One full mark pass; repeats while deletions cascade."""
        total = 0
        while True:
            n = self._collect_once()
            total += n
            if n == 0:
                return total

    def _collect_once(self) -> int:
        n = 0
        for kind in DEPENDENT_KINDS:
            objs, _rv = self.store.list(kind)
            for obj in objs:
                ref = getattr(obj, "owner_ref", None)
                if ref is None:
                    continue
                owner_kind = OWNER_KINDS.get(ref[0])
                if owner_kind is None:
                    continue
                owner_key = f"{obj.namespace}/{ref[1]}"
                try:
                    self.store.get(owner_kind, owner_key)
                except NotFoundError:
                    try:
                        self.store.delete(kind, obj.key)
                        n += 1
                    except NotFoundError:
                        pass
        return n
