"""ResourceQuota controller — pkg/controller/resourcequota.

Reconciles each quota's `used` totals (aggregate pod cpu/memory requests +
pod count per namespace) from live state. The admission plugin both
enforces `hard` AND commits usage synchronously on create (CAS); this
controller reconciles the drift admission can't see — deletes, terminal
phases (the reference's quota evaluator scopes to non-terminal pods).

The port's copy of the reference's `controllers/resourcequota.py` with
the port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Pod, ResourceQuota, get_resource_request
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.store import (
    Store, PODS, RESOURCEQUOTAS, NotFoundError,
)

TERMINAL_PHASES = ("Succeeded", "Failed")


def pod_usage(pod: Pod) -> dict[str, int]:
    req = get_resource_request(pod)
    return {"cpu": req.milli_cpu, "memory": req.memory, "pods": 1}


class ResourceQuotaController:
    def __init__(self, store: Store):
        self.store = store
        self.informers = InformerFactory(store)
        self._dirty: set[str] = set()
        quotas = self.informers.informer(RESOURCEQUOTAS)
        quotas.add_event_handler(
            on_add=lambda q: self._dirty.add(q.key),
            on_update=lambda o, n: self._dirty.add(n.key),
            on_delete=lambda q: self._dirty.discard(q.key))
        pods = self.informers.informer(PODS)
        pods.add_event_handler(on_add=self._pod_changed,
                               on_update=lambda o, n: self._pod_changed(n),
                               on_delete=self._pod_changed)

    def _pod_changed(self, pod: Pod) -> None:
        for q in self.informers.informer(RESOURCEQUOTAS).list():
            if q.namespace == pod.namespace:
                self._dirty.add(q.key)

    def sync(self) -> None:
        self.informers.sync_all()
        for q in self.informers.informer(RESOURCEQUOTAS).list():
            self._dirty.add(q.key)
        self.reconcile_dirty()

    def pump(self) -> int:
        self.informers.pump_all()
        return self.reconcile_dirty()

    def reconcile_dirty(self) -> int:
        n = 0
        while self._dirty:
            key = self._dirty.pop()
            try:
                quota = self.store.get(RESOURCEQUOTAS, key)
            except NotFoundError:
                continue
            self.reconcile(quota)
            n += 1
        return n

    def reconcile(self, quota: ResourceQuota) -> None:
        # the pod total is computed INSIDE the CAS mutate so a retry after a
        # concurrent admission charge (admission.py commits usage on admit)
        # re-lists live pods instead of clobbering the quota with a stale
        # pre-charge total
        def mutate(cur):
            pods, _rv = self.store.list(PODS)
            used = {k: 0 for k in cur.hard}
            for p in pods:
                if p.namespace != cur.namespace or p.deleted \
                        or p.phase in TERMINAL_PHASES:
                    continue
                for k, v in pod_usage(p).items():
                    if k in used:
                        used[k] += v
            if used == cur.used:
                return None
            cur.used = used
            return cur
        try:
            self.store.guaranteed_update(RESOURCEQUOTAS, quota.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
