"""Endpoints controller — pkg/controller/endpoint/endpoints_controller.go.

The first loop in the reference's controller list: for every Service,
maintain an Endpoints object naming the ready pods its selector matches.
Address identity is (pod_key, node_name) — the pruned model has no pod IPs,
and the node is what a proxy would route to. Only bound, ready pods count
(the reference filters through IsPodReady the same way).

The port's copy of the reference's `controllers/endpoints.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Endpoints, Pod, Service
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.store import (
    Store, PODS, SERVICES, ENDPOINTS, AlreadyExistsError, NotFoundError,
)


def _is_ready(pod: Pod) -> bool:
    if not pod.node_name or pod.deleted:
        return False
    for c in pod.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return True   # no kubelet reported readiness: bound counts as ready


class EndpointsController:
    def __init__(self, store: Store):
        self.store = store
        self.informers = InformerFactory(store)
        self._dirty: set[str] = set()
        svcs = self.informers.informer(SERVICES)
        svcs.add_event_handler(
            on_add=lambda s: self._dirty.add(s.key),
            on_update=lambda o, n: self._dirty.add(n.key),
            on_delete=self._service_deleted)
        pods = self.informers.informer(PODS)
        pods.add_event_handler(on_add=lambda p: self._mark_all(),
                               on_update=lambda o, n: self._mark_all(),
                               on_delete=lambda p: self._mark_all())

    def _service_deleted(self, svc: Service) -> None:
        self._dirty.discard(svc.key)
        try:
            self.store.delete(ENDPOINTS, svc.key)
        except NotFoundError:
            pass

    def _mark_all(self) -> None:
        for s in self.informers.informer(SERVICES).list():
            self._dirty.add(s.key)

    def sync(self) -> None:
        self.informers.sync_all()
        self._mark_all()
        self.reconcile_dirty()

    def pump(self) -> int:
        self.informers.pump_all()
        return self.reconcile_dirty()

    def reconcile_dirty(self) -> int:
        n = 0
        while self._dirty:
            key = self._dirty.pop()
            try:
                svc = self.store.get(SERVICES, key)
            except NotFoundError:
                continue
            self.reconcile(svc)
            n += 1
        return n

    def reconcile(self, svc: Service) -> None:
        if not svc.selector:
            return   # selectorless services manage their own endpoints
        pods, _rv = self.store.list(PODS)
        addresses = tuple(sorted(
            (p.key, p.node_name) for p in pods
            if p.namespace == svc.namespace and _is_ready(p)
            and all(p.labels.get(k) == v for k, v in svc.selector.items())))
        try:
            current = self.store.get(ENDPOINTS, svc.key)
        except NotFoundError:
            try:
                self.store.create(ENDPOINTS, Endpoints(
                    name=svc.name, namespace=svc.namespace,
                    addresses=addresses))
            except AlreadyExistsError:
                pass
            return
        if current.addresses == addresses:
            return

        def mutate(cur):
            cur.addresses = addresses
            return cur
        try:
            self.store.guaranteed_update(ENDPOINTS, svc.key, mutate)
        except NotFoundError:
            pass
