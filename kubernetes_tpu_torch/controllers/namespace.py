"""Namespace + serviceaccount controllers.

- NamespaceController (pkg/controller/namespace/namespace_controller.go):
  a namespace in phase Terminating (set by the apiserver's DELETE
  finalization) has every namespaced object in it deleted, then the
  namespace object itself removed — the deletion cascade users observe as
  `kubectl delete namespace`.
- ServiceAccountController (pkg/controller/serviceaccount): every Active
  namespace gets a "default" ServiceAccount.

The port's copy of the reference's `controllers/namespace.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Namespace, ServiceAccount
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.store import (
    Store, NAMESPACES, SERVICEACCOUNTS, AlreadyExistsError, NotFoundError,
)
from kubernetes_tpu_torch.api import serde


def namespaced_kinds() -> list[str]:
    """Every registered kind whose objects carry a namespace field — the
    discovery the reference does against the API surface
    (namespace_controller deletes 'all namespaced resources')."""
    return [k for k in serde.KIND_TYPES
            if k not in serde.CLUSTER_SCOPED_KINDS]


class NamespaceController(DirtyKeyController):
    KIND = NAMESPACES

    def reconcile(self, ns: Namespace) -> None:
        if ns.phase != "Terminating":
            return
        # deleteAllContent: every namespaced object in this namespace
        for kind in namespaced_kinds():
            objs, _rv = self.store.list(kind)
            for obj in objs:
                if getattr(obj, "namespace", None) != ns.name:
                    continue
                try:
                    self.store.delete(kind, obj.key)
                except NotFoundError:
                    pass
        try:
            self.store.delete(NAMESPACES, ns.key)
        except NotFoundError:
            pass


class ServiceAccountController(DirtyKeyController):
    """ensure_default: every Active namespace carries a 'default' SA
    (reference: pkg/controller/serviceaccount/serviceaccounts_controller.go)."""

    KIND = NAMESPACES

    def _register_extra_handlers(self) -> None:
        sa = self.informers.informer(SERVICEACCOUNTS)
        sa.add_event_handler(
            on_delete=lambda s: self._dirty.add(s.namespace))

    def reconcile(self, ns: Namespace) -> None:
        if ns.phase != "Active":
            return
        try:
            self.store.get(SERVICEACCOUNTS, f"{ns.name}/default")
        except NotFoundError:
            try:
                self.store.create(SERVICEACCOUNTS, ServiceAccount(
                    name="default", namespace=ns.name))
            except AlreadyExistsError:
                pass
