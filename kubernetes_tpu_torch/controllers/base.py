"""Shared controller scaffold: informer-driven dirty-key reconciliation.

Every workload controller follows the reference's controller shape
(informer event handlers -> workqueue -> syncHandler; e.g.
pkg/controller/deployment/deployment_controller.go:63): the primary kind's
events mark keys dirty, reconcile_dirty drains them through reconcile().
Subclasses set KIND, implement reconcile(obj), and add any secondary-kind
handlers in _register_extra_handlers().

Workqueue metrics (the k8s.io/client-go/util/workqueue metrics-provider
analog, labeled by controller class name): depth, adds, queue-wait and
work durations, retries. A reconcile() exception re-queues the key (so
the work isn't lost) and counts as a retry before propagating.

The port's copy of the reference's `controllers/base.py` with the port's
imports.
"""
from __future__ import annotations

import time
from typing import Any

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.store import Store, NotFoundError

WQ_DEPTH = obs.gauge(
    "workqueue_depth", "Current dirty-key queue depth, by controller.",
    ("name",))
WQ_ADDS = obs.counter(
    "workqueue_adds_total", "Keys marked dirty, by controller.", ("name",))
WQ_QUEUE_DURATION = obs.histogram(
    "workqueue_queue_duration_seconds",
    "Time keys wait dirty before reconcile, by controller.", ("name",))
WQ_WORK_DURATION = obs.histogram(
    "workqueue_work_duration_seconds",
    "Time reconcile() spends per key, by controller.", ("name",))
WQ_RETRIES = obs.counter(
    "workqueue_retries_total",
    "Keys re-queued after a reconcile() exception, by controller.",
    ("name",))


class DirtyKeyController:
    KIND: str = ""

    def __init__(self, store: Store, clock=None):
        self.store = store
        self.clock = clock
        self.informers = InformerFactory(store)
        self._dirty: set[str] = set()
        # wall-clock dirty-mark times for queue_duration (real time, not
        # the injectable scheduling clock: metrics measure this process)
        self._dirty_since: dict[str, float] = {}
        self._wq_name = type(self).__name__
        prim = self.informers.informer(self.KIND)
        prim.add_event_handler(
            on_add=lambda o: self._mark_dirty(o.key),
            on_update=lambda o, n: self._mark_dirty(n.key),
            on_delete=lambda o: self._unmark_dirty(o.key))
        self._register_extra_handlers()

    def _register_extra_handlers(self) -> None:
        """Secondary-kind informer wiring (pods -> owner dirty, etc.)."""

    # -- workqueue ----------------------------------------------------------
    def _mark_dirty(self, key: str) -> None:
        if key not in self._dirty:
            self._dirty.add(key)
            self._dirty_since[key] = time.perf_counter()
            WQ_ADDS.labels(self._wq_name).inc()
            WQ_DEPTH.labels(self._wq_name).set(len(self._dirty))

    def _unmark_dirty(self, key: str) -> None:
        self._dirty.discard(key)
        self._dirty_since.pop(key, None)
        WQ_DEPTH.labels(self._wq_name).set(len(self._dirty))

    def sync(self) -> None:
        self.informers.sync_all()
        for o in self.informers.informer(self.KIND).list():
            self._mark_dirty(o.key)
        self.reconcile_dirty()

    def pump(self) -> int:
        self.informers.pump_all()
        return self.reconcile_dirty()

    def reconcile_dirty(self) -> int:
        n = 0
        name = self._wq_name
        while self._dirty:
            key = self._dirty.pop()
            marked = self._dirty_since.pop(key, None)
            now = time.perf_counter()
            if marked is not None:
                WQ_QUEUE_DURATION.labels(name).observe(now - marked)
            WQ_DEPTH.labels(name).set(len(self._dirty))
            try:
                obj = self.store.get(self.KIND, key)
            except NotFoundError:
                continue
            try:
                self.reconcile(obj)
            except Exception:
                # the reference workqueue re-queues on syncHandler error
                # (AddRateLimited); keep the key so the work isn't lost,
                # count the retry, and let the error propagate
                WQ_RETRIES.labels(name).inc()
                self._mark_dirty(key)
                raise
            finally:
                WQ_WORK_DURATION.labels(name).observe(
                    time.perf_counter() - now)
            n += 1
        return n

    def reconcile(self, obj: Any) -> None:
        raise NotImplementedError
