"""Horizontal pod autoscaler — pkg/controller/podautoscaler/horizontal.go.

v1 CPU-utilization semantics (replica_calculator.go GetResourceReplicas):
average the matched pods' CPU usage over their requests, take the ratio to
the target percentage, and scale the Deployment to
ceil(currentReplicas * ratio) inside [min, max] — skipping changes within
the 10% tolerance band so metric noise doesn't flap replica counts. The
usage feed is the store's `podmetrics` kind (the metrics.k8s.io
stand-in).

The port's copy of the reference's `controllers/hpa.py` with the port's
imports.
"""
from __future__ import annotations

import math
import time as _time

from kubernetes_tpu_torch.api.types import HorizontalPodAutoscaler, Pod
from kubernetes_tpu_torch.api.types import get_resource_request
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL, WARNING
from kubernetes_tpu_torch.store.store import (
    Store, DEPLOYMENTS, HPAS, PODS, PODMETRICS, NotFoundError,
)

TOLERANCE = 0.1          # horizontal.go tolerance


class HorizontalPodAutoscalerController(DirtyKeyController):
    KIND = HPAS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        self.recorder = EventRecorder(store, component="horizontal-pod-autoscaler")

    def _register_extra_handlers(self) -> None:
        # new usage samples re-evaluate every autoscaler (the reference
        # instead polls every 15s; event-driven keeps pump() deterministic)
        metrics = self.informers.informer(PODMETRICS)
        mark = lambda *_: self._dirty.update(
            h.key for h in self.informers.informer(HPAS).list())
        metrics.add_event_handler(on_add=mark, on_update=mark, on_delete=mark)

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _time.time()

    def reconcile(self, hpa: HorizontalPodAutoscaler) -> None:
        kind, name = hpa.scale_target_ref
        if kind != "Deployment":
            return
        try:
            dep = self.store.get(DEPLOYMENTS, f"{hpa.namespace}/{name}")
        except NotFoundError:
            self.recorder.event("HorizontalPodAutoscaler", hpa.key, WARNING,
                                "FailedGetScale", f"{kind}/{name} not found")
            return
        if dep.selector is None:
            return
        pods = [p for p in self.store.list(PODS)[0]
                if p.namespace == hpa.namespace and not p.deleted
                and dep.selector.matches(p.labels)]
        utilizations = []
        missing = 0
        for p in pods:
            try:
                m = self.store.get(PODMETRICS, p.key)
            except NotFoundError:
                missing += 1
                continue
            req = get_resource_request(p).milli_cpu
            if req > 0:
                utilizations.append(100.0 * m.cpu_usage / req)
            else:
                missing += 1
        current = dep.replicas
        desired = current
        avg = None
        target = hpa.target_cpu_utilization
        n_all = len(utilizations) + missing
        if utilizations and target > 0:
            avg = sum(utilizations) / len(utilizations)
            ratio = avg / target
            if abs(ratio - 1.0) > TOLERANCE:
                if missing == 0:
                    # rebased on the measured population
                    # (replica_calculator.go calcPlainMetricReplicas)
                    desired = math.ceil(n_all * ratio)
                else:
                    # metric-less pods damp the move: they count as 0%
                    # usage on the way up and as FULL request utilization
                    # (100%) on the way down (replica_calculator.go:106) —
                    # filling with the target instead over-shrinks during
                    # rollouts whose fresh pods have no samples yet — and a
                    # move that flips direction (or lands in tolerance)
                    # after the fill is discarded
                    fill = 0.0 if ratio > 1.0 else 100.0
                    avg_all = (sum(utilizations) + fill * missing) / n_all
                    new_ratio = avg_all / target
                    if abs(new_ratio - 1.0) > TOLERANCE and \
                            (new_ratio > 1.0) == (ratio > 1.0):
                        desired = math.ceil(n_all * new_ratio)
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
        scaled = desired != current
        if scaled:
            def scale(cur):
                cur.replicas = desired
                return cur
            try:
                self.store.guaranteed_update(DEPLOYMENTS, dep.key, scale)
            except NotFoundError:
                return
            self.recorder.event(
                "HorizontalPodAutoscaler", hpa.key, NORMAL,
                "SuccessfulRescale",
                f"New size: {desired}; reason: cpu resource utilization "
                f"above/below target")

        util = int(round(avg)) if avg is not None else None

        def status(cur):
            if not scaled and cur.current_replicas == current \
                    and cur.desired_replicas == desired \
                    and cur.current_cpu_utilization == util:
                return None   # steady state: no write, no self-re-dirty
            cur.current_replicas = current
            cur.desired_replicas = desired
            cur.current_cpu_utilization = util
            if scaled:
                cur.last_scale_time = self._now()
            return cur
        try:
            self.store.guaranteed_update(HPAS, hpa.key, status,
                                         allow_skip=True)
        except NotFoundError:
            pass
