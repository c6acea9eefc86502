"""Disruption controller — reconciles PodDisruptionBudget status from pod
state through the store.

Mirror of pkg/controller/disruption/disruption.go (trySync :496,
getExpectedPodCount :526, getExpectedScale :569, countHealthyPods :615,
updatePdbStatus :683): watch pods + PDBs, recompute
{expectedPods, currentHealthy, desiredHealthy, disruptionsAllowed} and write
the status back only when it changed. PDB-aware preemption
(pickOneNodeForPreemption's minPDBviolations criterion) reads the
reconciled `disruptions_allowed` — before this controller, that field was a
static literal nothing maintained.

Pruning notes vs the reference:
- "healthy" is an explicit Ready condition when present, else simply
  "bound" (no kubelet exists to report readiness).
- the expected-scale walk resolves a pod's single controller via
  `owner_ref` against the ReplicaSet stand-in's `replicas` (the reference
  consults RC/RS/Deployment/StatefulSet scale subresources).
- disruptedPods eviction-in-flight bookkeeping is out of scope (no /evict
  subresource here; the scheduler deletes victims directly).

The port's copy of the reference's `controllers/disruption.py` with the
port's imports.
"""
from __future__ import annotations

import math
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL, WARNING
from kubernetes_tpu_torch.store.store import Store, PODS, PDBS, REPLICASETS, NotFoundError


def _value_from_int_or_percent(value, total: int, round_up: bool) -> int:
    """apimachinery intstr.GetValueFromIntOrPercent."""
    if isinstance(value, int):
        return value
    s = str(value).strip()
    if s.endswith("%"):
        pct = int(s[:-1])
        v = pct * total / 100.0
        return math.ceil(v) if round_up else math.floor(v)
    return int(s)


def _is_healthy(pod: Pod) -> bool:
    for c in pod.conditions:
        if c.type == "Ready":
            return c.status == "True"
    return bool(pod.node_name)


class DisruptionController:
    """One reconcile loop of the 31 in controllermanager.go:372-412."""

    def __init__(self, store: Store):
        self.store = store
        self.recorder = EventRecorder(store, component="controllermanager")
        self.informers = InformerFactory(store)
        self._dirty: set[str] = set()
        pods = self.informers.informer(PODS)
        # any pod change may move any budget's healthy count; PDBs are few,
        # so dirty them all (the reference maps pod->pdb via selector lookup)
        pods.add_event_handler(on_add=lambda p: self._mark_all(),
                               on_update=lambda o, n: self._mark_all(),
                               on_delete=lambda p: self._mark_all())
        pdbs = self.informers.informer(PDBS)
        pdbs.add_event_handler(on_add=lambda b: self._dirty.add(b.key),
                               on_update=lambda o, n: self._dirty.add(n.key),
                               on_delete=lambda b: self._dirty.discard(b.key))
        rs = self.informers.informer(REPLICASETS)
        rs.add_event_handler(on_add=lambda r: self._mark_all(),
                             on_update=lambda o, n: self._mark_all(),
                             on_delete=lambda r: self._mark_all())

    def _mark_all(self) -> None:
        for b in self.informers.informer(PDBS).list():
            self._dirty.add(b.key)

    # -- lifecycle -----------------------------------------------------------
    def sync(self) -> None:
        self.informers.sync_all()
        self._mark_all()
        self.reconcile_dirty()

    def pump(self) -> int:
        """Drain informer events, reconcile dirty budgets; returns number
        reconciled."""
        self.informers.pump_all()
        return self.reconcile_dirty()

    def reconcile_dirty(self) -> int:
        n = 0
        while self._dirty:
            key = self._dirty.pop()
            try:
                pdb = self.store.get(PDBS, key)
            except NotFoundError:
                continue
            self.try_sync(pdb)
            n += 1
        return n

    # -- reconcile (trySync :496) --------------------------------------------
    def _pods_for_pdb(self, pdb: PodDisruptionBudget) -> list[Pod]:
        if pdb.selector is None:
            return []
        pods, _rv = self.store.list(PODS)
        return [p for p in pods
                if p.namespace == pdb.namespace
                and not p.deleted
                and pdb.selector.matches(p.labels)]

    def _expected_scale(self, pdb: PodDisruptionBudget,
                        pods: list[Pod]) -> Optional[int]:
        """getExpectedScale :569 — sum of scales of the pods' controllers;
        None (error) when any pod has no controller."""
        controllers: dict[str, int] = {}
        rss, _rv = self.store.list(REPLICASETS)
        by_name = {(r.namespace, r.name): r for r in rss}
        for pod in pods:
            if pod.owner_ref is None:
                return None
            _kind, name, _uid = pod.owner_ref
            rs = by_name.get((pod.namespace, name))
            if rs is None:
                return None
            controllers[rs.key] = rs.replicas
        return sum(controllers.values())

    def _expected_pod_count(self, pdb: PodDisruptionBudget, pods: list[Pod]
                            ) -> Optional[tuple[int, int]]:
        """getExpectedPodCount :526 -> (expected, desired_healthy)."""
        if pdb.max_unavailable is not None:
            scale = self._expected_scale(pdb, pods)
            if scale is None:
                return None
            max_unavail = _value_from_int_or_percent(
                pdb.max_unavailable, scale, True)
            return scale, max(scale - max_unavail, 0)
        if pdb.min_available is not None:
            if isinstance(pdb.min_available, int):
                return len(pods), pdb.min_available
            scale = self._expected_scale(pdb, pods)
            if scale is None:
                return None
            return scale, _value_from_int_or_percent(
                pdb.min_available, scale, True)
        return None   # no spec: leave the status alone (pruned-type compat)

    def try_sync(self, pdb: PodDisruptionBudget) -> None:
        pods = self._pods_for_pdb(pdb)
        if not pods:
            self.recorder.event("PodDisruptionBudget", pdb.key, NORMAL,
                                "NoPods", "No matching pods found")
        counts = self._expected_pod_count(pdb, pods)
        if counts is None:
            if pdb.min_available is None and pdb.max_unavailable is None:
                return
            # failSafe :676: fail closed — no disruptions while confused
            self.recorder.event(
                "PodDisruptionBudget", pdb.key, WARNING,
                "CalculateExpectedPodCountFailed",
                "Failed to calculate the number of expected pods")
            self._update_status(pdb, pdb.current_healthy, pdb.desired_healthy,
                                pdb.expected_pods, 0)
            return
        expected, desired = counts
        healthy = sum(1 for p in pods if _is_healthy(p))
        allowed = healthy - desired
        if expected <= 0 or allowed <= 0:
            allowed = 0
        self._update_status(pdb, healthy, desired, expected, allowed)

    def _update_status(self, pdb: PodDisruptionBudget, healthy: int,
                       desired: int, expected: int, allowed: int) -> None:
        if (pdb.current_healthy == healthy and pdb.desired_healthy == desired
                and pdb.expected_pods == expected
                and pdb.disruptions_allowed == allowed):
            return   # updatePdbStatus :689 skips no-op writes
        def mutate(cur):
            cur.current_healthy = healthy
            cur.desired_healthy = desired
            cur.expected_pods = expected
            cur.disruptions_allowed = allowed
            return cur
        try:
            self.store.guaranteed_update(PDBS, pdb.key, mutate)
        except NotFoundError:
            pass
