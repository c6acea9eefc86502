"""Deployment controller — pkg/controller/deployment/deployment_controller.go:63.

Declarative rollout over owned ReplicaSets: each distinct pod template gets
its own RS named `{deployment}-{template-hash}` (the reference's
pod-template-hash scheme); RollingUpdate walks the new RS up and old RSes
down inside the maxSurge/maxUnavailable envelope using the RS controller's
reconciled ready counts; Recreate scales every old RS to zero before
bringing the new one up. Scale (spec.replicas changes against an unchanged
template) adjusts the current RS in place.

The port's copy of the reference's `controllers/deployment.py` with the
port's imports.
"""
from __future__ import annotations

import hashlib
import json

from kubernetes_tpu_torch.api.types import Deployment, ReplicaSet
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, DEPLOYMENTS, REPLICASETS, AlreadyExistsError, NotFoundError,
)


def template_hash(template) -> str:
    """Stable short hash of a pod template (pod-template-hash analog)."""
    from kubernetes_tpu_torch.api import serde
    blob = json.dumps(serde.to_dict(template), sort_keys=True)
    return hashlib.md5(blob.encode()).hexdigest()[:10]


class DeploymentController(DirtyKeyController):
    KIND = DEPLOYMENTS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        self.recorder = EventRecorder(store, component="controllermanager")

    def _register_extra_handlers(self) -> None:
        rs = self.informers.informer(REPLICASETS)
        rs.add_event_handler(on_add=self._rs_changed,
                             on_update=lambda o, n: self._rs_changed(n),
                             on_delete=self._rs_changed)

    def _rs_changed(self, rs: ReplicaSet) -> None:
        if rs.owner_ref is not None and rs.owner_ref[0] == "Deployment":
            self._dirty.add(f"{rs.namespace}/{rs.owner_ref[1]}")

    # -- syncDeployment ------------------------------------------------------
    def _owned_rs(self, dep: Deployment) -> list[ReplicaSet]:
        sets, _rv = self.store.list(REPLICASETS)
        return [r for r in sets
                if r.namespace == dep.namespace and r.owner_ref is not None
                and r.owner_ref[:2] == ("Deployment", dep.name)]

    def _scale_rs(self, rs_key: str, replicas: int) -> None:
        def mutate(cur):
            if cur.replicas == replicas:
                return None
            cur.replicas = replicas
            return cur
        try:
            self.store.guaranteed_update(REPLICASETS, rs_key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass

    def reconcile(self, dep: Deployment) -> None:
        if dep.template is None or dep.paused:
            return
        if dep.strategy == "RollingUpdate" and dep.max_surge <= 0 \
                and dep.max_unavailable <= 0:
            # the reference's apiserver validation rejects this combination
            # (a rollout could neither surge nor shed — permanent livelock);
            # surface it instead of silently converging to a no-op
            self.recorder.event(
                "Deployment", dep.key, "Warning", "InvalidSpec",
                "maxSurge and maxUnavailable may not both be 0")
            return
        rev = template_hash(dep.template)
        new_name = f"{dep.name}-{rev}"
        owned = self._owned_rs(dep)
        new_rs = next((r for r in owned if r.name == new_name), None)
        old = [r for r in owned if r.name != new_name]
        if new_rs is None:
            # getNewReplicaSet: create the revision's RS; its selector adds
            # the template-hash label so revisions don't claim each other's
            # pods (pod-template-hash, deployment/sync.go)
            from kubernetes_tpu_torch.api.types import LabelSelector
            tmpl = _clone_template(dep.template)
            tmpl.labels = dict(tmpl.labels)
            tmpl.labels["pod-template-hash"] = rev
            base = dict(dep.selector.match_labels) if dep.selector else {}
            base["pod-template-hash"] = rev
            new_rs = ReplicaSet(
                name=new_name, namespace=dep.namespace,
                selector=LabelSelector(match_labels=tuple(sorted(base.items()))),
                replicas=0, template=tmpl,
                owner_ref=("Deployment", dep.name, f"deploy-{dep.name}"))
            try:
                self.store.create(REPLICASETS, new_rs)
                self.recorder.event(
                    "Deployment", dep.key, NORMAL, "ScalingReplicaSet",
                    f"Scaled up replica set {new_name} to start rollout")
            except AlreadyExistsError:
                new_rs = self.store.get(REPLICASETS, f"{dep.namespace}/{new_name}")

        all_pods, _rv = self.store.list(PODS)
        old_total = sum(r.replicas for r in old)
        if dep.strategy == "Recreate":
            # scale all old to zero; bring the new one up only when every
            # old pod is gone (deployment/recreate.go)
            for r in old:
                self._scale_rs(r.key, 0)
            if any(self._counts(r, all_pods)[0] for r in old):
                return
            self._scale_rs(new_rs.key, dep.replicas)
            for r in old:   # drained revisions don't accumulate
                try:
                    self.store.delete(REPLICASETS, r.key)
                except NotFoundError:
                    pass
        else:
            # RollingUpdate (deployment/rolling.go): scale new up within the
            # surge envelope, old down within the availability floor.
            # Availability is counted from LIVE pod phases, not the lagging
            # RS status, so a stale status can never delete healthy pods.
            max_total = dep.replicas + max(dep.max_surge, 0)
            new_target = min(dep.replicas, new_rs.replicas
                             + max(0, max_total - (new_rs.replicas + old_total)))
            if new_target != new_rs.replicas:
                self._scale_rs(new_rs.key, new_target)
            ready_total = self._counts(new_rs, all_pods)[1] + sum(
                self._counts(r, all_pods)[1] for r in old)
            min_available = dep.replicas - max(dep.max_unavailable, 0)
            room = max(0, ready_total - min_available)
            for r in sorted(old, key=lambda r: r.name):
                # cleanupUnhealthyReplicas: not-ready old pods don't count
                # toward availability — shed them first, beyond any room
                total_r, ready_r = self._counts(r, all_pods)
                unhealthy = max(0, min(r.replicas, total_r) - ready_r)
                cut = min(r.replicas, unhealthy + room)
                if cut > 0:
                    self._scale_rs(r.key, r.replicas - cut)
                    room -= max(0, cut - unhealthy)
            # fully-drained old sets are deleted (their pods are gone); the
            # GC would cascade anyway but the rollout owns this cleanup
            for r in old:
                if r.replicas == 0 and not self._counts(r, all_pods)[0]:
                    try:
                        self.store.delete(REPLICASETS, r.key)
                    except NotFoundError:
                        pass
        self._update_status(dep, new_rs, all_pods)

    def _counts(self, rs: ReplicaSet, pods: list) -> tuple[int, int]:
        """(live, ready) pod counts for one RS against a pod list the caller
        fetched once per reconcile. Applies the same ClaimPods owner filter
        as ReplicaSetController._matching_pods so foreign pods with
        coincidentally-matching labels never inflate availability."""
        if rs.selector is None:
            return 0, 0
        mine = [p for p in pods
                if p.namespace == rs.namespace and not p.deleted
                and rs.selector.matches(p.labels)
                and (p.owner_ref is None
                     or p.owner_ref[:2] == ("ReplicaSet", rs.name))]
        return len(mine), sum(1 for p in mine if p.phase == "Running")

    def _update_status(self, dep: Deployment, new_rs: ReplicaSet,
                       all_pods: list) -> None:
        updated, updated_ready = self._counts(new_rs, all_pods)
        ready = updated_ready + sum(self._counts(r, all_pods)[1]
                                    for r in self._owned_rs(dep)
                                    if r.name != new_rs.name)
        rev = template_hash(dep.template)

        def mutate(cur):
            if (cur.observed_revision == rev
                    and cur.updated_replicas == updated
                    and cur.ready_replicas == ready
                    and cur.available_replicas == ready):
                return None
            cur.observed_revision = rev
            cur.updated_replicas = updated
            cur.ready_replicas = ready
            cur.available_replicas = ready
            return cur
        try:
            self.store.guaranteed_update(DEPLOYMENTS, dep.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass


def _clone_template(t):
    import copy
    return copy.deepcopy(t)
