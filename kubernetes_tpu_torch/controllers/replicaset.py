"""ReplicaSet controller — pkg/controller/replicaset/replica_set.go.

The workload-management loop: for every ReplicaSet (which also stands in
for RC/StatefulSet in this pruned model), reconcile the number of matching
live pods to spec.replicas — creating owned pods from the set's template
shape when short (syncReplicaSet -> manageReplicas), deleting the
youngest surplus pods when over (the reference prefers not-ready/younger
pods via ActivePods ordering; creation time is the pruned criterion here).
Owned pods carry owner_ref so the disruption controller's expected-scale
walk and PodGC recognize them.

The port's copy of the reference's `controllers/replicaset.py` with the
port's imports.
"""
from __future__ import annotations

import itertools
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod, Container, ReplicaSet
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, REPLICASETS, AlreadyExistsError, NotFoundError,
)

_suffix = itertools.count(1)


class ReplicaSetController(DirtyKeyController):
    KIND = REPLICASETS

    def __init__(self, store: Store, clock=None, admission=None):
        super().__init__(store, clock=clock)
        # controller-originated pod writes go through the same admission
        # chain as kubectl-path writes (LimitRanger defaults, PriorityClass
        # resolution, toleration defaulting, quota), so scale-up pods are
        # not shaped differently from user-created ones — in the reference
        # every controller write passes apiserver admission
        from kubernetes_tpu_torch.apiserver.admission import AdmissionChain
        self.admission = admission if admission is not None else AdmissionChain()
        self.recorder = EventRecorder(store, component="controllermanager")

    def _register_extra_handlers(self) -> None:
        pods = self.informers.informer(PODS)
        pods.add_event_handler(on_add=self._pod_changed,
                               on_update=lambda o, n: self._pod_changed(n),
                               on_delete=self._pod_changed)

    def _pod_changed(self, pod: Pod) -> None:
        if pod.owner_ref is not None:
            kind, name, _uid = pod.owner_ref
            self._dirty.add(f"{pod.namespace}/{name}")
        else:
            # orphan adoption path: any selector might match it
            for r in self.informers.informer(REPLICASETS).list():
                self._dirty.add(r.key)

    def reconcile(self, rs: ReplicaSet) -> None:
        self.manage_replicas(rs)

    # -- syncReplicaSet -> manageReplicas ------------------------------------
    def _matching_pods(self, rs: ReplicaSet) -> list[Pod]:
        if rs.selector is None:
            return []
        pods, _rv = self.store.list(PODS)
        return [p for p in pods
                if p.namespace == rs.namespace and not p.deleted
                and rs.selector.matches(p.labels)
                # adopt orphans; never count pods owned by a DIFFERENT
                # controller (a Job pod with overlapping labels is not ours
                # — reference ControllerRefManager ClaimPods)
                and (p.owner_ref is None
                     or p.owner_ref[:2] == ("ReplicaSet", rs.name))]

    def _template_pod(self, rs: ReplicaSet) -> Pod:
        owner = ("ReplicaSet", rs.name, f"rs-{rs.name}")
        name = f"{rs.name}-{next(_suffix):x}"
        if rs.template is not None:
            extra = dict(rs.selector.match_labels) if rs.selector else {}
            return rs.template.make_pod(name, rs.namespace, owner_ref=owner,
                                        extra_labels=extra)
        labels = dict(rs.selector.match_labels) if rs.selector else {}
        return Pod(name=name,
                   namespace=rs.namespace, labels=labels,
                   owner_ref=owner,
                   containers=(Container.make(name="c"),))

    def manage_replicas(self, rs: ReplicaSet) -> None:
        pods = self._matching_pods(rs)
        diff = rs.replicas - len(pods)
        if diff > 0:
            from kubernetes_tpu_torch.apiserver.admission import AdmissionError
            for _ in range(diff):
                pod = self._template_pod(rs)
                admitted = None
                try:
                    pod = admitted = self.admission.admit(PODS, pod, self.store)
                    self.store.create(PODS, pod)
                except AlreadyExistsError:
                    # the admitted create never landed: refund quota charges
                    self.admission.refund(PODS, admitted, self.store)
                    continue
                except AdmissionError as e:
                    # quota exhausted (etc.): surface and stop this pass —
                    # the remaining creates would fail the same way
                    self.recorder.event(
                        "ReplicaSet", rs.key, "Warning", "FailedCreate",
                        f"Error creating: {e}")
                    break
                self.recorder.event(
                    "ReplicaSet", rs.key, NORMAL, "SuccessfulCreate",
                    f"Created pod: {pod.name}")
        elif diff < 0:
            # scale down: keep-worthiest first (scheduled, then older — the
            # reference's ActivePods ranking deletes unscheduled/younger
            # pods first), then delete the tail beyond spec.replicas
            pods.sort(key=lambda p: (0 if p.node_name else 1,
                                     p.creation_timestamp))
            victims = pods[rs.replicas:]
            for p in victims:
                try:
                    self.store.delete(PODS, p.key)
                except NotFoundError:
                    continue
                self.recorder.event(
                    "ReplicaSet", rs.key, NORMAL, "SuccessfulDelete",
                    f"Deleted pod: {p.name}")
        self._update_status(rs)

    def _update_status(self, rs: ReplicaSet) -> None:
        """calculateStatus analog: observed + ready replica counts the
        deployment controller's rollout gating reads."""
        pods = self._matching_pods(rs)
        observed = len(pods)
        ready = sum(1 for p in pods if p.phase == "Running")
        if observed == rs.observed_replicas and ready == rs.ready_replicas:
            return

        def mutate(cur):
            if cur.observed_replicas == observed \
                    and cur.ready_replicas == ready:
                return None
            cur.observed_replicas = observed
            cur.ready_replicas = ready
            return cur
        try:
            self.store.guaranteed_update(REPLICASETS, rs.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
