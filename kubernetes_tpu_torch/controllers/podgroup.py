"""PodGroup controller — gang phase/timeout reconciliation.

The coscheduling analog of the sig-scheduling PodGroup controller
(pkg/controller in scheduler-plugins): watches PodGroups and their member
pods (the `pod-group.kubernetes-tpu/name` label) and reconciles status:

- members/scheduled counts from live pods;
- phase: Pending -> PreScheduling once minMember members exist,
  -> Scheduled once >= minMember members are BOUND,
  -> Unschedulable once schedule_timeout_seconds elapses without reaching
  Scheduled (a later successful placement flips it back — eviction or
  member deletion can likewise drop a Scheduled group back to
  PreScheduling, matching the live counts);
- a Warning event on the timeout transition (the user-visible audit of a
  gang that never formed).

The scheduler shell owns the PreScheduling write on its first attempt so
the phase flips even between controller pumps; this controller is the
authority that converges status with reality afterwards.

The port's copy of the reference's `controllers/podgroup.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.coscheduling.types import (
    PHASE_PENDING, PHASE_PRESCHEDULING, PHASE_SCHEDULED, PHASE_UNSCHEDULABLE,
    PodGroup, pod_group_name,
)
from kubernetes_tpu_torch.store.record import EventRecorder, WARNING
from kubernetes_tpu_torch.store.store import Store, PODGROUPS, PODS, NotFoundError
from kubernetes_tpu_torch.utils.clock import RealClock


class PodGroupController(DirtyKeyController):
    KIND = PODGROUPS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        self.clock = clock or RealClock()
        self.recorder = EventRecorder(store, component="podgroup-controller")
        # timeout base for groups created without a creation_timestamp:
        # first time THIS controller observed the group
        self._first_seen: dict[str, float] = {}

    def _register_extra_handlers(self) -> None:
        pods = self.informers.informer(PODS)

        def dirty_owner(pod) -> None:
            name = pod_group_name(pod)
            if name:
                self._mark_dirty(f"{pod.namespace}/{name}")

        pods.add_event_handler(
            on_add=dirty_owner,
            on_update=lambda _old, new: dirty_owner(new),
            on_delete=dirty_owner)

    def reconcile(self, group: PodGroup) -> None:
        now = self.clock.now()
        base = group.creation_timestamp \
            or self._first_seen.setdefault(group.key, now)
        members = [
            p for p in self.informers.informer(PODS).list()
            if p.namespace == group.namespace
            and pod_group_name(p) == group.name]
        n_members = len(members)
        n_bound = sum(1 for p in members if p.node_name)
        min_member = max(group.min_member, 1)
        timed_out = (group.schedule_timeout_seconds is not None
                     and now - base > group.schedule_timeout_seconds)
        if n_bound >= min_member:
            want = PHASE_SCHEDULED
        elif timed_out:
            want = PHASE_UNSCHEDULABLE
        elif group.phase == PHASE_UNSCHEDULABLE:
            want = PHASE_UNSCHEDULABLE   # terminal until placement succeeds
        elif n_members >= min_member or n_bound > 0:
            # enough members exist (or some are already bound — a formerly
            # Scheduled group that lost members below minMember); the
            # scheduler is (or will be) trying — don't regress a
            # PreScheduling the shell already wrote
            want = PHASE_PRESCHEDULING
        elif group.phase == PHASE_PRESCHEDULING and n_members > 0:
            want = PHASE_PRESCHEDULING
        else:
            want = PHASE_PENDING
        if want == group.phase and n_members == group.members \
                and n_bound == group.scheduled:
            return
        try:
            self.store.update_pod_group_status(
                group.key, phase=want, members=n_members,
                scheduled=n_bound, now=now)
        except NotFoundError:
            return
        if want == PHASE_UNSCHEDULABLE and group.phase != PHASE_UNSCHEDULABLE:
            # the gang never formed inside its window — the audit record
            self.recorder.event(
                "PodGroup", group.key, WARNING, "GangTimeout",
                f"pod group {group.key} did not reach minMember="
                f"{min_member} within {group.schedule_timeout_seconds}s "
                f"({n_bound} bound of {n_members} members)")
