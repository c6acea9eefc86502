"""PodGroup — the co-scheduling (gang) API object.

Mirrors the semantics of the sig-scheduling coscheduling plugin's
PodGroup CRD (scheduling.sigs.k8s.io/v1alpha1 PodGroupSpec/Status): a
named group of pods that must be placed all-or-nothing. `min_member` is
the gang floor — the scheduler commits a gang attempt only when every
gathered member found a node AND (gathered + already bound) covers it;
otherwise the whole trial is discarded and no partial binding ever
reaches the store. Pods join a group through the well-known label
`pod-group.kubernetes-tpu/name` (the CRD uses a label the same way —
membership is metadata, not spec, so the Pod schema is untouched).

Phases:
- Pending:        the group exists; fewer than min_member members seen.
- PreScheduling:  enough members exist; the scheduler is attempting (or
                  backing off between) atomic placements.
- Scheduled:      >= min_member members are bound.
- Unschedulable:  schedule_timeout_seconds elapsed without reaching
                  Scheduled (the controller's terminal verdict; a later
                  successful placement flips it back to Scheduled).

Copied from the reference with the port's imports:
`kubernetes_tpu.coscheduling.types`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# well-known membership label (coscheduling plugin:
# pod-group.scheduling.sigs.k8s.io/name)
LABEL_POD_GROUP = "pod-group.kubernetes-tpu/name"

PHASE_PENDING = "Pending"
PHASE_PRESCHEDULING = "PreScheduling"
PHASE_SCHEDULED = "Scheduled"
PHASE_UNSCHEDULABLE = "Unschedulable"


@dataclass
class PodGroup:
    """Pruned PodGroup: spec (min_member, schedule_timeout_seconds) +
    status (phase, member counts) — served by the apiserver like any
    kind, with a /status subresource for the controller/scheduler."""
    name: str
    namespace: str = "default"
    # spec
    min_member: int = 1
    schedule_timeout_seconds: Optional[float] = None
    # status
    phase: str = PHASE_PENDING
    members: int = 0        # member pods observed (bound + pending)
    scheduled: int = 0      # member pods currently bound
    last_transition_time: Optional[float] = None
    # bookkeeping
    creation_timestamp: float = 0.0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "PodGroup":
        import copy
        return copy.copy(self)


def pod_group_name(pod) -> Optional[str]:
    """The group a pod belongs to (its membership label), else None."""
    return pod.labels.get(LABEL_POD_GROUP) or None


def pod_group_key(pod) -> Optional[str]:
    """Store key (namespace/name) of the pod's group, else None."""
    name = pod.labels.get(LABEL_POD_GROUP)
    if not name:
        return None
    return f"{pod.namespace}/{name}"


def pod_group_status_mutator(phase: Optional[str] = None,
                             members: Optional[int] = None,
                             scheduled: Optional[int] = None,
                             now: Optional[float] = None):
    """Mutate closure for the /status subresource — shared by the
    embedded store and RemoteStore (per the CLAUDE.md sync rule: both
    transports must write identical objects). Returns None (no write)
    when nothing changes, so guaranteed_update(allow_skip=True) skips
    no-op writes exactly like pod_condition_mutator."""
    def mutate(group):
        changed = False
        if phase is not None and group.phase != phase:
            group.phase = phase
            group.last_transition_time = now
            changed = True
        if members is not None and group.members != members:
            group.members = members
            changed = True
        if scheduled is not None and group.scheduled != scheduled:
            group.scheduled = scheduled
            changed = True
        return group if changed else None
    return mutate
