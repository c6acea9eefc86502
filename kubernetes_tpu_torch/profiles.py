"""Scheduling profiles: the port's copy of the data part of
`kubernetes_tpu/profiles/__init__.py` (with the helpers it needs from
`factory.py` and `apis/policy.py`), and the per-profile priority configs
of the serial cycle's host twin (`oracle_configs`).

A pod picks its profile by `spec.schedulerName`; each profile carries its
own priority-weight vector. On the device the vectors stack into one
`[profiles x priorities]` int64 table (column order `ops.PRIORITY_AXIS`)
and every kernel gathers a pod's row by its profile id, so one launch
scores a window that mixes profiles. The last column, `gang_locality`, is
the rank-aware gang objective: a profile with `rank_aware=True` makes its
gangs prefer zones that already hold members of the same gang.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.factory import DEFAULT_PRIORITY_WEIGHTS, \
    build_priority_configs
from kubernetes_tpu_torch.ops import DEFAULT_WEIGHTS, MAX_PRIORITY, \
    PRIORITY_AXIS

DEFAULT_PROFILE_NAME = "default-scheduler"

#: weight * MaxPriority must fit int32 (api/validation)
MAX_WEIGHT = (1 << 31) // MAX_PRIORITY

#: priority name -> kernel weight key (factory.py TPU_WEIGHT_KEYS)
KERNEL_WEIGHT_KEYS = {
    "SelectorSpreadPriority": "selector_spread",
    "InterPodAffinityPriority": "interpod",
    "LeastRequestedPriority": "least_requested",
    "MostRequestedPriority": "most_requested",
    "RequestedToCapacityRatioPriority": "rtcr",
    "BalancedResourceAllocation": "balanced",
    "NodePreferAvoidPodsPriority": "prefer_avoid",
    "NodeAffinityPriority": "node_affinity",
    "TaintTolerationPriority": "taint_toleration",
    "ImageLocalityPriority": "image_locality",
}


class ProfileValidationError(ValueError):
    pass


def kernel_weights(name_weights: dict) -> Optional[dict]:
    """Kernel weight dict of a priority selection, or None when a priority
    has no kernel implementation (factory.py `tpu_kernel_weights`)."""
    weights = {k: 0 for k in DEFAULT_WEIGHTS}
    for name, w in name_weights.items():
        key = KERNEL_WEIGHT_KEYS.get(name)
        if key is None:
            return None
        weights[key] = w
    return weights


def _weight_errors(name: str, weight: int) -> list:
    """apis/policy.py `validate_policy`'s bounds for one priority."""
    if weight <= 0:
        return [f"priority {name}: weight must be positive"]
    if weight >= MAX_WEIGHT:
        return [f"priority {name}: weight {weight} too large"]
    return []


@dataclass(frozen=True)
class SchedulingProfile:
    """One named profile: a priority-weight vector and the rank-aware knob.
    Empty `weights` means the DefaultProvider vector."""
    name: str
    weights: tuple = ()          # ((priority name, weight), ...)
    rank_aware: bool = False
    gang_weight: int = 1

    def name_weights(self) -> dict:
        if self.weights:
            return dict(self.weights)
        return dict(DEFAULT_PRIORITY_WEIGHTS)

    @staticmethod
    def from_dict(d: dict) -> "SchedulingProfile":
        """The KubeSchedulerConfiguration-flavoured shape: {"schedulerName":
        ..., "priorities": {name: weight} | [{"name": ..., "weight": ...}],
        "rankAwareGang": bool, "gangWeight": int} (snake_case accepted)."""
        name = d.get("schedulerName") or d.get("scheduler_name") \
            or d.get("name") or DEFAULT_PROFILE_NAME
        prios = d.get("priorities") or ()
        if isinstance(prios, dict):
            weights = tuple(sorted(prios.items()))
        else:
            weights = tuple(sorted(
                (p["name"], p.get("weight", 1)) for p in prios))
        return SchedulingProfile(
            name=name, weights=weights,
            rank_aware=bool(d.get("rankAwareGang",
                                  d.get("rank_aware", False))),
            gang_weight=int(d.get("gangWeight", d.get("gang_weight", 1))))


class ProfileSet:
    """An ordered, validated set of profiles. Profile 0 is the default; a
    single default-vector, non-rank-aware profile is the pre-profile
    scheduler (`tensor_mode()` False)."""

    def __init__(self, profiles: Optional[list] = None,
                 validate: bool = True):
        if not profiles:
            profiles = [SchedulingProfile(DEFAULT_PROFILE_NAME)]
        self.profiles: list[SchedulingProfile] = list(profiles)
        self._index = {p.name: i for i, p in enumerate(self.profiles)}
        if validate:
            self.validate()

    @staticmethod
    def from_dict(d: dict) -> "ProfileSet":
        return ProfileSet([SchedulingProfile.from_dict(p)
                           for p in d.get("profiles", ())])

    def validate(self) -> None:
        """Duplicate or empty profile names, unknown priority names and
        weights outside the policy bounds are errors."""
        errs = []
        seen: set = set()
        for p in self.profiles:
            if p.name in seen:
                errs.append(f"duplicate profile name {p.name!r}")
            seen.add(p.name)
            if not p.name:
                errs.append("profile name must not be empty")
            nw = p.name_weights()
            for prio_name in nw:
                if prio_name not in KERNEL_WEIGHT_KEYS:
                    errs.append(f"profile {p.name}: unknown priority "
                                f"{prio_name!r}")
            werrs = []
            for n, w in sorted(nw.items()):
                werrs += _weight_errors(n, w)
            if p.rank_aware:
                werrs += _weight_errors(f"{p.name}/GangLocalityPriority",
                                        p.gang_weight)
            if werrs:
                errs.append(f"profile {p.name}: " + "; ".join(werrs))
        if errs:
            raise ProfileValidationError("; ".join(errs))

    def __len__(self) -> int:
        return len(self.profiles)

    def __iter__(self):
        return iter(self.profiles)

    def index_of(self, scheduler_name: str) -> Optional[int]:
        """Profile index of a pod's spec.schedulerName, or None."""
        return self._index.get(scheduler_name)

    def tensor_mode(self) -> bool:
        """True when the kernels must run the weight-table program: more
        than one profile, a non-default vector, or a rank-aware profile."""
        if len(self.profiles) > 1:
            return True
        p = self.profiles[0]
        return p.rank_aware or (
            p.weights and dict(p.weights) != DEFAULT_PRIORITY_WEIGHTS)

    def kernel_row(self, i: int) -> dict:
        """Kernel-keyed weight dict of profile `i`, gang_locality included
        (0 unless rank-aware)."""
        p = self.profiles[i]
        row = kernel_weights(p.name_weights())
        if row is None:
            raise ProfileValidationError(
                f"profile {p.name}: priorities not kernel-expressible")
        row["gang_locality"] = p.gang_weight if p.rank_aware else 0
        return row

    def union_kernel_weights(self) -> dict:
        """The static gate dict of every weight-table launch: a family runs
        iff any profile weights it (per-pod rows then scale it)."""
        union = {k: 0 for k in PRIORITY_AXIS}
        for i in range(len(self.profiles)):
            for k, w in self.kernel_row(i).items():
                union[k] = max(union[k], int(w))
        return union

    def weight_table(self) -> np.ndarray:
        """The [profiles x priorities] int64 table, PRIORITY_AXIS columns."""
        tab = np.zeros((len(self.profiles), len(PRIORITY_AXIS)),
                       dtype=np.int64)
        for i in range(len(self.profiles)):
            row = self.kernel_row(i)
            for j, key in enumerate(PRIORITY_AXIS):
                tab[i, j] = int(row.get(key, 0))
        return tab

    def oracle_configs(self, i: int, services_fn=lambda: [],
                       replicasets_fn=lambda: [],
                       hard_pod_affinity_weight: int = 1) -> list:
        """Profile i's PriorityConfig list for the serial cycle's host
        twin: the SAME weight vector its weight-table row carries (the
        gang-locality objective comes per call, in `extra_configs`: it
        needs the trial's live zone counts)."""
        return build_priority_configs(
            self.profiles[i].name_weights(), services_fn=services_fn,
            replicasets_fn=replicasets_fn,
            hard_pod_affinity_weight=hard_pod_affinity_weight)
