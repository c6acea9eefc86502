"""Scheduling profiles: the port's copy of
`kubernetes_tpu/profiles/__init__.py` (with the helpers it needs from
`factory.py`; its weight bounds are the port's `apis/policy.py`): the
profile set, its row updates and snapshots, its lookups, the
unknown-profile report and the per-profile scheduled counts, and the
per-profile priority configs of the serial cycle's host twin
(`oracle_configs`).

A pod picks its profile by `spec.schedulerName`; each profile carries its
own priority-weight vector. A pod whose schedulerName no profile claims
is reported (`profile.unknown` and, with a recorder, a FailedScheduling
event), never scored by the default profile. On the device the vectors stack into one
`[profiles x priorities]` int64 table (column order `ops.PRIORITY_AXIS`)
and every kernel gathers a pod's row by its profile id, so one launch
scores a window that mixes profiles. The last column, `gang_locality`, is
the rank-aware gang objective: a profile with `rank_aware=True` makes its
gangs prefer zones that already hold members of the same gang.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.apis.policy import (   # noqa: F401 (MAX_WEIGHT)
    MAX_WEIGHT, Policy, PolicyValidationError, PriorityPolicy,
    validate_policy,
)
from kubernetes_tpu_torch.factory import DEFAULT_PRIORITY_WEIGHTS, \
    TPU_WEIGHT_KEYS, build_priority_configs, tpu_kernel_weights
from kubernetes_tpu_torch.ops import PRIORITY_AXIS

DEFAULT_PROFILE_NAME = "default-scheduler"

#: the event type of the unknown-profile report (store/record.py WARNING)
WARNING = "Warning"


class ProfileValidationError(ValueError):
    pass


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
        #: uids already reported unknown (bounds the event noise)
        self._unknown_seen: set = set()
        self.unknown_names: dict[str, int] = {}
        #: pods scheduled by each profile (`debug_state`; the counter
        #: `profile.scheduled.<name>` is the same count)
        self.scheduled_counts = [0] * len(self.profiles)
        #: bumped on every successful set_row: caches key their refresh
        #: off it
        self.version = 0
        if validate:
            self.validate()

    @staticmethod
    def from_dict(d: dict) -> "ProfileSet":
        return ProfileSet([SchedulingProfile.from_dict(p)
                           for p in d.get("profiles", ())])

    @staticmethod
    def from_json(text: str) -> "ProfileSet":
        return ProfileSet.from_dict(json.loads(text))

    @staticmethod
    def from_file(path: str) -> "ProfileSet":
        with open(path) as f:
            return ProfileSet.from_dict(json.load(f))

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
                if prio_name not in TPU_WEIGHT_KEYS:
                    errs.append(f"profile {p.name}: unknown priority "
                                f"{prio_name!r}")
            # the weights ride apis/policy's bounds (positive, under
            # MAX_WEIGHT), the rank-aware gang weight too
            pol = Policy(priorities=[
                PriorityPolicy(name=n, weight=w) for n, w in
                sorted(nw.items())])
            if p.rank_aware:
                pol.priorities.append(PriorityPolicy(
                    name=f"{p.name}/GangLocalityPriority",
                    weight=p.gang_weight))
            try:
                validate_policy(pol)
            except PolicyValidationError as e:
                errs.append(f"profile {p.name}: {e}")
        if errs:
            raise ProfileValidationError("; ".join(errs))

    def set_row(self, name_or_index, weights, rank_aware=None,
                gang_weight=None) -> SchedulingProfile:
        """Replace one profile's weight row in place (same name, same
        index). The whole trial set runs the constructor's validation;
        on failure nothing changes. `weights` is a {priority name:
        weight} mapping or the constructor's tuple form; empty means the
        DefaultProvider vector. Returns the installed profile."""
        if isinstance(name_or_index, int):
            i = name_or_index
            if not 0 <= i < len(self.profiles):
                raise ProfileValidationError(f"no profile at index {i}")
        else:
            i = self._index.get(name_or_index)
            if i is None:
                raise ProfileValidationError(
                    f"no profile named {name_or_index!r}")
        old = self.profiles[i]
        if isinstance(weights, dict):
            wt = tuple(sorted((str(k), int(v)) for k, v in weights.items()))
        else:
            wt = tuple(weights)
        cand = SchedulingProfile(
            name=old.name, weights=wt,
            rank_aware=old.rank_aware if rank_aware is None
            else bool(rank_aware),
            gang_weight=old.gang_weight if gang_weight is None
            else int(gang_weight))
        trial = list(self.profiles)
        trial[i] = cand
        ProfileSet(trial, validate=True)
        self.profiles[i] = cand
        self.version += 1
        return cand

    def snapshot(self) -> "ProfileSet":
        """A copy whose rows stay as they are now: later set_row calls
        replace entries of the live list only."""
        snap = ProfileSet(list(self.profiles), validate=False)
        snap.version = self.version
        return snap

    def __len__(self) -> int:
        return len(self.profiles)

    def __iter__(self):
        return iter(self.profiles)

    @property
    def default(self) -> SchedulingProfile:
        return self.profiles[0]

    def index_of(self, scheduler_name: str) -> Optional[int]:
        """Profile index of a pod's spec.schedulerName, or None when no
        profile claims it (the caller reports it, not default-scores)."""
        return self._index.get(scheduler_name)

    def profile_for(self, scheduler_name: str) -> Optional[SchedulingProfile]:
        i = self.index_of(scheduler_name)
        return None if i is None else self.profiles[i]

    def gang_weight_for(self, scheduler_name: str) -> int:
        p = self.profile_for(scheduler_name)
        return p.gang_weight if (p is not None and p.rank_aware) else 0

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
        row = tpu_kernel_weights(p.name_weights())
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

    def report_unknown(self, pod, recorder=None) -> None:
        """Book a pod no profile claims: `profile.unknown` and, once per
        uid, a FailedScheduling event on `recorder`."""
        self.unknown_names[pod.scheduler_name] = \
            self.unknown_names.get(pod.scheduler_name, 0) + 1
        if pod.uid in self._unknown_seen:
            return
        self._unknown_seen.add(pod.uid)
        if len(self._unknown_seen) > 65536:
            self._unknown_seen.clear()
        obs.inc("profile.unknown")
        if recorder is not None:
            recorder.pod_event(
                pod, WARNING, "FailedScheduling",
                f"no scheduling profile claims "
                f"schedulerName={pod.scheduler_name!r}")

    def note_scheduled(self, i: int, count: int = 1) -> None:
        obs.inc("profile.scheduled." + self.profiles[i].name, count)
        self.scheduled_counts[i] += count

    def debug_state(self) -> dict:
        tab = self.weight_table()
        return {
            "priority_axis": list(PRIORITY_AXIS),
            "profiles": [{
                "name": p.name,
                "rank_aware": p.rank_aware,
                "weights": tab[i].tolist(),
                "scheduled": self.scheduled_counts[i],
            } for i, p in enumerate(self.profiles)],
            "tensor_mode": self.tensor_mode(),
            "unknown_scheduler_names": dict(self.unknown_names),
        }
