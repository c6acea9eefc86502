"""Component configuration — KubeSchedulerConfiguration analog.

Mirrors pkg/scheduler/apis/config/types.go:42: scheduler name, algorithm
source (provider | policy file/inline), hard pod-affinity weight, leader
election, preemption switch, percentage of nodes to score, bind timeout —
plus this framework's own switch: the TPUScoring feature gate routing
filter/score through the device kernels (in the port: deciding on the
card, through the hand-written CUDA kernels; see `utils/features.py`).

Round-trips to/from plain dicts (the stand-in for the reference's versioned
serialization, apis/config/v1alpha1) with validation
(apis/config/validation).

Copied whole from the reference (`kubernetes_tpu.apis.config`) with the
port's imports: one config file serves both packages.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Optional

DEFAULT_SCHEDULER_NAME = "default-scheduler"
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 50
DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1
DEFAULT_BIND_TIMEOUT_SECONDS = 100      # scheduler.go:50


@dataclass
class LeaderElectionConfig:
    """component-base config.LeaderElectionConfiguration subset."""
    leader_elect: bool = False
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    lock_object_name: str = "kube-scheduler"


@dataclass
class AlgorithmSource:
    """apis/config/types.go:93 — exactly one of provider / policy."""
    provider: Optional[str] = "DefaultProvider"
    policy_file: Optional[str] = None
    policy_inline: Optional[dict] = None


@dataclass
class SchedulerConfiguration:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    algorithm_source: AlgorithmSource = field(default_factory=AlgorithmSource)
    hard_pod_affinity_symmetric_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT
    disable_preemption: bool = False
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    bind_timeout_seconds: float = DEFAULT_BIND_TIMEOUT_SECONDS
    leader_election: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    # feature gates (pkg/features analog); TPUScoring routes filter/score to
    # the device kernels (the card's, in the port)
    feature_gates: dict = field(default_factory=lambda: {"TPUScoring": True})
    plugins_enabled: Optional[list] = None
    # scheduling profiles (round 19 — KubeSchedulerConfiguration.profiles):
    # raw profile dicts ({"schedulerName": ..., "priorities": ...,
    # "rankAwareGang": ..., "gangWeight": ...}); build_profiles() resolves
    # them into a validated profiles.ProfileSet. None = single-profile
    # (scheduler_name + algorithm_source), exactly the pre-profile config.
    profiles: Optional[list] = None

    # -- round trip ----------------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SchedulerConfiguration":
        cfg = SchedulerConfiguration()
        src = d.get("algorithm_source") or {}
        cfg.algorithm_source = AlgorithmSource(
            provider=src.get("provider", "DefaultProvider"),
            policy_file=src.get("policy_file"),
            policy_inline=src.get("policy_inline"))
        le = d.get("leader_election") or {}
        cfg.leader_election = LeaderElectionConfig(**{
            k: le[k] for k in LeaderElectionConfig.__dataclass_fields__ if k in le})
        for k in ("scheduler_name", "hard_pod_affinity_symmetric_weight",
                  "disable_preemption", "percentage_of_nodes_to_score",
                  "bind_timeout_seconds", "plugins_enabled", "profiles"):
            if k in d:
                setattr(cfg, k, d[k])
        if "feature_gates" in d:
            cfg.feature_gates = dict(cfg.feature_gates, **d["feature_gates"])
        return cfg

    def build_profiles(self):
        """Resolve `profiles` into a validated profiles.ProfileSet, or
        None when the config is single-profile. Validation errors
        (duplicate names, unknown priorities, weight bounds) surface as
        ValidationError, matching the rest of this module."""
        if not self.profiles:
            return None
        from kubernetes_tpu_torch.profiles import ProfileSet
        try:
            return ProfileSet.from_dict({"profiles": self.profiles})
        except ValueError as e:
            raise ValidationError(str(e)) from e

    @staticmethod
    def from_file(path: str) -> "SchedulerConfiguration":
        with open(path) as f:
            return SchedulerConfiguration.from_dict(json.load(f))


class ValidationError(ValueError):
    pass


def validate(cfg: SchedulerConfiguration) -> None:
    """apis/config/validation analog."""
    errs = []
    if not cfg.scheduler_name:
        errs.append("scheduler_name must not be empty")
    if not (0 <= cfg.percentage_of_nodes_to_score <= 100):
        errs.append("percentage_of_nodes_to_score must be in [0, 100]")
    if not (0 <= cfg.hard_pod_affinity_symmetric_weight <= 100):
        errs.append("hard_pod_affinity_symmetric_weight must be in [0, 100]")
    if cfg.bind_timeout_seconds <= 0:
        errs.append("bind_timeout_seconds must be positive")
    src = cfg.algorithm_source
    has_policy = src.policy_file is not None or src.policy_inline is not None
    if src.provider is None and not has_policy:
        errs.append("algorithm_source requires provider or policy")
    if src.policy_file is not None and src.policy_inline is not None:
        errs.append("policy_file and policy_inline are mutually exclusive")
    # provider defaults to DefaultProvider; any OTHER provider alongside a
    # policy is ambiguous (the reference requires exactly one source)
    if has_policy and src.provider not in (None, "DefaultProvider"):
        errs.append("provider and policy are mutually exclusive")
    if cfg.profiles:
        if has_policy:
            errs.append("profiles and policy are mutually exclusive")
        try:
            cfg.build_profiles()
        except ValidationError as e:
            errs.append(str(e))
    if errs:
        raise ValidationError("; ".join(errs))
