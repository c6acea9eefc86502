"""Scheduler Policy schema — pkg/scheduler/api Policy analog.

Mirrors api/types.go: Policy (:46) with PredicatePolicy (:72),
PriorityPolicy (:82), and ExtenderConfig (:203). Loaded from JSON exactly
like `--policy-config-file` (factory.go:346 CreateFromConfig).

Copied whole from the reference (`kubernetes_tpu.apis.policy`). Its
weight bounds (`MAX_WEIGHT`) serve the port's ProfileSet validation and
the tuner's search as well. The port parses and validates extenders, but
its scheduler has no extender passes yet: `factory.create_scheduler`
refuses a Policy that names one.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

MAX_PRIORITY = 10      # api/types.go:35
MAX_WEIGHT = (1 << 31) // MAX_PRIORITY  # api/validation: weight*MaxPriority must fit int32


@dataclass
class PredicatePolicy:
    name: str
    # custom-predicate arguments (api/types.go:90 PredicateArgument):
    # {"serviceAffinity": {"labels": [...]}} or
    # {"labelsPresence": {"labels": [...], "presence": bool}}
    argument: Optional[dict] = None


@dataclass
class PriorityPolicy:
    name: str
    weight: int = 1


@dataclass
class ExtenderConfig:
    """api/types.go:203 — out-of-process scheduler webhook."""
    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    preempt_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: tuple = ()


@dataclass
class Policy:
    predicates: list[PredicatePolicy] = field(default_factory=list)
    priorities: list[PriorityPolicy] = field(default_factory=list)
    extenders: list[ExtenderConfig] = field(default_factory=list)
    hard_pod_affinity_symmetric_weight: Optional[int] = None

    @staticmethod
    def from_dict(d: dict) -> "Policy":
        def snake(name: str) -> str:
            out = []
            for ch in name:
                if ch.isupper():
                    out.append("_")
                    out.append(ch.lower())
                else:
                    out.append(ch)
            return "".join(out)

        p = Policy()
        for pd in d.get("predicates", []):
            p.predicates.append(PredicatePolicy(
                name=pd["name"], argument=pd.get("argument")))
        for pr in d.get("priorities", []):
            p.priorities.append(PriorityPolicy(
                name=pr["name"], weight=pr.get("weight", 1)))
        for ex in d.get("extenders", []):
            # accept both the reference's camelCase keys (urlPrefix,
            # filterVerb, managedResources...) and snake_case
            fields = ExtenderConfig.__dataclass_fields__
            kw = {}
            for key, value in ex.items():
                norm = key if key in fields else snake(key)
                if norm in fields:
                    if norm == "managed_resources":
                        # reference shape: [{"name": "example.com/gpu"}, ...]
                        value = tuple(
                            m["name"] if isinstance(m, dict) else m
                            for m in value)
                    kw[norm] = value
            p.extenders.append(ExtenderConfig(**kw))
        if "hardPodAffinitySymmetricWeight" in d:
            p.hard_pod_affinity_symmetric_weight = d["hardPodAffinitySymmetricWeight"]
        elif "hard_pod_affinity_symmetric_weight" in d:
            p.hard_pod_affinity_symmetric_weight = d["hard_pod_affinity_symmetric_weight"]
        return p

    @staticmethod
    def from_json(text: str) -> "Policy":
        return Policy.from_dict(json.loads(text))

    @staticmethod
    def from_file(path: str) -> "Policy":
        with open(path) as f:
            return Policy.from_dict(json.load(f))


class PolicyValidationError(ValueError):
    pass


def validate_policy(policy: Policy) -> None:
    """api/validation/validation.go analog: priority weights must be positive
    and bounded so weight*MaxPriority can't overflow int32."""
    errs = []
    for pr in policy.priorities:
        if pr.weight <= 0:
            errs.append(f"priority {pr.name}: weight must be positive")
        elif pr.weight >= MAX_WEIGHT:
            errs.append(f"priority {pr.name}: weight {pr.weight} too large")
    for ex in policy.extenders:
        if ex.weight <= 0:
            errs.append(f"extender {ex.url_prefix}: weight must be positive")
    bind_count = sum(1 for ex in policy.extenders if ex.bind_verb)
    if bind_count > 1:
        errs.append("only one extender may implement bind")
    if errs:
        raise PolicyValidationError("; ".join(errs))
