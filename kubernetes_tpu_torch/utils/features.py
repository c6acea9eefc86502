"""Feature-gate registry — pkg/features/kube_features.go analog.

The reference consults a process-global gate set
(`utilfeature.DefaultFeatureGate.Enabled`, e.g. gating snapshot behavior at
cache.go:213 and balanced-allocation volume variance at
balanced_resource_allocation.go:44); this mirrors that shape: a default
table, `enabled()` lookups from anywhere, and config-time overrides
(`--feature-gates` -> SchedulerConfiguration.feature_gates -> set_gates).

Copied whole from the reference (`kubernetes_tpu.utils.features`). The
gate names stay the reference's, so one config file works with both
packages: in the port, `TPUScoring` means "decide on the card" (the
TorchScheduler and its CUDA kernels). Its table default stays False and
`SchedulerConfiguration`'s default turns it on, as in the reference.
"""
from __future__ import annotations

# name -> default (the subset of the reference's 66 gates this framework
# consults, with the reference's v1.15 defaults)
DEFAULT_FEATURE_GATES: dict[str, bool] = {
    # scheduler scoring runs on the device kernel path (the north star's
    # gate; in the port: the card)
    "TPUScoring": False,
    # balanced-allocation scores volume-count variance alongside cpu/mem
    # (balanced_resource_allocation.go:44; default false / alpha)
    "BalanceAttachedNodeVolumes": False,
    # node conditions surface as taints; the default provider's predicate
    # set assumes this (defaults.go:60 ApplyFeatureGates; default true)
    "TaintNodesByCondition": True,
    # kubelet-reported attach limits in node.allocatable
    # ("attachable-volumes-*"; default true in v1.15)
    "AttachVolumeLimit": True,
}

_gates: dict[str, bool] = dict(DEFAULT_FEATURE_GATES)


def enabled(name: str) -> bool:
    return _gates.get(name, False)


def set_gates(overrides: dict[str, bool]) -> None:
    """Apply config-time overrides (unknown names are kept — callers may
    consult gates this table doesn't pre-declare)."""
    _gates.update({k: bool(v) for k, v in overrides.items()})


def reset() -> None:
    """Restore defaults (test isolation)."""
    _gates.clear()
    _gates.update(DEFAULT_FEATURE_GATES)
