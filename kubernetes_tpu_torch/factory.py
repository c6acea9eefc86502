"""Predicate and priority registries of the reference's factory
(`kubernetes_tpu/factory.py`), copied with the port's imports and cut to
what `TorchScheduler`'s host twin and the scheduler shell reach: the
DefaultProvider's predicate names and priority weights, the predicate-set
assembly, the priority config registry and the kernel weight dict of a
priority selection (`tpu_kernel_weights`). The policy and config surface
(providers, custom predicates and priorities registered by a Policy,
`create_scheduler`) has no copy in the port.

Mirrors pkg/scheduler/factory/ (CreateFromKeys :417) and
pkg/scheduler/algorithmprovider/defaults (defaultPredicates :40,
defaultPriorities :108).
"""
from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch.ops import DEFAULT_WEIGHTS
from kubernetes_tpu_torch.oracle import predicates as preds
from kubernetes_tpu_torch.oracle import priorities as prios
from kubernetes_tpu_torch.oracle.generic_scheduler import PriorityConfig

# -- predicate registry -------------------------------------------------------
# The effective DefaultProvider set with TaintNodesByCondition on
# (defaults.go:40,60-90): condition/pressure predicates are replaced by
# taints + CheckNodeUnschedulable.
DEFAULT_PREDICATE_NAMES = [
    "NoVolumeZoneConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "MaxCSIVolumeCountPred", "MatchInterPodAffinity",
    "NoDiskConflict", "GeneralPredicates", "CheckVolumeBinding",
    "CheckNodeUnschedulable", "PodToleratesNodeTaints",
]


def build_predicate_set(names: list[str],
                        node_infos,
                        volume_listers=None,
                        volume_binder=None) -> dict[str, Callable]:
    """CreateFromKeys predicate assembly: the named subset, evaluated in
    predicates.PREDICATE_ORDERING."""
    base = preds.default_predicate_set(node_infos,
                                       volume_listers=volume_listers,
                                       volume_binder=volume_binder)
    # keep the metadata-invalidation handle (not a predicate; preemption and
    # the nominated-ghost two-pass need it)
    out = {"_ipa_checker": base["_ipa_checker"]}
    for name in names:
        if name in base:
            out[name] = base[name]
        elif name in ("PodFitsResources", "PodFitsHostPorts", "MatchNodeSelector",
                      "HostName"):
            out[name] = {
                "PodFitsResources": preds.pod_fits_resources,
                "PodFitsHostPorts": preds.pod_fits_host_ports,
                "MatchNodeSelector": preds.pod_match_node_selector,
                "HostName": preds.pod_fits_host,
            }[name]
        else:
            raise KeyError(f"unknown predicate {name!r}")
    return out


# -- priority registry --------------------------------------------------------
DEFAULT_PRIORITY_WEIGHTS = {
    "SelectorSpreadPriority": 1,
    "InterPodAffinityPriority": 1,
    "LeastRequestedPriority": 1,
    "BalancedResourceAllocation": 1,
    "NodePreferAvoidPodsPriority": 10000,   # register_priorities.go:26
    "NodeAffinityPriority": 1,
    "TaintTolerationPriority": 1,
    "ImageLocalityPriority": 1,
}


def build_priority_configs(name_weights: dict[str, int],
                           services_fn=lambda: [],
                           replicasets_fn=lambda: [],
                           hard_pod_affinity_weight: int = 1) -> list[PriorityConfig]:
    def spread_fn(pod, node_infos, nodes):
        selectors = prios.get_selectors(pod, services_fn(), replicasets_fn())
        hosts = [n.name for n in nodes]
        counts = [prios.selector_spread_map(pod, node_infos[h], selectors)
                  for h in hosts]
        return prios.selector_spread_reduce(node_infos, hosts, counts)

    def interpod_fn(pod, node_infos, nodes):
        return prios.interpod_affinity_priority(pod, node_infos, nodes,
                                                hard_pod_affinity_weight)

    def image_fn(pod, node_infos, nodes):
        total = len(node_infos)
        return [prios.image_locality_map(pod, node_infos[n.name], total)
                for n in nodes]

    builders = {
        "SelectorSpreadPriority": lambda w: PriorityConfig(
            "SelectorSpreadPriority", w, function=spread_fn),
        "InterPodAffinityPriority": lambda w: PriorityConfig(
            "InterPodAffinityPriority", w, function=interpod_fn),
        "LeastRequestedPriority": lambda w: PriorityConfig(
            "LeastRequestedPriority", w, map_fn=prios.least_requested_map),
        "MostRequestedPriority": lambda w: PriorityConfig(
            "MostRequestedPriority", w, map_fn=prios.most_requested_map),
        "RequestedToCapacityRatioPriority": lambda w: PriorityConfig(
            "RequestedToCapacityRatioPriority", w, map_fn=prios.make_rtcr_map()),
        "BalancedResourceAllocation": lambda w: PriorityConfig(
            "BalancedResourceAllocation", w, map_fn=prios.balanced_allocation_map),
        "NodePreferAvoidPodsPriority": lambda w: PriorityConfig(
            "NodePreferAvoidPodsPriority", w, map_fn=prios.node_prefer_avoid_pods_map),
        "ResourceLimitsPriority": lambda w: PriorityConfig(
            "ResourceLimitsPriority", w, map_fn=prios.resource_limits_map),
        "NodeAffinityPriority": lambda w: PriorityConfig(
            "NodeAffinityPriority", w, map_fn=prios.node_affinity_map,
            reduce_fn=lambda s: prios.normalize_reduce(prios.MAX_PRIORITY, False, s)),
        "TaintTolerationPriority": lambda w: PriorityConfig(
            "TaintTolerationPriority", w, map_fn=prios.taint_toleration_map,
            reduce_fn=lambda s: prios.normalize_reduce(prios.MAX_PRIORITY, True, s)),
        "ImageLocalityPriority": lambda w: PriorityConfig(
            "ImageLocalityPriority", w, function=image_fn),
        "EqualPriority": lambda w: PriorityConfig(
            "EqualPriority", w, map_fn=prios.equal_priority_map),
    }
    out = []
    for name, weight in name_weights.items():
        if name in builders:
            out.append(builders[name](weight))
        else:
            raise KeyError(f"unknown priority {name!r}")
    return out


# -- kernel support matrix ----------------------------------------------------
# priority name -> kernel weight key (ops.kernels.DEFAULT_WEIGHTS)
TPU_WEIGHT_KEYS = {
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


def tpu_kernel_weights(name_weights: dict[str, int]) -> Optional[dict]:
    """Kernel weight dict for a priority selection, or None when a priority
    has no device implementation (callers fall back to the host twin)."""
    weights = {k: 0 for k in DEFAULT_WEIGHTS}
    for name, w in name_weights.items():
        key = TPU_WEIGHT_KEYS.get(name)
        if key is None:
            return None
        weights[key] = w
    return weights
