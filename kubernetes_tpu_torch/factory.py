"""Factory: predicate/priority registries, algorithm providers, config
wiring — the port's copy of the reference's factory
(`kubernetes_tpu/factory.py`) with the port's imports.

Mirrors pkg/scheduler/factory/ (RegisterFitPredicate plugins.go:106,
CreateFromProvider :336, CreateFromConfig :346, CreateFromKeys :417) and
pkg/scheduler/algorithmprovider/defaults (defaultPredicates :40,
defaultPriorities :108, ClusterAutoscalerProvider swapping LeastRequested
for MostRequested :99).

`create_scheduler` takes the device route (the port's `Scheduler` with
`use_device=True` on `device`, `cuda` by default: TorchScheduler and its
CUDA kernels) exactly when the reference takes its TPU route: the
`TPUScoring` gate is on, every priority has a kernel weight, every
predicate is one the kernels evaluate, and the Policy names no extender
(a bind-only one included). Otherwise it builds the shell over the port's
copy of the oracle, with the Policy's extenders (`core/extender.py`) in
its filter, prioritize, preempt and bind passes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.apis.config import SchedulerConfiguration, validate
from kubernetes_tpu_torch.apis.policy import Policy, validate_policy
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

_EXTRA_PREDICATES: dict[str, Callable] = {}


def register_fit_predicate(name: str, factory: Callable) -> None:
    """plugins.go:106 RegisterFitPredicate —
    `factory(node_infos, services_fn) -> fn`."""
    _EXTRA_PREDICATES[name] = factory


def register_custom_fit_predicate(policy_pred) -> bool:
    """plugins.go:204 RegisterCustomFitPredicate — map a Policy predicate
    with an argument onto its checker. Returns True when registered."""
    arg = policy_pred.argument or {}
    if "labelsPresence" in arg:
        spec = arg["labelsPresence"]
        register_fit_predicate(
            policy_pred.name,
            lambda ni, sf, _s=spec: preds.make_node_label_presence(
                _s.get("labels", []), bool(_s.get("presence", True))))
        return True
    if "serviceAffinity" in arg:
        spec = arg["serviceAffinity"]
        register_fit_predicate(
            policy_pred.name,
            lambda ni, sf, _s=spec: preds.make_service_affinity(
                _s.get("labels", []), ni, sf))
        return True
    return False


def build_predicate_set(names: list[str],
                        node_infos,
                        volume_listers=None,
                        volume_binder=None,
                        services_fn: Callable = lambda: []) -> dict[str, Callable]:
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
        elif name in _EXTRA_PREDICATES:
            out[name] = _EXTRA_PREDICATES[name](node_infos, services_fn)
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

_EXTRA_PRIORITIES: dict[str, Callable] = {}


def register_priority(name: str, config_factory: Callable) -> None:
    """plugins.go RegisterPriorityConfigFactory analog:
    `config_factory(weight, services_fn, replicasets_fn, hard_weight) ->
    PriorityConfig`."""
    _EXTRA_PRIORITIES[name] = config_factory


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
        elif name in _EXTRA_PRIORITIES:
            out.append(_EXTRA_PRIORITIES[name](
                weight, services_fn, replicasets_fn, hard_pod_affinity_weight))
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

TPU_SUPPORTED_PREDICATES = {
    "GeneralPredicates", "PodFitsResources", "PodFitsHostPorts",
    "MatchNodeSelector", "HostName", "CheckNodeUnschedulable",
    "PodToleratesNodeTaints", "MatchInterPodAffinity",
    # volume predicates are always-fit in this version
    "NoVolumeZoneConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount", "MaxCSIVolumeCountPred", "NoDiskConflict",
    "CheckVolumeBinding",
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


def tpu_supports_predicates(names: list[str]) -> bool:
    return all(n in TPU_SUPPORTED_PREDICATES for n in names)


# -- algorithm providers ------------------------------------------------------
@dataclass(frozen=True)
class AlgorithmProvider:
    predicate_names: tuple
    priority_weights: tuple  # of (name, weight)


_PROVIDERS: dict[str, AlgorithmProvider] = {}


def register_algorithm_provider(name: str, predicate_names: list[str],
                                priority_weights: dict[str, int]) -> None:
    _PROVIDERS[name] = AlgorithmProvider(
        tuple(predicate_names), tuple(priority_weights.items()))


def get_algorithm_provider(name: str) -> AlgorithmProvider:
    if name not in _PROVIDERS:
        raise KeyError(f"unknown algorithm provider {name!r}")
    return _PROVIDERS[name]


register_algorithm_provider("DefaultProvider", DEFAULT_PREDICATE_NAMES,
                            DEFAULT_PRIORITY_WEIGHTS)
# ClusterAutoscalerProvider: MostRequested replaces LeastRequested
# (defaults.go:99 registerAlgorithmProvider)
_ca = dict(DEFAULT_PRIORITY_WEIGHTS)
del _ca["LeastRequestedPriority"]
_ca["MostRequestedPriority"] = 1
register_algorithm_provider("ClusterAutoscalerProvider",
                            DEFAULT_PREDICATE_NAMES, _ca)


# -- config -> Scheduler ------------------------------------------------------
def resolve_algorithm(cfg: SchedulerConfiguration
                      ) -> tuple[list[str], dict[str, int], Policy]:
    """AlgorithmSource resolution (scheduler.go:162-192): provider name or
    Policy. Returns (predicate_names, priority_weights, policy)."""
    src = cfg.algorithm_source
    if src.policy_file or src.policy_inline:
        if src.policy_file:
            policy = Policy.from_file(src.policy_file)
        else:
            policy = Policy.from_dict(src.policy_inline)
        validate_policy(policy)
        default = get_algorithm_provider("DefaultProvider")
        pred_names = ([p.name for p in policy.predicates]
                      if policy.predicates else list(default.predicate_names))
        prio_weights = ({p.name: p.weight for p in policy.priorities}
                        if policy.priorities else dict(default.priority_weights))
        return pred_names, prio_weights, policy
    provider = get_algorithm_provider(src.provider or "DefaultProvider")
    return (list(provider.predicate_names), dict(provider.priority_weights),
            Policy())


def create_scheduler(store, cfg: Optional[SchedulerConfiguration] = None,
                     extender_endpoints: Optional[dict] = None,
                     device="cuda", **kw):
    """cmd/kube-scheduler Run + scheduler.New analog: validated config in,
    fully wired Scheduler out. `extender_endpoints` maps extender url_prefix
    to a callable-endpoint dict for in-process extenders. On the device
    route the scheduler decides on `device` (`cuda` unless the caller asks
    for the CPU's plain versions); a device route that did not end up on a
    TorchScheduler on that device raises instead of running on the host."""
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.core.extender import SchedulerExtender
    cfg = cfg or SchedulerConfiguration()
    validate(cfg)
    from kubernetes_tpu_torch.utils import features
    features.set_gates(cfg.feature_gates)
    pred_names, prio_weights, policy = resolve_algorithm(cfg)
    for pd in policy.predicates:
        if pd.argument:
            register_custom_fit_predicate(pd)
    hard_weight = (policy.hard_pod_affinity_symmetric_weight
                   if policy.hard_pod_affinity_symmetric_weight is not None
                   else cfg.hard_pod_affinity_symmetric_weight)
    extenders = [
        SchedulerExtender(ec, endpoints=(extender_endpoints or {}).get(
            ec.url_prefix))
        for ec in policy.extenders]
    # the reference's TPU-route rule (its factory.py:295-298)
    use_device = bool(cfg.feature_gates.get("TPUScoring")) \
        and tpu_kernel_weights(prio_weights) is not None \
        and tpu_supports_predicates(pred_names) \
        and not extenders
    kw.setdefault("extenders", extenders)
    # production wiring shards the node axis across every visible card;
    # direct Scheduler construction stays single-card unless asked. The
    # CPU's plain versions take no mesh.
    if str(device) != "cpu":
        kw.setdefault("mesh", "auto")
    sched = Scheduler(
        store,
        scheduler_name=cfg.scheduler_name,
        use_device=use_device,
        device=device,
        percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
        hard_pod_affinity_weight=hard_weight,
        disable_preemption=cfg.disable_preemption,
        predicate_names=pred_names,
        priority_weights=prio_weights,
        plugins_enabled=cfg.plugins_enabled,
        **kw)
    if use_device:
        import torch
        from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
        algo = sched.algorithm
        want = torch.device(device).type
        if not isinstance(algo, TorchScheduler) \
                or algo.device.type != want:
            raise RuntimeError(
                f"create_scheduler: the device route built "
                f"{type(algo).__name__} on "
                f"{getattr(algo, 'device', 'the host')}, not a "
                f"TorchScheduler on {want}")
    return sched
