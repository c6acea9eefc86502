"""The generic scheduling algorithm, deterministic-sequential, copied from
the reference oracle (`kubernetes_tpu.oracle.generic_scheduler`) with the
port's imports, its extender filter and prioritize passes included.

The device driver shares the adaptive partial-search quota, the decision
record and the FitError it raises; `TorchScheduler`'s host twin runs
`GenericScheduler` itself. Reference: pkg/scheduler/core/generic_scheduler.go
— findNodesThatFit (:457, with the resumable lastIndex rotation and the
adaptive percentageOfNodesToScore truncation :434), PrioritizeNodes (:672,
map / reduce / weighted-sum), and selectHost (:286, round-robin among
max-score ties via lastNodeIndex). Evaluated sequentially, which makes the
feasible set and tie-breaks deterministic (the reference's 16-way goroutine
pool makes its own truncation/tie order racy; sequential order IS the
single-worker reference behavior, and is the canonical parity target).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Pod, Node, Service, ReplicaSet
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.oracle import predicates as preds
from kubernetes_tpu_torch.oracle import priorities as prios
from kubernetes_tpu_torch.oracle.preemption import pod_fits_on_node_with_nominated

MIN_FEASIBLE_NODES_TO_FIND = 100       # generic_scheduler.go:57
MIN_FEASIBLE_PERCENTAGE = 5            # generic_scheduler.go:62
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 50  # api/types.go:40


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int) -> int:
    """Adaptive partial-search quota (reference: generic_scheduler.go:434).
    Shared by the oracle and the device scheduler so both stop the node walk
    at exactly the same point."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive <= 0:
        adaptive = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_PERCENTAGE:
            adaptive = MIN_FEASIBLE_PERCENTAGE
    num = num_all_nodes * adaptive // 100
    if num < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num


@dataclass
class PriorityConfig:
    """One Score plugin entry (reference: priorities.PriorityConfig)."""
    name: str
    weight: int = 1
    map_fn: Optional[Callable[[Pod, NodeInfo], int]] = None
    reduce_fn: Optional[Callable[[list[int]], list[int]]] = None
    # function-style priorities compute the whole list at once
    function: Optional[Callable[[Pod, dict[str, NodeInfo], list[Node]], list[int]]] = None


def default_priority_configs(services_fn: Callable[[], list[Service]] = lambda: [],
                             replicasets_fn: Callable[[], list[ReplicaSet]] = lambda: [],
                             hard_pod_affinity_weight: int = 1) -> list[PriorityConfig]:
    """The DefaultProvider priority set (reference: defaults.go:108), all
    weight 1 except NodePreferAvoidPods at 10000
    (register_priorities.go:26)."""

    def selector_spread_function(pod: Pod, node_infos: dict[str, NodeInfo],
                                 nodes: list[Node]) -> list[int]:
        selectors = prios.get_selectors(pod, services_fn(), replicasets_fn())
        hosts = [n.name for n in nodes]
        counts = [prios.selector_spread_map(pod, node_infos[h], selectors) for h in hosts]
        return prios.selector_spread_reduce(node_infos, hosts, counts)

    def interpod_function(pod: Pod, node_infos: dict[str, NodeInfo],
                          nodes: list[Node]) -> list[int]:
        return prios.interpod_affinity_priority(pod, node_infos, nodes,
                                                hard_pod_affinity_weight)

    def image_locality_fn(pod: Pod, node_infos: dict[str, NodeInfo],
                          nodes: list[Node]) -> list[int]:
        total = len(node_infos)
        return [prios.image_locality_map(pod, node_infos[n.name], total) for n in nodes]

    return [
        PriorityConfig("SelectorSpreadPriority", 1, function=selector_spread_function),
        PriorityConfig("InterPodAffinityPriority", 1, function=interpod_function),
        PriorityConfig("LeastRequestedPriority", 1, map_fn=prios.least_requested_map),
        PriorityConfig("BalancedResourceAllocation", 1, map_fn=prios.balanced_allocation_map),
        PriorityConfig("NodePreferAvoidPodsPriority", 10000, map_fn=prios.node_prefer_avoid_pods_map),
        PriorityConfig("NodeAffinityPriority", 1, map_fn=prios.node_affinity_map,
                       reduce_fn=lambda s: prios.normalize_reduce(prios.MAX_PRIORITY, False, s)),
        PriorityConfig("TaintTolerationPriority", 1, map_fn=prios.taint_toleration_map,
                       reduce_fn=lambda s: prios.normalize_reduce(prios.MAX_PRIORITY, True, s)),
        PriorityConfig("ImageLocalityPriority", 1, function=image_locality_fn),
    ]


@dataclass
class ScheduleResult:
    suggested_host: str
    evaluated_nodes: int
    feasible_nodes: int
    # per-host weighted total score, in feasible order (for parity checks)
    host_priority: list[tuple[str, int]] = field(default_factory=list)
    failed_predicates: dict[str, list[str]] = field(default_factory=dict)


class FitError(Exception):
    def __init__(self, pod: Pod, num_all_nodes: int, failed: dict[str, list[str]]):
        super().__init__(f"0/{num_all_nodes} nodes available for {pod.key}")
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.failed_predicates = failed


class GenericScheduler:
    """Deterministic-sequential Schedule(): filter -> score -> select."""

    def __init__(self,
                 percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
                 always_check_all_predicates: bool = False,
                 hard_pod_affinity_weight: int = 1,
                 nominated_pods_fn: Callable[[str], list[Pod]] = lambda n: []):
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.always_check_all = always_check_all_predicates
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.nominated_pods_fn = nominated_pods_fn  # podFitsOnNode two-pass (:627)
        self.extenders = []   # SchedulerExtender list (core/extender.go)
        self.last_index = 0         # findNodesThatFit resumable rotation (:486)
        self.last_node_index = 0    # selectHost round-robin counter (:292)

    # -- findNodesThatFit ---------------------------------------------------
    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        """Reference: generic_scheduler.go:434."""
        return num_feasible_nodes_to_find(num_all_nodes,
                                          self.percentage_of_nodes_to_score)

    def find_nodes_that_fit(self, pod: Pod, node_infos: dict[str, NodeInfo],
                            all_node_names: list[str],
                            predicate_funcs: dict[str, Callable],
                            ) -> tuple[list[Node], dict[str, list[str]], int]:
        """Sequential equivalent of :457 — walk from last_index, stop at
        num_nodes_to_find feasible. Returns (nodes, failed_map, evaluated)."""
        n = len(all_node_names)
        num_to_find = self.num_feasible_nodes_to_find(n)
        filtered: list[Node] = []
        failed: dict[str, list[str]] = {}
        processed = 0
        for i in range(n):
            if len(filtered) >= num_to_find:
                break
            name = all_node_names[(self.last_index + i) % n]
            ni = node_infos[name]
            processed += 1
            fit, reasons = pod_fits_on_node_with_nominated(
                pod, ni, predicate_funcs, self.nominated_pods_fn,
                self.always_check_all, node_infos=node_infos)
            if fit:
                filtered.append(ni.node)
            else:
                failed[name] = reasons
        self.last_index = (self.last_index + processed) % n if n else 0
        return filtered, failed, processed

    # -- PrioritizeNodes ----------------------------------------------------
    def prioritize_nodes(self, pod: Pod, node_infos: dict[str, NodeInfo],
                         priority_configs: list[PriorityConfig],
                         nodes: list[Node]) -> list[tuple[str, int]]:
        """Reference: :672 — when no configs, EqualPriority weight 1."""
        if not priority_configs:
            return [(n.name, 1) for n in nodes]
        totals = [0] * len(nodes)
        for cfg in priority_configs:
            if cfg.function is not None:
                scores = cfg.function(pod, node_infos, nodes)
            else:
                scores = [cfg.map_fn(pod, node_infos[n.name]) for n in nodes]
                if cfg.reduce_fn is not None:
                    scores = cfg.reduce_fn(scores)
            for i, s in enumerate(scores):
                totals[i] += s * cfg.weight
        return [(n.name, t) for n, t in zip(nodes, totals)]

    # -- selectHost ---------------------------------------------------------
    def select_host(self, host_priority: list[tuple[str, int]]) -> str:
        """Reference: :286 — round-robin among max-score ties."""
        if not host_priority:
            raise ValueError("empty priorityList")
        max_score = max(s for _, s in host_priority)
        max_idx = [i for i, (_, s) in enumerate(host_priority) if s == max_score]
        ix = self.last_node_index % len(max_idx)
        self.last_node_index += 1
        return host_priority[max_idx[ix]][0]

    # -- Schedule -----------------------------------------------------------
    def schedule(self, pod: Pod, node_infos: dict[str, NodeInfo],
                 all_node_names: list[str],
                 predicate_funcs: Optional[dict[str, Callable]] = None,
                 priority_configs: Optional[list[PriorityConfig]] = None,
                 ) -> ScheduleResult:
        if predicate_funcs is None:
            predicate_funcs = preds.default_predicate_set(node_infos)
        if priority_configs is None:
            priority_configs = default_priority_configs(
                hard_pod_affinity_weight=self.hard_pod_affinity_weight)
        if not all_node_names:
            raise FitError(pod, 0, {})
        filtered, failed, evaluated = self.find_nodes_that_fit(
            pod, node_infos, all_node_names, predicate_funcs)
        # extender filter pass (generic_scheduler.go:532)
        if filtered and self.extenders:
            for ext in self.extenders:
                filtered, ext_failed = ext.filter(pod, filtered)
                for name, reasons in ext_failed.items():
                    failed.setdefault(name, []).extend(reasons)
                if not filtered:
                    break
        if not filtered:
            raise FitError(pod, len(all_node_names), failed)
        if len(filtered) == 1:
            return ScheduleResult(filtered[0].name, evaluated, 1,
                                  [(filtered[0].name, 0)], failed)
        host_priority = self.prioritize_nodes(pod, node_infos, priority_configs, filtered)
        # extender prioritize pass (generic_scheduler.go:774): extender scores
        # are multiplied by the extender's own weight and added in
        if self.extenders:
            totals = dict(host_priority)
            for ext in self.extenders:
                scores, weight = ext.prioritize(pod, filtered)
                if not weight:
                    continue
                for name, score in scores.items():
                    if name in totals:
                        totals[name] += score * weight
            host_priority = [(name, totals[name]) for name, _ in host_priority]
        host = self.select_host(host_priority)
        return ScheduleResult(host, evaluated, len(filtered), host_priority, failed)
