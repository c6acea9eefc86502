"""The pieces of the oracle's generic scheduling algorithm the device
driver shares: the adaptive partial-search quota, the decision record and
the FitError it raises (reference: pkg/scheduler/core/generic_scheduler.go).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_tpu_torch.api.types import Pod

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
