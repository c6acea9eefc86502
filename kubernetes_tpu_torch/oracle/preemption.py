"""The host pieces of preemption that the device paths call, copied from the
oracle (reference: pkg/scheduler/core/generic_scheduler.go):

- the result record of Preempt (:310);
- the importance order of victims (util.MoreImportantPod);
- the eligibility check (:1165) and the candidate filter (:1142) that run
  before the victim scan;
- the fast path when no candidate hosts a lower-priority pod;
- the PDB-violation mask over the columnar pod table, which feeds the
  reprieve order of the victim table.

The victim scan and the node pick themselves run on the device
(`ops.kernels.preemption_scan`, `ops.kernels.pressure_batch`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.types import Pod, Node, PodDisruptionBudget
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.oracle import predicates as preds


def importance_key(p: Pod):
    """Sort key for descending importance (reference:
    pkg/scheduler/util.MoreImportantPod — higher priority first, ties broken
    by earlier start time)."""
    start = p.start_time if p.start_time is not None else float("inf")
    return (-p.priority, start)


def pod_eligible_to_preempt_others(pod: Pod,
                                   node_infos: dict[str, NodeInfo]) -> bool:
    """Reference: :1165 — a pod that already nominated a node is ineligible
    while a lower-priority pod on that node is terminating."""
    if pod.nominated_node_name:
        ni = node_infos.get(pod.nominated_node_name)
        if ni is not None:
            for p in ni.pods:
                if p.deleted and p.priority < pod.priority:
                    return False
    return True


def nodes_where_preemption_might_help(
        node_infos: dict[str, NodeInfo],
        all_node_names: list[str],
        failed_predicates: dict[str, list[str]]) -> list[str]:
    """Reference: :1142 — drop nodes whose failure includes an unresolvable
    reason (preempting pods can't fix a selector/taint mismatch). A node
    absent from the failure map counts as resolvable (:1145-1151)."""
    out = []
    for name in all_node_names:
        reasons = failed_predicates.get(name) or []
        if any(r in preds.UNRESOLVABLE_FAILURES for r in reasons):
            continue
        out.append(name)
    return out


def no_possible_victims(pod: Pod, node_infos: dict[str, NodeInfo],
                        candidates: list[str]) -> bool:
    """True when no candidate hosts any lower-priority pod: victim removal
    is then a no-op on every node, and a candidate could only succeed if
    the pod already fit unchanged, which the FitError rules out."""
    return not any(p.priority < pod.priority
                   for name in candidates
                   for p in node_infos[name].pods)


def pods_violating_pdbs_mask(table,
                             pdbs: list[PodDisruptionBudget]) -> np.ndarray:
    """[P] bool over a columnar pod table (ops.node_state.PodTable): the pod
    violates when a PDB of its namespace with no disruptions left selects
    it (filterPodsWithPDBViolation, :1032), one selector mask per PDB."""
    viol = np.zeros(len(table.pods), dtype=bool)
    for pdb in pdbs:
        if pdb.selector is None or pdb.disruptions_allowed > 0:
            continue
        nsid = table.ns_vocab.get(pdb.namespace)
        if nsid is None:
            continue
        viol |= (table.ns_id == nsid) & preds.selector_match_mask(
            pdb.selector, table)
    return viol


@dataclass
class PreemptionResult:
    node: Optional[Node]
    victims: list[Pod]
    nominated_to_clear: list[Pod]
