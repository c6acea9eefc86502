"""Semantic oracle: preemption — exact reference behavior, copied from the
reference (`kubernetes_tpu.oracle.preemption`) with the port's imports. The
device paths (`ops.kernels.preemption_scan`, `pressure_batch`) call its
eligibility, candidate and PDB pieces; the scheduler shell's fallback runs
its `Preemptor`.

Mirrors pkg/scheduler/core/generic_scheduler.go:
- Preempt (:310): eligibility → candidate nodes → victim selection per node
  → 6-criteria node pick → lower-priority nomination cleanup.
- selectVictimsOnNode (:1054): remove all lower-priority pods, check fit,
  then the order-dependent reprieve loop (PDB-violating pods first, each
  sorted by descending importance).
- pickOneNodeForPreemption (:837): minPDBViolations → minHighestVictim →
  minSumPriorities → fewestVictims → latestStartTime → first.
- podFitsOnNode's two-pass nominated-pod handling (:598,627): a node with
  higher/equal-priority nominated pods must fit both with and without them.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Pod, Node, PodDisruptionBudget
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.oracle import predicates as preds


@dataclass
class Victims:
    """Reference: api/types.go:263."""
    pods: list[Pod] = field(default_factory=list)
    num_pdb_violations: int = 0


def importance_key(p: Pod):
    """Sort key for descending importance (reference:
    pkg/scheduler/util.MoreImportantPod — higher priority first, ties broken
    by earlier start time). The single source for victim ordering."""
    start = p.start_time if p.start_time is not None else float("inf")
    return (-p.priority, start)


def more_important_pod(a: Pod, b: Pod) -> bool:
    return importance_key(a) < importance_key(b)


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
    reason (preempting pods can't fix a selector/taint mismatch)."""
    out = []
    for name in all_node_names:
        # a node absent from the failure map (e.g. extender-trimmed) counts
        # as resolvable — the reference includes it (:1145-1151)
        reasons = failed_predicates.get(name) or []
        if any(r in preds.UNRESOLVABLE_FAILURES for r in reasons):
            continue
        out.append(name)
    return out


def no_possible_victims(pod: Pod, node_infos: dict[str, NodeInfo],
                        candidates: list[str]) -> bool:
    """Fast-path predicate shared by the oracle Preemptor and the device
    path (core/torch_scheduler.preempt) so the two cannot drift: when no
    candidate hosts any lower-priority pod, victim removal is a no-op on
    every node — a candidate could only succeed if the pod already fit
    unchanged, impossible against the snapshot that produced its FitError.
    The reference discovers this by walking every candidate through
    selectVictimsOnNode (generic_scheduler.go:1054); skipping the walk
    avoids an O(candidates x predicate-set) scan per failed pod in
    same-priority saturation workloads."""
    return not any(p.priority < pod.priority
                   for name in candidates
                   for p in node_infos[name].pods)


def pods_violating_pdbs(pods: list[Pod],
                        pdbs: list[PodDisruptionBudget]) -> list[Pod]:
    """Reference: :1032 filterPodsWithPDBViolation — a pod violates when a
    matching PDB has no disruptions left."""
    violating = []
    for pod in pods:
        for pdb in pdbs:
            if pdb.namespace != pod.namespace or pdb.selector is None:
                continue
            if pdb.selector.matches(pod.labels) and pdb.disruptions_allowed <= 0:
                violating.append(pod)
                break
    return violating


def pods_violating_pdbs_mask(table, pdbs: list[PodDisruptionBudget]) -> "np.ndarray":
    """[P] bool twin of pods_violating_pdbs over a columnar pod table
    (ops.node_state.PodTable, duck-typed like the predicates matchers): one
    selector mask per PDB instead of a Python loop per (pod, pdb) pair.
    Must stay bit-identical to a row-by-row scalar evaluation — the victim
    table's reprieve ordering sorts on these flags, so a divergence here is
    a preemption-decision divergence (pinned by the PDB mask parity
    fuzzes)."""
    import numpy as np
    from kubernetes_tpu_torch.oracle.predicates import selector_match_mask
    viol = np.zeros(len(table.pods), dtype=bool)
    for pdb in pdbs:
        if pdb.selector is None or pdb.disruptions_allowed > 0:
            continue
        nsid = table.ns_vocab.get(pdb.namespace)
        if nsid is None:
            continue
        viol |= (table.ns_id == nsid) & selector_match_mask(pdb.selector,
                                                            table)
    return viol


def select_victims_on_node(pod: Pod, node_info: NodeInfo,
                           fits_fn: Callable[[Pod, NodeInfo], bool],
                           pdbs: list[PodDisruptionBudget],
                           checker=None) -> Optional[Victims]:
    """Reference: :1054. `fits_fn` runs the predicate suite against a
    *mutated copy* of the node (the caller passes podFitsOnNode bound to the
    predicate set). `checker` is the inter-pod-affinity metadata handle:
    every mutation mirrors into it incrementally (meta.RemovePod/AddPod,
    :1068-1078) instead of invalidating the cluster scan per fit check.
    Returns None when preemption can't help on this node."""
    ni = node_info.clone()
    node = ni.node
    # remove all lower-priority pods
    potential = [p for p in ni.pods if p.priority < pod.priority]
    for p in list(potential):
        ni.remove_pod(p)
        if checker is not None:
            checker.remove_pod(pod, p, node)
    if not fits_fn(pod, ni):
        return None
    # reprieve loop: PDB-violating victims get re-added first (so we prefer
    # keeping them), each group in descending importance
    violating = pods_violating_pdbs(potential, pdbs)
    violating_set = {p.uid for p in violating}
    non_violating = [p for p in potential if p.uid not in violating_set]
    violating.sort(key=importance_key)
    non_violating.sort(key=importance_key)
    victims = Victims()

    def reprieve(p: Pod) -> bool:
        ni.add_pod(p)
        if checker is not None:
            checker.add_pod(pod, p, node)
        if fits_fn(pod, ni):
            return True
        ni.remove_pod(p)
        if checker is not None:
            checker.remove_pod(pod, p, node)
        return False

    for p in violating:
        if not reprieve(p):
            victims.pods.append(p)
            victims.num_pdb_violations += 1
    for p in non_violating:
        if not reprieve(p):
            victims.pods.append(p)
    return victims


def pick_one_node_for_preemption(
        nodes_to_victims: dict[str, Victims]) -> Optional[str]:
    """Reference: :837 — six tie-break criteria, order preserved from the
    candidate map's iteration order (here: insertion order)."""
    if not nodes_to_victims:
        return None
    # a node with no victims wins immediately
    for name, v in nodes_to_victims.items():
        if not v.pods:
            return name
    candidates = list(nodes_to_victims)

    # 1. fewest PDB violations
    min_pdb = min(nodes_to_victims[n].num_pdb_violations for n in candidates)
    candidates = [n for n in candidates
                  if nodes_to_victims[n].num_pdb_violations == min_pdb]
    if len(candidates) == 1:
        return candidates[0]

    # 2. lowest first-victim priority. The victims list is ordered
    # (PDB-violating victims in descending importance, then the rest), and
    # the reference reads Pods[0] — NOT the true maximum (:876).
    def first_priority(n):
        return nodes_to_victims[n].pods[0].priority
    min_high = min(first_priority(n) for n in candidates)
    candidates = [n for n in candidates if first_priority(n) == min_high]
    if len(candidates) == 1:
        return candidates[0]

    # 3. smallest sum of victim priorities, each offset by 2^31 so victim
    # COUNT dominates for negative priorities (:899-903)
    def sum_priorities(n):
        return sum(p.priority + (1 << 31) for p in nodes_to_victims[n].pods)
    min_sum = min(sum_priorities(n) for n in candidates)
    candidates = [n for n in candidates if sum_priorities(n) == min_sum]
    if len(candidates) == 1:
        return candidates[0]

    # 4. fewest victims
    min_count = min(len(nodes_to_victims[n].pods) for n in candidates)
    candidates = [n for n in candidates
                  if len(nodes_to_victims[n].pods) == min_count]
    if len(candidates) == 1:
        return candidates[0]

    # 5. latest (earliest start time among the truly-highest-priority
    # victims) — util.GetEarliestPodStartTime; a nil start time reads as
    # "now" in the reference, i.e. latest (+inf here)
    def earliest_start_of_highest(n):
        pods = nodes_to_victims[n].pods
        high = max(p.priority for p in pods)
        return min(p.start_time if p.start_time is not None else float("inf")
                   for p in pods if p.priority == high)
    best = candidates[0]
    best_t = earliest_start_of_highest(best)
    for n in candidates[1:]:
        t = earliest_start_of_highest(n)
        if t > best_t:
            best_t = t
            best = n
    return best


@dataclass
class PreemptionResult:
    node: Optional[Node]
    victims: list[Pod]
    nominated_to_clear: list[Pod]


class Preemptor:
    """genericScheduler.Preempt (:310) against a snapshot."""

    def __init__(self,
                 pdbs_fn: Callable[[], list[PodDisruptionBudget]] = lambda: [],
                 extenders: Optional[list] = None):
        self.pdbs_fn = pdbs_fn
        self.extenders = extenders or []

    def preempt(self, pod: Pod, node_infos: dict[str, NodeInfo],
                all_node_names: list[str],
                fit_error,
                nominated_pods_fn: Callable[[str], list[Pod]] = lambda n: [],
                predicate_set_fn: Optional[Callable] = None) -> PreemptionResult:
        if not pod_eligible_to_preempt_others(pod, node_infos):
            return PreemptionResult(None, [], [])
        candidates = nodes_where_preemption_might_help(
            node_infos, all_node_names, fit_error.failed_predicates)
        if not candidates:
            # preemption can't help anywhere: the pod's own stale nomination
            # must be cleared (reference: generic_scheduler.go:330-333 returns
            # []*v1.Pod{pod} as nominatedPodsToClear)
            return PreemptionResult(None, [], [pod])
        pdbs = self.pdbs_fn()
        if no_possible_victims(pod, node_infos, candidates):
            return PreemptionResult(None, [], [])

        nodes_to_victims: dict[str, Victims] = {}
        for name in candidates:
            ni = node_infos[name]
            # The predicate set sees the snapshot with the candidate's
            # mutated clone standing in for the original: inter-pod affinity
            # must observe removed/reprieved victims, so its metadata cache
            # is invalidated around every mutation (the reference's
            # meta.RemovePod/AddPod, :1068-1078).
            scratch = dict(node_infos)
            funcs = (predicate_set_fn(scratch) if predicate_set_fn
                     else preds.default_predicate_set(scratch))
            checker = funcs.get("_ipa_checker")

            def fits_with_scratch(p: Pod, mutated: NodeInfo, _name=name,
                                  _scratch=scratch, _funcs=funcs,
                                  _checker=checker) -> bool:
                _scratch[_name] = mutated
                try:
                    # the reference passes the scheduling queue into
                    # selectVictimsOnNode (:985), so victim fitting runs the
                    # nominated-ghost two-pass too — otherwise two preemptors
                    # can nominate the same node with zero victims, live-locking.
                    # The affinity metadata tracks victim mutations
                    # incrementally (select_victims_on_node's checker hooks),
                    # so no invalidation here.
                    ok, _ = pod_fits_on_node_with_nominated(
                        p, mutated, _funcs, nominated_pods_fn,
                        node_infos=_scratch)
                    return ok
                finally:
                    _scratch[_name] = node_infos[_name]
            v = select_victims_on_node(pod, ni, fits_with_scratch, pdbs,
                                       checker=checker)
            if v is not None:
                nodes_to_victims[name] = v
        # extender preemption veto/trim (generic_scheduler.go:347)
        for ext in self.extenders:
            if not getattr(ext.config, "preempt_verb", ""):
                continue
            surviving = ext.process_preemption(
                pod, {n: v.pods for n, v in nodes_to_victims.items()})
            nodes_to_victims = {
                n: Victims(pods=surviving[n],
                           num_pdb_violations=nodes_to_victims[n].num_pdb_violations)
                for n in surviving}
        chosen = pick_one_node_for_preemption(nodes_to_victims)
        if chosen is None:
            return PreemptionResult(None, [], [])
        # lower-priority nominated pods on the chosen node lose their spot
        # (reference: :1185 getLowerPriorityNominatedPods)
        nominated_to_clear = [
            p for p in nominated_pods_fn(chosen) if p.priority < pod.priority]
        node = node_infos[chosen].node
        return PreemptionResult(node, nodes_to_victims[chosen].pods,
                                nominated_to_clear)


# ---------------------------------------------------------------------------
# Nominated-pod-aware fitting (reference: podFitsOnNode :598 two-pass)
# ---------------------------------------------------------------------------
def pod_fits_on_node_with_nominated(
        pod: Pod, node_info: NodeInfo,
        predicate_funcs: dict[str, Callable],
        nominated_pods_fn: Callable[[str], list[Pod]],
        always_check_all: bool = False,
        node_infos: Optional[dict[str, NodeInfo]] = None) -> tuple[bool, list[str]]:
    """Two-pass check: pass 1 with higher/equal-priority nominated pods
    added to the node, pass 2 without; the pod must fit both.

    When `node_infos` is the snapshot the predicate set was built over, the
    ghost-augmented clone is swapped into it for pass 1 so inter-pod
    affinity sees the ghosts (the reference's meta.AddPod, :627)."""
    node_name = node_info.node.name if node_info.node else ""
    nominated = [p for p in nominated_pods_fn(node_name)
                 if p.priority >= pod.priority and p.uid != pod.uid]
    if not nominated:
        return preds.pod_fits_on_node(pod, node_info, predicate_funcs,
                                      always_check_all)
    checker = predicate_funcs.get("_ipa_checker")
    # pass 1: with nominated pods (the affinity metadata takes the ghosts
    # as incremental AddPod deltas, removed again for pass 2 — meta.AddPod
    # semantics, :627)
    ni = node_info.clone()
    ghosts = []
    for p in nominated:
        ghost = copy.copy(p)
        ghost.node_name = node_name
        ni.add_pod(ghost)
        ghosts.append(ghost)
        if checker is not None:
            checker.add_pod(pod, ghost, ni.node)
    swapped = node_infos is not None and node_name in node_infos
    if swapped:
        original = node_infos[node_name]
        node_infos[node_name] = ni
    try:
        fit, reasons = preds.pod_fits_on_node(pod, ni, predicate_funcs,
                                              always_check_all)
    finally:
        if swapped:
            node_infos[node_name] = original
        if checker is not None:
            for ghost in ghosts:
                checker.remove_pod(pod, ghost, ni.node)
    if not fit:
        return fit, reasons
    # pass 2: without
    return preds.pod_fits_on_node(pod, node_info, predicate_funcs,
                                  always_check_all)
