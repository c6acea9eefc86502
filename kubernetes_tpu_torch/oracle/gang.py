"""Serial gang trial — the oracle referee for all-or-nothing placement.

The device path trial-places a whole PodGroup through the burst wave
machinery and commits only a complete gang; THIS is the sequential
semantics it must match bit-for-bit (the same contract the burst kernels
hold against the serial scheduleOne loop, extended to group atomicity):

    for each member, in queue order:
        refresh the snapshot (earlier members' assumes are visible)
        consume one NodeTree enumeration
        schedule(member) against the live state
        assume the placement in the cache
    all members placed  -> the trial's assumes stand; the caller binds
    any member fails    -> EVERY assume is rolled back, the algorithm's
                           last_index / lastNodeIndex rewind, and the
                           NodeTree cursor restores — observable state is
                           exactly as if the gang was never attempted

`GangTrial` owns the rollback bookkeeping so the scheduler shell (and the
parity fuzzes) cannot half-rewind. It is transport- and algorithm-agnostic:
the oracle shell runs it as its primary gang path, and the TPU shell runs
it whenever the burst kernels refuse a gang's feature mix (decisions are
identical either way — that is the point).

Copied from the reference with the port's imports:
`kubernetes_tpu.oracle.gang`.
"""
from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch.oracle.generic_scheduler import FitError


class GangTrial:
    """One atomic trial of a gang against the live cache."""

    def __init__(self, cache, algorithm):
        self.cache = cache
        self.algorithm = algorithm

    def run(self, pods: list, schedule_fn: Callable,
            refresh_snapshot_fn: Callable[[], None],
            on_placed: Optional[Callable[[str], None]] = None,
            ) -> Optional[list[str]]:
        """Trial-place `pods` serially. Returns the per-member host list
        with every member's assume left IN the cache (the caller commits
        by binding), or None after a full rollback when any member failed.

        `schedule_fn(pod, names)` is the shell's algorithm dispatch;
        `refresh_snapshot_fn()` refreshes the shell's snapshot so member
        k sees members 0..k-1 as assumed load. `on_placed(host)`
        (optional) fires after each member's assume — the rank-aware gang
        set-scoring hook: the shell folds the placed member's zone into
        the trial's zone-count tracker so member k+1's GangLocalityPriority
        sees members 0..k, exactly like the fused kernel's per-segment
        carry (a rollback discards the whole tracker with the trial)."""
        tree = self.cache.node_tree
        tree_chk = tree.checkpoint()
        li = self.algorithm.last_index
        lni = self.algorithm.last_node_index
        assumed: list = []
        hosts: list[str] = []
        # exposed so the shell can roll a SUCCESSFUL trial back too (a
        # node death detected between trial and commit re-trials the gang
        # rather than binding a partial one)
        self.last_assumed = assumed
        self.last_chk = (tree_chk, li, lni)
        try:
            for pod in pods:
                refresh_snapshot_fn()
                names = tree.list_names()
                result = schedule_fn(pod, names)
                trial = pod.clone()
                trial.node_name = result.suggested_host
                self.cache.assume_pod(trial)
                assumed.append(trial)
                hosts.append(result.suggested_host)
                if on_placed is not None:
                    on_placed(result.suggested_host)
        except FitError:
            self.rollback(assumed, tree_chk, li, lni)
            return None
        return hosts

    def rollback(self, assumed: list, tree_chk, li: int, lni: int) -> None:
        """Forget every trial assume and rewind the walk counters + the
        rotation cursor to the pre-gang checkpoint (reverse order, so the
        cache transitions through the same states the trial created)."""
        for trial in reversed(assumed):
            self.cache.forget_pod(trial)
        self.algorithm.last_index = li
        self.algorithm.last_node_index = lni
        self.cache.node_tree.restore(tree_chk)
