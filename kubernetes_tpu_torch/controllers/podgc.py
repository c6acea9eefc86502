"""Pod garbage collector — pkg/controller/podgc/gc_controller.go.

Three sweeps per reconcile (gc_controller.go:gc):
- gcTerminated: when a terminated-pod threshold is configured, delete the
  oldest Succeeded/Failed pods beyond it (sorted by creation time).
- gcOrphaned: pods bound to a node that no longer exists are deleted.
- gcUnscheduledTerminating: terminating pods never scheduled to a node are
  force-deleted.

The port's copy of the reference's `controllers/podgc.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import Store, PODS, NODES, NotFoundError

TERMINATED_PHASES = ("Succeeded", "Failed")


class PodGCController:
    def __init__(self, store: Store, terminated_pod_threshold: int = 0):
        self.store = store
        self.threshold = terminated_pod_threshold   # 0 = sweep disabled
        self.recorder = EventRecorder(store, component="controllermanager")
        self.informers = InformerFactory(store)

    def sync(self) -> None:
        self.informers.sync_all()
        self.gc()

    def pump(self) -> int:
        self.informers.pump_all()
        return self.gc()

    def _delete(self, pod, reason: str, event: str = "PodGC") -> bool:
        try:
            self.store.delete(PODS, pod.key)
        except NotFoundError:
            return False
        self.recorder.pod_event(pod, NORMAL, event,
                                f"{reason}: deleting pod {pod.key}")
        return True

    def gc(self) -> int:
        pods, _rv = self.store.list(PODS)
        nodes = {n.name for n in self.store.list(NODES)[0]}
        deleted = 0
        # gcTerminated: oldest terminated pods beyond the threshold
        if self.threshold > 0:
            terminated = [p for p in pods if p.phase in TERMINATED_PHASES]
            excess = len(terminated) - self.threshold
            if excess > 0:
                terminated.sort(key=lambda p: p.creation_timestamp)
                for p in terminated[:excess]:
                    deleted += self._delete(p, "terminated pods over threshold")
        # gcOrphaned: bound to a vanished node — force-delete with a
        # NodeLost audit record (the reference's node-lost eviction
        # reason); the pod's controller recreates it, and the recreated
        # pods sort by CREATION time in the scheduler's activeQ (pinned
        # by tests/test_node_churn.py, mirroring the crash-recovery
        # ordering contract)
        for p in pods:
            if p.node_name and p.node_name not in nodes:
                deleted += self._delete(
                    p, f"node {p.node_name} gone", event="NodeLost")
        # gcUnscheduledTerminating
        for p in pods:
            if p.deleted and not p.node_name:
                deleted += self._delete(p, "terminating and never scheduled")
        return deleted
