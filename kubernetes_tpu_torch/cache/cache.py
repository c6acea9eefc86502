"""Scheduler cache: authoritative in-memory cluster state with optimistic
assume/confirm/expire and generation-based incremental snapshots.

Mirrors the semantics of pkg/scheduler/internal/cache/cache.go:
- AssumePod (:274) — optimistically place a pod before binding completes;
  FinishBinding (:295) starts a TTL; cleanup (:632) expires it.
- AddPod (:385) — informer confirmation of an assumed pod.
- Per-node recency: nodes whose NodeInfo changed move to the head of a
  doubly-linked list (:134), so UpdateNodeInfoSnapshot (:210) only clones
  nodes whose generation is newer than the snapshot's.

Copied from the reference with the port's imports:
`kubernetes_tpu.cache.cache`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.cache.node_tree import NodeTree
from kubernetes_tpu_torch.utils.clock import Clock, RealClock

DEFAULT_ASSUME_TTL = 30.0  # seconds (reference: factory.go:250)


class CacheError(Exception):
    pass


class _ListItem:
    """Doubly-linked recency list node (reference: nodeInfoListItem :53)."""

    __slots__ = ("info", "prev", "next")

    def __init__(self, info: NodeInfo):
        self.info = info
        self.prev: Optional[_ListItem] = None
        self.next: Optional[_ListItem] = None


@dataclass
class _PodState:
    pod: Pod
    deadline: Optional[float] = None     # assumed-pod expiry once binding finished
    binding_finished: bool = False


@dataclass
class Snapshot:
    """NodeInfoSnapshot (reference: interface.go:125). `sums` holds the
    cluster utilization's six sums over `node_infos` (requested cpu,
    memory, ephemeral storage, then allocatable: node_info.
    utilization_of), kept by update_snapshot as it swaps clones in and
    out: the utilization gauge reads them instead of walking every node
    (~14 ms at 15,000 nodes on one host core) each time a scraper samples
    it. The reference's Snapshot has no such field."""
    node_infos: dict[str, NodeInfo] = field(default_factory=dict)
    generation: int = 0
    sums: tuple = (0, 0, 0, 0, 0, 0)


class SchedulerCache:
    def __init__(self, ttl: float = DEFAULT_ASSUME_TTL,
                 clock: Optional[Clock] = None):
        self.ttl = ttl
        self.clock = clock or RealClock()
        self._lock = threading.RLock()
        self._nodes: dict[str, _ListItem] = {}
        self._head: Optional[_ListItem] = None
        self._pod_states: dict[str, _PodState] = {}   # uid -> state
        self._assumed: set[str] = set()               # uids
        self.node_tree = NodeTree()

    # -- recency list -------------------------------------------------------
    def _move_to_head(self, item: _ListItem) -> None:
        if self._head is item:
            return
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        item.prev = None
        item.next = self._head
        if self._head is not None:
            self._head.prev = item
        self._head = item

    def _remove_from_list(self, item: _ListItem) -> None:
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        if self._head is item:
            self._head = item.next
        item.prev = item.next = None

    def _touch(self, name: str) -> NodeInfo:
        """NodeInfo for mutation; creates a placeholder (node=None) like the
        reference does for pods that arrive before their node (:389)."""
        item = self._nodes.get(name)
        if item is None:
            item = _ListItem(NodeInfo())
            self._nodes[name] = item
        self._move_to_head(item)
        return item.info

    # -- pods ---------------------------------------------------------------
    def assume_pod(self, pod: Pod) -> None:
        """Reference: cache.go:274 — pod.node_name must already be set."""
        with self._lock:
            if pod.uid in self._pod_states:
                raise CacheError(f"pod {pod.key} already assumed/added")
            self._touch(pod.node_name).add_pod(pod)
            self._pod_states[pod.uid] = _PodState(pod)
            self._assumed.add(pod.uid)

    def assume_pods(self, pods: list) -> None:
        """Batched assume_pod for a committed burst wave: ONE lock
        acquisition for the wave instead of one per pod. Per-pod semantics
        are assume_pod's exactly (same placeholder creation, same recency
        touch, same already-assumed error — raised after the earlier pods
        of the batch landed, matching what the serial loop would have
        done)."""
        with self._lock:
            for pod in pods:
                if pod.uid in self._pod_states:
                    raise CacheError(f"pod {pod.key} already assumed/added")
                self._touch(pod.node_name).add_pod(pod)
                self._pod_states[pod.uid] = _PodState(pod)
                self._assumed.add(pod.uid)

    def finish_binding(self, pod: Pod, now: Optional[float] = None) -> None:
        """Reference: cache.go:295 — start the expiry TTL."""
        with self._lock:
            state = self._pod_states.get(pod.uid)
            if state is None or pod.uid not in self._assumed:
                return
            state.binding_finished = True
            state.deadline = (now if now is not None else self.clock.now()) + self.ttl

    def finish_bindings(self, pods: list, now: Optional[float] = None) -> None:
        """Batched finish_binding: one lock, one clock read for the wave."""
        now = now if now is not None else self.clock.now()
        deadline = now + self.ttl
        with self._lock:
            for pod in pods:
                state = self._pod_states.get(pod.uid)
                if state is None or pod.uid not in self._assumed:
                    continue
                state.binding_finished = True
                state.deadline = deadline

    def forget_pod(self, pod: Pod) -> None:
        """Reference: cache.go:319 — undo a failed assume."""
        with self._lock:
            state = self._pod_states.get(pod.uid)
            if state is None or pod.uid not in self._assumed:
                raise CacheError(f"pod {pod.key} wasn't assumed so cannot be forgotten")
            self._remove_pod_from_node(state.pod)
            del self._pod_states[pod.uid]
            self._assumed.discard(pod.uid)

    def add_pod(self, pod: Pod) -> None:
        """Informer ADDED for an assigned pod (reference: cache.go:385).
        Confirms an assumed pod, or inserts one the cache didn't assume."""
        with self._lock:
            state = self._pod_states.get(pod.uid)
            if state is not None and pod.uid in self._assumed:
                if state.pod.node_name != pod.node_name:
                    # binding went elsewhere than assumed: fix up
                    self._remove_pod_from_node(state.pod)
                    self._touch(pod.node_name).add_pod(pod)
                self._assumed.discard(pod.uid)
                state.deadline = None
                state.pod = pod
            elif state is None:
                self._touch(pod.node_name).add_pod(pod)
                self._pod_states[pod.uid] = _PodState(pod)
            # duplicate ADDED for confirmed pod: no-op

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            state = self._pod_states.get(old.uid)
            if state is not None and old.uid not in self._assumed:
                self._remove_pod_from_node(state.pod)
                self._touch(new.node_name).add_pod(new)
                state.pod = new

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            state = self._pod_states.get(pod.uid)
            if state is None:
                return
            self._remove_pod_from_node(state.pod)
            del self._pod_states[pod.uid]
            self._assumed.discard(pod.uid)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        item = self._nodes.get(pod.node_name)
        if item is not None:
            item.info.remove_pod(pod)
            # drop an empty placeholder once its last pod is gone
            # (reference: cache.go removePod -> removeNodeInfoFromList)
            if item.info.node is None and not item.info.pods:
                self._remove_from_list(item)
                del self._nodes[pod.node_name]
            else:
                self._move_to_head(item)

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return pod.uid in self._assumed

    def assumed_pods(self) -> list[Pod]:
        """Snapshot of every currently assumed pod (crash-restart
        recovery reconciles these against the store: landed bindings are
        finished/adopted, the rest forgotten and re-queued)."""
        with self._lock:
            return [self._pod_states[uid].pod for uid in self._assumed
                    if uid in self._pod_states]

    def get_pod(self, pod: Pod) -> Optional[Pod]:
        with self._lock:
            state = self._pod_states.get(pod.uid)
            return state.pod if state else None

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_states)

    # -- nodes --------------------------------------------------------------
    def add_node(self, node: Node) -> None:
        with self._lock:
            item = self._nodes.get(node.name)
            if item is None:
                item = _ListItem(NodeInfo())
                self._nodes[node.name] = item
            else:
                # re-add: refresh tree zone membership
                if item.info.node is not None:
                    self.node_tree.remove_node(item.info.node)
            item.info.set_node(node)
            self._move_to_head(item)
            self.node_tree.add_node(node)

    def update_node(self, old: Node, new: Node) -> None:
        with self._lock:
            item = self._nodes.get(new.name)
            if item is None:
                self.add_node(new)
                return
            if item.info.node is not None:
                self.node_tree.update_node(item.info.node, new)
            else:
                self.node_tree.add_node(new)
            item.info.set_node(new)
            self._move_to_head(item)

    def remove_node(self, node: Node) -> None:
        with self._lock:
            item = self._nodes.get(node.name)
            if item is None:
                return
            item.info.remove_node()
            # keep placeholder if pods still reference the node (reference :520)
            if not item.info.pods:
                self._remove_from_list(item)
                del self._nodes[node.name]
            else:
                self._move_to_head(item)
            self.node_tree.remove_node(node)

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def get_node(self, name: str) -> Optional[Node]:
        """The cached Node object (None when absent or a placeholder) —
        the dead-node invalidation path needs the real object so the
        NodeTree removal lands in the right zone."""
        with self._lock:
            item = self._nodes.get(name)
            return item.info.node if item is not None else None

    def node_generation(self, name: str) -> Optional[int]:
        """Current generation of one node's NodeInfo (None when absent);
        lets the TPU mirror sync after self-inflicted mutations."""
        with self._lock:
            item = self._nodes.get(name)
            return item.info.generation if item is not None else None

    def node_generations(self, names: list) -> list:
        """Batched node_generation (one lock for a committed burst wave)."""
        with self._lock:
            return [item.info.generation if item is not None else None
                    for item in map(self._nodes.get, names)]

    # -- snapshot -----------------------------------------------------------
    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incremental clone of changed nodes (reference: cache.go:210).
        Walks the recency list head→tail, stopping at the first item whose
        generation is not newer than the snapshot's."""
        with self._lock:
            balanced_gen = self._head.info.generation if self._head else snapshot.generation
            rc, rm, re, ac, am, ae = snapshot.sums
            infos = snapshot.node_infos
            item = self._head
            while item is not None and item.info.generation > snapshot.generation:
                info = item.info
                if info.node is not None:
                    name = info.node.name
                    old = infos.get(name)
                    if old is not None:
                        q, a = old.requested, old.allocatable
                        rc -= q.milli_cpu
                        rm -= q.memory
                        re -= q.ephemeral_storage
                        ac -= a.milli_cpu
                        am -= a.memory
                        ae -= a.ephemeral_storage
                    infos[name] = info.clone()
                    q, a = info.requested, info.allocatable
                    rc += q.milli_cpu
                    rm += q.memory
                    re += q.ephemeral_storage
                    ac += a.milli_cpu
                    am += a.memory
                    ae += a.ephemeral_storage
                item = item.next
            # drop nodes deleted from the cache; placeholders (node=None)
            # don't count as live, so compare against the node tree
            # (reference: cache.go:210 compares against nodeTree.numNodes)
            if len(infos) > self.node_tree.num_nodes:
                live = {n for n, it in self._nodes.items() if it.info.node is not None}
                for name in list(infos):
                    if name not in live:
                        q, a = infos[name].requested, infos[name].allocatable
                        rc -= q.milli_cpu
                        rm -= q.memory
                        re -= q.ephemeral_storage
                        ac -= a.milli_cpu
                        am -= a.memory
                        ae -= a.ephemeral_storage
                        del infos[name]
            # one reference swap: a reader on another thread sees the sums
            # before or after this update, never half of it
            snapshot.sums = (rc, rm, re, ac, am, ae)
            snapshot.generation = balanced_gen
            return snapshot

    # -- expiry -------------------------------------------------------------
    def cleanup_assumed_pods(self, now: Optional[float] = None) -> list[Pod]:
        """Reference: cache.go:632 — expire assumed pods past their deadline."""
        now = now if now is not None else self.clock.now()
        expired = []
        with self._lock:
            for uid in list(self._assumed):
                state = self._pod_states[uid]
                if state.binding_finished and state.deadline is not None \
                        and now >= state.deadline:
                    expired.append(state.pod)
                    self._remove_pod_from_node(state.pod)
                    del self._pod_states[uid]
                    self._assumed.discard(uid)
        return expired

    # -- debugging (reference: internal/cache/debugger) ----------------------
    def dump(self) -> dict:
        with self._lock:
            return {
                "nodes": {
                    name: {
                        "pods": [p.key for p in item.info.pods],
                        "requested_milli_cpu": item.info.requested.milli_cpu,
                        "requested_memory": item.info.requested.memory,
                        "generation": item.info.generation,
                    }
                    for name, item in self._nodes.items()
                },
                "assumed_pods": sorted(
                    self._pod_states[uid].pod.key for uid in self._assumed),
            }
