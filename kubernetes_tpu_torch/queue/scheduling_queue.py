"""Three-part pending-pod queue with backoff and event-driven wake-ups.

Mirrors the semantics of pkg/scheduler/internal/queue/scheduling_queue.go:
- activeQ: heap by (priority desc, enqueue time asc) — pods ready to schedule.
- podBackoffQ: heap by backoff-completion time — pods recently failed.
- unschedulableQ: map — pods waiting for a cluster event.
- moveRequestCycle (:290): a failed pod whose scheduling cycle predates the
  last MoveAllToActiveQueue request goes to backoff (something changed while
  it was being scheduled), otherwise to unschedulable.
- Backoff 1s initial, doubling to 10s max (pod_backoff.go:41, wired :184).
- Unschedulable pods are flushed to active after 60s (:52, :368).
- nominatedPodMap (:725): pods nominated onto a node by preemption.

Copied from the reference with the port's imports:
`kubernetes_tpu.queue.scheduling_queue`.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod, has_pod_affinity_terms
from kubernetes_tpu_torch.coscheduling.types import pod_group_key
from kubernetes_tpu_torch.obs import ledger as obs_ledger
from kubernetes_tpu_torch.utils.clock import Clock, RealClock
from kubernetes_tpu_torch.utils.heap import NumericKeyedHeap

INITIAL_BACKOFF = 1.0          # seconds (scheduling_queue.go:184)
MAX_BACKOFF = 10.0
UNSCHEDULABLE_TIMEOUT = 60.0   # seconds (scheduling_queue.go:52)

# gang members share their group's (priority, timestamp, seq) sort anchor
# so they pop ADJACENTLY; the member's own enqueue order survives as a
# fraction below the inter-pod seq resolution (seqs are integers >= 1
# apart, so members can never interleave with a neighboring group)
_GROUP_MEMBER_STEP = 2.0 ** -20


@dataclass
class _QueuedPod:
    pod: Pod
    timestamp: float
    seq: int = 0        # FIFO tie-break for equal (priority, timestamp)
    expiry: float = 0.0  # backoff-completion time, snapshotted at enqueue so
    #                      the backoffQ heap key never mutates under the heap


class PodBackoffMap:
    """Per-pod attempt counter → exponential backoff (pod_backoff.go:41)."""

    def __init__(self, initial: float = INITIAL_BACKOFF, max_backoff: float = MAX_BACKOFF):
        self.initial = initial
        self.max = max_backoff
        self._attempts: dict[str, int] = {}
        self._last_update: dict[str, float] = {}

    def backoff_pod(self, key: str, now: float) -> None:
        self._attempts[key] = self._attempts.get(key, 0) + 1
        self._last_update[key] = now

    def backoff_time(self, key: str) -> float:
        """Duration of the current backoff window for the pod."""
        attempts = self._attempts.get(key, 0)
        if attempts == 0:
            return 0.0
        return min(self.initial * (2 ** (attempts - 1)), self.max)

    def backoff_expiry(self, key: str) -> float:
        return self._last_update.get(key, 0.0) + self.backoff_time(key)

    def clear(self, key: str) -> None:
        self._attempts.pop(key, None)
        self._last_update.pop(key, None)


class NominatedPodMap:
    """pods nominated to run on nodes by preemption (:725)."""

    def __init__(self):
        self._by_node: dict[str, list[Pod]] = {}
        self._node_of: dict[str, str] = {}  # pod key -> node

    def add(self, pod: Pod, node_name: str = "") -> None:
        self.delete(pod)
        node = node_name or pod.nominated_node_name
        if not node:
            return
        self._node_of[pod.key] = node
        self._by_node.setdefault(node, []).append(pod)

    def delete(self, pod: Pod) -> None:
        node = self._node_of.pop(pod.key, None)
        if node is None:
            return
        lst = self._by_node.get(node, [])
        self._by_node[node] = [p for p in lst if p.key != pod.key]
        if not self._by_node[node]:
            del self._by_node[node]

    def update(self, old: Pod, new: Pod) -> None:
        self.delete(old)
        self.add(new)

    def pods_for_node(self, node_name: str) -> list[Pod]:
        return list(self._by_node.get(node_name, []))

    def all_pods(self) -> list[Pod]:
        """Every nominated pod (crash-restart recovery prunes entries the
        store no longer backs, then re-adds from the relist)."""
        return [p for lst in self._by_node.values() for p in lst]

    def has_any(self) -> bool:
        return bool(self._by_node)





class PriorityQueue:
    def __init__(self, clock: Optional[Clock] = None,
                 initial_backoff: float = INITIAL_BACKOFF,
                 max_backoff: float = MAX_BACKOFF,
                 unschedulable_timeout: float = UNSCHEDULABLE_TIMEOUT):
        self.clock = clock or RealClock()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count()
        # gang sort anchors: group key -> (priority, timestamp, seq) of the
        # first member seen, so later members sort adjacent to it
        # (coscheduling: gangs form contiguous segments in pop order)
        self._group_anchor: dict[str, tuple[int, float, int]] = {}
        # per-GROUP exponential backoff — a failed gang parks as a unit so
        # queued singletons behind it are not starved by hot re-attempts
        self._gang_backoff = PodBackoffMap(initial_backoff, max_backoff)
        # both orderings are numeric triples (utils/heap.NumericKeyedHeap)
        self._active = NumericKeyedHeap(
            key_fn=lambda q: q.pod.key,
            triple_fn=self._active_triple)
        self._backoffq = NumericKeyedHeap(
            key_fn=lambda q: q.pod.key,
            triple_fn=lambda q: (q.expiry, q.seq, 0.0))
        self._unschedulable: dict[str, _QueuedPod] = {}
        self._backoff = PodBackoffMap(initial_backoff, max_backoff)
        self.unschedulable_timeout = unschedulable_timeout
        self.nominated = NominatedPodMap()
        self._scheduling_cycle = 0
        self._move_request_cycle = -1
        self._closed = False
        self._last_backoff_sweep = self.clock.now()

    def _active_triple(self, q: _QueuedPod) -> tuple:
        """activeQ ordering (priority desc, timestamp asc, seq asc) with
        gang adjacency: a pod group's members all ride the anchor of the
        group's FIRST-seen member — group priority/creation, per the gang
        ordering contract — so a drained burst sees each gang as one
        contiguous run. Member order inside the group stays enqueue order
        (the sub-integer seq fraction)."""
        gk = pod_group_key(q.pod)
        if gk is None:
            return (-q.pod.priority, q.timestamp, q.seq)
        anchor = self._group_anchor.get(gk)
        if anchor is None:
            anchor = self._group_anchor[gk] = (q.pod.priority, q.timestamp,
                                               q.seq)
        prio, ts, seq0 = anchor
        frac = min((q.seq - seq0) * _GROUP_MEMBER_STEP, 0.999999)
        return (-prio, ts, seq0 + frac)

    # -- basic ops ----------------------------------------------------------
    def add(self, pod: Pod) -> None:
        """New pending pod → activeQ (reference: Add :267)."""
        with self._cond:
            q = _QueuedPod(pod, self.clock.now(), next(self._seq))
            self._active.add(q)
            self._unschedulable.pop(pod.key, None)
            self._backoffq.delete(pod.key)
            self.nominated.add(pod)
            # lifecycle ledger: monotonic arrival stamp (first-enqueue
            # wins, so backoff re-entries keep their true queue wait)
            obs_ledger.LEDGER.stamp_enqueue(pod.key)
            self._cond.notify()

    def add_many(self, pods: list) -> None:
        """Batched add for informer-delivered arrival runs: ONE lock
        acquisition, one shared enqueue timestamp (relative order inside
        the batch rides the seq counter, exactly like per-pod adds), one
        heap-core push for the whole batch, and one batched ledger
        stamp — the round-17 ingest prologue (per-pod add() semantics
        otherwise identical)."""
        if not pods:
            return
        with self._cond:
            now = self.clock.now()
            qs = []
            for pod in pods:
                q = _QueuedPod(pod, now, next(self._seq))
                self._unschedulable.pop(pod.key, None)
                self._backoffq.delete(pod.key)
                self.nominated.add(pod)
                qs.append(q)
            self._active.add_many(qs)
            obs_ledger.LEDGER.stamp_enqueue_many(
                [p.key for p in pods], t=now)
            self._cond.notify_all()

    def add_if_not_present(self, pod: Pod) -> None:
        with self._cond:
            if pod.key in self._active or pod.key in self._backoffq \
                    or pod.key in self._unschedulable:
                return
            self.add(pod)

    def add_unschedulable_if_not_present(self, pod: Pod, pod_scheduling_cycle: int) -> None:
        """Failed pod re-entry (reference: :300)."""
        with self._cond:
            if pod.key in self._unschedulable or pod.key in self._active \
                    or pod.key in self._backoffq:
                return
            now = self.clock.now()
            self._backoff.backoff_pod(pod.key, now)
            q = _QueuedPod(pod, now, next(self._seq),
                           expiry=self._backoff.backoff_expiry(pod.key))
            if self._move_request_cycle >= pod_scheduling_cycle:
                self._backoffq.add(q)
                self._cond.notify()
            else:
                self._unschedulable[pod.key] = q
            self.nominated.add(pod)
            obs_ledger.LEDGER.stamp_enqueue(pod.key)  # first-enqueue wins

    def pop(self, timeout: Optional[float] = None) -> Optional[Pod]:
        """Blocks until a pod is ready (reference: :389). Flushes backoff /
        unschedulable timers opportunistically so single-threaded callers
        don't need the background goroutines.

        The blocking `timeout` is wall-clock (it is caller plumbing, not
        scheduling semantics), while backoff/flush timing uses the injected
        clock — so a FakeClock test can time out of an empty queue."""
        import time as _time
        with self._cond:
            deadline = None if timeout is None else _time.monotonic() + timeout
            while True:
                self._flush_locked()
                q = self._active.pop()
                if q is not None:
                    self._scheduling_cycle += 1
                    obs_ledger.LEDGER.stamp(q.pod.key, obs_ledger.POP)
                    return q.pod
                if self._closed:
                    return None
                wait = 0.02
                if deadline is not None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                self._cond.wait(wait)

    def pop_burst(self, limit: int) -> list[tuple[Pod, int]]:
        """Drain up to `limit` ready pods under one lock acquisition and
        ONE heap-core call (pop_many) — (pod, scheduling_cycle) pairs, cycle
        numbering identical to `limit` successive pop() calls.
        Non-blocking; the burst shell's drain prologue."""
        with self._cond:
            self._flush_locked()
            base = self._scheduling_cycle
            qs = self._active.pop_many(limit)
            self._scheduling_cycle += len(qs)
            if qs:
                obs_ledger.LEDGER.stamp_many(
                    [q.pod.key for q in qs], obs_ledger.POP)
            return [(q.pod, base + i + 1) for i, q in enumerate(qs)]

    # -- gang (coscheduling) ops --------------------------------------------
    def pop_group(self, group_key: str,
                  limit: int = 1 << 16) -> list[tuple[Pod, int]]:
        """Drain every ACTIVE member of `group_key` (up to `limit`), in the
        order the activeQ would have popped them — the shell uses this to
        complete a gang whose tail the burst drain limit cut off, so gangs
        are always attempted whole. Non-blocking; backoff/unschedulable
        members stay put (they rejoin at their own expiry)."""
        with self._cond:
            self._flush_locked()
            members = [q for q in self._active.list()
                       if pod_group_key(q.pod) == group_key]
            members.sort(key=self._active_triple)
            out: list[tuple[Pod, int]] = []
            for q in members[:limit]:
                self._active.delete(q.pod.key)
                self._scheduling_cycle += 1
                out.append((q.pod, self._scheduling_cycle))
            if out:
                obs_ledger.LEDGER.stamp_many(
                    [p.key for p, _c in out], obs_ledger.POP)
            return out

    def park_group(self, group_key: str, pods: list[Pod]) -> float:
        """A gang attempt failed (or the group is still incomplete): park
        every given member in the backoffQ under ONE per-group exponential
        backoff window, so the members leave the activeQ together, re-enter
        together when the window expires, and queued singletons behind the
        gang are not starved by hot re-attempts. Returns the window's
        expiry time."""
        with self._cond:
            now = self.clock.now()
            self._gang_backoff.backoff_pod(group_key, now)
            expiry = self._gang_backoff.backoff_expiry(group_key)
            for pod in pods:
                self._active.delete(pod.key)
                self._unschedulable.pop(pod.key, None)
                self._backoffq.delete(pod.key)
                self._backoffq.add(_QueuedPod(pod, now, next(self._seq),
                                              expiry=expiry))
                self.nominated.add(pod)
            return expiry

    def clear_group(self, group_key: str) -> None:
        """Forget a group's backoff + sort anchor (its gang committed, or
        the group object was deleted)."""
        with self._cond:
            self._gang_backoff.clear(group_key)
            self._group_anchor.pop(group_key, None)

    def group_backoff_remaining(self, group_key: str) -> float:
        with self._lock:
            return max(0.0, self._gang_backoff.backoff_expiry(group_key)
                       - self.clock.now())

    @staticmethod
    def _is_pod_updated(old: Optional[Pod], new: Pod) -> bool:
        """Reference: :412 isPodUpdated — resourceVersion and the whole
        status are stripped before comparing, so the scheduler's own
        condition/nomination writes don't clear an unschedulable pod's
        backoff (they'd otherwise hot-loop it through the scheduler)."""
        if old is None:
            return True

        def strip(p: Pod) -> Pod:
            # exactly the status-equivalent fields plus resourceVersion; a
            # *spec* nodeName change must still count as an update
            c = p.clone()
            c.resource_version = 0
            c.nominated_node_name = ""
            c.phase = "Pending"
            c.conditions = ()
            c.start_time = None
            return c

        return strip(old) != strip(new)

    def update(self, old: Optional[Pod], new: Pod) -> None:
        """Reference: :430 — refresh in place; a *spec* update to an
        unschedulable pod moves it back to active (status-only updates just
        refresh the stored object)."""
        with self._cond:
            self.nominated.update(old or new, new)
            if new.key in self._active:
                self._active.add(_QueuedPod(new, self.clock.now(), next(self._seq)))
                self._cond.notify()
                return
            if new.key in self._backoffq:
                expiry = self._backoffq.get(new.key).expiry
                self._backoffq.add(_QueuedPod(new, self.clock.now(), next(self._seq),
                                              expiry=expiry))
                return
            if new.key in self._unschedulable:
                if self._is_pod_updated(old, new):
                    del self._unschedulable[new.key]
                    self._backoff.clear(new.key)
                    self._active.add(_QueuedPod(new, self.clock.now(), next(self._seq)))
                    self._cond.notify()
                else:
                    q = self._unschedulable[new.key]
                    self._unschedulable[new.key] = _QueuedPod(
                        new, q.timestamp, next(self._seq), expiry=q.expiry)
                return
            self.add(new)

    def delete(self, pod: Pod) -> None:
        with self._cond:
            self._active.delete(pod.key)
            self._backoffq.delete(pod.key)
            self._unschedulable.pop(pod.key, None)
            self._backoff.clear(pod.key)
            self.nominated.delete(pod)

    def update_many(self, pairs: list) -> None:
        """Batched update (round 23): one queue-lock acquisition for a
        whole informer run of (old, new) pairs — per-pair semantics are
        exactly update()'s (the inner acquires are reentrant no-ops)."""
        with self._cond:
            for old, new in pairs:
                self.update(old, new)

    def delete_many(self, pods: list) -> None:
        """Batched delete (round 23): one queue-lock acquisition for a
        whole informer run."""
        with self._cond:
            for pod in pods:
                self.delete(pod)

    # -- event-driven moves --------------------------------------------------
    def move_all_to_active(self) -> None:
        """Cluster changed → retry everything (reference: :519)."""
        with self._cond:
            now = self.clock.now()
            for key, q in list(self._unschedulable.items()):
                q.expiry = self._backoff.backoff_expiry(key)
                if q.expiry > now:
                    self._backoffq.add(q)
                else:
                    self._active.add(q)
                del self._unschedulable[key]
            self._move_request_cycle = self._scheduling_cycle
            self._cond.notify_all()

    def assigned_pod_added(self, pod: Pod) -> None:
        """An assigned pod landed → unschedulable pods with (anti)affinity may
        now fit (reference: AssignedPodAdded :486)."""
        self._move_pods_with_affinity()

    def assigned_pod_updated(self, pod: Pod) -> None:
        self._move_pods_with_affinity()

    def _move_pods_with_affinity(self) -> None:
        with self._cond:
            now = self.clock.now()
            moved = False  # noqa: F841 kept for notify gating
            for key, q in list(self._unschedulable.items()):
                if has_pod_affinity_terms(q.pod):
                    q.expiry = self._backoff.backoff_expiry(key)
                    if q.expiry > now:
                        self._backoffq.add(q)
                    else:
                        self._active.add(q)
                    del self._unschedulable[key]
                    moved = True
            # record the move request even when nothing moved: a pod mid-cycle
            # must land in backoffQ, not unschedulableQ
            # (reference: scheduling_queue.go:519 sets moveRequestCycle always)
            self._move_request_cycle = self._scheduling_cycle
            if moved:
                self._cond.notify_all()

    # -- timers --------------------------------------------------------------
    def _flush_locked(self) -> None:
        now = self.clock.now()
        # backoff completed → active (reference: :334)
        while True:
            head = self._backoffq.peek()
            if head is None or head.expiry > now:
                break
            self._backoffq.pop()
            self._active.add(head)
        # unschedulable leftover > 60s → active (reference: :368)
        for key, q in list(self._unschedulable.items()):
            if now - q.timestamp > self.unschedulable_timeout:
                del self._unschedulable[key]
                self._active.add(q)
        # sweep stale backoff records for pods no longer queued
        # (reference: PodBackoffMap.CleanupPodsCompletesBackingoff)
        if now - self._last_backoff_sweep > 2 * self._backoff.max:
            self._last_backoff_sweep = now
            for key in list(self._backoff._attempts):
                if key in self._active or key in self._backoffq \
                        or key in self._unschedulable:
                    continue
                if self._backoff.backoff_expiry(key) + self._backoff.max < now:
                    self._backoff.clear(key)

    def flush(self) -> None:
        with self._cond:
            self._flush_locked()
            self._cond.notify_all()

    # -- introspection -------------------------------------------------------
    @property
    def scheduling_cycle(self) -> int:
        with self._lock:
            return self._scheduling_cycle

    def pending_pods(self) -> dict[str, list[Pod]]:
        with self._lock:
            return {
                "active": [q.pod for q in self._active.list()],
                "backoff": [q.pod for q in self._backoffq.list()],
                "unschedulable": [q.pod for q in self._unschedulable.values()],
            }

    def num_pending(self) -> int:
        with self._lock:
            return len(self._active) + len(self._backoffq) + len(self._unschedulable)

    def active_depth(self) -> int:
        """O(1) activeQ depth — the serving backpressure gate's watermark
        input (deliberately NOT num_pending: backoff/unschedulable pods
        re-enter on their own timers and shedding new arrivals on their
        account would starve a recovering cluster)."""
        with self._lock:
            return len(self._active)

    def parked_gangs(self) -> dict[str, dict]:
        """Gangs currently under a group backoff window, with deadlines —
        the /debug/sched view of why a PodGroup isn't being attempted."""
        with self._lock:
            now = self.clock.now()
            out = {}
            for gk in self._gang_backoff._attempts:
                expiry = self._gang_backoff.backoff_expiry(gk)
                out[gk] = {
                    "attempts": self._gang_backoff._attempts[gk],
                    "backoff_expiry": round(expiry, 3),
                    "remaining_seconds": round(max(0.0, expiry - now), 3),
                }
            return out

    def debug_state(self) -> dict:
        """One /debug/sched section: queue depths, cycle counter, parked
        gangs with deadlines, nominated-pod count."""
        with self._lock:
            state = {
                "active_depth": len(self._active),
                "backoff_depth": len(self._backoffq),
                "unschedulable_depth": len(self._unschedulable),
                "scheduling_cycle": self._scheduling_cycle,
                "move_request_cycle": self._move_request_cycle,
                "nominated_nodes": len(self.nominated._by_node),
            }
        state["parked_gangs"] = self.parked_gangs()
        return state

    def clear_backoff(self, pod: Pod) -> None:
        with self._cond:
            self._backoff.clear(pod.key)
            q = self._backoffq.delete(pod.key)
            if q is not None:
                q.expiry = 0.0
                self._active.add(q)
                self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
