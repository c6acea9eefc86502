"""Node lifecycle controller — heartbeat-lease health grading, condition
taints, and zone-aware rate-limited NoExecute eviction.

Mirror of pkg/controller/nodelifecycle (node_lifecycle_controller.go with
TaintBasedEvictions + TaintNodesByCondition on, the v1.15 default stance
the scheduler's predicate set assumes):

- heartbeat leases (monitorNodeHealth): every node agent renews a
  coordination Lease (`node-<name>`, api.types.node_lease_key) on its
  clock; a node whose lease is staler than `node_monitor_grace` grades
  Ready=Unknown — no status-field polling. The agent's own heartbeat
  restores Ready=True on recovery.
- condition -> taint sync: a node whose Ready condition is False gets the
  `node.kubernetes.io/not-ready` NoSchedule + NoExecute taints; Unknown
  gets `node.kubernetes.io/unreachable`; a Ready node has both removed
  (controller doNoScheduleTaintingPass / doNoExecuteTaintingPass).
- zone-aware rate-limited eviction (NoExecuteTaintManager +
  handleDisruption): pods due for NoExecute eviction enter a PER-ZONE
  queue drained through per-zone token buckets. Zone health grades the
  rate: Normal -> `eviction_rate`, PartialDisruption (notReady fraction
  >= `unhealthy_zone_threshold`) -> `secondary_eviction_rate`,
  FullDisruption (no ready node — or a disconnected master, which reads
  as every zone fully disrupted) -> ZERO evictions. Deliberate deviation
  from the reference: an isolated fully-disrupted zone also stops
  evicting (the reference evicts it at the primary rate); this repo's
  contract is that mass-failure never mass-evicts.
- every eviction routes through the PDB-guarded `Store.evict_pod`
  subresource verb: a pod whose disruption budget is exhausted is
  refused (429 semantics) and retried on a later pump — no eviction ever
  lands while `disruptionsAllowed == 0`.

The port's copy of the reference's `controllers/nodelifecycle.py` with
the port's imports.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.api.types import (
    Node, Pod, Taint, NO_SCHEDULE, NO_EXECUTE,
    LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION, node_lease_key,
)
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, NODES, DisruptionBudgetError, NotFoundError,
)
from kubernetes_tpu_torch.utils.clock import Clock, RealClock

TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
_LIFECYCLE_KEYS = (TAINT_NOT_READY, TAINT_UNREACHABLE)

# zone disruption states (nodelifecycle zoneState analogs)
STATE_NORMAL = "Normal"
STATE_PARTIAL = "PartialDisruption"
STATE_FULL = "FullDisruption"
_STATE_CODE = {STATE_NORMAL: 0, STATE_PARTIAL: 1, STATE_FULL: 2}

ZONE_STATE = obs.gauge(
    "zone_disruption_state",
    "Disruption grade per failure zone: 0 = Normal (primary eviction "
    "rate), 1 = PartialDisruption (secondary rate), 2 = FullDisruption "
    "(zero evictions).", ("zone",))


class TokenBucket:
    """flowcontrol.NewTokenBucketRateLimiter analog on an injected
    timestamp (the controller passes its Clock's now()): `rate` tokens
    per second up to `burst`. `refund()` returns a token a refused
    eviction consumed (budget-exhausted pods must not burn the zone's
    pace)."""

    def __init__(self, rate: float, burst: float = 1.0):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last: Optional[float] = None

    def set_rate(self, rate: float) -> None:
        self.rate = float(rate)

    def _advance(self, now: float) -> None:
        if self._last is None:
            self._last = now
        if now > self._last:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now

    def try_take(self, now: float) -> bool:
        self._advance(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def refund(self) -> None:
        self._tokens = min(self.burst, self._tokens + 1.0)

    def tokens(self, now: float) -> float:
        self._advance(now)
        return self._tokens


def _zone_of(node: Node) -> str:
    """Human-readable failure-zone key for pacing/metrics ("region/zone",
    or whichever half is labeled; "" = unzoned). Deliberately NOT
    get_zone_key's \\x00-joined form — these names surface in /metrics
    labels and /debug/sched."""
    region = node.labels.get(LABEL_ZONE_REGION, "")
    zone = node.labels.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if region and zone:
        return f"{region}/{zone}"
    return region or zone


def _ready_status(node: Node) -> str:
    for c in node.conditions:
        if c.type == "Ready":
            return c.status
    return "True"   # no condition reported = treated schedulable


def _wanted_taints(node: Node) -> tuple[Taint, ...]:
    status = _ready_status(node)
    if status == "False":
        return (Taint(key=TAINT_NOT_READY, effect=NO_SCHEDULE),
                Taint(key=TAINT_NOT_READY, effect=NO_EXECUTE))
    if status == "Unknown":
        return (Taint(key=TAINT_UNREACHABLE, effect=NO_SCHEDULE),
                Taint(key=TAINT_UNREACHABLE, effect=NO_EXECUTE))
    return ()


class NodeLifecycleController:
    # a node whose lease heartbeat is this stale reads Ready=Unknown
    # (reference: node-monitor-grace-period, 40s default); kept as a class
    # attribute for back-compat with callers that override it
    NODE_MONITOR_GRACE = 40.0

    def __init__(self, store: Store, clock: Optional[Clock] = None,
                 eviction_rate: float = 0.1,
                 secondary_eviction_rate: float = 0.01,
                 eviction_burst: float = 1.0,
                 unhealthy_zone_threshold: float = 0.55,
                 node_monitor_grace: Optional[float] = None):
        self.store = store
        self.clock = clock or RealClock()
        self.eviction_rate = float(eviction_rate)
        self.secondary_eviction_rate = float(secondary_eviction_rate)
        self.eviction_burst = float(eviction_burst)
        self.unhealthy_zone_threshold = float(unhealthy_zone_threshold)
        self.node_monitor_grace = (self.NODE_MONITOR_GRACE
                                   if node_monitor_grace is None
                                   else float(node_monitor_grace))
        self.recorder = EventRecorder(store, component="controllermanager")
        self.informers = InformerFactory(store)
        self._dirty_nodes: set[str] = set()
        # node -> NoExecute taint keys -> time first observed (for bounded
        # tolerationSeconds eviction)
        self._noexec_since: dict[str, dict[str, float]] = {}
        # zone-paced eviction plane: per-zone FIFO of (pod_key, node_name)
        # due for NoExecute eviction, per-zone token buckets, and the
        # latest zone grades (the /debug/sched section's content)
        self._evict_q: dict[str, deque] = {}
        self._queued: set[str] = set()
        self._pacers: dict[str, TokenBucket] = {}
        self._zone_state: dict[str, str] = {}
        self._evicted_by_zone: dict[str, int] = {}
        nodes = self.informers.informer(NODES)
        nodes.add_event_handler(
            on_add=lambda n: self._dirty_nodes.add(n.name),
            on_update=lambda o, n: self._dirty_nodes.add(n.name),
            on_delete=lambda n: (self._dirty_nodes.discard(n.name),
                                 self._noexec_since.pop(n.name, None)))
        pods = self.informers.informer(PODS)
        pods.add_event_handler(
            on_add=lambda p: p.node_name and self._dirty_nodes.add(p.node_name),
            on_update=lambda o, n: n.node_name
            and self._dirty_nodes.add(n.node_name),
            on_delete=lambda p: None)
        self._register_debug()

    def _register_debug(self) -> None:
        """Publish zone grades + pacer tokens + queue depths as a
        /debug/sched section (weakref-held: a dropped controller's
        section disappears instead of pinning the object graph)."""
        import weakref
        ref = weakref.ref(self)

        def snap():
            c = ref()
            return None if c is None else c.debug_state()
        obs.register_debug("nodelifecycle", snap)

    def debug_state(self) -> dict:
        now = self.clock.now()
        zones = {}
        for zone in set(self._zone_state) | set(self._evict_q) \
                | set(self._pacers):
            pacer = self._pacers.get(zone)
            zones[zone] = {
                "state": self._zone_state.get(zone, STATE_NORMAL),
                "rate": pacer.rate if pacer is not None else None,
                "tokens": (round(pacer.tokens(now), 3)
                           if pacer is not None else None),
                "queued": len(self._evict_q.get(zone, ())),
                "evicted": self._evicted_by_zone.get(zone, 0),
            }
        return {"zones": zones,
                "eviction_rate": self.eviction_rate,
                "secondary_eviction_rate": self.secondary_eviction_rate}

    def sync(self) -> None:
        self.informers.sync_all()
        for n in self.informers.informer(NODES).list():
            self._dirty_nodes.add(n.name)
        self.reconcile_dirty()

    def monitor_node_health(self) -> None:
        """monitorNodeHealth analog: grade nodes whose kubelet heartbeat
        (node Lease renewal) has gone silent past the grace period as
        Ready=Unknown; the condition->taint pass then isolates them. The
        kubelet's own heartbeat restores Ready=True on recovery."""
        from kubernetes_tpu_torch.store.store import LEASES
        from kubernetes_tpu_torch.api.types import NodeCondition
        now = self.clock.now()
        leases = {l.holder: l for l in self.store.list(LEASES)[0]
                  if l.name.startswith("node-")}
        nodes, _rv = self.store.list(NODES)
        for node in nodes:
            lease = leases.get(node.name)
            if lease is None or lease.name != node_lease_key(node.name):
                continue   # never heartbeated: static fixture node
            status = _ready_status(node)
            if now - lease.renew_time <= self.node_monitor_grace:
                continue
            if status == "Unknown":
                continue

            def grade(cur):
                conds = [c for c in cur.conditions if c.type != "Ready"]
                conds.append(NodeCondition(type="Ready", status="Unknown"))
                cur.conditions = tuple(conds)
                return cur
            try:
                self.store.guaranteed_update(NODES, node.name, grade)
            except NotFoundError:
                continue
            self.recorder.event(
                "Node", node.name, NORMAL, "NodeNotReady",
                f"Node {node.name} hasn't heartbeated in "
                f"{now - lease.renew_time:.0f}s")
            self._dirty_nodes.add(node.name)
        self._update_zone_states()

    # -- zone disruption grading (handleDisruption analog) -------------------
    def _update_zone_states(self) -> None:
        nodes, _rv = self.store.list(NODES)
        by_zone: dict[str, list[Node]] = {}
        for n in nodes:
            by_zone.setdefault(_zone_of(n), []).append(n)
        states: dict[str, str] = {}
        for zone, members in by_zone.items():
            not_ready = sum(1 for n in members
                            if _ready_status(n) != "True")
            if members and not_ready == len(members):
                state = STATE_FULL
            elif len(members) > 0 and \
                    not_ready / len(members) >= self.unhealthy_zone_threshold:
                state = STATE_PARTIAL
            else:
                state = STATE_NORMAL
            states[zone] = state
            ZONE_STATE.labels(zone or "<unzoned>").set(_STATE_CODE[state])
            pacer = self._pacers.get(zone)
            if pacer is None:
                pacer = self._pacers[zone] = TokenBucket(
                    self.eviction_rate, self.eviction_burst)
            pacer.set_rate(self._rate_for(state))
        # zones whose last node vanished: drop grades (their queued
        # evictions resolve as no-longer-due / orphaned at drain)
        for zone in list(self._zone_state):
            if zone not in states:
                del self._zone_state[zone]
                ZONE_STATE.labels(zone or "<unzoned>").set(0)
        self._zone_state = states

    def _rate_for(self, state: str) -> float:
        if state == STATE_FULL:
            return 0.0
        if state == STATE_PARTIAL:
            return self.secondary_eviction_rate
        return self.eviction_rate

    def pump(self) -> int:
        self.informers.pump_all()
        self.monitor_node_health()
        # bounded-toleration evictions fire on time, not on events
        for name in list(self._noexec_since):
            self._dirty_nodes.add(name)
        n = self.reconcile_dirty()
        self.drain_evictions()
        return n

    def reconcile_dirty(self) -> int:
        n = 0
        while self._dirty_nodes:
            name = self._dirty_nodes.pop()
            try:
                node = self.store.get(NODES, name)
            except NotFoundError:
                self._noexec_since.pop(name, None)
                continue
            self._sync_taints(node)
            n += 1
        return n

    # -- condition -> taint (doNoSchedule/doNoExecuteTaintingPass) ----------
    def _sync_taints(self, node: Node) -> None:
        wanted = _wanted_taints(node)
        kept = tuple(t for t in node.taints if t.key not in _LIFECYCLE_KEYS)
        new = kept + wanted
        if tuple(sorted(new, key=repr)) != tuple(sorted(node.taints, key=repr)):
            def mutate(cur):
                cur.taints = tuple(
                    t for t in cur.taints
                    if t.key not in _LIFECYCLE_KEYS) + wanted
                return cur
            try:
                node = self.store.guaranteed_update(NODES, node.name, mutate)
            except NotFoundError:
                return
            if wanted:
                self.recorder.event(
                    "Node", node.name, NORMAL, "NodeNotReady" if
                    _ready_status(node) == "False" else "NodeNotReachable",
                    f"Node {node.name} tainted {wanted[0].key}")
        self._queue_noexecute_evictions(node)

    # -- NoExecute taint manager: queue side ----------------------------------
    def _queue_noexecute_evictions(self, node: Node) -> None:
        """Track NoExecute taints' first-seen times and enqueue pods past
        their toleration deadline into the node's ZONE eviction queue
        (the paced drain below performs the actual evictions)."""
        noexec = [t for t in node.taints if t.effect == NO_EXECUTE]
        since = self._noexec_since.setdefault(node.name, {})
        now = self.clock.now()
        live = set()
        for t in noexec:
            live.add(t.key)
            since.setdefault(t.key, now)
        for k in list(since):
            if k not in live:
                del since[k]
        if not noexec:
            if not since:
                self._noexec_since.pop(node.name, None)
            return
        zone = _zone_of(node)
        pods, _rv = self.store.list(PODS)
        for pod in pods:
            if pod.node_name != node.name or pod.deleted \
                    or pod.key in self._queued:
                continue
            deadline = self._eviction_deadline(pod, noexec, since)
            if deadline is None or deadline > now:
                continue
            self._evict_q.setdefault(zone, deque()).append(
                (pod.key, node.name))
            self._queued.add(pod.key)

    # -- NoExecute taint manager: paced drain ---------------------------------
    def drain_evictions(self) -> int:
        """Drain each zone's eviction queue through its token bucket, one
        batched `store.evict_many` per zone per tick (round 23): the tick
        takes as many tokens as it has due pods (up to the bucket), lands
        them in ONE store critical section, then settles outcomes —
        "refused" and "skipped" pods refund their tokens and stay queued
        IN ORDER for a later pump (stop_on_refusal preserves the serial
        path's head-of-line pacing: nothing behind a budget-blocked pod
        jumps it). A FullDisruption zone (rate 0) performs zero
        evictions. Returns pods evicted."""
        now = self.clock.now()
        evicted = 0
        for zone, q in self._evict_q.items():
            pacer = self._pacers.get(zone)
            if pacer is None:
                pacer = self._pacers[zone] = TokenBucket(
                    self.eviction_rate, self.eviction_burst)
            if pacer.rate <= 0.0:
                continue
            batch: list = []   # (pod_key, node_name, pod) — tokens taken
            while q:
                pod_key, node_name = q[0]
                pod = self._still_due(pod_key, node_name, now)
                if pod is None:
                    q.popleft()
                    self._queued.discard(pod_key)
                    continue
                if not pacer.try_take(now):
                    break
                batch.append((pod_key, node_name, pod))
                q.popleft()
            if not batch:
                continue
            outcomes = self.store.evict_many(
                [k for k, _n, _p in batch], reason="taint-manager",
                stop_on_refusal=True)
            requeue: list = []
            for pod_key, node_name, pod in batch:
                out = outcomes.get(pod_key, "missing")
                if out == "evicted":
                    self._queued.discard(pod_key)
                    evicted += 1
                    self._evicted_by_zone[zone] = \
                        self._evicted_by_zone.get(zone, 0) + 1
                    self.recorder.pod_event(
                        pod, NORMAL, "TaintManagerEviction",
                        f"Deleting pod {pod_key} from node {node_name}")
                elif out == "missing":
                    # vanished between the due-check and the write: the
                    # serial path consumed the token here too (no refund)
                    self._queued.discard(pod_key)
                else:   # refused (budget) or skipped (behind a refusal)
                    pacer.refund()
                    requeue.append((pod_key, node_name))
            for item in reversed(requeue):
                q.appendleft(item)
        return evicted

    def _still_due(self, pod_key: str, node_name: str,
                   now: float) -> Optional[Pod]:
        """Re-validate a queued eviction at drain time: the taint may have
        cleared, the pod may have moved/vanished, the node may be gone
        (podgc's orphan sweep owns that case). Returns the pod when the
        eviction is still due, else None."""
        try:
            node = self.store.get(NODES, node_name)
        except NotFoundError:
            return None
        noexec = [t for t in node.taints if t.effect == NO_EXECUTE]
        if not noexec:
            return None
        try:
            pod = self.store.get(PODS, pod_key)
        except NotFoundError:
            return None
        if pod.node_name != node_name or pod.deleted:
            return None
        since = self._noexec_since.get(node_name, {})
        deadline = self._eviction_deadline(pod, noexec, since)
        if deadline is not None and deadline <= now:
            return pod
        return None

    @staticmethod
    def _eviction_deadline(pod: Pod, noexec: list[Taint],
                           since: dict[str, float]) -> Optional[float]:
        """Earliest time the pod must go; None = tolerates forever.
        Reference: NoExecuteTaintManager processPodOnNode — a pod must
        tolerate EVERY NoExecute taint; the usable toleration window is
        the minimum tolerationSeconds across them. Pinned semantics
        (tests/test_node_churn.py table): no matching toleration = evict
        immediately; tolerationSeconds absent on every matching
        toleration = never evict; 0 = immediate; negative = clamped to 0
        (immediate), matching the reference's negative-seconds handling."""
        deadline = None
        for t in noexec:
            tols = [tol for tol in pod.tolerations if tol.tolerates(t)]
            if not tols:
                return 0.0          # evict now
            secs = [tol.toleration_seconds for tol in tols
                    if getattr(tol, "toleration_seconds", None) is not None]
            if secs:
                d = since.get(t.key, 0.0) + max(0.0, min(secs))
                deadline = d if deadline is None else min(deadline, d)
        return deadline
