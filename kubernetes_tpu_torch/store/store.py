"""In-memory versioned object store with list/watch — the etcd+apiserver analog.

Copied from the reference (`kubernetes_tpu.store.store`) with the port's
imports; it runs on the pure-Python commit core, so the reference's
native-core demotion has no copy here.

Provides the same distributed-communication contract the reference's control
plane is built on (SURVEY §2.4): a single authoritative store assigning a
monotonically increasing resourceVersion to every write, optimistic
concurrency via resourceVersion preconditions (reference:
staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go GuaranteedUpdate),
and resumable watch streams with a bounded event log (reference:
storage/cacher/cacher.go:217 watch cache; etcd3/watcher.go:99).

Objects are the pruned dataclasses from `kubernetes_tpu_torch.api.types`. The
store snapshots objects ON WRITE (so a caller mutating its argument after
create/update cannot corrupt stored state) and ON READ via get/list — the
stand-in for the reference's serialize/deserialize boundary. Watch events
and create/update RETURN VALUES alias that write snapshot: they are
read-only by convention — consumers that mutate (cache, queue, scheduler)
clone() first, exactly as API clients deserialize their own copy.
"""
from __future__ import annotations

import copy
import os
import threading
import time as _time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as _np

from kubernetes_tpu_torch import chaos, obs

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

# Well-known kinds (the reference's resource names)
PODS = "pods"
NODES = "nodes"
SERVICES = "services"
REPLICASETS = "replicasets"
PDBS = "poddisruptionbudgets"
PVS = "persistentvolumes"
PVCS = "persistentvolumeclaims"
LEASES = "leases"  # leader-election locks (resourcelock analog)
EVENTS = "events"  # user-visible audit records (record.EventRecorder analog)
PRIORITYCLASSES = "priorityclasses"  # scheduling.k8s.io (admission-resolved)
ENDPOINTS = "endpoints"  # service backends (controllers.endpoints)
RESOURCEQUOTAS = "resourcequotas"  # per-namespace caps (admission-enforced)
DEPLOYMENTS = "deployments"  # apps workload tier (controllers.deployment)
JOBS = "jobs"  # batch run-to-completion (controllers.job)
DAEMONSETS = "daemonsets"  # one-pod-per-node (controllers.daemonset)
STATEFULSETS = "statefulsets"  # ordinal identities (controllers.statefulset)
NAMESPACES = "namespaces"  # lifecycle owned by controllers.namespace
HPAS = "horizontalpodautoscalers"  # autoscaling (controllers.hpa)
CLUSTERROLES = "clusterroles"  # rbac.authorization.k8s.io policy objects
CLUSTERROLEBINDINGS = "clusterrolebindings"
PODMETRICS = "podmetrics"  # metrics.k8s.io stand-in (HPA's usage source)
CRONJOBS = "cronjobs"  # batch schedules (controllers.cronjob)
CONFIGMAPS = "configmaps"
SECRETS = "secrets"
SERVICEACCOUNTS = "serviceaccounts"
PODGROUPS = "podgroups"  # co-scheduling gangs (coscheduling.types.PodGroup)

DEFAULT_WATCH_LOG = 8192  # events retained per kind for resumable watches

# watch fan-out robustness counters (reference: the watch cache terminates
# streams that outrun it; apiserver_terminated_watchers_total analog)
WATCH_DROPPED = obs.counter(
    "watch_dropped_total",
    "Watch events dropped instead of buffered unboundedly, by reason: "
    "slow-consumer (per-watcher backlog exceeded the ring bound at "
    "fan-out) or log-window (the shared event log evicted entries the "
    "watcher never copied out). The watcher's next poll raises "
    "ExpiredError and the consumer re-lists (410 Gone).", ("reason",))
COMMIT_WAVES = obs.counter(
    "store_commit_waves_total",
    "Batched bind+event commit waves written through the commit core, by "
    "implementation (native C++ extension vs pure-Python twin).",
    ("impl",))
# µs-scale families (obs.MICRO_BUCKETS): the native commit core lands a
# wave in tens of µs and fan-out lag is sub-ms on an idle box — the
# default ms ladder would crush both into one bucket (the round-12
# per-family bucket-override satellite)
COMMIT_WAVE_SECONDS = obs.histogram(
    "store_commit_wave_seconds",
    "Wall seconds of one commit_wave core call (batched bind + audit "
    "record creates), by implementation.",
    ("impl",), buckets=obs.MICRO_BUCKETS)
WATCH_FANOUT_LAG = obs.histogram(
    "watch_fanout_lag_seconds",
    "Seconds from an event's commit (core log append) to its copy-out by "
    "a watcher — stamped inside BOTH commit cores (native commitcore.cpp "
    "and the PyCommitCore twin) via the fan-out sink.",
    ("impl",), buckets=obs.MICRO_BUCKETS)
WAVE_DEDUP = obs.counter(
    "store_commit_wave_dedup_total",
    "commit_wave calls answered from the wave-token dedupe map: a retried "
    "wave whose first attempt had landed before the ambiguous failure — "
    "the retry returned the recorded result instead of double-landing "
    "binds or double-emitting events.")
# watch-plane subscription classes (round 20): watchers sharing one
# (kind, selector) interest dedupe into a class; each event is
# materialized (and wire-encoded) ONCE per class, classmates after the
# first serve the shared object/bytes from the class cache.
WATCH_CLASSES_GAUGE = obs.gauge(
    "watch_subscription_classes",
    "Live shared subscription classes (distinct (kind, selector) watcher "
    "interests) in the commit core's fan-out plane, by kind.", ("kind",))
WATCH_COPYOUT_SHARED = obs.counter(
    "watch_copyout_shared_total",
    "Watch copy-out slots served from a subscription class's shared cache "
    "(an Event or wire line a classmate already materialized) — the "
    "fan-out work the class plane deduplicated away.")
WATCH_COPYOUT_MAT = obs.counter(
    "watch_copyout_materializations_total",
    "Watch copy-out Event materializations actually performed (once per "
    "event per class in shared mode; once per event per watcher in the "
    "degenerate per-watcher mode).")

#: watcher_lags() debug copy-out sample cap: the /debug/sched fan-out
#: health view walks at most this many live watchers (at 100k watchers a
#: full walk is itself a fan-out storm)
WATCHER_LAG_SAMPLE = 1000

EVICTIONS = obs.counter(
    "evictions_total",
    "Pods evicted through the PDB-guarded eviction verb, by reason "
    "(taint-manager = NoExecute taint eviction via the zone-paced "
    "queue, drain = kubectl drain, api = the HTTP subresource). A "
    "refused eviction (budget exhausted -> 429) does NOT count.",
    ("reason",))

#: retained dedupe tokens (one per wave; the retry window is one wave, so
#: a small multiple of any realistic pipeline depth is plenty)
WAVE_TOKEN_CAP = 1024

#: retained audit EventRecords (the reference apiserver expires events
#: after a TTL — default 1h — for exactly this reason: a serving process
#: emits one Scheduled record per pod forever, and an unbounded events
#: bucket is a heap leak whose growing gen2 GC passes land as multi-ms
#: pauses inside scheduling windows). Oldest-first eviction past the cap,
#: with a DELETED watch event so consumers stay consistent.
DEFAULT_EVENTS_CAP = 1 << 16

EVENTS_TRIMMED = obs.counter(
    "store_events_trimmed_total",
    "Audit EventRecords evicted oldest-first past the store's retention "
    "cap (the reference's event TTL analog; each eviction emits DELETED).")

FENCED_WRITES = obs.counter(
    "store_fenced_writes_total",
    "Writes rejected whole because they carried an expired or superseded "
    "partition-lease fencing token, by verb (commit_wave / bind / "
    "advance). A fenced write lands NOTHING: no binds, no events, no rv.",
    ("verb",))
BIND_CAS_CONFLICTS = obs.counter(
    "store_bind_conflicts_total",
    "Bind writes refused by the rv-CAS already-bound check (the pod was "
    "bound by another writer between decision and commit). The pod's "
    "existing binding is never overwritten — this counter plus the "
    "fleet's zero-double-bind tripwire are the two sides of the same "
    "invariant.")
# churn-plane batching proof (round 23): objects per call >> 1 means a
# churn tick's mutations take O(batches) store-lock acquisitions, not
# O(pods) — the soak asserts it on these two families.
BATCH_MUTATIONS = obs.counter(
    "store_batch_mutations_total",
    "Objects landed through the batched mutation verbs (update_many / "
    "evict_many / delete_many), by verb.", ("verb",))
BATCH_MUTATION_CALLS = obs.counter(
    "store_batch_mutation_calls_total",
    "Batched mutation verb invocations — one store-lock acquisition and "
    "one commit-core call each — by verb.", ("verb",))


class ConflictError(Exception):
    """resourceVersion precondition failed (optimistic-concurrency loss)."""


class FencedError(ConflictError):
    """A write carried an expired or superseded partition-lease fencing
    token (round 18, active-active fleet): the claim it wrote under has a
    newer holder, so the WHOLE write is rejected atomically — no partial
    wave lands, no events emit, no rv burns. Subclasses ConflictError so
    every existing never-auto-retry path treats it as a definitive answer;
    the HTTP surface maps it to 409 reason=Fenced."""

    def __init__(self, message: str, scope: str = ""):
        super().__init__(message)
        self.scope = scope


class DisruptionBudgetError(Exception):
    """Eviction refused: a matching PodDisruptionBudget has no disruptions
    left (the eviction subresource's 429 TooManyRequests — reference
    pkg/registry/core/pod/rest/eviction.go). `retry_after` is the
    suggested backoff seconds the server sends as Retry-After."""

    def __init__(self, message: str, retry_after: float = 10.0):
        super().__init__(message)
        self.retry_after = retry_after


class BackpressureError(Exception):
    """Pod create shed by the serving admission gate (activeQ depth or
    in-flight launch windows over the watermark) — the apiserver's
    429 TooManyRequests on CREATE, with Retry-After carrying the server's
    suggested backoff. Distinct from DisruptionBudgetError (the eviction
    subresource's 429): a shed create definitively did NOT land, so
    clients retry it safely after the suggested backoff; a refused
    eviction must never auto-retry."""

    def __init__(self, message: str, retry_after: float = 0.25,
                 accepted: int = 0):
        super().__init__(message)
        self.retry_after = retry_after
        # batched-create partial acceptance (create_many): the first
        # `accepted` objects of the batch LANDED; only the tail was shed.
        # Always 0 on the single-create path.
        self.accepted = accepted


class NotFoundError(Exception):
    pass


class AlreadyExistsError(Exception):
    pass


class ExpiredError(Exception):
    """Watch asked to resume from a resourceVersion older than the log window
    (the reference returns 410 Gone → client re-lists)."""


@dataclass(frozen=True)
class Event:
    type: str            # ADDED | MODIFIED | DELETED
    kind: str
    obj: Any             # snapshot of the object at this version
    resource_version: int


class Watch:
    """One watch stream: a bounded cursor into the commit core's event log
    plus a stop handle. Copy-out happens on the CONSUMER's thread (the
    core materializes Event objects at poll, off the committing thread),
    and a consumer that falls behind the ring bound is dropped-with-resync:
    next()/try_next()/drain() raise ExpiredError and the caller re-lists,
    exactly like the reference reflector on 410 Gone."""

    def __init__(self, store: "Store", kind: str, wid: int,
                 selector: Optional[str] = None):
        self._store = store
        self.kind = kind
        self.selector = selector
        self._wid = wid
        self._stopped = False

    def _pre_poll(self) -> None:
        if self._store._fanout_deferred:
            # a chaos-deferred wave fan-out: the consumer's poll is the
            # seam's delivery point — events are delayed, never lost
            self._store.deliver_deferred()
        if chaos.take("watch.drop"):
            # injected slow-consumer drop: identical consumer contract to
            # the real overflow path (ExpiredError -> re-list)
            WATCH_DROPPED.labels("injected").inc()
            raise ExpiredError(
                f"{self.kind}: chaos-injected watch drop (resync required)")

    def _poll(self, timeout: Optional[float], limit: int) -> list[Event]:
        self._pre_poll()
        try:
            return self._store._core.poll(self._wid, timeout, limit)
        except ExpiredError as e:
            # fan-out-time drops were already counted (slow-consumer, by
            # event) in flush; an eviction the poll itself detects is the
            # log-window case (contract message shared with the native core)
            if "evicted" in str(e):
                WATCH_DROPPED.labels("log-window").inc()
            raise

    def _poll_bytes(self, timeout: Optional[float],
                    limit: int) -> list[bytes]:
        """Byte-ring poll: pre-encoded wire lines from the subscription
        class's serialize-once cache (same chaos seams and drop contract
        as the Event path)."""
        self._pre_poll()
        try:
            return self._store._core.poll_bytes(self._wid, timeout, limit)
        except ExpiredError as e:
            if "evicted" in str(e):
                WATCH_DROPPED.labels("log-window").inc()
            raise

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Next event, or None on timeout / stream close. Raises
        ExpiredError when this watcher was dropped (slow consumer)."""
        evs = self._poll(timeout, 1)
        return evs[0] if evs else None

    def try_next(self) -> Optional[Event]:
        """Non-blocking next event, or None when nothing is pending."""
        evs = self._poll(0, 1)
        return evs[0] if evs else None

    def drain(self) -> list[Event]:
        return self._poll(0, 1 << 30)

    def next_bytes(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next event as a pre-encoded wire line (requires a wire encoder
        on the store; the apiserver installs one). Shares the watcher
        cursor with next()/drain() — a stream consumes ONE representation."""
        lines = self._poll_bytes(timeout, 1)
        return lines[0] if lines else None

    def drain_bytes(self) -> list[bytes]:
        return self._poll_bytes(0, 1 << 30)

    def stop(self) -> None:
        self._stopped = True
        self._store._watch_ids.pop(self._wid, None)
        self._store._core.detach(self._wid)  # wakes any blocked next()


def nominated_node_mutator(node_name: str) -> Callable[[Any], Any]:
    """Mutate closure for SetNominatedNodeName — shared by the embedded
    store and RemoteStore so both transports write identical objects."""
    def mutate(pod):
        pod.nominated_node_name = node_name
        return pod
    return mutate


def pod_condition_mutator(condition) -> Callable[[Any], Any]:
    """Mutate closure for podutil.UpdatePodCondition (factory.go:715):
    replace the same-type condition if changed, append if absent, None for
    a no-op (with allow_skip the write is skipped entirely). Shared by the
    embedded store and RemoteStore."""
    def mutate(pod):
        conds = list(pod.conditions)
        for i, c in enumerate(conds):
            if c.type == condition.type:
                if c == condition:
                    return None   # unchanged -> no write
                conds[i] = condition
                break
        else:
            conds.append(condition)
        pod.conditions = tuple(conds)
        return pod
    return mutate


def _key_of(obj: Any) -> str:
    return obj.key


def _clone(obj: Any) -> Any:
    """Snapshot an object crossing the store boundary. Objects with a fast
    clone() use it; anything else falls back to deepcopy."""
    c = getattr(obj, "clone", None)
    return c() if c is not None else copy.deepcopy(obj)


class Store:
    """Threadsafe versioned KV with per-kind watch fan-out.

    The versioned write log and watch delivery live in the COMMIT CORE
    (store/commit_core.PyCommitCore; the reference's native core has no
    copy here): every write verb is
    one core call assigning resourceVersions and appending watch-log
    entries, and the burst path's `commit_wave`/`fanout_wave` pair lands a
    whole wave's binds + audit events as ONE core call each.

    `watch_queue_size` bounds each watcher's backlog (defaults to the log
    size — the shared ring is the buffer); a consumer that falls further
    behind is dropped-with-resync instead of buffering unboundedly."""

    def __init__(self, watch_log_size: int = DEFAULT_WATCH_LOG,
                 debug_integrity: Optional[bool] = None,
                 watch_queue_size: Optional[int] = None,
                 events_cap: Optional[int] = DEFAULT_EVENTS_CAP,
                 shared_watch_classes: bool = True):
        from kubernetes_tpu_torch.store.commit_core import make_commit_core
        self._lock = threading.RLock()
        self._objs: dict[str, dict[str, Any]] = {}
        self._queue_size = (watch_queue_size if watch_queue_size is not None
                            else watch_log_size)
        self._core = make_commit_core(
            watch_log_size, self._queue_size,
            Event, ExpiredError, AlreadyExistsError)
        self.core_impl = "twin"
        # shared subscription classes (round 20): watchers with the same
        # (kind, selector) interest share one materialize-once event cache
        # and one serialize-once byte ring. False is the degenerate
        # class-per-watcher mode — the EXACT pre-class fan-out path, kept
        # as the differential referee's old shape.
        self.shared_watch_classes = bool(shared_watch_classes)
        if not self.shared_watch_classes:
            self._core.set_shared_classes(False)
        # last cumulative core fan-out stats synced into the obs counters
        # (the core counts monotonically; obs counters get the deltas)
        self._fanout_obs_synced = {"materializations": 0, "shared_hits": 0}
        self._gauge_kinds: set = set()
        # watcher_lag_summary()'s TTL cache ({"at": t, "summary": {...}});
        # the all-watchers backlog walk is O(watchers) core calls
        self._lag_summary_cache: Optional[dict] = None
        self._log_size = watch_log_size
        # audit-record retention (the event-TTL analog); None/0 = unbounded
        self._events_cap = events_cap
        # wave-token dedupe map (idempotent commit retry): token -> the
        # missing-keys result of the wave that landed under it. A retried
        # commit_wave after an ambiguous failure replays the RESULT, not
        # the write.
        self._wave_tokens: "OrderedDict[str, list]" = OrderedDict()
        # batched-mutation dedupe (round 23): update_many / evict_many
        # replays answer the recorded RESULT, exactly the wave contract
        self._mutation_tokens: "OrderedDict[str, Any]" = OrderedDict()
        # chaos store.fanout seam: a deferred wave delivery is flushed by
        # the next fan-out call or the next consumer poll (never lost)
        self._fanout_deferred = False
        # serving admission gate (serve.backpressure.BackpressureGate):
        # when attached, pod creates are checked against the activeQ-depth
        # / in-flight-window watermarks and shed with BackpressureError
        # (HTTP: 429 + Retry-After) — and accepted pod creates stamp the
        # lifecycle ledger's admission slot, opening the watch-to-enqueue
        # phase. None (the default) admits everything unstamped.
        self.admission_gate = None
        # live watcher ids (wid -> (kind, selector)) for the /debug/sched
        # cursor-lag view AND demotion adoption (class membership rides
        # the adoption); pruned on Watch.stop()
        self._watch_ids: dict[int, tuple] = {}
        # fan-out sink: the commit core calls this at poll copy-out with
        # (kind, events, lags) — feeds the fan-out-lag histogram and the
        # pod ledger's copy-out stamp
        self._core.set_fanout_sink(self._make_fanout_sink())
        # alias tripwire: watch events and create/update return values alias
        # the write snapshot, read-only BY CONVENTION. In debug mode every
        # write records a fingerprint of the stored object; the next write
        # to the same key (and check_integrity()) verifies it, so a consumer
        # that mutated an aliased object in place fails LOUDLY instead of
        # silently corrupting every other consumer. Enabled explicitly or
        # via KTPU_STORE_INTEGRITY=1 (the test suite turns it on).
        if debug_integrity is None:
            debug_integrity = bool(os.environ.get("KTPU_STORE_INTEGRITY"))
        self._integrity: Optional[dict] = {} if debug_integrity else None

    # -- observability -------------------------------------------------------
    def _make_fanout_sink(self):
        """Build the copy-out sink. Deliberately closes over nothing of
        `self` (the core holds the sink; a closure over the store would
        make a reference cycle through the core)."""
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        lag_child = WATCH_FANOUT_LAG.labels(self.core_impl)

        def sink(kind, events, lags):
            # one vectorized fold per poll batch — a per-event observe()
            # loop here would put O(events) Python back on the consumer
            # threads the GIL-released poll just freed
            lag_child.observe_batch(lags)
            if kind == PODS and LEDGER.has_awaiting():
                now = _time.perf_counter()
                for ev in events:
                    if ev.type == MODIFIED and ev.obj.node_name:
                        LEDGER.copyout(ev.obj.key, now)
        return sink

    def watcher_lags(self, sample: int = WATCHER_LAG_SAMPLE) -> list[dict]:
        """Per-watcher published-but-unconsumed cursor backlog (the
        /debug/sched fan-out health view). SAMPLED: at 100k watchers a
        full walk is itself a fan-out storm, so the debug copy-out stops
        at `sample` watchers (class-level health lives in
        watch_plane_state(), which is O(classes))."""
        out = []
        with self._lock:
            ids = list(self._watch_ids.items())
        for wid, (kind, _sel) in ids[:sample]:
            try:
                out.append({"wid": wid, "kind": kind,
                            "backlog": int(self._core.backlog(wid))})
            except Exception:
                continue
        return out

    def watcher_lag_summary(self, ttl: float = 2.0) -> dict:
        """Backlog summary over ALL watchers in one pass — count, max,
        p99, total — the true-tail complement to the sampled
        watcher_lags() list (which stops at 1k entries and, at 100k
        watchers, would report the FIRST thousand's health as the
        plane's). One `backlog(wid)` call per watcher; results are
        cached for `ttl` seconds because the soak scraper reads this at
        2 Hz via a callback gauge and 100k core calls per sample would
        be a self-inflicted fan-out storm (ttl=0 forces a fresh walk)."""
        now = _time.perf_counter()
        with self._lock:
            cached = self._lag_summary_cache
            if cached is not None and ttl > 0 \
                    and now - cached["at"] < ttl:
                return dict(cached["summary"])
            ids = list(self._watch_ids)
        backlogs = []
        for wid in ids:
            try:
                backlogs.append(int(self._core.backlog(wid)))
            except Exception:
                continue
        if backlogs:
            arr = _np.asarray(backlogs, dtype=_np.int64)
            summary = {"count": int(arr.size),
                       "max": int(arr.max()),
                       "p99": int(_np.percentile(arr, 99)),
                       "total": int(arr.sum())}
        else:
            summary = {"count": 0, "max": 0, "p99": 0, "total": 0}
        with self._lock:
            self._lag_summary_cache = {"at": now, "summary": summary}
        return dict(summary)

    def set_wire_encoder(self, fn) -> None:
        """Install the byte ring's wire encoder ((etype, obj, rv) ->
        bytes; the apiserver passes its serde line encoder)."""
        self._core.set_wire_encoder(fn)

    def watch_plane_state(self) -> dict:
        """Subscription-class fan-out snapshot (classes, members, ring
        occupancy, bytes served) from the commit core, and the obs
        delta-sync point: the core counts materializations/shared hits
        monotonically; this folds the deltas into the process counters
        and refreshes the per-kind class gauge."""
        stats = self._core.fanout_stats()
        with self._lock:
            synced = self._fanout_obs_synced
            d_mat = stats["materializations"] - synced["materializations"]
            d_sh = stats["shared_hits"] - synced["shared_hits"]
            synced["materializations"] = stats["materializations"]
            synced["shared_hits"] = stats["shared_hits"]
        if d_mat > 0:
            WATCH_COPYOUT_MAT.inc(d_mat)
        if d_sh > 0:
            WATCH_COPYOUT_SHARED.inc(d_sh)
        per_kind: dict[str, int] = {}
        for row in stats["classes"]:
            per_kind[row["kind"]] = per_kind.get(row["kind"], 0) + 1
        for kind, n in per_kind.items():
            WATCH_CLASSES_GAUGE.labels(kind).set(n)
        for kind in self._gauge_kinds - set(per_kind):
            WATCH_CLASSES_GAUGE.labels(kind).set(0)   # all classes gone
        self._gauge_kinds = set(per_kind)
        return stats

    def debug_state(self) -> dict:
        with self._lock:
            n_objs = {k: len(v) for k, v in self._objs.items()}
            rv = self._core.rv()
            n_watchers = len(self._watch_ids)
        return {"resource_version": rv,
                "commit_core": self.core_impl,
                "objects": n_objs,
                "watchers_total": n_watchers,
                "watchers": self.watcher_lags(),
                "watcher_lag_summary": self.watcher_lag_summary(),
                "watch_plane": self.watch_plane_state()}

    # -- alias tripwire ------------------------------------------------------
    @staticmethod
    def _fingerprint(obj: Any) -> int:
        return hash(repr(obj))

    def _record_entry(self, kind: str, key: str, obj: Any) -> None:
        if self._integrity is not None:
            self._integrity[(kind, key)] = self._fingerprint(obj)

    def _check_entry(self, kind: str, key: str, obj: Any) -> None:
        if self._integrity is None:
            return
        fp = self._integrity.get((kind, key))
        if fp is not None and fp != self._fingerprint(obj):
            raise RuntimeError(
                f"store integrity violation: {kind}/{key} was mutated in "
                "place through an aliased reference (watch event or "
                "create/update return value) — consumers must clone() "
                "before mutating")

    def check_integrity(self) -> None:
        """Verify every live bucket entry still matches the fingerprint
        recorded at its write (debug mode only; no-op otherwise)."""
        with self._lock:
            if self._integrity is None:
                return
            for kind, bucket in self._objs.items():
                for key, obj in bucket.items():
                    self._check_entry(kind, key, obj)

    # -- reads --------------------------------------------------------------
    def get(self, kind: str, key: str) -> Any:
        with self._lock:
            obj = self._objs.get(kind, {}).get(key)
            if obj is None:
                raise NotFoundError(f"{kind}/{key}")
            return _clone(obj)

    def list(self, kind: str) -> tuple[list[Any], int]:
        """Objects plus the store resourceVersion the list is consistent at."""
        with self._lock:
            objs = [_clone(o) for o in self._objs.get(kind, {}).values()]
            return objs, self._core.rv()

    def resource_version(self) -> int:
        with self._lock:
            return self._core.rv()

    def contains(self, kind: str, key: str) -> bool:
        """Existence probe without the clone a get() pays — the burst
        commit's stale-host check runs this once per unique host per
        wave."""
        with self._lock:
            return key in self._objs.get(kind, {})

    def missing_keys(self, kind: str, keys: list) -> list:
        """The keys of `keys` this store does not hold, in their order, under
        one lock acquisition: the burst's stale-host checks ask it once for
        a launch's or a wave's hosts (the port's; the reference probes
        `contains` a host)."""
        with self._lock:
            bucket = self._objs.get(kind, {})
            return [k for k in keys if k not in bucket]

    def count(self, kind: str) -> int:
        """O(1) object count — the burst launch's stale scan compares it
        against the enumeration length to catch a node death whose rows
        received no decisions (the removal still shifts rotation and
        tie-breaking, so the launch must be refused either way)."""
        with self._lock:
            return len(self._objs.get(kind, {}))

    # -- fencing tokens (round 18, active-active fleet) ----------------------
    # A scope names one partition lease; tokens are the lease's
    # resourceVersion at acquisition (strictly greater for every later
    # claimant). Validation/advance live in the commit core.
    def _fence_ok_locked(self, scope: str, token: int) -> bool:
        return bool(self._core.fence_ok(scope, int(token)))

    def _fence_advance_locked(self, scope: str, token: int) -> bool:
        return bool(self._core.advance_fence(scope, int(token)))

    @staticmethod
    def _fence_pairs(fence) -> list:
        """Normalize a fence argument: one (scope, token) pair or a list
        of pairs (a wave may span several claimed shards)."""
        if not fence:
            return []
        if isinstance(fence, tuple) and len(fence) == 2 \
                and isinstance(fence[0], str):
            return [fence]
        return list(fence)

    def _check_fences_locked(self, fence, verb: str) -> None:
        """Validate EVERY fence pair read-only first, then advance — so a
        rejection is atomic (no scope advanced, nothing written) and a
        mixed wave can never partially move the table. Raises FencedError
        naming the superseded scope."""
        pairs = self._fence_pairs(fence)
        for scope, token in pairs:
            if not self._fence_ok_locked(scope, token):
                FENCED_WRITES.labels(verb).inc()
                raise FencedError(
                    f"{verb}: fencing token {token} for {scope!r} is "
                    f"superseded (current "
                    f"{self.fence_token_locked(scope)})", scope=scope)
        for scope, token in pairs:
            self._fence_advance_locked(scope, token)

    def fence_token_locked(self, scope: str) -> int:
        return int(self._core.fence_token(scope))

    def advance_fence(self, scope: str, token: int) -> bool:
        """The claim protocol's handoff verb: a new partition-lease holder
        advances the fence BEFORE replaying its partition, so any late
        write from the superseded holder is rejected even if the usurper
        has not written yet. Returns False (no state change) when `token`
        is itself already superseded — the caller lost a newer race and
        must drop its claim."""
        with self._lock:
            ok = self._fence_advance_locked(scope, int(token))
        if not ok:
            FENCED_WRITES.labels("advance").inc()
        return ok

    def fence_token(self, scope: str) -> int:
        with self._lock:
            return self.fence_token_locked(scope)

    def fence_table(self) -> dict:
        """scope -> token snapshot (the fleet replay harness re-applies it
        at the recorded points; /debug material otherwise)."""
        with self._lock:
            return dict(self._core.fence_table())

    # -- writes -------------------------------------------------------------
    # Every verb's per-object body lives in the commit core (shared by the
    # serial verbs and the burst wave): one snapshot serves the bucket, the
    # event log, and the return value — the store NEVER mutates a stored
    # object in place, and consumers receive store objects read-only;
    # anything that mutates must clone() first, which every caller (cache,
    # queue, scheduler) already does.
    def _flush(self) -> None:
        """Publish pending log entries to watchers, booking drops."""
        dropped = self._core.flush()
        if dropped:
            WATCH_DROPPED.labels("slow-consumer").inc(dropped)

    def _trim_events_locked(self) -> None:
        """Evict the oldest audit records past the retention cap (event
        TTL analog; caller holds the lock and flushes after). The evicted
        object moves into the DELETED log entry — it left the bucket, so
        no clone is needed (the usual read-only aliasing convention)."""
        cap = self._events_cap
        if not cap:
            return
        bucket = self._objs.get(EVENTS)
        if bucket is None or len(bucket) <= cap:
            return
        core = self._core
        trimmed = 0
        while len(bucket) > cap:
            key = next(iter(bucket))
            obj = bucket.pop(key)
            if self._integrity is not None:
                self._integrity.pop((EVENTS, key), None)
            core.append(DELETED, EVENTS, obj, core.next_rv())
            trimmed += 1
        EVENTS_TRIMMED.inc(trimmed)

    def create(self, kind: str, obj: Any, move: bool = False) -> Any:
        """`move=True` transfers ownership: the caller promises never to
        touch `obj` again, skipping the write snapshot (the event recorder's
        fire-and-forget records use this)."""
        gate = self.admission_gate
        if gate is not None and kind == PODS:
            # serving backpressure: shed BEFORE anything is written (a
            # 429'd create definitively did not land), and evict any
            # ledger record the shed attempt would otherwise poison
            gate.admit(obj)
        with self._lock:
            try:
                stored = self._core.create_batch(
                    self._objs.setdefault(kind, {}), kind, [obj], move)[0]
                if kind == EVENTS:
                    self._trim_events_locked()
            finally:
                self._flush()
            self._record_entry(kind, _key_of(stored), stored)
        if gate is not None and kind == PODS:
            # admission accepted: open the pod's lifecycle record at the
            # accepted create, BEFORE the informer delivers it to
            # queue.add (the watch-to-enqueue phase's left boundary)
            from kubernetes_tpu_torch.obs.ledger import LEDGER
            LEDGER.stamp_admission(stored.key)
        return stored

    def update(self, kind: str, obj: Any, expect_rv: Optional[int] = None) -> Any:
        with self._lock:
            bucket = self._objs.setdefault(kind, {})
            key = _key_of(obj)
            current = bucket.get(key)
            if current is None:
                raise NotFoundError(f"{kind}/{key}")
            if expect_rv is not None and current.resource_version != expect_rv:
                raise ConflictError(
                    f"{kind}/{key}: rv {current.resource_version} != expected {expect_rv}")
            self._check_entry(kind, key, current)
            stored = _clone(obj)
            rv = self._core.next_rv()
            stored.resource_version = rv
            bucket[key] = stored
            self._record_entry(kind, key, stored)
            self._core.append(MODIFIED, kind, stored, rv)  # see create()
            self._flush()
            return stored

    def guaranteed_update(self, kind: str, key: str,
                          mutate: Callable[[Any], Any],
                          allow_skip: bool = False) -> Any:
        """Read-modify-write retry loop (reference: GuaranteedUpdate).
        With allow_skip, a mutate returning None means "no change" and the
        current object is returned without a write."""
        while True:
            current = self.get(kind, key)
            rv = current.resource_version
            updated = mutate(current)
            if allow_skip and updated is None:
                return current
            try:
                return self.update(kind, updated, expect_rv=rv)
            except ConflictError:
                continue

    # -- batched mutation bodies (round 23; caller holds the lock) -----------
    def _update_batch_locked(self, bucket: dict, kind: str,
                             objs: list) -> list:
        """One core call lands a whole batch of replacement objects (the
        per-object body identical to update())."""
        stored = self._core.update_batch(bucket, kind, objs)
        if self._integrity is not None:
            for o in stored:
                self._record_entry(kind, _key_of(o), o)
        return stored

    def _delete_batch_locked(self, bucket: dict, kind: str,
                             keys: list) -> list:
        """One core call pops a whole batch of keys (delete() semantics
        per key; missing keys skip)."""
        return self._core.delete_batch(bucket, kind, keys)

    def _mutation_token_hit(self, token: Optional[str]):
        if token is None:
            return None
        hit = self._mutation_tokens.get(token)
        if hit is not None:
            WAVE_DEDUP.inc()
        return hit

    def _mutation_token_record(self, token: Optional[str], result) -> None:
        if token is None:
            return
        self._mutation_tokens[token] = result
        while len(self._mutation_tokens) > WAVE_TOKEN_CAP:
            self._mutation_tokens.popitem(last=False)

    def update_many(self, kind: str, updates: list, fence=None,
                    token: Optional[str] = None,
                    conflicts: Optional[list] = None,
                    missing: Optional[list] = None) -> list:
        """Batched update under ONE lock and ONE commit-core call (the
        churn plane's mutation verb, round 23 — the round-17 ingest
        batching mirrored onto the write path). `updates` is a list of
        replacement objects or (obj, expect_rv) pairs; a bare object
        updates unconditionally (expect_rv None), exactly like update().

        Per-item semantics are update()'s, reported per item instead of
        raised: a vanished key lands in `missing`, an rv-CAS loser in
        `conflicts` (both optional out-lists; refused items are skipped,
        never partially applied). Returns the stored snapshots of the
        items that landed, in batch order.

        `fence` carries the writer's partition-lease token(s) and is
        validated BEFORE any write — a superseded token rejects the whole
        batch atomically (FencedError), the commit_wave contract. `token`
        is the caller's idempotency key: a batch that already landed under
        it returns its recorded result without touching the core."""
        pairs = [(u[0], u[1]) if isinstance(u, tuple) else (u, None)
                 for u in updates]
        with self._lock:
            hit = self._mutation_token_hit(token)
            if hit is not None:
                stored, confl, miss = hit
                if conflicts is not None:
                    conflicts.extend(confl)
                if missing is not None:
                    missing.extend(miss)
                return list(stored)
            # fence validation FIRST — before the chaos seam and every
            # core write (the commit_wave ordering contract)
            if fence is not None:
                self._check_fences_locked(fence, "update_many")
            chaos.check("store.update_many")
            bucket = self._objs.setdefault(kind, {})
            confl: list = []
            miss: list = []
            live: list = []
            for obj, expect_rv in pairs:
                key = _key_of(obj)
                current = bucket.get(key)
                if current is None:
                    miss.append(key)
                    continue
                if expect_rv is not None \
                        and current.resource_version != expect_rv:
                    confl.append(key)
                    continue
                self._check_entry(kind, key, current)
                live.append(obj)
            stored = self._update_batch_locked(bucket, kind, live) \
                if live else []
            self._flush()
            self._mutation_token_record(
                token, (list(stored), list(confl), list(miss)))
        BATCH_MUTATION_CALLS.labels("update_many").inc()
        if stored:
            BATCH_MUTATIONS.labels("update_many").inc(len(stored))
        if conflicts is not None:
            conflicts.extend(confl)
        if missing is not None:
            missing.extend(miss)
        return stored

    def delete(self, kind: str, key: str) -> Any:
        with self._lock:
            bucket = self._objs.get(kind, {})
            obj = bucket.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind}/{key}")
            self._check_entry(kind, key, obj)
            if self._integrity is not None:
                self._integrity.pop((kind, key), None)
            rv = self._core.next_rv()
            self._core.append(DELETED, kind, _clone(obj), rv)
            self._flush()
        if kind == PODS:
            # lifecycle-ledger finalize-on-delete: a pod deleted while
            # still holding an in-flight slot (pending, or bound and
            # awaiting its bind event's copy-out stamp) must not retain
            # it forever — the completion reaper / PodGC would otherwise
            # leak one record per deletion until the capacity bound
            from kubernetes_tpu_torch.obs.ledger import LEDGER
            LEDGER.finalize_delete(key)
        return obj

    def delete_many(self, kind: str, keys: list) -> list:
        """Batched delete under ONE lock and one flush (the completion
        reaper's verb — per-pod deletes put one lock+flush per reaped pod
        on the serving loop's critical path). Missing keys are skipped;
        returns the deleted objects. Per-key semantics otherwise identical
        to delete()."""
        with self._lock:
            bucket = self._objs.get(kind, {})
            present = []
            for key in keys:
                obj = bucket.get(key)
                if obj is None:
                    continue
                self._check_entry(kind, key, obj)
                if self._integrity is not None:
                    self._integrity.pop((kind, key), None)
                present.append(key)
            # ONE core call pops + logs the whole batch (round 23; one
            # log-ring splice instead of one per key on the native core)
            gone = self._delete_batch_locked(bucket, kind, present) \
                if present else []
            self._flush()
        BATCH_MUTATION_CALLS.labels("delete_many").inc()
        if gone:
            BATCH_MUTATIONS.labels("delete_many").inc(len(gone))
        if kind == PODS and gone:
            from kubernetes_tpu_torch.obs.ledger import LEDGER
            for obj in gone:
                LEDGER.finalize_delete(obj.key)
        return gone

    # -- pod conveniences (the scheduler's write surface) --------------------
    def bind_pod(self, pod_key: str, node_name: str,
                 fence=None) -> Any:
        """POST pods/<p>/binding analog (reference: factory.go:710).

        Single-lock fast path of guaranteed_update(set nodeName): one
        clone, one lock, one event. Round 18 makes the verb an rv-CAS
        bind (the reference rejects a Binding for a pod whose nodeName is
        already set): a pod already bound to a DIFFERENT node raises
        ConflictError and its binding is never overwritten — two racing
        schedulers see exactly one success and one 409 — while a re-bind
        to the SAME node is an idempotent no-op (a retried bind whose
        first attempt landed must look like success). `fence` optionally
        carries the writer's partition-lease fencing token(s); a
        superseded token raises FencedError before anything lands."""
        with self._lock:
            if fence is not None:
                self._check_fences_locked(fence, "bind")
            bucket = self._objs.setdefault(PODS, {})
            current = bucket.get(pod_key)
            if current is None:
                raise NotFoundError(f"{PODS}/{pod_key}")
            # the alias tripwire runs BEFORE the CAS read: a consumer
            # mutation through an aliased reference must fail loudly as
            # corruption, not masquerade as an already-bound conflict
            self._check_entry(PODS, pod_key, current)
            if current.node_name:
                if current.node_name == node_name:
                    return current   # idempotent re-bind: already landed
                BIND_CAS_CONFLICTS.inc()
                raise ConflictError(
                    f"{PODS}/{pod_key}: already bound to "
                    f"{current.node_name} (rv-CAS refused bind to "
                    f"{node_name})")
            self._bind_batch_locked(bucket, [(pod_key, node_name)], [])
            self._flush()
            from kubernetes_tpu_torch.obs.ledger import LEDGER
            LEDGER.commit_many((pod_key,))
            return bucket[pod_key]

    def _bind_batch_locked(self, bucket, bindings: list[tuple[str, str]],
                           conflicts: list) -> list[str]:
        """Batched binding body shared by bind_pod/bind_pods/commit_wave;
        caller holds the lock and flushes. Returns the missing keys and
        appends rv-CAS losers to `conflicts`: a pod already bound to a
        different node is NEVER overwritten (the fleet's double-bind
        impossibility rests on this one scan), and a same-node re-bind is
        a silent no-op (neither missing nor conflicted — the binding
        already landed). The integrity tripwire brackets the core call
        (debug mode only)."""
        if self._integrity is not None:
            # alias tripwire BEFORE the CAS scan: a mutated aliased pod
            # must surface as corruption, not as an already-bound loser
            for pod_key, _n in bindings:
                current = bucket.get(pod_key)
                if current is not None:
                    self._check_entry(PODS, pod_key, current)
        live = []
        for pod_key, node_name in bindings:
            current = bucket.get(pod_key)
            if current is not None and current.node_name:
                if current.node_name != node_name:
                    BIND_CAS_CONFLICTS.inc()
                    conflicts.append(pod_key)
                continue
            live.append((pod_key, node_name))
        if not live:
            return []
        missing = self._core.bind_batch(bucket, PODS, live)
        if self._integrity is not None:
            gone = set(missing)
            for pod_key, _n in live:
                if pod_key not in gone:
                    self._record_entry(PODS, pod_key, bucket[pod_key])
        return missing

    def bind_pods(self, bindings: list[tuple[str, str]],
                  fence=None, conflicts: Optional[list] = None) -> list[str]:
        """Batch form of bind_pod for the burst prefix commit: ONE lock
        acquisition and ONE core call for the whole burst instead of one
        per pod (per-binding semantics identical to bind_pod, including
        the rv-CAS already-bound check). Returns the keys that were
        missing (deleted between decision and commit); rv-CAS losers go
        to `conflicts` when the caller passes a list — else they ride the
        missing return (either way the caller requeues them, never
        overwrites). `fence` validates the writer's partition-lease
        tokens atomically before anything lands."""
        confl: list = []
        with self._lock:
            if fence is not None:
                self._check_fences_locked(fence, "bind")
            bucket = self._objs.setdefault(PODS, {})
            missing = self._bind_batch_locked(bucket, bindings, confl)
        self._flush()
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        gone = set(missing) | set(confl)
        LEDGER.commit_many([k for k, _n in bindings if k not in gone])
        if conflicts is not None:
            conflicts.extend(confl)
            return missing
        return missing + confl

    def create_many(self, kind: str, objs: list,
                    move: bool = False) -> list:
        """Batch create under one lock and one core call (event records
        from a burst commit, and the serving lane's batched arrival
        ingest); per-object semantics identical to create(). Raises on
        the first duplicate — callers pass fresh uniquely-named objects.

        Pod batches ride the serving admission surface exactly like
        create(), but with ONE gate evaluation and ONE batched ledger
        admission stamp per call: the gate admits a PREFIX (its depth
        watermark grows monotonically across a batch — see
        BackpressureGate.admit_many), the admitted prefix lands in one
        core call, and a shed tail raises ONE BackpressureError carrying
        `accepted` (how many landed) + the suggested Retry-After. Returns
        the stored objects (admitted prefix)."""
        gate = self.admission_gate
        retry_after = None
        shed = 0
        if gate is not None and kind == PODS and objs:
            admit_many = getattr(gate, "admit_many", None)
            if admit_many is not None:
                n_admit, retry_after = admit_many(objs)
            else:
                # a gate without the batch verb keeps per-pod admits;
                # the first shed ends the batch (prefix semantics)
                n_admit = 0
                try:
                    for o in objs:
                        gate.admit(o)
                        n_admit += 1
                except BackpressureError as e:
                    retry_after = e.retry_after
            shed = len(objs) - n_admit
            objs = objs[:n_admit]
        stored: list = []
        if objs:
            with self._lock:
                try:
                    stored = self._core.create_batch(
                        self._objs.setdefault(kind, {}), kind, objs, move)
                    if kind == EVENTS:
                        self._trim_events_locked()
                finally:
                    self._flush()
                if self._integrity is not None:
                    for o in stored:
                        self._record_entry(kind, _key_of(o), o)
            if gate is not None and kind == PODS:
                # one batched admission stamp for the accepted prefix —
                # the per-pod path's stamp_admission, amortized
                from kubernetes_tpu_torch.obs.ledger import LEDGER
                LEDGER.stamp_admission_many([o.key for o in stored])
        if shed:
            raise BackpressureError(
                f"{kind}: batched create shed {shed}/{shed + len(stored)} "
                f"past the admission watermark",
                retry_after=(retry_after if retry_after is not None
                             else 0.25),
                accepted=len(stored))
        return stored

    def commit_wave(self, bindings: list[tuple[str, str]],
                    events: Optional[list] = None,
                    token: Optional[str] = None,
                    event_spec: Optional[dict] = None,
                    fence=None,
                    conflicts: Optional[list] = None) -> list[str]:
        """One burst wave's whole store-write tail as ONE core call: the
        batched bind (bind_pods semantics) plus the audit-record creates
        for the bindings that landed (`events[i]` rides `bindings[i]`;
        records are created move=True, like the recorder's batch path).
        Fan-out is deliberately NOT triggered here — the scheduler calls
        `fanout_wave()` as its one separate per-wave delivery call, which
        may overlap the remaining host commit work.

        `token` is the caller's idempotency key (one fresh token per wave,
        REUSED across retries of that wave): a wave that already landed
        under the same token returns its recorded missing-keys result
        without touching the core — a retried bind after an AMBIGUOUS
        failure (the wave landed but the caller saw an exception) can
        neither double-land nor double-emit its events.

        `fence` (round 18) carries the writing scheduler's partition-lease
        fencing token(s): an expired or superseded token rejects the WHOLE
        wave atomically (FencedError; no bind, no event, no rv — on the
        native core and the twin alike, since validation precedes every
        core write). Bindings whose pod is ALREADY bound to a different
        node are rv-CAS conflicts: skipped (never overwritten), reported
        via `conflicts` when a list is passed, else merged into the
        missing return; their audit records are skipped exactly like a
        vanished pod's. Same-node re-binds are idempotent no-ops.

        `event_spec` (round 17, mutually exclusive with `events`) asks
        the commit core to BUILD the Scheduled audit payloads itself:
        `{"component": name}` makes the core construct one
        `Successfully assigned {key} to {node}` record per landed binding
        (record names ride a reserved block of the recorder's global
        sequence), deleting the per-pod Python record construction from
        the commit thread (PyCommitCore.commit_wave_binds). Retries of
        the SAME token must
        pass the same spec; the dedupe map answers them either way."""
        import time as _time
        if event_spec is not None:
            from kubernetes_tpu_torch.api.types import EventRecord
            from kubernetes_tpu_torch.store.record import reserve_seq
            seq0 = reserve_seq(max(1, len(bindings)))
            component = event_spec.get("component", "")
        with self._lock:
            if token is not None:
                hit = self._wave_tokens.get(token)
                if hit is not None:
                    WAVE_DEDUP.inc()
                    missing, confl = list(hit[0]), list(hit[1])
                    if conflicts is not None:
                        conflicts.extend(confl)
                        return missing
                    return missing + confl
            # fence validation FIRST (before the chaos seam and every
            # core write): a superseded claim's retry must stay rejected
            # whole, never half-retried into the core
            if fence is not None:
                self._check_fences_locked(fence, "commit_wave")
            # injected pre-land failure: nothing written yet — the caller
            # retries the whole wave under the same token
            chaos.check("store.commit_wave")
            pods = self._objs.setdefault(PODS, {})
            evs = self._objs.setdefault(EVENTS, {})
            if self._integrity is not None:
                # alias tripwire BEFORE the CAS scan (see bind_pod)
                for pod_key, _n in bindings:
                    current = pods.get(pod_key)
                    if current is not None:
                        self._check_entry(PODS, pod_key, current)
            # rv-CAS pre-scan (round 18): already-bound pods never reach
            # the core — a different-node decision is a conflict, a
            # same-node one an idempotent no-op; `live` keeps wave order
            confl = []
            live = []
            live_idx = []
            for i, (pod_key, node_name) in enumerate(bindings):
                current = pods.get(pod_key)
                if current is not None and current.node_name:
                    if current.node_name != node_name:
                        BIND_CAS_CONFLICTS.inc()
                        confl.append(pod_key)
                    continue
                live.append((pod_key, node_name))
                live_idx.append(i)
            t_core = _time.perf_counter()
            if event_spec is not None:
                # ONE core call builds the Scheduled payloads AND lands
                # binds + events
                missing = self._core.commit_wave_binds(
                    pods, PODS, live, evs, EVENTS, EventRecord, component,
                    seq0)
            else:
                recs = events or []
                if recs and len(live) != len(bindings):
                    # events[i] rides bindings[i]: conflicted / no-op
                    # bindings drop their records like vanished pods
                    recs = [recs[i] for i in live_idx]
                missing = self._core.commit_wave(pods, PODS, live,
                                                 evs, EVENTS, recs)
            self._trim_events_locked()   # audit retention (event TTL)
            t_landed = _time.perf_counter()
            if token is not None:
                self._wave_tokens[token] = (list(missing), list(confl))
                while len(self._wave_tokens) > WAVE_TOKEN_CAP:
                    self._wave_tokens.popitem(last=False)
            # injected AMBIGUOUS failure: the wave LANDED (core write done,
            # token recorded) but the caller's "response" is lost below
            ambiguous = chaos.take("store.commit_wave.ambiguous")
            COMMIT_WAVES.labels(self.core_impl).inc()
            COMMIT_WAVE_SECONDS.labels(self.core_impl).observe(
                t_landed - t_core)
            if self._integrity is not None:
                gone = set(missing)
                for pod_key, _n in live:
                    if pod_key not in gone:
                        self._record_entry(PODS, pod_key, pods[pod_key])
                for rec in events or []:
                    stored = evs.get(rec.key)
                    if stored is not None:
                        self._record_entry(EVENTS, rec.key, stored)
        # ledger: the commit_wave landing IS the per-pod commit stamp
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        gone = set(missing) | set(confl)
        LEDGER.commit_many([k for k, _n in bindings if k not in gone],
                           t=t_landed)
        if ambiguous:
            raise chaos.StoreFault(
                "store.commit_wave.ambiguous",
                "chaos: commit_wave response lost after the wave landed")
        if conflicts is not None:
            conflicts.extend(confl)
            return missing
        return missing + confl

    def fanout_wave(self) -> None:
        """Deliver a committed wave's pending watch events: ONE core call
        advancing every watcher's published cursor (O(watchers), not
        O(watchers x events) — consumers copy out on their own threads).
        A chaos-deferred delivery is flushed by the NEXT fan-out call or
        the next consumer poll — delayed, never lost."""
        if chaos.take("store.fanout"):
            self._fanout_deferred = True
            return
        self._fanout_deferred = False
        self._flush()

    def deliver_deferred(self) -> None:
        """Flush a chaos-deferred wave fan-out (called from a consumer's
        poll — the seam's guaranteed delivery point)."""
        with self._lock:
            self._fanout_deferred = False
            self._flush()

    def evict_pod(self, pod_key: str, reason: str = "api") -> Any:
        """POST pods/{ns}/{name}/eviction analog (reference:
        pkg/registry/core/pod/rest/eviction.go): delete the pod ONLY if
        every matching PodDisruptionBudget has disruptions left, and
        charge each matching budget's `disruptions_allowed` in the same
        critical section — two evictors racing a budget of 1 see exactly
        one success and one DisruptionBudgetError (the HTTP surface maps
        it to 429 + Retry-After). The disruption controller's recompute
        reconciles the charged status from pod state afterwards, exactly
        like the reference's trySync."""
        with self._lock:
            pod = self._objs.get(PODS, {}).get(pod_key)
            if pod is None:
                raise NotFoundError(f"{PODS}/{pod_key}")
            blockers = [
                b for b in self._objs.get(PDBS, {}).values()
                if b.namespace == pod.namespace and b.selector is not None
                and b.selector.matches(pod.labels)]
            exhausted = next(
                (b for b in blockers if b.disruptions_allowed <= 0), None)
            if exhausted is not None:
                # the reference eviction handler's exact message wording
                raise DisruptionBudgetError(
                    f"Cannot evict pod as it would violate the pod's "
                    f"disruption budget. ({exhausted.key} exhausted "
                    f"for {pod_key})")
            for b in blockers:
                charged = _clone(b)
                charged.disruptions_allowed -= 1
                self.update(PDBS, charged)   # reentrant: emits MODIFIED
            gone = self.delete(PODS, pod_key)
        EVICTIONS.labels(reason).inc()
        return gone

    def evict_many(self, pod_keys: list, reason: str = "api", fence=None,
                   token: Optional[str] = None,
                   stop_on_refusal: bool = False) -> dict:
        """Batched PDB-charging eviction (round 23): the whole batch runs
        in ONE critical section with per-item outcomes — returns
        {pod_key: "evicted" | "refused" | "missing" | "skipped"}. Budget
        charges are visible WITHIN the batch (a budget of 1 facing two
        pods answers one evicted + one refused, exactly like two serial
        racers), and the writes land as one batched MODIFIED per touched
        budget (carrying the cumulative charge) plus one batched DELETED
        pass for the evicted pods — two commit-core calls per batch
        instead of O(pods) serial verbs. A refused item charges nothing
        and deletes nothing.

        `stop_on_refusal` preserves the zone evictor's head-of-line
        pacing: the first refusal ends processing and every later item
        reports "skipped" (not attempted — its token is refundable).
        `fence` validates before any write (whole-batch FencedError);
        `token` dedupes a retried batch onto its recorded outcomes."""
        with self._lock:
            hit = self._mutation_token_hit(token)
            if hit is not None:
                return dict(hit)
            if fence is not None:
                self._check_fences_locked(fence, "evict_many")
            chaos.check("store.evict_many")
            pods = self._objs.get(PODS, {})
            pdb_bucket = self._objs.setdefault(PDBS, {})
            outcomes: dict = {}
            charged: dict = {}   # pdb key -> working clone (batch-visible)
            to_delete: list = []
            stopped = False
            for pod_key in pod_keys:
                if stopped:
                    outcomes[pod_key] = "skipped"
                    continue
                pod = pods.get(pod_key)
                if pod is None:
                    outcomes[pod_key] = "missing"
                    continue
                self._check_entry(PODS, pod_key, pod)
                blockers = [
                    charged.get(b.key, b)
                    for b in pdb_bucket.values()
                    if b.namespace == pod.namespace
                    and b.selector is not None
                    and b.selector.matches(pod.labels)]
                if any(b.disruptions_allowed <= 0 for b in blockers):
                    outcomes[pod_key] = "refused"
                    if stop_on_refusal:
                        stopped = True
                    continue
                for b in blockers:
                    c = charged.get(b.key)
                    if c is None:
                        c = charged[b.key] = _clone(b)
                    c.disruptions_allowed -= 1
                outcomes[pod_key] = "evicted"
                to_delete.append(pod_key)
            if charged:
                self._update_batch_locked(pdb_bucket, PDBS,
                                          list(charged.values()))
            if to_delete:
                if self._integrity is not None:
                    for pod_key in to_delete:
                        self._integrity.pop((PODS, pod_key), None)
                self._delete_batch_locked(pods, PODS, to_delete)
            self._flush()
            self._mutation_token_record(token, dict(outcomes))
        BATCH_MUTATION_CALLS.labels("evict_many").inc()
        if to_delete:
            BATCH_MUTATIONS.labels("evict_many").inc(len(to_delete))
            EVICTIONS.labels(reason).inc(len(to_delete))
            from kubernetes_tpu_torch.obs.ledger import LEDGER
            for pod_key in to_delete:
                LEDGER.finalize_delete(pod_key)
        return outcomes

    def set_nominated_node_name(self, pod_key: str, node_name: str) -> Any:
        return self.guaranteed_update(PODS, pod_key,
                                      nominated_node_mutator(node_name))

    def update_pod_group_status(self, group_key: str,
                                phase: Optional[str] = None,
                                members: Optional[int] = None,
                                scheduled: Optional[int] = None,
                                now: Optional[float] = None) -> Any:
        """PodGroup /status subresource analog: phase + member counts only
        (spec fields untouched); no-op writes are skipped. The mutate
        closure is shared with RemoteStore so both transports write
        identical objects (the CLAUDE.md sync rule)."""
        from kubernetes_tpu_torch.coscheduling.types import pod_group_status_mutator
        return self.guaranteed_update(
            PODGROUPS, group_key,
            pod_group_status_mutator(phase=phase, members=members,
                                     scheduled=scheduled, now=now),
            allow_skip=True)

    def update_pod_condition(self, pod_key: str, condition) -> Any:
        """UpdateStatus analog for one condition (reference: factory.go:715
        podConditionUpdater + podutil.UpdatePodCondition): replace the
        condition of the same type if it changed, append if absent; no-op
        write is skipped entirely."""
        return self.guaranteed_update(PODS, pod_key,
                                      pod_condition_mutator(condition),
                                      allow_skip=True)

    # -- watch --------------------------------------------------------------
    def watch(self, kind: str, since_rv: Optional[int] = None,
              selector: Optional[str] = None) -> Watch:
        """Stream events for `kind` after `since_rv` (None → only new events).

        `selector` is an OPAQUE interest key, not a filter: watchers that
        pass the same (kind, selector) dedupe into one subscription class
        and share materialize-once Event objects and serialize-once wire
        bytes; every watcher still sees the kind's FULL event stream.
        None joins the kind's default class.

        Raises ExpiredError when since_rv has fallen out of the event log —
        callers re-list, exactly like the reference's Reflector on 410 Gone.
        (The core can't prove no gap when the oldest retained event may not
        be the first after since_rv.)
        """
        with self._lock:
            try:
                wid = self._core.attach(kind, since_rv, selector)
            except TypeError:
                # stale prebuilt .so predating subscription classes
                wid = self._core.attach(kind, since_rv)
            self._watch_ids[wid] = (kind, selector)
            return Watch(self, kind, wid, selector=selector)

    # -- bulk load (benchmark harness) --------------------------------------
    def load(self, kind: str, objs: Iterable[Any]) -> None:
        for o in objs:
            self.create(kind, o)
