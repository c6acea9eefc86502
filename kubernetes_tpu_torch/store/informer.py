"""Reflector + shared informer over the versioned store.

Mirrors the reference's client-side cache pipeline (SURVEY §3.4):
Reflector.ListAndWatch (client-go/tools/cache/reflector.go:159) →
DeltaFIFO → sharedIndexInformer.HandleDeltas (shared_informer.go:180) →
registered handlers. Here the transport is the in-process Store watch; the
delta queue is the Watch's event queue; handlers see the same
add/update/delete callbacks with old+new objects.

Two pump modes:
- `start()` — background thread, like the reference's informer goroutines.
- `pump(max_events)` — synchronous drain for deterministic tests and for
  the benchmark loop (keeps the hot path single-threaded).

Copied from the reference with the port's imports:
`kubernetes_tpu.store.informer`.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Callable, Optional

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.store.store import (
    Store, Watch, Event, ADDED, MODIFIED, DELETED, ExpiredError,
)

# reflector metrics (client-go reflector_metrics.go analog)
RELISTS = obs.counter(
    "informer_relists_total",
    "List+watch re-establishments (initial sync and 410-Gone resumes), "
    "by kind.", ("kind",))
WATCH_EXPIRATIONS = obs.counter(
    "informer_watch_expirations_total",
    "Watches that outran the server's event log (410 Gone), by kind.",
    ("kind",))
RELIST_BACKOFF = obs.histogram(
    "informer_relist_backoff_seconds",
    "Backoff slept before a re-list during a consecutive-ExpiredError "
    "streak, by kind. The first expiry of a streak re-lists immediately "
    "(zero observation); a sustained expired window climbs the jittered "
    "exponential ladder instead of hot-looping list+watch.", ("kind",),
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))

Handler = Callable[[Any], None]
UpdateHandler = Callable[[Any, Any], None]
BatchHandler = Callable[[list], None]


class ResourceEventHandler:
    """One registered handler set, optionally filtered
    (reference: cache.FilteringResourceEventHandler).

    `on_add_many` is the batched-ingest extension (round 17): when set, a
    pump that delivered a RUN of consecutive adds hands the whole run to
    this callback in one call (per-object filter still applied) instead of
    one `on_add` per object — per-handler delivery ORDER is unchanged, so
    a handler never observes anything a per-event loop wouldn't.

    `on_update_many` / `on_delete_many` extend the same contract to the
    mutation plane (round 23): runs of consecutive MODIFIED land as one
    [(old, new), ...] call, runs of consecutive DELETED as one [obj, ...]
    call. A MODIFIED run batches ONLY when every pair is a plain update
    under the filter (both sides pass) — mixed filter categories
    (update-as-add / update-as-delete) fall back to the per-event loop so
    their interleaved order is bit-identical to the unbatched path."""

    def __init__(self,
                 on_add: Optional[Handler] = None,
                 on_update: Optional[UpdateHandler] = None,
                 on_delete: Optional[Handler] = None,
                 filter_fn: Optional[Callable[[Any], bool]] = None,
                 on_add_many: Optional[BatchHandler] = None,
                 on_update_many: Optional[BatchHandler] = None,
                 on_delete_many: Optional[BatchHandler] = None):
        self.on_add = on_add
        self.on_add_many = on_add_many
        self.on_update = on_update
        self.on_update_many = on_update_many
        self.on_delete = on_delete
        self.on_delete_many = on_delete_many
        self.filter_fn = filter_fn

    def _passes(self, obj: Any) -> bool:
        return self.filter_fn is None or self.filter_fn(obj)

    def handle_added_run(self, objs: list) -> None:
        """A run of consecutive ADDED objects, in delivery order: one
        `on_add_many` call for the filtered batch when registered, else
        the per-object `on_add` loop."""
        if self.on_add is None and self.on_add_many is None:
            return
        passing = objs if self.filter_fn is None \
            else [o for o in objs if self.filter_fn(o)]
        if not passing:
            return
        if self.on_add_many is not None and len(passing) > 1:
            self.on_add_many(passing)
        elif self.on_add is not None:
            for o in passing:
                self.on_add(o)
        else:
            self.on_add_many(passing)

    def handle_updated_run(self, pairs: list) -> None:
        """A run of consecutive MODIFIED (old, new) pairs, in delivery
        order: one `on_update_many` call when registered and EVERY pair
        is a plain update under the filter — anything else (an
        update-as-add or update-as-delete in the run) replays the exact
        per-event loop, preserving the interleaved category order."""
        if self.on_update_many is not None and len(pairs) > 1 and all(
                old is not None and self._passes(old) and self._passes(new)
                for old, new in pairs):
            self.on_update_many(pairs)
            return
        for old, new in pairs:
            self.handle(MODIFIED, old, new)

    def handle_deleted_run(self, objs: list) -> None:
        """A run of consecutive DELETED objects, in delivery order: one
        `on_delete_many` call for the filtered batch when registered,
        else the per-object `on_delete` loop."""
        if self.on_delete is None and self.on_delete_many is None:
            return
        passing = objs if self.filter_fn is None \
            else [o for o in objs if self.filter_fn(o)]
        if not passing:
            return
        if self.on_delete_many is not None and len(passing) > 1:
            self.on_delete_many(passing)
        elif self.on_delete is not None:
            for o in passing:
                self.on_delete(o)
        else:
            self.on_delete_many(passing)

    def handle(self, ev_type: str, old: Any, new: Any) -> None:
        if ev_type == ADDED:
            if self._passes(new) and self.on_add:
                self.on_add(new)
        elif ev_type == MODIFIED:
            old_ok = old is not None and self._passes(old)
            new_ok = self._passes(new)
            # reference filtering semantics: update→update / add / delete
            if old_ok and new_ok:
                if self.on_update:
                    self.on_update(old, new)
            elif new_ok:
                if self.on_add:
                    self.on_add(new)
            elif old_ok:
                if self.on_delete:
                    self.on_delete(old)
        elif ev_type == DELETED:
            if self._passes(new) and self.on_delete:
                self.on_delete(new)


class SharedInformer:
    """List+watch one kind; maintain a local cache; fan events out."""

    def __init__(self, store: Store, kind: str):
        self.store = store
        self.kind = kind
        self._handlers: list[ResourceEventHandler] = []
        self._cache: dict[str, Any] = {}
        self._watch: Optional[Watch] = None
        self._synced = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.RLock()
        # terminal background-mode failure (revoked/denied credentials):
        # recorded by _safe_relist before it stops the informer, so the
        # operator sees WHY the informer died instead of a silent stall
        self.last_error: Optional[Exception] = None
        # consecutive-ExpiredError streak driving the re-list backoff:
        # the first expiry re-lists immediately, a sustained expired
        # window (log smaller than churn) backs off exponentially with
        # jitter instead of spinning list+watch back-to-back. `_sleep` is
        # injectable so tests count/observe delays deterministically.
        self._expired_streak = 0
        self._backoff_rng = random.Random(f"relist:{kind}")
        self._sleep: Callable[[float], Any] = self._stop.wait
        self.relist_backoff_base = 0.05
        self.relist_backoff_cap = 1.0

    # -- registration -------------------------------------------------------
    def add_event_handler(self,
                          on_add: Optional[Handler] = None,
                          on_update: Optional[UpdateHandler] = None,
                          on_delete: Optional[Handler] = None,
                          filter_fn: Optional[Callable[[Any], bool]] = None,
                          on_add_many: Optional[BatchHandler] = None,
                          on_update_many: Optional[BatchHandler] = None,
                          on_delete_many: Optional[BatchHandler] = None,
                          ) -> None:
        self._handlers.append(ResourceEventHandler(
            on_add, on_update, on_delete, filter_fn,
            on_add_many=on_add_many, on_update_many=on_update_many,
            on_delete_many=on_delete_many))

    # -- lister (reference: informer.Lister()) ------------------------------
    def list(self) -> list[Any]:
        with self._lock:
            return list(self._cache.values())

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._cache.get(key)

    @property
    def has_synced(self) -> bool:
        return self._synced

    def backlog(self) -> int:
        """Events published for this informer's watch but not yet pumped
        (embedded store: the commit core's cursor backlog; remote: the
        client reader's queue). The serving backpressure gate adds this
        to the activeQ depth so a burst of creates BETWEEN informer pumps
        cannot blow past the watermark unobserved — it counts every
        undelivered event for the kind (binds included), which only
        overcounts, so the gate errs toward shedding under churn."""
        w = self._watch
        if w is None:
            return 0
        core = getattr(self.store, "_core", None)
        wid = getattr(w, "_wid", None)
        if core is not None and wid is not None:
            try:
                return int(core.backlog(wid))
            except Exception:
                return 0
        q = getattr(w, "_queue", None)   # RemoteWatch's reader queue
        return q.qsize() if q is not None else 0

    # -- relist backoff guard ------------------------------------------------
    def _note_expired(self) -> None:
        """One step of the consecutive-ExpiredError streak: sleep the
        streak's jittered exponential delay (0 on the first expiry) and
        record it. Stopping the informer interrupts the sleep."""
        streak = self._expired_streak
        self._expired_streak = streak + 1
        if streak == 0:
            return
        delay = min(self.relist_backoff_cap,
                    self.relist_backoff_base * (2 ** (streak - 1)))
        delay *= 0.5 + self._backoff_rng.random() / 2
        RELIST_BACKOFF.labels(self.kind).observe(delay)
        self._sleep(delay)

    # -- list+watch ---------------------------------------------------------
    def sync(self) -> None:
        """Initial list + open watch at the list's resourceVersion."""
        self._relist()
        self._synced = True

    def _relist(self) -> None:
        """List + re-open the watch, then reconcile the local cache with
        DeltaFIFO Replace semantics (delta_fifo.go:96): vanished keys emit
        deletes, changed keys updates, new keys adds — so a 410-Gone resume
        (reflector.go:159) never replays spurious adds or loses deletes
        that happened inside the expired window."""
        RELISTS.labels(self.kind).inc()
        if self._watch is not None:
            self._watch.stop()
        while True:
            objs, rv = self.store.list(self.kind)
            try:
                self._watch = self.store.watch(self.kind, since_rv=rv)
            except ExpiredError:
                # the log window moved past rv between list and watch
                # open: a sustained window would otherwise re-list
                # back-to-back — climb the backoff ladder instead
                self._note_expired()
                continue
            break
        new = {o.key: o for o in objs}
        with self._lock:
            old_cache = self._cache
            self._cache = new
        for key, obj in new.items():
            old = old_cache.get(key)
            if old is None:
                self._dispatch(ADDED, None, obj)
            elif old.resource_version != obj.resource_version:
                self._dispatch(MODIFIED, old, obj)
        for key, obj in old_cache.items():
            if key not in new:
                self._dispatch(DELETED, None, obj)

    #: events copied out per watch poll during pump() — ONE core poll call
    #: serves a whole batch instead of one call per event (the round-17
    #: batched-ingest prologue)
    pump_batch = 256

    def pump(self, max_events: Optional[int] = None,
             timeout: float = 0.0) -> int:
        """Synchronously apply pending watch events, copied out in
        batches (one core poll per `pump_batch` events; consecutive adds
        dispatch as one batch to handlers that registered on_add_many).
        Returns count applied."""
        if self._watch is None:
            self.sync()
        n = 0
        while max_events is None or n < max_events:
            limit = self.pump_batch if max_events is None \
                else min(self.pump_batch, max_events - n)
            try:
                evs = self._poll_batch(timeout, limit)
            except ExpiredError:
                # the watch outran the server's event log: re-list
                # (reflector 410 contract); consecutive expirations with
                # no event applied in between back off
                WATCH_EXPIRATIONS.labels(self.kind).inc()
                self._note_expired()
                self._relist()
                continue
            if not evs:
                break
            self._apply_batch(evs)
            n += len(evs)
        return n

    def _poll_batch(self, timeout: float, limit: int) -> list:
        """Copy out up to `limit` pending events: one cursor poll on the
        embedded store's Watch; transports without the batch poll
        (RemoteWatch's reader queue) drain per event."""
        w = self._watch
        poll = getattr(w, "_poll", None)
        if poll is not None:
            return poll(timeout if timeout else 0, limit)
        evs = []
        ev = w.next(timeout=timeout) if timeout else w.try_next()
        while ev is not None:
            evs.append(ev)
            if len(evs) >= limit:
                break
            ev = w.try_next()
        return evs

    def _apply(self, ev: Event) -> None:
        self._apply_batch([ev])

    def _apply_batch(self, evs: list) -> None:
        # a delivered event ends any consecutive-ExpiredError streak
        self._expired_streak = 0
        prepared = []   # (effective etype, old, new) in delivery order
        with self._lock:
            cache = self._cache
            for ev in evs:
                old = None
                if ev.type in (ADDED, MODIFIED):
                    old = cache.get(ev.obj.key)
                    cache[ev.obj.key] = ev.obj
                elif ev.type == DELETED:
                    old = cache.pop(ev.obj.key, None)
                # an ADDED for a key we already had behaves as update
                # (re-list replay)
                etype = ev.type
                if etype == ADDED and old is not None:
                    etype = MODIFIED
                prepared.append((etype, old, ev.obj))
        i = 0
        n = len(prepared)
        while i < n:
            # run of consecutive same-type events: one batched dispatch
            # per handler (per-handler order identical to the per-event
            # loop; singletons take the plain _dispatch path)
            etype, old, new = prepared[i]
            j = i + 1
            while j < n and prepared[j][0] == etype:
                j += 1
            if j - i == 1:
                self._dispatch(etype, old, new)
            elif etype == ADDED:
                run = [prepared[k][2] for k in range(i, j)]
                for h in self._handlers:
                    h.handle_added_run(run)
            elif etype == MODIFIED:
                pairs = [(prepared[k][1], prepared[k][2])
                         for k in range(i, j)]
                for h in self._handlers:
                    h.handle_updated_run(pairs)
            else:   # DELETED
                run = [prepared[k][2] for k in range(i, j)]
                for h in self._handlers:
                    h.handle_deleted_run(run)
            i = j

    def _dispatch(self, ev_type: str, old: Any, new: Any) -> None:
        for h in self._handlers:
            h.handle(ev_type, old, new)

    # -- background mode ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        if self._watch is None:
            self.sync()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"informer-{self.kind}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ev = self._watch.next(timeout=0.05)
            except ExpiredError:
                WATCH_EXPIRATIONS.labels(self.kind).inc()
                self._note_expired()
                self._safe_relist()
                continue
            if ev is not None:
                self._apply(ev)

    def _safe_relist(self) -> None:
        """Background-mode re-list: transient transport failures (a remote
        apiserver mid-restart) must not kill the informer thread — retry
        until the list+watch lands or the informer stops. The synchronous
        pump() path propagates transport errors to its caller instead.

        Authentication/authorization failures are NOT transient: a revoked
        or denied token will 401/403 forever, so retrying silently turns a
        credential problem into an invisible stall. Record the error and
        stop the informer instead (the reference reflector likewise
        surfaces Unauthorized instead of hot-looping on it)."""
        while not self._stop.is_set():
            try:
                self._relist()
                return
            except ExpiredError:
                self._note_expired()
                continue
            except Exception as e:
                code = getattr(e, "code", None)
                if code in (401, 403):
                    self.last_error = e
                    self._stop.set()
                    return
                if self._stop.wait(0.2):
                    return

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


class InformerFactory:
    """SharedInformerFactory analog: one informer per kind, shared."""

    def __init__(self, store: Store):
        self.store = store
        self._informers: dict[str, SharedInformer] = {}

    def informer(self, kind: str) -> SharedInformer:
        inf = self._informers.get(kind)
        if inf is None:
            inf = SharedInformer(self.store, kind)
            self._informers[kind] = inf
        return inf

    def sync_all(self) -> None:
        for inf in self._informers.values():
            if not inf.has_synced:
                inf.sync()

    def pump_all(self) -> int:
        return sum(inf.pump() for inf in self._informers.values())

    def start_all(self) -> None:
        for inf in self._informers.values():
            inf.start()

    def stop_all(self) -> None:
        for inf in self._informers.values():
            inf.stop()
