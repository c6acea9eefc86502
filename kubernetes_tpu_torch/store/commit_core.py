"""Commit core: the store's versioned write log + watch fan-out engine.

Copied from the reference (`kubernetes_tpu.store.commit_core`): its
pure-Python `PyCommitCore`, the twin of the reference's native C++ core,
which has no copy here, without the reference's demotion hand-over and
with its class-per-watcher mode (`set_shared_classes`).
`make_commit_core` always returns the twin. The core fixes the store's observable state: resourceVersion assignment order,
missing-key detection, AlreadyExists raises, per-watcher event sequences,
and overflow/resync decisions.

Design:

- The core owns the store's rv counter and the per-kind event LOG — a
  bounded ring of (etype, obj, rv) entries with an absolute sequence
  number. Objects in the log are the store's write snapshots (the same
  aliasing contract as before: read-only by convention).
- A watcher is a CURSOR into its kind's log, not a private queue: fan-out
  is O(watchers) per wave (advance the published cursor + wake sleepers),
  not O(watchers x events), and the consumer thread materializes its own
  `Event` objects at copy-out — moving that per-event cost OFF the commit
  thread.
- Slow consumers are BOUNDED: a watcher whose backlog exceeds `ring_size`
  (or whose cursor falls out of the log ring) is dropped-with-resync —
  its pending events are discarded and the next poll raises ExpiredError,
  exactly the reference's 410-Gone watch-cache semantics. The store
  counts these on `watch_dropped_total{reason}`.
- Writes APPEND pending entries without delivering; `flush()` publishes
  them to watchers in log order. Serial store verbs flush before
  returning; `Store.commit_wave` defers so the wave's fan-out is one
  separate call (`Store.fanout_wave`) that can overlap the commit tail.

The rv counter and log appends are guarded by the Store's lock (every
writer holds it); the cursor/notify state has its own condition so
copy-out never touches the store lock.
"""
from __future__ import annotations

import copy
import os
import threading
import time as _time
from bisect import bisect_right
from typing import Any, Optional

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


def _clone(obj: Any) -> Any:
    """The store's write-snapshot rule: a fast clone() when the type has
    one, deepcopy otherwise (identical to store._clone)."""
    c = getattr(obj, "clone", None)
    return c() if c is not None else copy.deepcopy(obj)


class _KindLog:
    __slots__ = ("entries", "rvs", "start", "flushed")

    def __init__(self):
        # (etype, obj, rv, ts) from abs seq `start`; ts is the monotonic
        # commit stamp feeding the watch_fanout_lag_seconds histogram
        # (commit -> copy-out) through the fan-out sink
        self.entries: list = []
        self.rvs: list[int] = []  # parallel rv vector (attach binary search)
        self.start = 0            # absolute seq of entries[0]
        self.flushed = 0          # absolute seq events are published up to

    @property
    def end(self) -> int:
        return self.start + len(self.entries)


class _SubClass:
    """One shared subscription class: every watcher with the same
    (kind, selector) interest indexes the same materialize-once caches.
    `evs`/`lines` are parallel slot vectors aligned to the kind log from
    absolute seq `cache_start` (realigned lazily at poll when the log
    ring evicts) — slot i caches the Event object / pre-encoded wire
    line for log entry `cache_start + i`, filled first-writer-wins by
    whichever classmate copies the entry out first. The selector is an
    OPAQUE interest key (class dedupe only, never an event filter)."""

    __slots__ = ("kind", "selector", "members", "cache_start",
                 "evs", "lines")

    def __init__(self, kind: str, selector: str, log: _KindLog):
        self.kind = kind
        self.selector = selector
        self.members = 0
        # cover the full current log window so replaying watchers
        # (attach with since_rv) index valid slots
        self.cache_start = log.start
        self.evs: list = [None] * len(log.entries)
        self.lines: list = [None] * len(log.entries)

    def align(self, log: _KindLog) -> None:
        """Realign the slot vectors to the log window [start, end)."""
        if self.cache_start < log.start:
            drop = min(len(self.evs), log.start - self.cache_start)
            del self.evs[:drop]
            del self.lines[:drop]
            self.cache_start = log.start
        need = log.end - self.cache_start - len(self.evs)
        if need > 0:
            self.evs.extend([None] * need)
            self.lines.extend([None] * need)


class _Watcher:
    __slots__ = ("kind", "cursor", "resync", "stopped", "cls")

    def __init__(self, kind: str, cursor: int,
                 cls: Optional[_SubClass] = None):
        self.kind = kind
        self.cursor = cursor      # absolute seq of the next entry to read
        self.resync = False
        self.stopped = False
        self.cls = cls            # shared subscription class (None = private)


class PyCommitCore:
    """Pure-Python commit core (the twin of the reference's native core)."""

    is_native = False

    def __init__(self, log_size: int, ring_size: int,
                 event_cls, expired_exc, already_exists_exc):
        self._log_size = int(log_size)
        self._ring_size = int(ring_size)
        self._event_cls = event_cls
        self._expired = expired_exc
        self._already = already_exists_exc
        self._rv = 0
        self._logs: dict[str, _KindLog] = {}
        self._watchers: dict[int, _Watcher] = {}
        self._by_kind: dict[str, list[int]] = {}
        self._next_wid = 0
        self._cond = threading.Condition(threading.Lock())
        self._fanout_sink = None
        # shared subscription classes (round 20): watchers with the same
        # (kind, selector) interest share one materialize-once Event cache
        # and one serialize-once byte cache. `set_shared_classes(False)`
        # is the old-shape degenerate mode (every watcher private) used by
        # the differential parity tests.
        self._shared_classes = True
        self._classes: dict[tuple[str, str], _SubClass] = {}
        self._wire_encoder = None      # (etype, obj, rv) -> bytes
        self._stat_mat = 0             # Event materializations (cache miss)
        self._stat_shared = 0          # deliveries served from a class cache
        self._stat_enc = 0             # wire-line encodes (cache miss)
        self._stat_bytes = 0           # wire bytes served (hits + misses)
        # fencing-token table (round 18, active-active fleet): scope ->
        # the highest lease fencing token validated so far. Guarded by
        # the STORE's lock like the rv counter (every writer holds it);
        # never touched from consumer threads.
        self._fences: dict[str, int] = {}

    def set_fanout_sink(self, sink) -> None:
        """Observability hook (identical on the native core): called at
        poll copy-out with (kind, events, lags) — `lags[i]` is the seconds
        between events[i]'s commit stamp and this copy-out. The store wires
        it to the watch_fanout_lag_seconds histogram and the pod-lifecycle
        ledger's copy-out stamp. Never part of parity-observable state."""
        self._fanout_sink = sink

    def set_wire_encoder(self, encoder) -> None:
        """Serialize-once byte ring (round 20): `encoder(etype, obj, rv)`
        must return the complete wire line (bytes) for one event. Encoded
        lines are cached per subscription class, so the HTTP watch path
        pays ONE serialization per event per class regardless of how many
        watchers stream it. Observability/delivery-plane only."""
        self._wire_encoder = encoder

    def set_shared_classes(self, enabled: bool) -> None:
        """Toggle class sharing for FUTURE attaches (old-shape degenerate
        mode when False: every watcher materializes privately, exactly the
        pre-round-20 copy-out path — the differential tests pin the two
        modes bit-identical)."""
        self._shared_classes = bool(enabled)

    # -- fencing tokens (round 18; caller holds the store lock) --------------
    # A scope names one partition lease (e.g. "fleet-default-scheduler-s3");
    # tokens are the lease's resourceVersion at acquisition, so a later
    # claimant's token is strictly greater. `fence_ok` is the read-only
    # validation (a write carrying a token below the recorded maximum is
    # superseded and must be rejected WHOLE before anything lands);
    # `advance_fence` records the new maximum. The native core implements
    # the identical pair (commitcore.cpp), and the parity tests drive both
    # through the store's random-program harness.
    def fence_ok(self, scope: str, token: int) -> bool:
        return int(token) >= self._fences.get(scope, 0)

    def advance_fence(self, scope: str, token: int) -> bool:
        token = int(token)
        if token < self._fences.get(scope, 0):
            return False
        self._fences[scope] = token
        return True

    def fence_token(self, scope: str) -> int:
        return self._fences.get(scope, 0)

    def fence_table(self) -> dict:
        return dict(self._fences)

    # -- rv ------------------------------------------------------------------
    def rv(self) -> int:
        return self._rv

    def next_rv(self) -> int:
        self._rv += 1
        return self._rv

    # -- log append (pending; caller holds the store lock) -------------------
    def _kind_log(self, kind: str) -> _KindLog:
        log = self._logs.get(kind)
        if log is None:
            log = self._logs[kind] = _KindLog()
        return log

    def _append(self, log: _KindLog, etype: str, obj: Any, rv: int,
                ts: Optional[float] = None) -> None:
        log.entries.append((etype, obj, rv,
                            ts if ts is not None else _time.perf_counter()))
        log.rvs.append(rv)
        if len(log.entries) > self._log_size:
            n = len(log.entries) - self._log_size
            del log.entries[:n]
            del log.rvs[:n]
            log.start += n
            # a cursor the eviction passed is detected at flush/poll time
            # (cursor < log.start -> drop-with-resync)

    def append(self, etype: str, kind: str, obj: Any, rv: int) -> None:
        """One pending log entry (the serial update/delete verbs)."""
        self._append(self._kind_log(kind), etype, obj, rv)

    # -- batched write verbs (pending; caller holds the store lock) ----------
    def bind_batch(self, bucket: dict, kind: str,
                   bindings: list[tuple[str, str]]) -> list[str]:
        """The store's batched bind body (_bind_locked semantics per
        binding): clone, set node_name, assign the next rv, replace the
        bucket entry, log MODIFIED. Returns the keys that were missing."""
        log = self._kind_log(kind)
        ts = _time.perf_counter()   # one commit stamp for the whole batch
        missing = []
        for pod_key, node_name in bindings:
            current = bucket.get(pod_key)
            if current is None:
                missing.append(pod_key)
                continue
            stored = current.clone()
            stored.node_name = node_name
            self._rv += 1
            stored.resource_version = self._rv
            bucket[pod_key] = stored
            self._append(log, MODIFIED, stored, self._rv, ts)
        return missing

    def create_batch(self, bucket: dict, kind: str, objs: list,
                     move: bool) -> list:
        """The store's batched create body (_create_locked semantics per
        object): raise AlreadyExists on a duplicate key, snapshot unless
        `move`, assign the next rv, log ADDED. Returns the stored objects."""
        log = self._kind_log(kind)
        ts = _time.perf_counter()   # one commit stamp for the whole batch
        out = []
        for obj in objs:
            key = obj.key
            if key in bucket:
                raise self._already(f"{kind}/{key}")
            stored = obj if move else _clone(obj)
            self._rv += 1
            stored.resource_version = self._rv
            bucket[key] = stored
            self._append(log, ADDED, stored, self._rv, ts)
            out.append(stored)
        return out

    def update_batch(self, bucket: dict, kind: str, objs: list) -> list:
        """The store's batched update body (round 23; update() semantics
        per object): snapshot the caller's replacement object, assign the
        next rv, replace the bucket entry, log MODIFIED — one commit
        stamp for the whole batch. NotFound / rv-CAS refusals are the
        STORE's per-item pre-scan (under the same lock), so every object
        reaching the core lands. Returns the stored snapshots."""
        log = self._kind_log(kind)
        ts = _time.perf_counter()   # one commit stamp for the whole batch
        out = []
        for obj in objs:
            stored = _clone(obj)
            self._rv += 1
            stored.resource_version = self._rv
            bucket[obj.key] = stored
            self._append(log, MODIFIED, stored, self._rv, ts)
            out.append(stored)
        return out

    def delete_batch(self, bucket: dict, kind: str, keys: list) -> list:
        """The store's batched delete body (round 23; delete() semantics
        per key): pop the bucket entry and log DELETED with a snapshot at
        the next rv — one commit stamp for the whole batch. The DELETED
        payload keeps the object's last stored rv (only the log entry
        carries the delete's own rv, exactly like the serial verb).
        Missing keys are skipped; returns the popped originals."""
        log = self._kind_log(kind)
        ts = _time.perf_counter()   # one commit stamp for the whole batch
        gone = []
        for key in keys:
            obj = bucket.pop(key, None)
            if obj is None:
                continue
            self._rv += 1
            self._append(log, DELETED, _clone(obj), self._rv, ts)
            gone.append(obj)
        return gone

    def commit_wave(self, pod_bucket: dict, pod_kind: str,
                    bindings: list[tuple[str, str]],
                    ev_bucket: dict, ev_kind: str, recs: list) -> list[str]:
        """One burst wave's whole store-write tail in one call: the batched
        bind plus the audit-record creates for the bindings that landed
        (recs[i] rides bindings[i]; a vanished pod's record is skipped,
        like the serial path that never reaches its Scheduled event).
        Event creates are move=True (recorder ownership transfer)."""
        missing = self.bind_batch(pod_bucket, pod_kind, bindings)
        if recs:
            if missing:
                miss = set(missing)
                recs = [r for (k, _n), r in zip(bindings, recs)
                        if k not in miss]
            self.create_batch(ev_bucket, ev_kind, recs, True)
        return missing

    def commit_wave_binds(self, pod_bucket: dict, pod_kind: str,
                          bindings: list[tuple[str, str]],
                          ev_bucket: dict, ev_kind: str,
                          record_cls, component: str,
                          seq0: int) -> list[str]:
        """commit_wave with the Scheduled-event payloads built INSIDE the
        core (round 17): the caller passes only (key, node) bindings plus
        the record class / component / reserved name-sequence start, and
        the core constructs one `Successfully assigned {key} to {node}`
        record per LANDED binding (binding i names its record seq0+i;
        vanished pods consume their seq but emit nothing — exactly the
        serial path that never reaches its Scheduled event). Deletes the
        last per-pod Python construction from the commit thread when the
        native core runs this; this twin is the referee."""
        from kubernetes_tpu_torch.store.record import build_scheduled_records
        missing = self.bind_batch(pod_bucket, pod_kind, bindings)
        if bindings:
            recs = build_scheduled_records(record_cls, bindings,
                                           component, seq0)
            if missing:
                miss = set(missing)
                recs = [r for (k, _n), r in zip(bindings, recs)
                        if k not in miss]
            if recs:
                self.create_batch(ev_bucket, ev_kind, recs, True)
        return missing

    # -- fan-out -------------------------------------------------------------
    def flush(self) -> int:
        """Publish every pending entry to its kind's watchers (log order)
        and wake blocked polls. A watcher whose backlog would exceed the
        ring bound — or whose cursor the log ring already evicted — is
        dropped-with-resync. Returns the number of events dropped."""
        dropped = 0
        with self._cond:
            for kind, log in self._logs.items():
                if log.flushed >= log.end:
                    continue
                log.flushed = log.end
                for wid in self._by_kind.get(kind, ()):
                    w = self._watchers[wid]
                    if w.resync or w.stopped:
                        continue
                    backlog = log.flushed - w.cursor
                    if w.cursor < log.start or backlog > self._ring_size:
                        dropped += backlog
                        w.cursor = log.flushed
                        w.resync = True
            self._cond.notify_all()
        return dropped

    # -- watch ---------------------------------------------------------------
    def _join_class(self, kind: str, selector: Optional[str],
                    log: _KindLog) -> Optional[_SubClass]:
        """Resolve (kind, selector) to its shared class, creating it on
        first membership (attach/detach move a refcount, never a backlog).
        Returns None in degenerate mode. Caller holds `_cond`."""
        if not self._shared_classes:
            return None
        key = (kind, selector or "")
        cls = self._classes.get(key)
        if cls is None:
            cls = self._classes[key] = _SubClass(kind, key[1], log)
        cls.members += 1
        return cls

    def attach(self, kind: str, since_rv: Optional[int],
               selector: Optional[str] = None) -> int:
        """New watcher cursor. since_rv=None -> only events published after
        this point; else replay from the log, raising ExpiredError when the
        resume point predates the log window (410 Gone). `selector` is the
        watcher's interest key: identical (kind, selector) watchers dedupe
        into one shared subscription class (None joins the kind's default
        class); it never filters events."""
        log = self._kind_log(kind)
        with self._cond:
            if since_rv is None:
                cursor = log.end
            elif log.rvs and since_rv < log.rvs[0] - 1:
                raise self._expired(
                    f"{kind}: rv {since_rv} older than log window")
            else:
                cursor = log.start + bisect_right(log.rvs, since_rv)
            wid = self._next_wid
            self._next_wid += 1
            cls = self._join_class(kind, selector, log)
            self._watchers[wid] = _Watcher(kind, cursor, cls)
            self._by_kind.setdefault(kind, []).append(wid)
            return wid

    def detach(self, wid: int) -> None:
        with self._cond:
            w = self._watchers.pop(wid, None)
            if w is not None:
                w.stopped = True
                lst = self._by_kind.get(w.kind, [])
                if wid in lst:
                    lst.remove(wid)
                cls = w.cls
                if cls is not None:
                    cls.members -= 1
                    if cls.members <= 0:
                        self._classes.pop((cls.kind, cls.selector), None)
            self._cond.notify_all()

    def _poll_pick(self, wid: int, timeout: Optional[float], limit: int,
                   bytes_mode: bool = False):
        """The shared wait-and-pick half of poll/poll_bytes: block for the
        first published entry, detect drop-with-resync, slice the picked
        entries and advance the cursor, and snapshot the watcher's class
        cache slots — all under `_cond`. Returns None on timeout/stop."""
        deadline = None
        if timeout and timeout > 0:
            deadline = _time.monotonic() + timeout
        with self._cond:
            while True:
                w = self._watchers.get(wid)
                if w is None:
                    return None
                if w.resync:
                    raise self._expired(
                        f"{w.kind}: watch dropped (resync required)")
                log = self._logs[w.kind]
                if w.cursor < log.start:
                    # the ring evicted entries this watcher never consumed
                    w.resync = True
                    raise self._expired(
                        f"{w.kind}: rv window evicted before copy-out")
                if w.cursor < log.flushed:
                    break
                if timeout == 0:
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - _time.monotonic()
                    if wait <= 0:
                        return None
                self._cond.wait(wait)   # None = wait forever
            c0 = w.cursor
            lo = c0 - log.start
            n = min(limit, log.flushed - c0)
            picked = log.entries[lo: lo + n]
            w.cursor += n
            cls = w.cls
            cached_evs = cached_lines = None
            if cls is None:
                # old-shape private watcher: every pick materializes
                self._stat_mat += n
            else:
                cls.align(log)
                base = c0 - cls.cache_start
                cached_evs = cls.evs[base: base + n]
                cached_lines = cls.lines[base: base + n]
                hits = cached_lines if bytes_mode else cached_evs
                self._stat_shared += sum(1 for h in hits if h is not None)
        return w, picked, c0, cls, cached_evs, cached_lines

    def _install_shared(self, cls: _SubClass, made_ev: list,
                        made_ln: list, nbytes: int) -> list:
        """First-writer-wins cache fill for events/lines this poll
        materialized. Returns the (event, entry) pairs THIS call installed
        — the fan-out sink fires for exactly those, so lag is observed
        once per event per class, not once per watcher."""
        installed = []
        with self._cond:
            self._stat_mat += len(made_ev)
            self._stat_enc += len(made_ln)
            self._stat_bytes += nbytes
            for seq, e, entry in made_ev:
                ci = seq - cls.cache_start
                if 0 <= ci < len(cls.evs) and cls.evs[ci] is None:
                    cls.evs[ci] = e
                    installed.append((e, entry))
            for seq, ln in made_ln:
                ci = seq - cls.cache_start
                if 0 <= ci < len(cls.lines) and cls.lines[ci] is None:
                    cls.lines[ci] = ln
        return installed

    def _sink_fire(self, kind: str, events: list, entries: list) -> None:
        sink = self._fanout_sink
        if sink is None or not events:
            return
        # copy-out stamp: commit->copy-out lag per event, observed on
        # the CONSUMER's thread (the identical hook exists in
        # commitcore.cpp's poll)
        now = _time.perf_counter()
        try:
            sink(kind, events, [now - en[3] for en in entries])
        except Exception:
            pass   # observability must never break delivery

    def poll(self, wid: int, timeout: Optional[float],
             limit: int) -> list:
        """Copy out up to `limit` published events past the watcher's
        cursor, blocking up to `timeout` seconds (None = forever) for the
        first one. Returns [] on timeout or after stop; raises ExpiredError
        when the watcher was dropped (slow consumer / log window). With a
        shared subscription class, each entry is materialized into an Event
        ONCE per class (first classmate to copy it out) and every later
        classmate is served the cached object — per-watcher event streams
        stay value-identical to the private path."""
        res = self._poll_pick(wid, timeout, limit)
        if res is None:
            return []
        w, picked, c0, cls, cached_evs, _cached_lines = res
        ev = self._event_cls
        kind = w.kind
        if cls is None:
            events = [ev(t, kind, o, rv) for t, o, rv, _ts in picked]
            self._sink_fire(kind, events, picked)
            return events
        events = []
        made = []   # (abs seq, event, entry) materialized by this call
        for i, entry in enumerate(picked):
            e = cached_evs[i]
            if e is None:
                e = ev(entry[0], kind, entry[1], entry[2])
                made.append((c0 + i, e, entry))
            events.append(e)
        if made:
            installed = self._install_shared(cls, made, [], 0)
            if installed:
                self._sink_fire(kind, [e for e, _en in installed],
                                [en for _e, en in installed])
        return events

    def poll_bytes(self, wid: int, timeout: Optional[float],
                   limit: int) -> list:
        """poll(), but returns pre-encoded wire lines (bytes) from the
        class's serialize-once byte ring: each entry is encoded ONCE per
        class and every watcher streams the same bytes object — zero
        per-watcher encoding on the delivery thread. Requires a wire
        encoder (`set_wire_encoder`)."""
        enc = self._wire_encoder
        if enc is None:
            raise RuntimeError("wire encoder not set")
        res = self._poll_pick(wid, timeout, limit, bytes_mode=True)
        if res is None:
            return []
        w, picked, c0, cls, cached_evs, cached_lines = res
        ev = self._event_cls
        kind = w.kind
        if cls is None:
            events = [ev(t, kind, o, rv) for t, o, rv, _ts in picked]
            lines = [enc(t, o, rv) for t, o, rv, _ts in picked]
            self._sink_fire(kind, events, picked)
            with self._cond:
                self._stat_enc += len(lines)
                self._stat_bytes += sum(len(b) for b in lines)
            return lines
        lines = []
        made_ev = []   # events materialized here (sink + classmate reuse)
        made_ln = []
        for i, entry in enumerate(picked):
            ln = cached_lines[i]
            if ln is None:
                ln = enc(entry[0], entry[1], entry[2])
                made_ln.append((c0 + i, ln))
                if cached_evs[i] is None:
                    made_ev.append((c0 + i,
                                    ev(entry[0], kind, entry[1], entry[2]),
                                    entry))
            lines.append(ln)
        installed = self._install_shared(cls, made_ev, made_ln,
                                         sum(len(b) for b in lines))
        if installed:
            self._sink_fire(kind, [e for e, _en in installed],
                            [en for _e, en in installed])
        return lines

    # -- introspection (tests / bench) ---------------------------------------
    def backlog(self, wid: int) -> int:
        with self._cond:
            w = self._watchers.get(wid)
            if w is None:
                return 0
            log = self._logs[w.kind]
            return max(0, log.flushed - max(w.cursor, log.start))

    def fanout_stats(self) -> dict:
        """Watch-plane snapshot (identical shape on the native core):
        cumulative materialization/shared-hit/encode/bytes counters plus
        one row per live subscription class. Observability only."""
        with self._cond:
            classes = sorted(self._classes.values(),
                             key=lambda c: (c.kind, c.selector))
            rows = [{"kind": c.kind, "selector": c.selector,
                     "members": c.members,
                     "cached_events":
                         sum(1 for e in c.evs if e is not None),
                     "cached_lines":
                         sum(1 for b in c.lines if b is not None),
                     "window": [c.cache_start,
                                c.cache_start + len(c.evs)]}
                    for c in classes]
            return {"shared_classes": self._shared_classes,
                    "materializations": self._stat_mat,
                    "shared_hits": self._stat_shared,
                    "line_encodes": self._stat_enc,
                    "bytes_served": self._stat_bytes,
                    "classes": rows}


def make_commit_core(log_size: int, ring_size: int, event_cls,
                     expired_exc, already_exists_exc):
    """The pure-Python PyCommitCore: the port has no native commit core, so
    KTPU_COMMITCORE=native raises."""
    if os.environ.get("KTPU_COMMITCORE") == "native":
        raise RuntimeError("KTPU_COMMITCORE=native: kubernetes_tpu_torch "
                           "has no native commit core")
    return PyCommitCore(log_size, ring_size, event_cls,
                        expired_exc, already_exists_exc)
