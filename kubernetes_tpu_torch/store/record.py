"""Event recorder: the user-visible audit trail.

Analog of client-go/tools/record.EventRecorder + its correlator: events are
aggregated by (involved object, type, reason, message) with a count, and
written through the store so any watcher (tests, CLI, controllers) sees them
— the reference's recorder posts to the events API the same way
(reference: pkg/scheduler/scheduler.go:268,325,433 call sites).

Copied from the reference with the port's imports:
`kubernetes_tpu.store.record`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from kubernetes_tpu_torch.api.types import EventRecord
from kubernetes_tpu_torch.store.store import (
    Store, EVENTS, AlreadyExistsError, ConflictError, NotFoundError,
)
from kubernetes_tpu_torch.store.remote import APIStatusError

NORMAL = "Normal"
WARNING = "Warning"

_seq_val = 0
_seq_lock = threading.Lock()


def reserve_seq(n: int) -> int:
    """Atomically reserve a contiguous block of `n` record-name sequence
    numbers; returns the first. The commit core's batched Scheduled-event
    build (native and twin) names its records seq0+i off one reservation
    per wave, so wave records stay unique against every other emitter of
    the process-global sequence (gaps from unlanded bindings are fine —
    the sequence only guarantees uniqueness, like the per-record
    next_seq() it generalizes)."""
    global _seq_val
    with _seq_lock:
        first = _seq_val + 1
        _seq_val += n
        return first


def next_seq() -> int:
    return reserve_seq(1)


def build_scheduled_records(record_cls, bindings: list, component: str,
                            seq0: int) -> list:
    """The batched Scheduled-record build of PyCommitCore.commit_wave_binds:
    one EventRecord per binding (key, node), named `{name}.{seq0+i:x}`,
    message exactly the burst commit's wording."""
    recs = []
    new = record_cls.__new__
    for i, (key, node) in enumerate(bindings):
        namespace, _, name = key.partition("/")
        rec = new(record_cls)
        rec.__dict__.update(
            name=f"{name or key}.{seq0 + i:x}",
            namespace=namespace if name else "default",
            involved_kind="Pod", involved_key=key,
            type=NORMAL, reason="Scheduled",
            message=f"Successfully assigned {key} to {node}",
            count=1, component=component, resource_version=0)
        recs.append(rec)
    return recs

# correlation cache bound (the reference correlator is an LRU with TTL,
# client-go/tools/record/events_cache.go); keys include per-pod messages, so
# an unbounded map grows one entry per pod ever scheduled
MAX_CORRELATION_ENTRIES = 4096


class EventRecorder:
    def __init__(self, store: Store, component: str = "default-scheduler",
                 max_entries: int = MAX_CORRELATION_ENTRIES):
        self.store = store
        self.component = component
        self._lock = threading.Lock()
        # correlation cache: aggregation key -> stored event key (LRU)
        self._known: OrderedDict[tuple, str] = OrderedDict()
        self._max_entries = max_entries

    def event(self, involved_kind: str, involved_key: str, etype: str,
              reason: str, message: str) -> None:
        agg = (self.component, involved_kind, involved_key, etype, reason,
               message)
        with self._lock:
            existing = self._known.get(agg)
            if existing is not None:
                self._known.move_to_end(agg)
                def bump(ev):
                    ev.count += 1
                    return ev
                try:
                    self.store.guaranteed_update(EVENTS, existing, bump)
                    return
                except NotFoundError:
                    pass   # expired/cleaned: fall through to re-create
            namespace, _, name = involved_key.partition("/")
            rec = EventRecord(
                name=f"{name or involved_key}.{next_seq():x}",
                namespace=namespace if name else "default",
                involved_kind=involved_kind, involved_key=involved_key,
                type=etype, reason=reason, message=message,
                component=self.component)
            try:
                self.store.create(EVENTS, rec, move=True)
            except (APIStatusError, AlreadyExistsError, ConflictError,
                    OSError):
                # fire-and-forget like the reference recorder: a rejected
                # or undeliverable event write (rate-limit 422, transport
                # failure, name collision) must never fail the component's
                # work loop — events are audit records, not state.
                # Programming errors (TypeError from schema drift) still
                # propagate.
                return
            self._known[agg] = rec.key
            while len(self._known) > self._max_entries:
                self._known.popitem(last=False)

    def make_pod_records(self, items) -> list:
        """Construct (without writing) one EventRecord per
        (pod, etype, reason, message) item. Burst messages are unique per
        pod (they carry the pod's key), so the correlation cache can never
        aggregate them and is skipped. The burst commit passes these
        straight into `store.commit_wave` so a wave's binds AND audit
        records land in ONE core call."""
        recs = []
        new = EventRecord.__new__
        for pod, etype, reason, message in items:
            key = pod.key
            namespace, _, name = key.partition("/")
            # dataclass __init__ costs ~3x a direct dict fill and this loop
            # runs 10k+ times inside the timed burst window
            rec = new(EventRecord)
            rec.__dict__.update(
                name=f"{name or key}.{next_seq():x}",
                namespace=namespace if name else "default",
                involved_kind="Pod", involved_key=key,
                type=etype, reason=reason, message=message,
                count=1, component=self.component, resource_version=0)
            recs.append(rec)
        return recs

    def pod_events_batch(self, items) -> None:
        """Burst-commit form: every record lands in ONE store write
        (create_many), one lock instead of one per pod."""
        recs = self.make_pod_records(items)
        if not recs:
            return
        drop = (APIStatusError, AlreadyExistsError, ConflictError, OSError)
        create_many = getattr(self.store, "create_many", None)
        if create_many is not None:
            try:
                create_many(EVENTS, recs, move=True)
            except drop:
                pass   # fire-and-forget, as above
            return
        for rec in recs:   # remote transport: per-record creates,
            try:           # each isolated like the serial pod_event path
                self.store.create(EVENTS, rec, move=True)
            except drop:
                continue

    # convenience mirrors of the reference call sites
    def pod_event(self, pod, etype: str, reason: str, message: str) -> None:
        self.event("Pod", pod.key, etype, reason, message)
