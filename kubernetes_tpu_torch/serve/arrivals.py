"""Arrival generator — the hollow client feeding the serving pipeline.

Copied from the reference (`kubernetes_tpu.serve.arrivals`) with the
port's imports.

Creates pods against any Store surface (the verb is just
`create(PODS, pod)`, or `create_many` for a batch) at a target
arrival rate, batch-paced: each tick creates the number of pods the
elapsed wall time owes at `rate`, so a generator thread that loses the
GIL to the scheduler catches up instead of silently under-delivering.

Backpressure is honored exactly like a well-behaved client: a shed
create (`BackpressureError`, the 429 + Retry-After contract) books the
rejection and RE-QUEUES the arrival locally for after the server's
suggested backoff (with jitter) — arrivals are never silently dropped,
so the bench's all-admitted-or-429'd audit can account for every one.
Arrivals still pending re-admission when the run ends are reported as
`shed_final` (the client gave up, as a real client eventually would).
"""
from __future__ import annotations

import random
import time
from typing import Optional

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.api.types import Container, Pod
from kubernetes_tpu_torch.store.store import (AlreadyExistsError,
                                        BackpressureError, PODS)

MI = 1024 ** 2

INGEST_BATCH = obs.histogram(
    "arrival_ingest_batch_size",
    "Fresh arrivals per batched create_many flush (the round-17 ingest "
    "contract: one admission-gate evaluation + one ledger admission "
    "stamp per flush). Single-create fallbacks observe 1.",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))


def default_pod(name: str) -> Pod:
    """The density-shaped arrival pod (the headline bench's spec)."""
    return Pod(name=name, labels={"app": "serve"},
               containers=(Container.make(
                   name="c", requests={"cpu": 100, "memory": 500 * MI}),))


class ArrivalGenerator:
    """Paced pod creation with 429-aware retry (see module docstring).

    Drive it cooperatively: `tick()` creates whatever is due now and
    returns quickly, so a single-threaded serve bench interleaves
    arrivals with serve windows without thread scheduling noise — or
    call `run()` on a thread for wall-clock pacing. `seed` fixes the
    retry-jitter stream and the name sequence, so two generators fed the
    same accept/shed answers produce identical arrival sequences (the
    serve parity fuzz's requirement)."""

    def __init__(self, store, rate: float, total: Optional[int] = None,
                 pod_fn=default_pod, name_prefix: str = "arr-",
                 seed: int = 0, give_up_after: int = 64):
        self.store = store
        self.rate = float(rate)
        self.total = total            # None = unbounded (duration-paced)
        self.pod_fn = pod_fn
        self.name_prefix = name_prefix
        self.give_up_after = int(give_up_after)
        self._rng = random.Random(seed)
        self._seq = 0
        self._t0: Optional[float] = None
        self._owed = 0.0
        # locally re-queued sheds: (due_time, name, attempts)
        self._retry: list = []
        self.attempted = 0            # distinct arrivals tried at least once
        self.created = 0
        self.rejected = 0             # total 429 sheds (incl. retries)
        self.gave_up = 0              # arrivals dropped after give_up_after

    def _create(self, name: str, attempts: int, now: float) -> None:
        try:
            self.store.create(PODS, self.pod_fn(name))
            self.created += 1
        except BackpressureError as e:
            self._shed(name, attempts, now, e.retry_after)
        except AlreadyExistsError:
            # a retried create whose first attempt actually landed
            self.created += 1

    def _shed(self, name: str, attempts: int, now: float,
              retry_after: float) -> None:
        self.rejected += 1
        if attempts + 1 >= self.give_up_after:
            self.gave_up += 1
            return
        # capped jittered client backoff off the server's suggestion
        delay = min(retry_after, 5.0) * (0.5 + self._rng.random())
        self._retry.append((now + delay, name, attempts + 1))

    def _create_batch(self, names: list, now: float) -> None:
        """Fresh arrivals ride ONE create_many: one admission-gate
        evaluation + one batched ledger admission stamp server-side (the
        round-17 ingest contract). A partial shed (429 with `accepted`)
        books the landed prefix and re-queues the shed tail with the
        usual jittered backoff — never silently dropped. Fresh names are
        unique by construction, so the batch can't AlreadyExists.
        Retries keep the per-pod path (a retry whose first attempt landed
        must resolve individually)."""
        pods = [self.pod_fn(nm) for nm in names]
        try:
            self.store.create_many(PODS, pods)
            self.created += len(pods)
        except BackpressureError as e:
            k = max(0, min(int(getattr(e, "accepted", 0)), len(pods)))
            self.created += k
            for nm in names[k:]:
                self._shed(nm, 0, now, e.retry_after)

    def _retry_batch(self, due: list, now: float) -> None:
        try:
            self.store.create_many(
                PODS, [self.pod_fn(name) for _t, name, _a in due])
            self.created += len(due)
        except BackpressureError as e:
            k = max(0, min(int(getattr(e, "accepted", 0)), len(due)))
            self.created += k
            for _t, name, attempts in due[k:]:
                self._shed(name, attempts, now, e.retry_after)
        except AlreadyExistsError:
            # some retry's first attempt landed after all (lossy
            # transport): resolve the chunk per-pod — creates that
            # landed in the raising batch re-resolve as AlreadyExists
            # -> counted created, exactly the per-pod contract
            for _t, name, attempts in due:
                self._create(name, attempts, now)

    def tick(self, now: Optional[float] = None) -> int:
        """Create every arrival due by `now` (fresh ones owed by the rate
        plus re-queued sheds whose backoff expired). Returns creates
        attempted this tick."""
        now = time.perf_counter() if now is None else now
        if self._t0 is None:
            self._t0 = now
        n = 0
        # re-admissions first: they arrived earlier and queue earlier.
        # Batched like fresh arrivals (one gate evaluation per flush) —
        # under sustained overload the retry pool is the DOMINANT create
        # source, and per-pod retries were hammering the admission
        # surface with six figures of creates/s. A retry whose first
        # attempt actually landed (AlreadyExists) is only possible over
        # a lossy transport; that chunk falls back to per-pod creates,
        # which resolve it exactly as before.
        due = [r for r in self._retry if r[0] <= now]
        if due:
            self._retry = [r for r in self._retry if r[0] > now]
            due.sort()
            n += len(due)
            if len(due) > 1 and hasattr(self.store, "create_many"):
                self._retry_batch(due, now)
            else:
                for _t, name, attempts in due:
                    self._create(name, attempts, now)
        self._owed += (now - self._t0) * self.rate
        self._t0 = now
        fresh = int(self._owed)
        if self.total is not None:
            fresh = min(fresh, self.total - self.attempted)
        self._owed -= fresh
        fresh = max(0, fresh)
        if fresh:
            names = []
            for _ in range(fresh):
                names.append(f"{self.name_prefix}{self._seq}")
                self._seq += 1
            self.attempted += fresh
            n += fresh
            INGEST_BATCH.observe(fresh)
            if fresh > 1 and hasattr(self.store, "create_many"):
                self._create_batch(names, now)
            else:
                for name in names:
                    self._create(name, 0, now)
        return n

    def finished(self) -> bool:
        return (self.total is not None and self.attempted >= self.total
                and not self._retry)

    def flush_retries(self, timeout: float = 30.0) -> None:
        """Drive pending re-admissions to an outcome (created or given
        up) — the post-run settlement the audit runs after."""
        deadline = time.perf_counter() + timeout
        while self._retry and time.perf_counter() < deadline:
            nxt = min(t for t, _n, _a in self._retry)
            time.sleep(max(0.0, min(nxt - time.perf_counter(), 0.05)))
            self.tick()

    def run(self, duration: float, stop=None) -> None:
        """Wall-clock pacing loop (thread entry): tick until `duration`
        elapses (or `stop()` is true), sleeping between ticks."""
        end = time.perf_counter() + duration
        while time.perf_counter() < end:
            if stop is not None and stop():
                return
            self.tick()
            if self.finished():
                return
            time.sleep(min(0.002, 1.0 / max(self.rate, 1.0)))

    def stats(self) -> dict:
        return {
            "attempted": self.attempted,
            "created": self.created,
            "rejected_429": self.rejected,
            "gave_up": self.gave_up,
            "pending_retry": len(self._retry),
        }
