"""Explicit backpressure for the serving mode — admission shed with 429.

Copied from the reference (`kubernetes_tpu.serve.backpressure`) with the
port's imports.

Real apiservers shed load instead of queueing unboundedly (priority &
fairness, the eviction subresource's 429 + Retry-After); this module is
that contract for the serving pipeline. A `BackpressureGate` attaches to
the store's pod-create path (`Store.admission_gate`; an apiserver in front
of it would map the refusal to HTTP 429 with Retry-After) and sheds
creates when either watermark is exceeded:

- activeQ depth: pending pods the scheduler has not popped yet — the
  direct measure of queue wait eating the startup SLO;
- in-flight launch windows: windows planned/dispatched but not yet
  committed (the N-deep launch queue's occupancy), so a stalled device
  sheds instead of stacking encoded windows.

The suggested Retry-After scales with how far over the watermark the
queue is (a deeper queue needs a longer back-off to drain), bounded by
`retry_after_max`. Shedding is observable: `admission_rejected_total
{reason}` counts sheds by cause and the `serve_activeq_depth` /
`serve_inflight_windows` gauges read the live values at scrape time.

Rejection evicts the pod's lifecycle-ledger record (the round-16 bugfix):
first-stamp-wins would otherwise carry a shed attempt's stamp into the
readmitted pod and bill the client's backoff as startup latency.
"""
from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch import chaos, obs
from kubernetes_tpu_torch.store.store import BackpressureError

ADMISSION_REJECTED = obs.counter(
    "admission_rejected_total",
    "Pod creates shed by the serving backpressure gate, by reason: "
    "queue-depth (activeQ over the watermark), inflight-windows (the "
    "launch queue is full), injected (the chaos serve.shed seam fired). "
    "Every shed answered 429 + Retry-After; the write never landed.",
    ("reason",))

_ACTIVEQ_DEPTH = obs.gauge(
    "serve_activeq_depth",
    "Live activeQ depth the serving admission gate keys on (the most "
    "recently attached gate wins the gauge).")
_INFLIGHT_WINDOWS = obs.gauge(
    "serve_inflight_windows",
    "Launch windows planned/dispatched but not yet fully committed "
    "(N-deep launch-queue occupancy), as seen by the most recently "
    "attached serving gate.")
_SHED_STATE = obs.gauge(
    "serve_backpressure_active",
    "1 while the most recently attached serving gate is shedding "
    "(activeQ depth at/over the watermark), else 0.")


class BackpressureGate:
    """Admission gate keyed on activeQ depth and in-flight windows.

    `depth_fn` returns the live activeQ depth (the scheduler queue's
    `active_depth`); `inflight_fn` (optional) returns the launch queue's
    in-flight window count (the ServeLoop wires its own). `admit(pod)`
    raises `BackpressureError` carrying the suggested Retry-After, after
    evicting the pod's ledger record; it is called by `Store.create`
    under no store lock (the gate reads are lock-free snapshots — an
    admit racing a pop may let one extra pod in, which the NEXT create
    sheds; watermarks are flow control, not invariants)."""

    def __init__(self, depth_fn: Callable[[], int],
                 max_depth: int = 50_000,
                 inflight_fn: Optional[Callable[[], int]] = None,
                 max_inflight: Optional[int] = None,
                 retry_after_base: float = 0.05,
                 retry_after_max: float = 2.0):
        self.depth_fn = depth_fn
        self.max_depth = int(max_depth)
        self.inflight_fn = inflight_fn
        self.max_inflight = max_inflight
        self.retry_after_base = float(retry_after_base)
        self.retry_after_max = float(retry_after_max)
        self.rejected = 0          # total sheds through THIS gate
        self.admitted = 0
        _ACTIVEQ_DEPTH.set_function(lambda: float(self.depth_fn()))
        _INFLIGHT_WINDOWS.set_function(
            lambda: float(self.inflight_fn() if self.inflight_fn else 0))
        _SHED_STATE.set_function(
            lambda: 1.0 if self.depth_fn() >= self.max_depth else 0.0)

    def suggest_retry_after(self, depth: int) -> float:
        """Backoff suggestion scaled by overload: at the watermark the
        base applies; k watermarks deep suggests ~k x base (a deeper
        queue needs proportionally longer to drain), capped."""
        over = max(1.0, depth / max(self.max_depth, 1))
        return min(self.retry_after_max, self.retry_after_base * over)

    def _shed(self, pod, reason: str, message: str) -> None:
        self.rejected += 1
        ADMISSION_REJECTED.labels(reason).inc()
        # the round-16 ledger bugfix: a shed pod's record must not
        # survive into its readmitted life with the stale first stamp
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        LEDGER.evict(pod.key)
        raise BackpressureError(
            message, retry_after=self.suggest_retry_after(self.depth_fn()))

    def admit(self, pod) -> None:
        """Raise BackpressureError to shed `pod`'s create; return to
        admit. Checked at the store's admission surface BEFORE
        anything is written."""
        if chaos.take("serve.shed"):
            self._shed(pod, "injected",
                       f"{pod.key}: chaos-injected admission shed")
        depth = self.depth_fn()
        if depth >= self.max_depth:
            self._shed(pod, "queue-depth",
                       f"{pod.key}: activeQ depth {depth} >= "
                       f"watermark {self.max_depth}")
        if self.max_inflight is not None and self.inflight_fn is not None:
            inflight = self.inflight_fn()
            if inflight >= self.max_inflight:
                self._shed(pod, "inflight-windows",
                           f"{pod.key}: {inflight} launch windows in "
                           f"flight >= cap {self.max_inflight}")
        self.admitted += 1

    def admit_many(self, pods) -> tuple:
        """ONE gate evaluation for a whole create_many batch: returns
        (n_admitted, retry_after) where pods[:n_admitted] are admitted
        and the TAIL is shed (retry_after is None when nothing shed).

        Semantics mirror per-pod admits exactly: each serial create
        grows the informer backlog by one before the next gate read, so
        pod i of the batch is evaluated against depth base+i — the depth
        watermark therefore sheds a TAIL, never a middle. The in-flight
        window count cannot change mid-batch (no window dispatches inside
        a store create), so it is read once; a chaos serve.shed draw mid-
        batch sheds from that pod on (flow control errs toward shedding —
        the seam is an opt-in chaos path, and shed arrivals re-admit).
        Ledger records of shed pods are evicted in one batch, exactly
        like the per-pod _shed path."""
        n = len(pods)
        base = self.depth_fn()
        accepted = 0
        reason = None
        if self.max_inflight is not None and self.inflight_fn is not None \
                and self.inflight_fn() >= self.max_inflight:
            reason = "inflight-windows"
        else:
            for pod in pods:
                if chaos.take("serve.shed"):
                    reason = "injected"
                    break
                if base + accepted >= self.max_depth:
                    reason = "queue-depth"
                    break
                accepted += 1
        self.admitted += accepted
        if accepted == n:
            return n, None
        shed = pods[accepted:]
        self.rejected += len(shed)
        ADMISSION_REJECTED.labels(reason).inc(len(shed))
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        LEDGER.evict_many([p.key for p in shed])
        return accepted, self.suggest_retry_after(base + accepted)

    def debug_state(self) -> dict:
        return {
            "max_depth": self.max_depth,
            "max_inflight": self.max_inflight,
            "depth": int(self.depth_fn()),
            "inflight": (int(self.inflight_fn())
                         if self.inflight_fn is not None else None),
            "admitted": self.admitted,
            "rejected": self.rejected,
        }


def fleet_gate(loops, max_depth: int,
               retry_after_base: float = 0.25,
               retry_after_max: float = 2.0) -> BackpressureGate:
    """One admission gate for an active-active fleet sharing a store
    (round 18): the store has a single `admission_gate` hook, but N
    serve loops each own a queue. The gate keys on the LEAST-loaded
    instance's depth (a create is shed only when every member is over
    the watermark — the pod's namespace-hash owner may well be the idle
    one) and the SUM of in-flight launch windows (device pressure is a
    fleet-wide resource). Attach the returned gate to
    `store.admission_gate` yourself — the fleet bench owns that wiring."""
    from kubernetes_tpu_torch.store.store import PODS as _PODS
    informers = [loop.sched.informers.informer(_PODS) for loop in loops]

    def depth() -> int:
        depths = [loop.sched.queue.active_depth() + inf.backlog()
                  for loop, inf in zip(loops, informers)]
        return min(depths) if depths else 0

    def inflight() -> int:
        return sum(loop.inflight_windows() for loop in loops)

    return BackpressureGate(
        depth, max_depth=max_depth, inflight_fn=inflight,
        max_inflight=4 * sum(max(1, loop.depth) for loop in loops),
        retry_after_base=retry_after_base,
        retry_after_max=retry_after_max)
