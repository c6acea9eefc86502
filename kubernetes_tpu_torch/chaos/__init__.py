"""kubernetes_tpu_torch.chaos — seeded, deterministic fault-injection plane.

Copied from the reference (`kubernetes_tpu.chaos`), cut to the seams the
port's store and shell reach. What differs: the device circuit breaker
absorbs the injected DeviceFault only (`device_fault_types`; a real CUDA
error stops the run), an injection is not noted on a flight recorder (the
port has none yet), and the seams of modules the port does not have yet
(the native cores, the remote store, the serving gate, the fleet's
leases) and the jumping clock are left out.

The paper's claim is 50x throughput WITH identical binding decisions, and
that contract is only worth anything if it survives the failure modes a
sustained soak actually produces: tunnel hiccups mid-burst, store write
failures, slow watchers, and scheduler restarts.
This module is the single switchboard for injecting those failures
DETERMINISTICALLY (per-seam seeded RNG streams — trial N of a chaos sweep
always injects the same faults at the same call sites) so every
degradation path in the repo is testable, reproducible, and benchmarkable.

Named seams (each consumer calls `chaos.check(seam)` / `chaos.take(seam)`
at the exact point the real failure would surface):

- ``device.dispatch`` / ``device.fetch`` — the device driver raises a
  DeviceFault before a kernel launch / packed-block readback
  (core/torch_scheduler.py; the device circuit breaker consumes these).
- ``store.commit_wave`` — Store.commit_wave fails BEFORE the core write
  lands (the retry loop re-runs the wave).
- ``store.commit_wave.ambiguous`` — the wave LANDED but the "response" is
  lost; the retry must dedupe on the wave token, never double-land.
- ``store.fanout`` — watch fan-out delivery is deferred (delivered by the
  next flush or the next consumer poll; events are never lost).
- ``watch.drop`` — an embedded-store watch poll raises ExpiredError as if
  the consumer outran the log window (informer re-lists).
- ``sched.crash`` — a scheduler-crash seam for crash-restart tests: the
  consumer (tests) raises SchedulerCrash at a commit boundary and then
  exercises Scheduler.recover().
- ``node.dead`` — node churn at the WORST moments: the pipeline calls
  `node_dead_point(point)` at its churn-vulnerable crossings —
  ``dispatch-fetch`` / ``fetch-commit`` around every burst launch's
  packed fetch (a kill there is caught by the launch-level stale scan,
  which refuses the launch WHOLE and replans post-churn), ``pre-bind``
  inside the wave commit (caught by the per-wave stale filter:
  requeue-with-backoff), and ``pre-cycle`` before a serial cycle's
  decision (caught by the pre-decision reconciliation sweep). A firing
  seam invokes the harness-registered node hook (`set_node_hook`), which
  deletes a node from the store. Opt-in: blanket ``all=`` rates skip it
  (it needs a hook and — unlike every other seam — legitimately changes
  the post-churn world, so the churn parity harnesses drive the SAME
  kill schedule through their serial-oracle referee).

Configuration:
- programmatic: ``chaos.plan(seed=42, rates={"device.fetch": 0.1})`` or
  ``chaos.plan(seed=42, all_rate=0.05)``;
- environment: ``KTPU_CHAOS="seed=42,all=0.05,device.fetch=0.2,limit=100"``
  (comma/space-separated key=value; ``all`` sets every seam, named seams
  override, ``limit`` caps injections per seam).

Every injection is recorded on ``chaos_injections_total{seam}``, and the
active plan publishes a ``/debug/sched`` section — a chaos run's artifact trail
names exactly which faults fired where.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Optional

from kubernetes_tpu_torch import obs

#: every named injection seam (the fault plane's public surface; tests pin
#: this set so a new seam cannot land unnamed)
SEAMS = (
    "device.dispatch",
    "device.fetch",
    "store.commit_wave",
    "store.commit_wave.ambiguous",
    "store.update_many",
    "store.evict_many",
    "store.fanout",
    "watch.drop",
    "sched.crash",
    "node.dead",
)

#: seams a blanket `all=<rate>` never seeds: they need explicit opt-in
#: plumbing (a crash-driving harness, a node-kill hook)
OPT_IN_SEAMS = ("sched.crash", "node.dead",
                # batched-mutation seams (round 23): pre-land StoreFaults
                # at update_many / evict_many. Opt-in because the batched
                # verbs' callers (churn actors, the zone evictor) surface
                # the raise to their own tick loop — a blanket `all=`
                # plan must not start failing paths that round-13 chaos
                # runs never armed
                "store.update_many", "store.evict_many")

INJECTIONS = obs.counter(
    "chaos_injections_total",
    "Faults injected by the chaos plane, by seam. Zero outside chaos "
    "runs; in a chaos bench/sweep this is the denominator of every "
    "degraded-mode claim.", ("seam",))


class InjectedFault(Exception):
    """Base of every chaos-injected failure; `seam` names the injection
    point. Messages deliberately avoid the bench's transient-error markers
    so an injected fault is never silently retried by machinery that was
    not built to consume it."""

    def __init__(self, seam: str, message: Optional[str] = None):
        super().__init__(message or f"chaos: injected fault at seam {seam}")
        self.seam = seam


class DeviceFault(InjectedFault):
    """Device failure: raised at the dispatch/fetch seams; consumed by the
    device circuit breaker."""


class StoreFault(InjectedFault):
    """Store write failure (commit_wave seams)."""


class FanoutFault(InjectedFault):
    """Watch fan-out delivery failure (delivery deferred, never lost)."""


class SchedulerCrash(InjectedFault):
    """Scheduler process death stand-in (crash-restart tests raise it at a
    commit boundary, then drive Scheduler.recover())."""


_FAULT_FOR = {
    "device.dispatch": DeviceFault,
    "device.fetch": DeviceFault,
    "store.commit_wave": StoreFault,
    "store.commit_wave.ambiguous": StoreFault,
    "store.update_many": StoreFault,
    "store.evict_many": StoreFault,
    "store.fanout": FanoutFault,
    "watch.drop": InjectedFault,
    "sched.crash": SchedulerCrash,
    "node.dead": InjectedFault,
}


def device_fault_types() -> tuple:
    """Exception classes the device circuit breaker treats as a device
    fault: the injected DeviceFault only. A real CUDA error, a kernel that
    does not build, a planner's refusal or a wrong stamp stops the run, so
    a faulted card never hands its decisions to the host unseen."""
    return (DeviceFault,)


class ChaosPlan:
    """One deterministic injection schedule.

    Each seam draws from its OWN `random.Random(f"{seed}:{seam}")` stream,
    so injections at one seam never shift another seam's sequence — adding
    a new seam (or a consumer adding a call site) leaves every other
    seam's trial-N behavior bit-identical. `limit` bounds injections per
    seam (0 = unlimited); `limits` overrides it for named seams — the
    parity harnesses cap `store.commit_wave` BELOW the commit retry
    budget, because a wave whose every retry fails must re-queue its pods
    with backoff (correctness holds, bit-parity cannot)."""

    def __init__(self, seed: int = 0, rates: Optional[dict] = None,
                 limit: int = 0, limits: Optional[dict] = None):
        self.seed = int(seed)
        self.rates = {s: float(r) for s, r in (rates or {}).items()}
        self.limits = {s: int(n) for s, n in (limits or {}).items()}
        unknown = (set(self.rates) | set(self.limits)) - set(SEAMS)
        if unknown:
            raise ValueError(f"unknown chaos seams: {sorted(unknown)}")
        self.limit = int(limit)
        self._rng = {s: random.Random(f"{self.seed}:{s}") for s in SEAMS}
        self._fired: dict[str, int] = {}
        self._lock = threading.Lock()

    def should(self, seam: str) -> bool:
        """One deterministic draw for `seam`; records the injection when it
        fires. Never raises — `check()` maps firing seams to exceptions."""
        rate = self.rates.get(seam, 0.0)
        if rate <= 0.0:
            return False
        cap = self.limits.get(seam, self.limit)
        with self._lock:
            if cap and self._fired.get(seam, 0) >= cap:
                return False
            if self._rng[seam].random() >= rate:
                return False
            self._fired[seam] = self._fired.get(seam, 0) + 1
        INJECTIONS.labels(seam).inc()
        return True

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def describe(self) -> dict:
        return {"seed": self.seed, "rates": dict(self.rates),
                "limit": self.limit, "limits": dict(self.limits),
                "fired": self.counts()}


_PLAN: Optional[ChaosPlan] = None
_ENV_LOADED = False
_ENV_LOCK = threading.Lock()


def _parse_spec(spec: str) -> ChaosPlan:
    """KTPU_CHAOS grammar: comma/space-separated key=value pairs.
    `seed=<int>`, `limit=<int>` (per-seam injection cap), `all=<rate>`
    (every seam), any seam name as `<seam>=<rate>` (overrides `all`), and
    `limit.<seam>=<int>` (per-seam cap overriding `limit`)."""
    seed, limit, all_rate = 0, 0, None
    rates: dict[str, float] = {}
    limits: dict[str, int] = {}
    for tok in spec.replace(",", " ").split():
        if "=" not in tok:
            raise ValueError(f"KTPU_CHAOS: bad token {tok!r} (want k=v)")
        k, v = tok.split("=", 1)
        if k == "seed":
            seed = int(v)
        elif k == "limit":
            limit = int(v)
        elif k == "all":
            all_rate = float(v)
        elif k.startswith("limit.") and k[len("limit."):] in SEAMS:
            limits[k[len("limit."):]] = int(v)
        elif k in SEAMS:
            rates[k] = float(v)
        else:
            raise ValueError(f"KTPU_CHAOS: unknown seam {k!r}")
    if all_rate is not None:
        for s in SEAMS:
            # opt-in seams need dedicated plumbing; blanket rates skip them
            if s in OPT_IN_SEAMS:
                continue
            rates.setdefault(s, all_rate)
    return ChaosPlan(seed=seed, rates=rates, limit=limit, limits=limits)


def _load_env() -> None:
    global _PLAN, _ENV_LOADED
    with _ENV_LOCK:
        if _ENV_LOADED:
            return
        _ENV_LOADED = True
        spec = os.environ.get("KTPU_CHAOS")
        if spec:
            _PLAN = _parse_spec(spec)


def active() -> Optional[ChaosPlan]:
    """The installed plan (programmatic wins; else KTPU_CHAOS, parsed
    once). None = the fault plane is inert (the fast path: one global
    read per seam call)."""
    if not _ENV_LOADED:
        _load_env()
    return _PLAN


def plan(seed: int = 0, rates: Optional[dict] = None, limit: int = 0,
         all_rate: Optional[float] = None,
         limits: Optional[dict] = None) -> ChaosPlan:
    """Install a deterministic injection plan (replaces any active one).
    `all_rate` seeds every seam except the opt-in ones;
    explicit `rates` entries override it. `limits` caps injections for
    named seams (overriding the blanket `limit`)."""
    global _PLAN, _ENV_LOADED
    merged = dict(rates or {})
    if all_rate is not None:
        for s in SEAMS:
            if s in OPT_IN_SEAMS:
                continue
            merged.setdefault(s, all_rate)
    _ENV_LOADED = True          # programmatic plan overrides the env
    _PLAN = ChaosPlan(seed=seed, rates=merged, limit=limit, limits=limits)
    return _PLAN


def disable() -> None:
    """Remove the active plan (and suppress KTPU_CHAOS re-parsing); the
    node-death hook is cleared too — it is plan-scoped harness plumbing."""
    global _PLAN, _ENV_LOADED, _NODE_HOOK
    _ENV_LOADED = True
    _PLAN = None
    _NODE_HOOK = None


def take(seam: str) -> bool:
    """True when the seam fires this call (recorded); the caller raises
    its own native exception type (e.g. the store's ExpiredError)."""
    p = active()
    return p is not None and p.should(seam)


def check(seam: str) -> None:
    """Raise the seam's mapped fault when the plan fires it; no-op (one
    global read) when the plane is inert."""
    p = active()
    if p is not None and p.should(seam):
        raise _FAULT_FOR[seam](seam)


def counts() -> dict[str, int]:
    p = active()
    return p.counts() if p is not None else {}


# -- node.dead: churn at the worst moments -----------------------------------
_NODE_HOOK = None


def set_node_hook(fn) -> None:
    """Install the node-death hook (None to clear): `fn(point)` is called
    when the node.dead seam fires at a pipeline point ("dispatch-fetch"
    or "fetch-commit") and performs the actual store deletion. The hook
    owns victim choice and any pending-kill bookkeeping — the seam only
    supplies deterministic timing."""
    global _NODE_HOOK
    _NODE_HOOK = fn


def node_dead_point(point: str) -> None:
    """Called by the pipeline at its node-churn-vulnerable moments
    (dispatch-fetch / fetch-commit / pre-bind / pre-cycle). Inert (one
    global read) without a hook AND a plan rating the seam — the hot
    path cost matches every other seam."""
    hook = _NODE_HOOK
    if hook is None:
        return
    p = active()
    if p is None or p.rates.get("node.dead", 0.0) <= 0.0:
        return
    if p.should("node.dead"):
        hook(point)


def _debug_section():
    p = active()
    return p.describe() if p is not None else None


obs.register_debug("chaos", _debug_section)
