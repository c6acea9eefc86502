"""ServeLoop — the continuously-fed scheduler (arrival-driven mode).

Copied from the reference (`kubernetes_tpu.serve.loop`) with the port's
imports. It wraps the port's scheduler shell, whose algorithm is a
TorchScheduler on the card (or on the CPU when the shell was given
`device="cpu"`). Nothing here catches an error of a window: a CUDA error
of a launch or a copy stops the run.

A drain loop pops until the queue is empty and stops; a serving scheduler
never stops. ServeLoop wraps a `Scheduler` and, per tick, pumps the
informers (admission flows in over the store's watches WHILE the device
executes) and cuts one launch-queue's worth of drain windows from the
live activeQ:

    step():  pump -> schedule_burst(max_pods = window_size * depth)

The shell's burst machinery is reused UNCHANGED — gang gathering, fused
segments, wave commits, refusal/rewind, node-death tolerance — so every
window's decisions keep the shell's parity with the serial oracle.

Window pipelining: the loop sets the algorithm's `launch_cap` to
`window_size` and `launch_depth` to `depth`, so a drain above one window
chunks into window-sized launches of which up to `depth` are in flight —
while window k's decisions commit, windows k+1..k+depth-1 are already
encoded and launched, each with its device-to-host copy started. Each
window stays ONE launch + ONE packed fetch, and the rewind contract
extends unchanged: a refused or failed window discards its in-flight
successors unfetched and replans from the packed-block boundaries.

Backpressure closes the loop: `attach_gate` installs a
`BackpressureGate` keyed on this loop's live activeQ depth and in-flight
window count as the store's admission gate, so arrivals beyond what the
device sustains are shed with 429 + Retry-After instead of eating the
startup SLO in queue wait.
"""
from __future__ import annotations

import time
from typing import Optional

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.serve.backpressure import BackpressureGate

SERVE_WINDOWS = obs.counter(
    "serve_windows_total",
    "Serve-loop ticks, by outcome: scheduled (the window bound pods), "
    "empty (the activeQ had nothing ready — the device idled this "
    "tick).", ("outcome",))
SERVE_PODS = obs.counter(
    "serve_pods_scheduled_total",
    "Pods bound by the serve loop's windows.")


class ServeLoop:
    """Arrival-driven serving over one Scheduler (see module docstring).

    `window_size` is the commit/failure granularity (one launch window);
    `depth` is the launch-queue depth — windows in flight while the
    oldest commits. `tick_interval` paces idle ticks only: a tick that
    found work immediately cuts the next window (a saturated serve loop
    is a busy loop, exactly like the drain benches)."""

    def __init__(self, scheduler, window_size: int = 2048,
                 depth: int = 3, tick_interval: float = 0.002):
        self.sched = scheduler
        self.window_size = int(window_size)
        self.depth = max(1, int(depth))
        self.tick_interval = float(tick_interval)
        self.windows_cut = 0
        self.pods_bound = 0
        self.idle_ticks = 0
        self.gate: Optional[BackpressureGate] = None
        # in-flight launch windows for the gate: the algorithm's driver
        # owns the real count; between steps it is 0
        algo = scheduler.algorithm
        if hasattr(algo, "launch_depth"):
            algo.launch_depth = self.depth
        if hasattr(algo, "launch_cap"):
            algo.launch_cap = self.window_size
        if hasattr(algo, "wave_size"):
            # commit windows align with launch windows: one commit wave
            # per window keeps the failure granularity one window
            algo.wave_size = min(int(algo.wave_size), self.window_size)

    # -- backpressure wiring -------------------------------------------------
    def inflight_windows(self) -> int:
        """Launch windows planned/dispatched but not fully committed —
        the N-deep launch queue's live occupancy (0 between steps)."""
        return int(getattr(self.sched.algorithm, "inflight_launches", 0))

    def attach_gate(self, max_depth: int,
                    max_inflight: Optional[int] = None,
                    retry_after_base: float = 0.05,
                    retry_after_max: float = 2.0) -> BackpressureGate:
        """Install a BackpressureGate keyed on THIS loop's queue depth and
        launch-queue occupancy as the scheduler store's admission gate
        (`Store.admission_gate`).

        Depth = activeQ + the pod informer's unpumped watch backlog: the
        activeQ alone lags creates by one pump, so a burst of arrivals
        between pumps would pass a stale watermark unobserved. The
        backlog counts every undelivered pod event (binds included), so
        under churn the gate errs toward shedding — flow control, not an
        invariant."""
        from kubernetes_tpu_torch.store.store import PODS
        pods_inf = self.sched.informers.informer(PODS)
        queue = self.sched.queue

        def depth() -> int:
            return queue.active_depth() + pods_inf.backlog()

        gate = BackpressureGate(
            depth, max_depth=max_depth,
            inflight_fn=self.inflight_windows,
            max_inflight=(max_inflight if max_inflight is not None
                          else 4 * self.depth),
            retry_after_base=retry_after_base,
            retry_after_max=retry_after_max)
        self.gate = gate
        store = self.sched.store
        if hasattr(store, "admission_gate"):
            store.admission_gate = gate
        return gate

    # -- the loop ------------------------------------------------------------
    def step(self) -> int:
        """One serve tick: deliver pending watch events, then cut up to
        `depth` launch windows from the live activeQ. Returns pods bound
        this tick."""
        self.sched.pump()
        bound = self.sched.schedule_burst(
            max_pods=self.window_size * self.depth)
        if bound > 0:
            self.windows_cut += 1
            self.pods_bound += bound
            SERVE_WINDOWS.labels("scheduled").inc()
            SERVE_PODS.inc(bound)
        else:
            self.idle_ticks += 1
            SERVE_WINDOWS.labels("empty").inc()
        return bound

    def run(self, duration: Optional[float] = None,
            until=None) -> dict:
        """Serve for `duration` seconds (or until `until()` is true);
        idle ticks sleep `tick_interval` so an empty queue doesn't spin
        the informer pump. Returns the loop's stats snapshot."""
        deadline = (None if duration is None
                    else time.perf_counter() + duration)
        while True:
            if until is not None and until():
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if self.step() == 0:
                time.sleep(self.tick_interval)
        return self.stats()

    def drain(self, timeout: float = 60.0) -> int:
        """Post-run drain: serve until the queue stays empty (arrivals
        stopped). Returns pods bound during the drain."""
        bound = 0
        deadline = time.perf_counter() + timeout
        idle = 0
        while time.perf_counter() < deadline:
            n = self.step()
            bound += n
            if n == 0:
                idle += 1
                if idle >= 3 and self.sched.queue.num_pending() == 0:
                    break
                time.sleep(self.tick_interval)
            else:
                idle = 0
        return bound

    def stats(self) -> dict:
        return {
            "windows_cut": self.windows_cut,
            "pods_bound": self.pods_bound,
            "idle_ticks": self.idle_ticks,
            "window_size": self.window_size,
            "depth": self.depth,
            "gate": (self.gate.debug_state()
                     if self.gate is not None else None),
        }
