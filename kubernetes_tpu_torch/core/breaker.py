"""Device circuit breaker — degrade to the host oracle, never to wrong
decisions.

A device fails in bursts: one failed launch is usually followed by more,
and every failed launch costs a round trip before the caller learns
anything. The breaker gives the device drivers the standard
three-state contract (closed -> open -> half-open), tuned for the repo's
parity posture: every degraded path (whole-burst refusal -> serial loop,
serial cycle -> host twin, preemption -> oracle Preemptor) is already
bit-identical to the device path, so tripping the breaker changes
THROUGHPUT only — the parity fuzzes run green with the fault plane
injecting at every device seam.

- closed: device path allowed; consecutive faults count.
- open (tripped after `fault_threshold` consecutive faults): every device
  gate (`allow_device`) refuses — bursts refuse up front (the shell runs
  the serial loop on the host twin), serial cycles pick the twin.
- half-open: after `probe_after` refused gates, ONE probe launch is
  allowed through; success re-closes, a fault re-opens (and the refusal
  counter restarts).

State is published on `tpu_device_circuit_state` (0 closed / 1 half-open /
2 open) and every recorded fault on `tpu_device_faults_total{seam}`.

Copied from the reference with the port's imports:
`kubernetes_tpu.core.breaker`.
"""
from __future__ import annotations

import threading

from kubernetes_tpu_torch import obs

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}

CIRCUIT_STATE = obs.gauge(
    "tpu_device_circuit_state",
    "Device circuit breaker state: 0 closed (device path live), 1 "
    "half-open (one probe in flight), 2 open (host-only mode — every "
    "decision rides the oracle twin until a probe succeeds).")
DEVICE_FAULTS = obs.counter(
    "tpu_device_faults_total",
    "Device-path faults absorbed by the circuit breaker, by seam "
    "(device.dispatch / device.fetch, plus device.runtime for faults the "
    "chaos plane did not inject). Every fault degraded a burst or cycle "
    "to the serial oracle path; none changed a decision.", ("seam",))


class DeviceCircuitBreaker:
    def __init__(self, fault_threshold: int = 3, probe_after: int = 16):
        self.fault_threshold = int(fault_threshold)
        self.probe_after = int(probe_after)
        self._state = CLOSED
        self._consecutive = 0
        self._denied = 0
        self._lock = threading.Lock()
        self.faults_total = 0
        self.trips_total = 0
        self.promotions_total = 0
        CIRCUIT_STATE.set(CLOSED)

    # -- gates ---------------------------------------------------------------
    def allow_device(self) -> bool:
        """One device-path gate. Closed: allow. Open: refuse, counting
        refusals toward the half-open probe window. Half-open: allow (the
        probe — the next record_fault/record_success resolves it)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                return True
            self._denied += 1
            if self._denied >= self.probe_after:
                self._set(HALF_OPEN)
                return True
            return False

    # -- outcomes ------------------------------------------------------------
    def record_fault(self, seam: str = "device.runtime") -> None:
        DEVICE_FAULTS.labels(seam).inc()
        with self._lock:
            self.faults_total += 1
            self._consecutive += 1
            if self._state == HALF_OPEN \
                    or self._consecutive >= self.fault_threshold:
                if self._state != OPEN:
                    self.trips_total += 1
                self._denied = 0
                self._set(OPEN)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self.promotions_total += 1
                self._set(CLOSED)

    def _set(self, state: int) -> None:
        self._state = state
        CIRCUIT_STATE.set(state)

    # -- introspection -------------------------------------------------------
    @property
    def state(self) -> str:
        return _STATE_NAMES[self._state]

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "state": _STATE_NAMES[self._state],
                "consecutive_faults": self._consecutive,
                "faults_total": self.faults_total,
                "trips_total": self.trips_total,
                "promotions_total": self.promotions_total,
                "denied_since_trip": self._denied,
                "fault_threshold": self.fault_threshold,
                "probe_after": self.probe_after,
            }
