"""Injectable clock — deterministic time for cache TTLs and queue backoff.

Mirrors the role of k8s.io/utils/clock in the reference (cache expiry and
backoff tests inject time; see cache.go:300 finishBinding(pod, now)).

Copied from the reference with the port's imports:
`kubernetes_tpu.utils.clock`.
"""
from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Settable clock; sleep() advances it (no blocking)."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def set(self, t: float) -> None:
        with self._lock:
            self._now = t
