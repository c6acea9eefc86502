"""Step tracing — the utiltrace analog.

Mirrors k8s.io/utils/trace as used in the hot path
(core/generic_scheduler.go:185-246): named steps with timestamps, logged
only when the whole operation exceeds a threshold (the scheduler uses
100ms per cycle). Copied from the reference (`kubernetes_tpu.utils.tracing`);
its device `Profiler` (a jax.profiler trace) has no copy here.
"""
from __future__ import annotations

import logging
import time

log = logging.getLogger("kubernetes_tpu_torch")

SLOW_CYCLE_THRESHOLD = 0.1  # 100ms (generic_scheduler.go:186)


class Trace:
    def __init__(self, name: str, threshold: float = SLOW_CYCLE_THRESHOLD):
        self.name = name
        self.threshold = threshold
        self.start = time.perf_counter()
        self.steps: list[tuple[str, float]] = []

    def step(self, msg: str) -> None:
        self.steps.append((msg, time.perf_counter()))

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def log_if_long(self) -> bool:
        """Emit the step timeline when the operation was slow. Returns
        whether it logged."""
        total = self.elapsed()
        if total < self.threshold:
            return False
        lines = [f"Trace {self.name!r} (total {total * 1000:.1f}ms):"]
        prev = self.start
        for msg, t in self.steps:
            lines.append(f"  +{(t - prev) * 1000:.1f}ms {msg}")
            prev = t
        log.warning("\n".join(lines))
        return True

    def emit_spans(self, cat: str = "trace") -> None:
        """Fold the step timeline into the obs span ring: one parent span
        for the whole operation plus one child per step slice, so a slow
        cycle's breakdown shows up in /debug/traces and bench --trace
        output, not only in the log."""
        from kubernetes_tpu_torch.obs import trace as obs_trace
        end = time.perf_counter()
        obs_trace.add_span(self.name, self.start, end, cat=cat)
        prev = self.start
        for msg, t in self.steps:
            obs_trace.add_span(f"{self.name}: {msg}", prev, t, cat=cat,
                               args={"parent": self.name})
            prev = t
