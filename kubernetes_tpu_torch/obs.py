"""Plain integer counters for the port's device pipeline.

One flat table of named counts. Names are dotted by family:
  dispatch.<op>   device program dispatches (upload, scatter, cycle,
                  burst_uniform, burst_scan, burst_fused, vic_upload,
                  vic_scatter, preempt_scan, pressure_batch)
  fetch.<op>      device-to-host copies (one per launch, never per pod)
  launch.<kernel> hand-kernel launches, booked by each kernel's wrapper at
                  the launch and nowhere else
  refusal.<reason> whole-burst refusals (the shell runs those pods serially)
  encoder.*, pod_rows.*  host mirror, victim table and row-cache
                  maintenance
"""
from __future__ import annotations

from collections import Counter

COUNTS: Counter = Counter()


def inc(name: str, n: int = 1) -> None:
    COUNTS[name] += int(n)


def get(name: str) -> int:
    return COUNTS[name]


def family(prefix: str) -> dict[str, int]:
    """Every count under `prefix.`, keyed by the rest of the name."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in COUNTS.items() if k.startswith(p)}


def reset(prefix: str = "") -> None:
    """Zero every count whose name starts with `prefix` (all by default)."""
    for k in [k for k in COUNTS if k.startswith(prefix)]:
        del COUNTS[k]
