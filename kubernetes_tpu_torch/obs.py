"""Plain integer counters for the port's device pipeline.

One flat table of named counts. Names are dotted by family:
  dispatch.<op>   device program dispatches (upload, scatter, cycle,
                  burst_uniform, burst_scan, burst_fused, vic_upload,
                  vic_scatter, preempt_scan, pressure_batch)
  fetch.<op>      device-to-host copies (one per launch, never per pod)
  launch.<kernel> hand-kernel launches, booked by each kernel's wrapper at
                  the launch and nowhere else
  refusal.<reason> whole-burst refusals (the shell runs those pods serially)
  twin.<reason>   serial cycles decided on the host twin
                  (gang-locality-serial, nominated-ghosts: the reference's
                  ORACLE_FALLBACKS labels)
  gather.<op>     mesh mode: bytes of the all-gather (cycle,
                  burst_uniform, burst_scan, burst_segments, pressure,
                  preempt), every
                  shard's record in every distinct device's buffer
                  (written in place or copied); the counterpart of the
                  JAX package's tpu_ici_allgather_bytes_total, which
                  books a model
  copies.<op>     mesh mode: the record copies the all-gather of a scan
                  or fused window or pressure wave enqueued (burst_scan,
                  burst_segments, pressure): only the rows of shards on
                  other devices
  passes.burst_uniform, syncs.burst_uniform  mesh mode: the sharded
                  burst's passes and its host reads of the pass counter
  steps.burst_scan, steps.burst_segments, steps.pressure  mesh mode:
                  the steps the sharded scan, fused window and pressure
                  wave enqueued (one per live pod, one per pod)
  encoder.*, pod_rows.*  host mirror, victim table and row-cache
                  maintenance
  profile.unknown, profile.scheduled.<profile>  pods no scheduling
                  profile claims (once per uid), pods each profile
                  scheduled
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
