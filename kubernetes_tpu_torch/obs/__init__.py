"""kubernetes_tpu_torch.obs — the port's observability layer.

Two parts. First, the plain integer counters of the port's device
pipeline (`COUNTS`, `inc`, `get`, `family`, `reset`): one flat table of
named counts, dotted by family:
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

Second, the copies of the reference's metric families that the scheduler
shell, the store, the informers, the queue and the breaker register
(`kubernetes_tpu.obs`): one process-global `Registry` with get-or-create
`counter()` / `gauge()` / `histogram()`, the `/debug/sched` section
registry, the span ring (`obs.trace`) and the per-pod latency ledger
(`obs.ledger`), the burst flight recorder (`obs.flight`), the process
self-metrics (`obs.procmetrics`) and the time-series scraper with its
verdict engine (`obs.timeseries`).
"""
from __future__ import annotations

import threading
from collections import Counter as _Tally

from kubernetes_tpu_torch.obs.registry import (   # noqa: F401
    Counter, Gauge, Histogram, MetricFamily, Registry,
    DEFAULT_BUCKETS, MICRO_BUCKETS, LATENCY_BUCKETS,
    escape_help, escape_label_value, format_value,
)
from kubernetes_tpu_torch.obs import trace        # noqa: F401

COUNTS: _Tally = _Tally()
#: the counts are shared by every thread of the process (a fleet runs its
#: instances on threads of their own): a read-modify-write holds the lock
_COUNTS_LOCK = threading.Lock()


def inc(name: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        COUNTS[name] += int(n)


def get(name: str) -> int:
    return COUNTS[name]


def family(prefix: str) -> dict[str, int]:
    """Every count under `prefix.`, keyed by the rest of the name."""
    p = prefix + "."
    with _COUNTS_LOCK:
        return {k[len(p):]: v for k, v in COUNTS.items()
                if k.startswith(p)}


def reset(prefix: str = "") -> None:
    """Zero every count whose name starts with `prefix` (all by default)."""
    with _COUNTS_LOCK:
        for k in [k for k in COUNTS if k.startswith(prefix)]:
            del COUNTS[k]


#: the process-global registry every component wires into
REGISTRY = Registry()


def counter(name, help, labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help, labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help, labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render_global() -> str:
    """One scrape of the global registry (every registered component)."""
    return REGISTRY.render()


# -- debug introspection registry (the /debug/sched surface) -----------------
# Components register named snapshot callables; `debug_snapshot` collects
# every section into one document. A raising section reports its error
# instead of failing the whole snapshot.
_DEBUG_SOURCES: dict = {}


def register_debug(name: str, fn) -> None:
    """Register (or replace — latest wins) a named debug section."""
    _DEBUG_SOURCES[name] = fn


def unregister_debug(name: str) -> None:
    _DEBUG_SOURCES.pop(name, None)


def debug_snapshot() -> dict:
    out = {}
    for name, fn in list(_DEBUG_SOURCES.items()):
        try:
            snap = fn()
        except Exception as e:     # a broken section must not fail the rest
            out[name] = {"error": repr(e)}
            continue
        if snap is not None:
            out[name] = snap
    return out


# the trace ring's overflow counter registers lazily from trace.py (it
# cannot import this package at its own import time); declare it eagerly
# here so the family is always present in the exposition
counter("obs_trace_dropped_total",
        "Spans dropped from the trace ring buffer on overflow (the "
        "ring keeps the newest spans).")

# imported LAST: these modules register families against REGISTRY above.
# procmetrics registers the process self-metrics (RSS/fds/threads/gc
# pauses) EAGERLY so the time-series scraper sees them from sample 0;
# timeseries hangs the scraper + verdict engine off the same registry.
from kubernetes_tpu_torch.obs import ledger       # noqa: F401,E402
from kubernetes_tpu_torch.obs import procmetrics  # noqa: F401,E402
from kubernetes_tpu_torch.obs import timeseries   # noqa: F401,E402
