"""Scheduler metrics exposition — pkg/scheduler/metrics/metrics.go analog.

Renders the scheduler's counters and queue gauges in Prometheus text
exposition format (the /metrics endpoint payload, server.go:284-295),
built on the shared obs registry (kubernetes_tpu_torch/obs) instead of a
hand-rolled string renderer — label values are escaped per the text
format, and the family set is lintable.

The scheduler's live counters stay in SchedulerMetrics (scheduler.py);
each scrape snapshots them into a fresh Registry so concurrent scrapes
and resets never tear a family mid-render. The metric names mirror the
reference's set: schedule_attempts_total, binding totals, preemption
counters, pending_pods by queue.

Copied whole from the reference (`kubernetes_tpu.metrics`) over the port's
`obs.registry` and its shell's `Scheduler.metrics`; the phases of the
device pipeline are the port's (encode / kernel / fetch on the card).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from kubernetes_tpu_torch.obs.registry import Registry

if TYPE_CHECKING:
    from kubernetes_tpu_torch.scheduler import Scheduler

PREFIX = "scheduler"


def _copy_histogram(fam, src, *labels) -> None:
    """Snapshot one scheduler.Histogram into a registry child (same
    cumulative-bucket layout, reference ExponentialBuckets(0.001, 2, 15))."""
    child = fam.labels(*labels)
    child.buckets = list(src.buckets)
    child.count = src.count
    child.sum = src.sum


def build_registry(sched: "Scheduler") -> Registry:
    """One scrape of the scheduler's metric families as a Registry."""
    m = sched.metrics
    pending = sched.queue.pending_pods()
    r = Registry()
    attempts = r.counter(
        f"{PREFIX}_schedule_attempts_total",
        "Number of attempts to schedule pods, by result.", ("result",))
    for result, count in m.schedule_attempts.items():
        attempts.labels(result).inc(count)
    r.counter(f"{PREFIX}_binding_total",
              "Number of successful pod bindings.").inc(m.binding_count)
    r.counter(f"{PREFIX}_total_preemption_attempts",
              "Total preemption attempts.").inc(m.preemption_attempts)
    r.counter(f"{PREFIX}_pod_preemption_victims",
              "Number of preemption victims.").inc(m.preemption_victims)
    # per-phase duration histograms (metrics.go:67-169
    # scheduling_duration_seconds / binding_duration_seconds /
    # e2e_scheduling_duration_seconds) — phases here are the device pipeline's:
    # encode/kernel/fetch plus algorithm/preemption/binding
    phases = r.histogram(
        f"{PREFIX}_scheduling_duration_seconds",
        "Scheduling phase latency, by operation.", ("operation",))
    for phase in sorted(m.phase_duration):
        _copy_histogram(phases, m.phase_duration[phase], phase)
    binding = r.histogram(f"{PREFIX}_binding_duration_seconds",
                          "Binding latency.")
    _copy_histogram(binding, m.binding_duration)
    e2e = r.histogram(f"{PREFIX}_e2e_scheduling_duration_seconds",
                      "End-to-end scheduling latency.")
    _copy_histogram(e2e, m.e2e_duration)
    pend = r.gauge(f"{PREFIX}_pending_pods", "Pending pods by queue.",
                   ("queue",))
    for queue_name in ("active", "backoff", "unschedulable"):
        pend.labels(queue_name).set(len(pending[queue_name]))
    r.gauge(f"{PREFIX}_cache_nodes",
            "Nodes tracked by the scheduler cache.").set(
        sched.cache.node_count())
    r.gauge(f"{PREFIX}_cache_pods",
            "Pods tracked by the scheduler cache.").set(
        sched.cache.pod_count())
    return r


def render_metrics(sched: "Scheduler") -> str:
    """One scrape of the scheduler's metric families."""
    return build_registry(sched).render()


def reset_metrics(sched: "Scheduler") -> None:
    """DELETE /metrics analog (metrics.Reset, metrics.go:242)."""
    sched.metrics.reset()
