"""Span tracing — spans in a bounded ring buffer, copied from the reference
(`kubernetes_tpu.obs.trace`) as far as `utils.tracing.Trace.emit_spans`
and the scheduler command's `/debug/traces` reach: `add_span` records one
complete ("X") event from explicit perf_counter timestamps, `events` /
`to_chrome` read the ring back as Chrome trace-event JSON. The buffer is a
deque with a fixed capacity, so old spans fall off the back. The span
context manager, its parent chain and the file export wait for the port's
tracing layer (torch.profiler and NVTX).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional

DEFAULT_CAPACITY = 65536

# perf_counter anchor: Chrome wants microsecond timestamps on one clock
_ORIGIN = time.perf_counter()

_buf: deque = deque(maxlen=DEFAULT_CAPACITY)


def _note_dropped(n: int = 1) -> None:
    """Book spans the ring overflowed away (the deque drops them silently;
    this is the observable tripwire). Lazy import: obs/__init__ imports
    this module, so the counter can only be fetched after init."""
    try:
        from kubernetes_tpu_torch import obs
        obs.counter(
            "obs_trace_dropped_total",
            "Spans dropped from the trace ring buffer on overflow (the "
            "ring keeps the newest spans).").inc(n)
    except Exception:
        pass   # never let observability bookkeeping break a hot path


def add_span(name: str, t0: float, t1: float, cat: str = "host",
             args: Optional[dict] = None) -> None:
    """Record one complete span from explicit perf_counter timestamps.
    `args` values must be JSON-serializable."""
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": (t0 - _ORIGIN) * 1e6, "dur": (t1 - t0) * 1e6,
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = dict(args)
    buf = _buf
    if buf.maxlen is not None and len(buf) >= buf.maxlen:
        _note_dropped()
    buf.append(ev)


def events(limit: Optional[int] = None,
           cat: Optional[str] = None) -> list[dict]:
    """Snapshot of the recorded spans, oldest first. `cat` filters by span
    category (e.g. "device" vs "host"); `limit` keeps only the NEWEST N
    spans after filtering — the /debug/traces query knobs."""
    evs = list(_buf)
    if cat is not None:
        evs = [e for e in evs if e.get("cat") == cat]
    if limit is not None and limit >= 0:
        evs = evs[-limit:] if limit else []
    return evs


def to_chrome(limit: Optional[int] = None,
              cat: Optional[str] = None) -> dict:
    """Chrome trace-event JSON object — Perfetto and chrome://tracing both
    load it directly."""
    return {"traceEvents": events(limit=limit, cat=cat),
            "displayTimeUnit": "ms"}
