"""Span tracing — spans in a bounded ring buffer, copied from the reference
(`kubernetes_tpu.obs.trace`) as far as `utils.tracing.Trace.emit_spans`
reaches: `add_span` records one complete ("X") event from explicit
perf_counter timestamps. The buffer is a deque with a fixed capacity, so
old spans fall off the back. The span context manager, its parent chain
and the Chrome export wait for the port's tracing layer (torch.profiler
and NVTX).
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
