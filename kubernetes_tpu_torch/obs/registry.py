"""Shared metrics registry — the component-metrics analog.

The reference ships a Prometheus registry on every component
(k8s.io/component-base/metrics; /metrics on the apiserver, scheduler,
controller-manager, kubelet). This is that layer for the repro: labeled
Counter/Gauge/Histogram families registered once per process, rendered in
the Prometheus text exposition format (version 0.0.4) with proper label
escaping — replacing the hand-rolled scheduler-only renderer that
interpolated label values unescaped.

Families are get-or-create by name (`Registry.counter(...)` returns the
existing family on a repeat call with the same shape), so modules declare
their metrics at import time and any number of component instances share
them — exactly how the prometheus client's default registry behaves.

Copied from the reference with the port's imports:
`kubernetes_tpu.obs.registry`.
"""
from __future__ import annotations

import re
import threading
from typing import Callable, Iterable, Optional, Sequence

# reference buckets: ExponentialBuckets(0.001, 2, 15) (metrics.go:93)
DEFAULT_BUCKETS = tuple(0.001 * 2 ** i for i in range(15))
# µs-scale preset for the native commit/fan-out phases: the default
# ms-scale ladder starts at 1ms, which crushes a 5-30µs commit-core call
# or a sub-ms watch fan-out lag into the first bucket — these start at 1µs
# and reach ~4s (ExponentialBuckets(1e-6, 4, 12) shape)
MICRO_BUCKETS = tuple(1e-6 * 4 ** i for i in range(12))
# wide pod-lifecycle preset: one family spans µs-scale phases (commit,
# fan-out copy-out) AND seconds-scale phases (queue wait) — 1µs..134s
LATENCY_BUCKETS = tuple(1e-6 * 4 ** i for i in range(14))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote, and
    newline must be escaped inside `{key="..."}` (exposition format §label
    values) — the old renderer interpolated them raw."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(v: str) -> str:
    """HELP text escaping: backslash and newline (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v) -> str:
    """Integral values render without a decimal point (counters read as
    event counts); everything else as shortest float repr. NaN and the
    infinities use the Prometheus text-format spellings — callback
    gauges publish NaN as the no-data value (a dead component's reader,
    a lane that committed nothing), and the exposition must carry that
    through rather than crash the whole scrape on int(NaN)."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_suffix(names: Sequence[str], values: Sequence[str],
                   extra: str = "") -> str:
    pairs = [f'{k}="{escape_label_value(v)}"'
             for k, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Callback gauge: the value is read at collect time (the
        prometheus GaugeFunc analog) — for queue depths / cache sizes."""
        self._fn = fn

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value


class _HistogramChild:
    __slots__ = ("bounds", "buckets", "count", "sum", "_lock")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = bounds
        self.buckets = [0] * len(bounds)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        self.observe_many(value, 1)

    def observe_many(self, value: float, count: int) -> None:
        """`count` identical observations in one pass (burst commits record
        their per-pod share without N bucket walks)."""
        if count <= 0:
            return
        with self._lock:
            self.count += count
            self.sum += value * count
            for i, b in enumerate(self.bounds):
                if value <= b:
                    self.buckets[i] += count

    def observe_batch(self, values) -> None:
        """Observe a whole batch of DISTINCT values in one vectorized pass —
        the watch fan-out copy-out and the per-wave ledger folds observe
        thousands of values per call; a Python observe() loop there would
        put an O(events) bucket walk back on the consumer threads."""
        import numpy as _np
        arr = _np.asarray(values, dtype=_np.float64)
        if arr.size == 0:
            return
        bounds = _np.asarray(self.bounds, dtype=_np.float64)
        # first bucket each value lands in; counts cumulate left-to-right
        # (bucket[i] counts v <= bounds[i], the Prometheus cumulative shape)
        idx = _np.searchsorted(bounds, arr, side="left")
        hist = _np.bincount(idx, minlength=len(bounds) + 1)
        cum = _np.cumsum(hist[:len(bounds)])
        with self._lock:
            self.count += int(arr.size)
            self.sum += float(arr.sum())
            for i in range(len(self.bounds)):
                self.buckets[i] += int(cum[i])


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild}


class MetricFamily:
    """One named family: HELP + TYPE + children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _new_child(self):
        return _CHILD_TYPES[self.kind]()

    def labels(self, *values, **kv):
        """Get-or-create the child for one label-value combination.
        Accepts positional values (labelnames order) or keywords."""
        if kv:
            if values:
                raise ValueError("mix of positional and keyword labels")
            values = tuple(str(kv[ln]) for ln in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values, self._new_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels; use .labels(...)")
        return self.labels()

    # -- exposition ---------------------------------------------------------
    def header_lines(self) -> list[str]:
        return [f"# HELP {self.name} {escape_help(self.help)}",
                f"# TYPE {self.name} {self.kind}"]

    def sample_lines(self) -> list[str]:
        out = []
        for values in sorted(self._children):
            child = self._children[values]
            suffix = _labels_suffix(self.labelnames, values)
            out.append(f"{self.name}{suffix} {format_value(child.value)}")
        return out

    def render(self) -> list[str]:
        return self.header_lines() + self.sample_lines()


class Counter(MetricFamily):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(MetricFamily):
    kind = "gauge"

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def observe_many(self, value: float, count: int) -> None:
        self._default().observe_many(value, count)

    def observe_batch(self, values) -> None:
        self._default().observe_batch(values)

    def sample_lines(self) -> list[str]:
        out = []
        for values in sorted(self._children):
            child = self._children[values]
            for i, b in enumerate(self.buckets):
                le = 'le="%g"' % b
                sfx = _labels_suffix(self.labelnames, values, le)
                out.append(f"{self.name}_bucket{sfx} {child.buckets[i]}")
            sfx = _labels_suffix(self.labelnames, values, 'le="+Inf"')
            out.append(f"{self.name}_bucket{sfx} {child.count}")
            sfx = _labels_suffix(self.labelnames, values)
            out.append(f"{self.name}_sum{sfx} {child.sum:.6f}")
            out.append(f"{self.name}_count{sfx} {child.count}")
        return out


class Registry:
    """Ordered set of metric families; renders one /metrics scrape."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def register(self, family: MetricFamily) -> MetricFamily:
        with self._lock:
            existing = self._families.get(family.name)
            if existing is not None:
                raise ValueError(f"metric {family.name!r} already registered")
            self._families[family.name] = family
        return family

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> MetricFamily:
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls) \
                        or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type or label set")
                want = kw.get("buckets")
                if want is not None and tuple(want) != DEFAULT_BUCKETS \
                        and existing.buckets != tuple(sorted(want)):
                    # per-family bucket overrides are part of the family's
                    # shape: silently returning the old ladder is how a
                    # µs-scale family ends up crushed into one ms bucket.
                    # (Passing the default ladder means "no opinion", so a
                    # declare-without-buckets reuse keeps working.)
                    raise ValueError(
                        f"metric {name!r} re-registered with different "
                        f"buckets")
                return existing
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def families(self) -> Iterable[MetricFamily]:
        return list(self._families.values())

    def render(self) -> str:
        lines: list[str] = []
        for fam in self._families.values():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every family (test isolation helper)."""
        with self._lock:
            self._families.clear()
