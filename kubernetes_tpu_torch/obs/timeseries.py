"""In-process metrics time-series — the soak scoreboard's sensor plane.

The registry (obs.registry) is cumulative counters, point-in-time
gauges, and cumulative histograms: perfect for "how much since process
start", blind to "when did it degrade". An hour-long soak that falls
over in minute 40 renders the same final /metrics scrape as one that
was slow from the first window. This module closes that gap without an
external Prometheus:

- `TimeSeriesScraper` samples the WHOLE registry on a cadence into a
  bounded columnar ring (newest `capacity` samples win): counters are
  stored as per-sample deltas (rates derive from the sampled dt),
  gauges raw, histograms as per-window bucket deltas reduced to
  windowed p50/p99 at sample time via the same searchsorted shape the
  registry's `observe_batch` uses — so "p99 over the last 500 ms", not
  "p99 since boot", at O(children) memory instead of O(observations).
- `GET /debug/timeseries?family=&window=` serves the ring as JSON
  (cmd/scheduler), and `series()` / the same document embeds into a
  soak artifact.
- `evaluate_verdicts` runs a catalogue of named detectors over the
  series — monotonic RSS growth, windowed-p99 trend breach,
  activeQ/backlog divergence, watch-class materialization-rate
  collapse, fence-conflict spikes, watcher-lag tail growth — each
  yielding a machine-checkable verdict string ("what fell over first"),
  never silently skipped: a detector whose input families were not
  sampled reports `no-data` by name.

Correctness under concurrent writes: a scrape racing a counter inc or
a histogram observe must never produce a negative delta or a
non-monotone bucket window — deltas are clamped at zero and histogram
children are snapshotted under their own lock (the same lock
`observe_batch` takes, held for a list copy). Columns stay aligned
with the time axis: a child that first appears mid-run is backfilled
with NaN for the samples it missed.

The scraper's own cost is booked on `timeseries_scrape_seconds` /
`timeseries_samples_total` (it samples itself, like every other
family). The port's overhead floor runs on the card (`chip_smoke.py`
`[scraper]`): the shell's headline burst with the scraper running must
stay >= 0.95x the scraper-off run, or the sampling duty cycle under 1 %.

Copied whole from the reference (`kubernetes_tpu.obs.timeseries`) with
the port's imports. The HTTP route of the port is `cmd/scheduler.py`'s
(the port has no apiserver yet, ROADMAP A7.4). One departure, in cost
only: a histogram child with no observation since the last sample skips
the bucket arithmetic (its window is empty: zero deltas, NaN quantiles,
as the arithmetic gives), and each child's columns are looked up once a
sample; the documents equal the reference's.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from kubernetes_tpu_torch import obs

SCRAPE_SECONDS = obs.gauge(
    "timeseries_scrape_seconds",
    "Wall cost of the most recent time-series registry sample (the "
    "scraper samples itself; the overhead floor holds the headline "
    "burst with the scraper on at >= 0.95x off).")
SAMPLES_TOTAL = obs.counter(
    "timeseries_samples_total",
    "Registry samples taken by the in-process time-series scraper.")

#: default sample cadence (seconds) — two samples a second resolves
#: minute-scale degradation trends at ~720 samples per 6-minute ring
DEFAULT_INTERVAL = 0.5
#: default ring capacity (samples); newest-N win
DEFAULT_CAPACITY = 720


def _quantile(bounds: np.ndarray, cum: np.ndarray, count: int,
              q: float) -> float:
    """Quantile estimate from a cumulative bucket-delta window — the
    prometheus histogram_quantile shape: find the bucket the rank lands
    in with searchsorted, interpolate linearly inside it. Observations
    past the last finite bound clamp to it. NaN with an empty window."""
    if count <= 0:
        return float("nan")
    rank = q * count
    idx = int(np.searchsorted(cum, rank, side="left"))
    if idx >= len(bounds):
        return float(bounds[-1]) if len(bounds) else float("nan")
    hi = float(bounds[idx])
    lo = float(bounds[idx - 1]) if idx > 0 else 0.0
    c_hi = float(cum[idx])
    c_lo = float(cum[idx - 1]) if idx > 0 else 0.0
    if c_hi <= c_lo:
        return hi
    return lo + (hi - lo) * (rank - c_lo) / (c_hi - c_lo)


#: a histogram child's columns, in order
_HIST_COLS = ("count_delta", "sum_delta", "p50", "p99")


class TimeSeriesScraper:
    """Registry sampler with a bounded columnar ring (module docstring).

    Thread-safe: `sample()` may be driven by the background thread
    (`start()`/`stop()`) or called directly (tests, cooperative bench
    loops); `series()`/`to_artifact()` read a consistent snapshot."""

    def __init__(self, registry=None, capacity: int = DEFAULT_CAPACITY,
                 interval: float = DEFAULT_INTERVAL):
        self._registry = registry if registry is not None else obs.REGISTRY
        self.capacity = int(capacity)
        self.interval = float(interval)
        self._lock = threading.Lock()
        self._t: deque = deque(maxlen=self.capacity)     # perf_counter
        self._dt: deque = deque(maxlen=self.capacity)    # since prev sample
        #: (family, labelvalues, column) -> deque of floats, aligned _t
        self._cols: dict[tuple, deque] = {}
        #: family -> labelvalues -> [the child's column deques (the same
        #: deques as in `_cols`, in column order), its last cumulative
        #: snapshot, the count of the last sample that saw it]
        self._by_family: dict[str, dict] = {}
        self._n_children = 0        # records in `_by_family`
        #: family -> ("counter"|"gauge"|"histogram", labelnames)
        self._fams: dict[str, tuple] = {}
        self._samples = 0
        self._t0: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- configuration -------------------------------------------------------
    def reset(self, capacity: Optional[int] = None,
              interval: Optional[float] = None) -> None:
        """Drop every sample and baseline (bench-cell isolation); the
        background thread, if any, keeps running on the new settings."""
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            if interval is not None:
                self.interval = float(interval)
            self._t = deque(maxlen=self.capacity)
            self._dt = deque(maxlen=self.capacity)
            self._cols.clear()
            self._by_family.clear()
            self._n_children = 0
            self._fams.clear()
            self._samples = 0
            self._t0 = None

    # -- sampling ------------------------------------------------------------
    def _col(self, key: tuple) -> deque:
        col = self._cols.get(key)
        if col is None:
            col = self._cols[key] = deque(maxlen=self.capacity)
            # a child born mid-run backfills NaN so every column stays
            # aligned with the time axis
            col.extend([float("nan")] * len(self._t))
        return col

    def _child(self, recs: dict, name: str, labels: tuple,
               columns: tuple) -> list:
        """A child's record in its family's `recs`, made at its first
        sample with its columns (backfilled) and no snapshot yet."""
        rec = recs[labels] = [
            tuple(self._col((name, labels, c)) for c in columns), None, 0]
        self._n_children += 1
        return rec

    def sample(self, now: Optional[float] = None) -> int:
        """Take one sample of every family; returns the sample count."""
        t_in = time.perf_counter()
        now = t_in if now is None else now
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            dt = (now - self._t[-1]) if self._t else float("nan")
            n = self._samples + 1
            nan = float("nan")
            seen = 0                # children sampled now
            for fam in self._registry.families():
                if not fam._children:
                    continue
                kind = fam.kind
                if kind not in ("counter", "gauge", "histogram"):
                    continue
                name = fam.name
                recs = self._by_family.get(name)
                if recs is None:
                    recs = self._by_family[name] = {}
                    self._fams[name] = (kind, fam.labelnames)
                items = list(fam._children.items())
                seen += len(items)
                if kind == "counter":
                    for labels, child in items:
                        rec = recs.get(labels)
                        if rec is None:
                            rec = self._child(recs, name, labels,
                                              ("delta",))
                        v = float(child.value)
                        prev = rec[1]
                        d = 0.0 if prev is None else v - prev
                        # clamp: a scrape racing an inc() must never
                        # book a negative delta
                        rec[0][0].append(d if d > 0.0 else 0.0)
                        rec[1] = v
                        rec[2] = n
                elif kind == "gauge":
                    for labels, child in items:
                        rec = recs.get(labels)
                        if rec is None:
                            rec = self._child(recs, name, labels,
                                              ("value",))
                        try:
                            v = float(child.value)
                        except Exception:
                            # a raising callback gauge must not kill the
                            # sample; its column reads NaN this window
                            v = nan
                        rec[0][0].append(v)
                        rec[2] = n
                else:
                    for labels, child in items:
                        rec = recs.get(labels)
                        if rec is None:
                            rec = self._child(recs, name, labels,
                                              _HIST_COLS)
                        with child._lock:   # coherent (buckets,count,sum)
                            bks = list(child.buckets)
                            cnt = int(child.count)
                            sm = float(child.sum)
                        pb, pc, ps = rec[1] or ([0] * len(bks), 0, 0.0)
                        rec[1] = (bks, cnt, sm)
                        dc = max(0, cnt - pc)
                        if dc == 0 and bks == pb:
                            # an empty window (the usual child between
                            # two samples): zero deltas, no quantile —
                            # what the bucket arithmetic below gives,
                            # without its numpy calls
                            p50 = p99 = nan
                        else:
                            cum = np.maximum(
                                np.asarray(bks, dtype=np.float64)
                                - np.asarray(pb, dtype=np.float64), 0.0)
                            # cumulative-bucket deltas stay non-decreasing
                            cum = np.maximum.accumulate(cum)
                            bounds = np.asarray(child.bounds,
                                                dtype=np.float64)
                            p50 = _quantile(bounds, cum, dc, 0.50)
                            p99 = _quantile(bounds, cum, dc, 0.99)
                        cols = rec[0]
                        cols[0].append(float(dc))
                        cols[1].append(max(0.0, sm - ps))
                        cols[2].append(p50)
                        cols[3].append(p99)
                        rec[2] = n
            # columns whose child vanished (registry cleared between
            # samples) pad NaN to stay aligned
            if seen != self._n_children:
                for recs in self._by_family.values():
                    for rec in recs.values():
                        if rec[2] != n:
                            for col in rec[0]:
                                col.append(nan)
            self._t.append(now)
            self._dt.append(dt)
            self._samples += 1
        SAMPLES_TOTAL.inc()
        SCRAPE_SECONDS.set(time.perf_counter() - t_in)
        return self._samples

    # -- background thread ---------------------------------------------------
    def start(self, interval: Optional[float] = None) -> None:
        """Run the sampler on a daemon thread at `interval` (idempotent)."""
        if interval is not None:
            self.interval = float(interval)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval):
                try:
                    self.sample()
                except Exception:
                    # a sampling bug must never take down the process
                    # it is observing
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="timeseries-scraper")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- readout -------------------------------------------------------------
    @staticmethod
    def _label_str(labelnames, labelvalues) -> str:
        return ",".join(f'{k}="{v}"'
                        for k, v in zip(labelnames, labelvalues))

    @staticmethod
    def _round(xs) -> list:
        out = []
        for x in xs:
            if isinstance(x, float) and math.isnan(x):
                out.append(None)          # JSON-safe NaN
            else:
                out.append(round(float(x), 6))
        return out

    def series(self, family: Optional[str] = None,
               window: Optional[int] = None) -> dict:
        """The ring as one JSON-ready document: a relative time axis plus
        per-family, per-child columns (counters gain a derived `rate`
        column, histograms a `rate` from count deltas). `family` filters
        to one family; `window` keeps the newest N samples."""
        with self._lock:
            t0 = self._t0 if self._t0 is not None else 0.0
            ts = [round(x - t0, 3) for x in self._t]
            dts = list(self._dt)
            cols = {k: list(v) for k, v in self._cols.items()
                    if family is None or k[0] == family}
            fams = dict(self._fams)
            n_samples = self._samples
            interval = self.interval
        if window is not None and window > 0:
            ts = ts[-window:]
            dts = dts[-window:]
            cols = {k: v[-window:] for k, v in cols.items()}

        def rate(deltas):
            return [d / dt if (dt and not math.isnan(dt) and dt > 0
                               and not math.isnan(d)) else float("nan")
                    for d, dt in zip(deltas, dts)]

        out_fams: dict = {}
        for (fname, labels, cname), vals in sorted(cols.items()):
            kind, labelnames = fams.get(fname, ("untyped", ()))
            fam = out_fams.setdefault(fname, {"type": kind, "series": {}})
            key = self._label_str(labelnames, labels)
            ser = fam["series"].setdefault(key, {})
            ser[cname] = self._round(vals)
            if kind == "counter" and cname == "delta":
                ser["rate"] = self._round(rate(vals))
            elif kind == "histogram" and cname == "count_delta":
                ser["rate"] = self._round(rate(vals))
        return {"interval": interval, "samples": n_samples,
                "window": len(ts), "t": ts, "families": out_fams}

    def to_artifact(self) -> str:
        return json.dumps(self.series(), sort_keys=True)


#: the process-global scraper the /debug/timeseries routes serve — idle
#: (zero samples, no thread) until a bench cell or an operator starts it
SCRAPER = TimeSeriesScraper()


# -- verdict engine -----------------------------------------------------------

class SeriesView:
    """Detector-facing view over a `series()` document: per-sample
    column access with children summed elementwise (NaN-ignoring), plus
    the segment statistics every trend detector shares."""

    def __init__(self, doc: dict):
        self.doc = doc
        self.t = np.asarray(doc.get("t", ()), dtype=np.float64)

    def has(self, family: str) -> bool:
        return family in self.doc.get("families", {})

    def col(self, family: str, col: str) -> np.ndarray:
        """Elementwise sum of `col` across the family's children (the
        total rate/depth view); all-NaN rows stay NaN."""
        fam = self.doc.get("families", {}).get(family)
        n = len(self.t)
        if fam is None or n == 0:
            return np.full(n, np.nan)
        rows = []
        for ser in fam["series"].values():
            vals = ser.get(col)
            if vals is not None:
                rows.append([np.nan if v is None else float(v)
                             for v in vals])
        if not rows:
            return np.full(n, np.nan)
        arr = np.asarray(rows, dtype=np.float64)
        out = np.nansum(arr, axis=0)
        out[np.all(np.isnan(arr), axis=0)] = np.nan
        return out

    def rate(self, family: str) -> np.ndarray:
        return self.col(family, "rate")

    # -- segment statistics --------------------------------------------------
    @staticmethod
    def seg_mean(xs: np.ndarray, lo: float, hi: float) -> float:
        """NaN-ignoring mean of the [lo, hi) fraction of the series."""
        n = len(xs)
        if n == 0:
            return float("nan")
        seg = xs[int(lo * n):max(int(lo * n) + 1, int(hi * n))]
        if len(seg) == 0 or np.all(np.isnan(seg)):
            return float("nan")
        return float(np.nanmean(seg))

    @staticmethod
    def rising_frac(xs: np.ndarray) -> float:
        """Fraction of sample-to-sample deltas that are positive
        (NaN-pairs excluded) — the monotonic-trend signal."""
        d = np.diff(xs)
        d = d[~np.isnan(d)]
        if len(d) == 0:
            return 0.0
        return float(np.mean(d > 0))

    def valid(self, xs: np.ndarray) -> int:
        return int(np.sum(~np.isnan(xs)))

    def first_cross(self, xs: np.ndarray, threshold: float) -> Optional[float]:
        """Relative time of the first sample strictly above `threshold`
        (the "when did it fall over" stamp); None if never."""
        idx = np.flatnonzero(~np.isnan(xs) & (xs > threshold))
        if len(idx) == 0 or len(self.t) == 0:
            return None
        return float(self.t[int(idx[0])])


#: minimum valid samples before a trend detector renders judgment
_MIN_SAMPLES = 8


def _verdict(name: str, status: str, detail: str,
             breach_t: Optional[float] = None) -> dict:
    v = {"name": name, "status": status, "detail": detail,
         "verdict": f"{name}: {status.upper()} — {detail}"}
    if breach_t is not None:
        v["breach_t"] = round(breach_t, 3)
    return v


def _detect_rss_growth(view: SeriesView) -> dict:
    name = "rss-monotonic-growth"
    xs = view.col("process_resident_memory_bytes", "value")
    if view.valid(xs) < _MIN_SAMPLES or np.nanmax(xs) <= 0:
        return _verdict(name, "no-data",
                        "process_resident_memory_bytes not sampled")
    # skip the first quarter: arena growth during warmup/jit is expected
    n = len(xs)
    body = xs[n // 4:]
    head = SeriesView.seg_mean(body, 0.0, 0.25)
    tail = SeriesView.seg_mean(body, 0.75, 1.0)
    growth = tail - head
    rising = SeriesView.rising_frac(body)
    mb = 1024.0 * 1024.0
    if head > 0 and tail > 1.30 * head and growth > 128 * mb \
            and rising > 0.6:
        return _verdict(
            name, "fail",
            f"RSS grew {growth / mb:.0f} MiB ({tail / head:.2f}x) past "
            f"warmup with {rising:.0%} rising samples — leak-shaped",
            view.first_cross(xs, 1.30 * head))
    return _verdict(name, "pass",
                    f"RSS steady: {head / mb:.0f} -> {tail / mb:.0f} MiB "
                    f"past warmup ({rising:.0%} rising)")


def _detect_p99_trend(view: SeriesView, slo: float = 5.0) -> dict:
    name = "p99-trend-breach"
    xs = view.col("pod_startup_seconds_p99_windowed", "value")
    if view.valid(xs) < _MIN_SAMPLES or not np.any(np.nan_to_num(xs) > 0):
        return _verdict(name, "no-data",
                        "pod_startup_seconds_p99_windowed not sampled")
    head = SeriesView.seg_mean(xs, 0.0, 0.5)
    tail = SeriesView.seg_mean(xs, 0.75, 1.0)
    if tail > slo and head <= slo:
        return _verdict(
            name, "fail",
            f"windowed startup p99 breached the {slo:.0f}s SLO late: "
            f"first-half {head:.3f}s -> last-quarter {tail:.3f}s "
            "(cumulative gauges would have averaged this away)",
            view.first_cross(xs, slo))
    if tail > max(3.0 * head, head + 1.0) and tail > 0.5:
        return _verdict(
            name, "fail",
            f"windowed startup p99 trending up: {head:.3f}s -> "
            f"{tail:.3f}s ({tail / max(head, 1e-9):.1f}x)",
            view.first_cross(xs, max(3.0 * head, head + 1.0)))
    return _verdict(name, "pass",
                    f"windowed p99 {head:.3f}s -> {tail:.3f}s, "
                    f"SLO {slo:.0f}s held")


def _detect_activeq_divergence(view: SeriesView) -> dict:
    name = "activeq-divergence"
    depth = view.col("serve_activeq_depth", "value")
    if view.valid(depth) < _MIN_SAMPLES:
        return _verdict(name, "no-data", "serve_activeq_depth not sampled")
    head = SeriesView.seg_mean(depth, 0.0, 0.25)
    tail = SeriesView.seg_mean(depth, 0.75, 1.0)
    rising = SeriesView.rising_frac(depth)
    binds = view.rate("serve_pods_scheduled_total")
    b_head = SeriesView.seg_mean(binds, 0.0, 0.25)
    b_tail = SeriesView.seg_mean(binds, 0.75, 1.0)
    throughput_ramp = (not math.isnan(b_head) and not math.isnan(b_tail)
                       and b_tail > 2.0 * max(b_head, 1.0))
    threshold = 4.0 * max(head, 0.0) + 256.0
    if tail > threshold and rising > 0.6 and not throughput_ramp:
        return _verdict(
            name, "fail",
            f"activeQ/backlog diverging: depth {head:.0f} -> {tail:.0f} "
            f"({rising:.0%} rising) while bind rate went "
            f"{b_head:.0f} -> {b_tail:.0f}/s — arrivals outrunning the "
            "serve plane",
            view.first_cross(depth, threshold))
    return _verdict(name, "pass",
                    f"activeQ depth {head:.0f} -> {tail:.0f}, bind rate "
                    f"{b_head:.0f} -> {b_tail:.0f}/s")


def _detect_materialization_collapse(view: SeriesView) -> dict:
    name = "watch-materialization-collapse"
    mat = view.rate("watch_copyout_materializations_total")
    shared = view.rate("watch_copyout_shared_total")
    copyout = np.nansum(np.vstack([mat, shared]), axis=0) \
        if len(mat) else mat
    if view.valid(copyout) < _MIN_SAMPLES \
            or not np.any(np.nan_to_num(copyout) > 0):
        return _verdict(name, "no-data",
                        "watch copy-out counters not sampled (no shared "
                        "watch classes live)")
    # the write-rate reference: pod binds landing (present on every
    # serve/fleet path; commit waves are impl-specific)
    writes = view.rate("serve_pods_scheduled_total")
    peak = float(np.nanmax(copyout))
    tail = SeriesView.seg_mean(copyout, 0.75, 1.0)
    w_peak = float(np.nanmax(writes)) if view.valid(writes) else 0.0
    w_tail = SeriesView.seg_mean(writes, 0.75, 1.0)
    if peak > 0 and tail < 0.05 * peak and w_peak > 0 \
            and w_tail > 0.25 * w_peak:
        return _verdict(
            name, "fail",
            f"watch-class copy-out rate collapsed: peak {peak:.0f}/s -> "
            f"last-quarter {tail:.0f}/s while binds held "
            f"{w_tail:.1f}/s — watchers have stopped draining",
            None)
    return _verdict(name, "pass",
                    f"copy-out rate peak {peak:.0f}/s, last-quarter "
                    f"{tail:.0f}/s, bind rate {w_tail:.1f}/s")


def _detect_fence_spike(view: SeriesView) -> dict:
    name = "fence-conflict-spike"
    if not (view.has("store_fenced_writes_total")
            or view.has("fleet_bind_conflicts_total")):
        return _verdict(name, "no-data",
                        "fencing counters not sampled (no fleet live)")
    fenced = view.rate("store_fenced_writes_total")
    confl = view.rate("fleet_bind_conflicts_total")
    both = np.nansum(np.vstack([fenced, confl]), axis=0) \
        if len(fenced) else fenced
    if not np.any(np.nan_to_num(both) > 0):
        return _verdict(name, "pass",
                        "zero fenced writes / bind conflicts observed")
    base = SeriesView.seg_mean(both, 0.0, 0.75)
    tail = SeriesView.seg_mean(both, 0.75, 1.0)
    threshold = 10.0 * max(base, 0.1)
    if tail > threshold and tail > 1.0:
        return _verdict(
            name, "fail",
            f"fence-conflict rate spiked: {base:.2f}/s baseline -> "
            f"{tail:.2f}/s last quarter — claim churn or a zombie "
            "instance fighting the fence",
            view.first_cross(both, threshold))
    return _verdict(name, "pass",
                    f"fence conflicts bounded: {base:.2f}/s baseline, "
                    f"{tail:.2f}/s last quarter")


def _detect_watcher_lag_tail(view: SeriesView) -> dict:
    name = "watcher-lag-tail"
    xs = view.col("store_watcher_backlog_p99", "value")
    if view.valid(xs) < _MIN_SAMPLES:
        return _verdict(name, "no-data",
                        "store_watcher_backlog_p99 not sampled (no "
                        "watcher-lag gauges registered)")
    head = SeriesView.seg_mean(xs, 0.0, 0.25)
    tail = SeriesView.seg_mean(xs, 0.75, 1.0)
    rising = SeriesView.rising_frac(xs)
    threshold = 4.0 * max(head, 0.0) + 100.0
    if tail > threshold and rising > 0.6:
        return _verdict(
            name, "fail",
            f"watcher-lag tail growing: p99 backlog {head:.0f} -> "
            f"{tail:.0f} events ({rising:.0%} rising) — fan-out is "
            "outrunning the consumers",
            view.first_cross(xs, threshold))
    return _verdict(name, "pass",
                    f"watcher p99 backlog {head:.0f} -> {tail:.0f} "
                    "events, bounded")


#: the verdict catalogue — every entry is evaluated on every call (a
#: detector without data answers `no-data` BY NAME, never vanishes);
#: tests pin this set so a new detector cannot land unnamed
DETECTORS = {
    "rss-monotonic-growth": _detect_rss_growth,
    "p99-trend-breach": _detect_p99_trend,
    "activeq-divergence": _detect_activeq_divergence,
    "watch-materialization-collapse": _detect_materialization_collapse,
    "fence-conflict-spike": _detect_fence_spike,
    "watcher-lag-tail": _detect_watcher_lag_tail,
}


def evaluate_verdicts(source) -> dict:
    """Run every detector over a scraper (or a prebuilt `series()`
    document). Returns {"verdicts": [...], "first_failure": name|None}
    where `first_failure` is the failing detector with the earliest
    breach stamp — the soak's "what fell over first" headline."""
    doc = source.series() if hasattr(source, "series") else source
    view = SeriesView(doc)
    verdicts = []
    for name, fn in DETECTORS.items():
        try:
            verdicts.append(fn(view))
        except Exception as e:      # a broken detector is itself reported
            verdicts.append(_verdict(name, "error", f"detector raised: "
                                     f"{e!r}"))
    failures = [v for v in verdicts if v["status"] == "fail"]
    first = None
    if failures:
        stamped = [v for v in failures if v.get("breach_t") is not None]
        first = (min(stamped, key=lambda v: v["breach_t"])["name"]
                 if stamped else failures[0]["name"])
    return {"verdicts": verdicts, "first_failure": first}
