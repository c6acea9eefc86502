"""The port's time-series scraper, verdict engine and process metrics
against the JAX package's, on the CPU (`tests/test_timeseries.py` on the
port).

- `TimeSeriesScraper` under concurrent writes (bounded writer threads,
  joined with a timeout): counter deltas never negative, histogram windows
  coherent, a raising callback gauge reads NaN;
- windowed p50 / p99 against a replayed oracle; the ring and its column
  alignment; the family filter, window and rates; reset; the background
  thread's start and stop;
- the verdict catalogue equal to the JAX package's by name, and every
  detector's verdict equal to JAX's on the same synthetic documents (and
  on one document both scrapers sampled from the same writes);
- the ledger's windowed twins, and the store's watcher-lag summary;
- the process families present in the global exposition, their callback
  gauges never raising, and the gc bracket's install / uninstall.

The HTTP route is `tests/test_torch_cmd.py`'s; the scraper's overhead
floor runs on the card (`chip_smoke.py` `[scraper]`).
"""
import gc
import math
import threading
import time

import numpy as np
import pytest

from kubernetes_tpu.obs import timeseries as jts
from kubernetes_tpu.obs.lint import lint_exposition
from kubernetes_tpu.obs.registry import Registry as JRegistry

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.obs import procmetrics
from kubernetes_tpu_torch.obs import timeseries as ts
from kubernetes_tpu_torch.obs.ledger import PodLifecycleLedger
from kubernetes_tpu_torch.obs.registry import DEFAULT_BUCKETS, Registry

#: seconds a test waits for a thread it started to end
JOIN_S = 10.0


def fresh_scraper(capacity=64):
    """Scraper over a private registry: tests stay independent of what
    the process-global registry accumulated."""
    reg = Registry()
    return ts.TimeSeriesScraper(registry=reg, capacity=capacity,
                                interval=0.01), reg


@pytest.fixture(autouse=True)
def global_scraper_stopped():
    """The process-global scraper is idle after every test: its thread
    joined, its ring empty."""
    yield
    ts.SCRAPER.stop()
    assert not ts.SCRAPER.running
    ts.SCRAPER.reset()


def race(target, samples, scraper):
    """Run `target(stop)` on one writer thread while `scraper` samples
    `samples` times; the writer is joined with a timeout."""
    stop = threading.Event()
    th = threading.Thread(target=target, args=(stop,), daemon=True)
    th.start()
    try:
        for _ in range(samples):
            scraper.sample()
    finally:
        stop.set()
        th.join(JOIN_S)
    assert not th.is_alive()


# -- sampling correctness under concurrent writes -----------------------------
class TestScraperConcurrency:
    def test_counter_deltas_never_negative_under_races(self):
        scraper, reg = fresh_scraper(capacity=256)
        c = reg.counter("race_total", "concurrent inc target")

        def writer(stop):
            while not stop.is_set():
                c.inc(3.0)
        race(writer, 200, scraper)
        final = float(c.value)
        scraper.sample()
        doc = scraper.series(family="race_total")
        deltas = doc["families"]["race_total"]["series"][""]["delta"]
        assert all(d is not None and d >= 0.0 for d in deltas)
        assert sum(deltas) <= final + 1e-9

    def test_histogram_windows_coherent_under_races(self):
        scraper, reg = fresh_scraper(capacity=256)
        h = reg.histogram("race_seconds", "concurrent observe target")

        def writer(stop):
            i = 0
            while not stop.is_set():
                h.observe(0.001 * (1 + (i % 1000)))
                i += 1
        race(writer, 200, scraper)
        cols = scraper.series(family="race_seconds")["families"][
            "race_seconds"]["series"][""]
        last = DEFAULT_BUCKETS[-1]
        for cd, sd, p50, p99 in zip(cols["count_delta"], cols["sum_delta"],
                                    cols["p50"], cols["p99"]):
            assert cd >= 0 and sd >= -1e-9
            if cd == 0:
                assert p50 is None and p99 is None
            else:
                assert 0.0 <= p50 <= p99 <= last + 1e-9

    def test_raising_gauge_callback_reads_nan_not_crash(self):
        scraper, reg = fresh_scraper()
        g = reg.gauge("bad_gauge", "raising callback")
        g.set_function(lambda: 1.0 / 0.0)
        reg.gauge("good_gauge", "healthy neighbor").set(7.0)
        scraper.sample()
        doc = scraper.series()
        assert doc["families"]["bad_gauge"]["series"][""]["value"] == [None]
        assert doc["families"]["good_gauge"]["series"][""]["value"] == [7.0]


def oracle_quantile(vals, q):
    """The prometheus histogram_quantile estimate from raw values, written
    apart from the scraper's bucket-delta path."""
    bounds = np.asarray(DEFAULT_BUCKETS)
    counts = np.zeros(len(bounds))
    for v in vals:
        idx = np.searchsorted(bounds, v, side="left")
        if idx < len(bounds):
            counts[idx] += 1
    cum = np.cumsum(counts)
    rank = q * len(vals)
    i = int(np.searchsorted(cum, rank, side="left"))
    if i >= len(bounds):
        return float(bounds[-1])
    lo = bounds[i - 1] if i > 0 else 0.0
    c_lo = cum[i - 1] if i > 0 else 0.0
    if cum[i] <= c_lo:
        return float(bounds[i])
    return float(lo + (bounds[i] - lo) * (rank - c_lo) / (cum[i] - c_lo))


class TestHistogramWindowOracle:
    def test_windowed_quantiles_match_replayed_oracle(self):
        scraper, reg = fresh_scraper(capacity=64)
        h = reg.histogram("oracle_seconds", "oracle target")
        rng = np.random.default_rng(7)
        scraper.sample()        # baseline
        windows = []
        for i in range(12):
            vals = rng.uniform(0.0005, 10.0, size=50 * (1 + i % 3))
            h.observe_batch(vals)
            windows.append(vals)
            scraper.sample()
        cols = scraper.series(family="oracle_seconds")["families"][
            "oracle_seconds"]["series"][""]
        assert cols["count_delta"][0] is None
        for i, vals in enumerate(windows):
            k = i + 1
            assert cols["count_delta"][k] == len(vals)
            assert cols["sum_delta"][k] == pytest.approx(vals.sum(),
                                                         rel=1e-4)
            for q, col in ((0.50, "p50"), (0.99, "p99")):
                assert cols[col][k] == pytest.approx(
                    oracle_quantile(vals, q), rel=1e-6, abs=1e-9), \
                    f"window {k} q={q}"

    def test_observations_past_last_bound_clamp(self):
        scraper, reg = fresh_scraper()
        h = reg.histogram("clamp_seconds", "overflow target")
        scraper.sample()
        h.observe_batch([1e6] * 10)
        scraper.sample()
        cols = scraper.series(family="clamp_seconds")["families"][
            "clamp_seconds"]["series"][""]
        assert cols["p99"][-1] == pytest.approx(DEFAULT_BUCKETS[-1])


class TestRingAndAlignment:
    def test_ring_keeps_newest_n_samples(self):
        scraper, reg = fresh_scraper(capacity=16)
        g = reg.gauge("tick", "sample index")
        for i in range(48):
            g.set(float(i))
            scraper.sample()
        doc = scraper.series()
        assert doc["samples"] == 48 and doc["window"] == 16
        assert doc["families"]["tick"]["series"][""]["value"] == \
            [float(i) for i in range(32, 48)]
        assert len(doc["t"]) == 16

    def test_midrun_child_backfills_nan(self):
        scraper, reg = fresh_scraper()
        reg.gauge("always", "from sample 0").set(1.0)
        for _ in range(5):
            scraper.sample()
        late = reg.counter("late_total", "born mid-run", ("who",))
        late.labels("a").inc(4.0)
        scraper.sample()
        col = scraper.series()["families"]["late_total"]["series"][
            'who="a"']["delta"]
        assert len(col) == 6 and col[:5] == [None] * 5 and col[5] == 0.0
        late.labels("a").inc(2.0)
        scraper.sample()
        assert scraper.series()["families"]["late_total"]["series"][
            'who="a"']["delta"][-1] == 2.0

    def test_series_family_filter_window_and_rates(self):
        scraper, reg = fresh_scraper()
        c = reg.counter("work_total", "rate source")
        for i in range(6):
            c.inc(10.0)
            scraper.sample(now=float(i))   # dt = 1 s exactly
        doc = scraper.series(family="work_total", window=3)
        assert list(doc["families"]) == ["work_total"]
        ser = doc["families"]["work_total"]["series"][""]
        assert ser["delta"] == [10.0, 10.0, 10.0]
        assert ser["rate"] == [10.0, 10.0, 10.0]
        assert doc["window"] == 3

    def test_reset_drops_samples_and_baselines(self):
        scraper, reg = fresh_scraper()
        c = reg.counter("r_total", "reset target")
        c.inc(5.0)
        scraper.sample()
        scraper.reset(capacity=8)
        assert scraper.series()["window"] == 0
        c.inc(5.0)
        scraper.sample()
        assert scraper.series()["families"]["r_total"]["series"][""][
            "delta"] == [0.0]

    def test_background_thread_start_stop(self):
        scraper, reg = fresh_scraper()
        reg.gauge("bg", "background target").set(1.0)
        scraper.start(interval=0.01)
        try:
            deadline = time.monotonic() + JOIN_S
            while scraper.series()["window"] < 3:
                assert time.monotonic() < deadline, "scraper never sampled"
                time.sleep(0.01)
            scraper.start()                  # idempotent: one thread
            assert sum(1 for t in threading.enumerate()
                       if t is scraper._thread) == 1
        finally:
            scraper.stop()
        assert not scraper.running
        n = scraper.series()["window"]
        time.sleep(0.05)
        assert scraper.series()["window"] == n   # actually stopped

    def test_same_writes_same_document_as_the_reference(self):
        """Both packages' scrapers over registries fed the same writes, at
        the same sample times (a child born mid-run, one that vanishes,
        histogram windows with and without observations, a family with
        no child): the same series document."""
        docs = []
        for reg, mod in ((Registry(), ts), (JRegistry(), jts)):
            scraper = mod.TimeSeriesScraper(registry=reg, capacity=32)
            c = reg.counter("w_total", "writes", ("kind",))
            g = reg.gauge("depth", "queue depth")
            h = reg.histogram("lat_seconds", "latency")
            rng = np.random.default_rng(3)
            empty = reg.counter("never_total", "a family with no child")
            assert not empty._children
            for i in range(20):
                c.labels("a").inc(float(i % 4))
                if 5 <= i < 12:
                    c.labels("b").inc(1.0)
                if i == 12:
                    # a child that vanishes: its column pads NaN
                    del c._children[("b",)]
                g.set(float(i * i % 7))
                if i % 3:
                    h.observe_batch(rng.uniform(0.001, 3.0, size=5 + i))
                scraper.sample(now=0.5 * i)
            docs.append(scraper.series())
        assert docs[0] == docs[1]


# -- verdict engine -------------------------------------------------------------
def doc_of(cols, n=None):
    """A series document: {(family, kind, col): values} in one child."""
    if n is None:
        n = max(len(v) for v in cols.values())
    fams = {}
    for (fam, kind, col), vals in cols.items():
        fams.setdefault(fam, {"type": kind, "series": {"": {}}})
        fams[fam]["series"][""][col] = vals
    return {"t": [float(i) for i in range(n)], "families": fams}


MB = 1024.0 * 1024.0
RSS = ("process_resident_memory_bytes", "gauge", "value")
P99 = ("pod_startup_seconds_p99_windowed", "gauge", "value")
DEPTH = ("serve_activeq_depth", "gauge", "value")
BINDS = ("serve_pods_scheduled_total", "counter", "rate")
MAT = ("watch_copyout_materializations_total", "counter", "rate")
SHARED = ("watch_copyout_shared_total", "counter", "rate")
FENCED = ("store_fenced_writes_total", "counter", "rate")
CONFL = ("fleet_bind_conflicts_total", "counter", "rate")
LAG = ("store_watcher_backlog_p99", "gauge", "value")

DOCS = {
    "empty": {"t": [], "families": {}},
    "rss_leak": doc_of({RSS: [200 * MB + 20 * MB * i for i in range(40)]}),
    "rss_steady": doc_of({RSS: [300 * MB + (i % 3) * MB for i in range(40)]}),
    "rss_thin": doc_of({RSS: [300 * MB] * 5}),
    "p99_late_stall": doc_of({P99: [0.2] * 24 + [8.0] * 8}),
    "p99_flat": doc_of({P99: [0.3] * 32}),
    "p99_trend": doc_of({P99: [0.1] * 16 + [0.4] * 8 + [1.8] * 8}),
    "p99_with_nan": doc_of({P99: [None] * 4 + [0.3] * 20 + [None] * 8}),
    "activeq_diverge": doc_of({DEPTH: [10.0 + 60.0 * i for i in range(32)],
                               BINDS: [500.0] * 32}),
    "activeq_ramp": doc_of({DEPTH: [10.0 + 60.0 * i for i in range(32)],
                            BINDS: [100.0] * 8 + [300.0] * 16
                            + [900.0] * 8}),
    "activeq_flat": doc_of({DEPTH: [50.0] * 32, BINDS: [500.0] * 32}),
    "mat_collapse": doc_of({MAT: [400.0] * 24 + [1.0] * 8,
                            SHARED: [100.0] * 24 + [0.0] * 8,
                            BINDS: [300.0] * 32}),
    "mat_healthy": doc_of({MAT: [400.0] * 32, SHARED: [100.0] * 32,
                           BINDS: [300.0] * 32}),
    "fence_spike": doc_of({FENCED: [0.1] * 24 + [30.0] * 8,
                           CONFL: [0.0] * 32}),
    "fence_zero": doc_of({FENCED: [0.0] * 16}),
    "fence_bounded": doc_of({FENCED: [1.0, 0.0] * 16, CONFL: [0.5] * 32}),
    "lag_growth": doc_of({LAG: [10.0 + 40.0 * i for i in range(32)]}),
    "lag_bounded": doc_of({LAG: [20.0, 25.0] * 16}),
    "everything_fails": doc_of({
        RSS: [200 * MB + 20 * MB * i for i in range(40)],
        P99: [0.2] * 30 + [8.0] * 10,
        LAG: [10.0 + 40.0 * i for i in range(40)]}),
}


class TestVerdicts:
    def test_catalogue_pinned_and_equal_to_the_reference(self):
        assert list(ts.DETECTORS) == list(jts.DETECTORS)
        assert set(ts.DETECTORS) == {
            "rss-monotonic-growth", "p99-trend-breach",
            "activeq-divergence", "watch-materialization-collapse",
            "fence-conflict-spike", "watcher-lag-tail"}

    @pytest.mark.parametrize("name", sorted(DOCS))
    def test_every_verdict_equals_the_reference(self, name):
        got = ts.evaluate_verdicts(DOCS[name])
        want = jts.evaluate_verdicts(DOCS[name])
        assert got == want
        assert {v["name"] for v in got["verdicts"]} == set(ts.DETECTORS)

    def test_the_documents_reach_every_status(self):
        seen = {}
        for doc in DOCS.values():
            for v in ts.evaluate_verdicts(doc)["verdicts"]:
                seen.setdefault(v["name"], set()).add(v["status"])
        for name, statuses in seen.items():
            assert {"pass", "fail", "no-data"} <= statuses, (name, statuses)

    def test_every_detector_answers_on_empty_doc(self):
        rep = ts.evaluate_verdicts({"t": [], "families": {}})
        assert {v["name"] for v in rep["verdicts"]} == set(ts.DETECTORS)
        assert all(v["status"] == "no-data" for v in rep["verdicts"])
        assert rep["first_failure"] is None
        for v in rep["verdicts"]:
            assert v["verdict"].startswith(f"{v['name']}: NO-DATA")

    def test_broken_detector_reports_error_by_name(self, monkeypatch):
        def boom(view):
            raise RuntimeError("broken detector")
        monkeypatch.setitem(ts.DETECTORS, "rss-monotonic-growth", boom)
        rep = ts.evaluate_verdicts({"t": [], "families": {}})
        by_name = {v["name"]: v for v in rep["verdicts"]}
        assert by_name["rss-monotonic-growth"]["status"] == "error"
        assert "broken detector" in by_name["rss-monotonic-growth"]["detail"]
        assert by_name["p99-trend-breach"]["status"] == "no-data"

    def test_p99_trend_breach_fires_on_late_stall(self):
        rep = ts.evaluate_verdicts(DOCS["p99_late_stall"])
        v = {v["name"]: v for v in rep["verdicts"]}["p99-trend-breach"]
        assert v["status"] == "fail" and v.get("breach_t") == 24.0
        assert rep["first_failure"] == "p99-trend-breach"

    def test_first_failure_is_the_earliest_breach(self):
        rep = ts.evaluate_verdicts(DOCS["everything_fails"])
        fails = {v["name"]: v["breach_t"] for v in rep["verdicts"]
                 if v["status"] == "fail"}
        assert len(fails) == 3
        assert rep["first_failure"] == min(fails, key=fails.get)

    def test_watcher_lag_tail_fires_on_growth(self):
        rep = ts.evaluate_verdicts(DOCS["lag_growth"])
        by_name = {v["name"]: v for v in rep["verdicts"]}
        assert by_name["watcher-lag-tail"]["status"] == "fail"

    def test_fence_spike_zero_is_pass_not_nodata(self):
        rep = ts.evaluate_verdicts(DOCS["fence_zero"])
        v = {v["name"]: v for v in rep["verdicts"]}["fence-conflict-spike"]
        assert v["status"] == "pass" and "zero" in v["detail"]

    def test_a_live_scraper_is_a_source(self):
        scraper, reg = fresh_scraper()
        g = reg.gauge("process_resident_memory_bytes", "rss")
        for i in range(12):
            g.set(100 * MB)
            scraper.sample()
        rep = ts.evaluate_verdicts(scraper)
        v = {v["name"]: v for v in rep["verdicts"]}["rss-monotonic-growth"]
        assert v["status"] == "pass"


# -- ledger windowed twins and the watcher-lag summary ------------------------
class TestLedgerWindowedTwins:
    def test_late_run_stall_flips_windowed_not_cumulative(self):
        led = PodLifecycleLedger()
        for i in range(10_000):
            k = f"fast/{i}"
            led.stamp_enqueue(k, t=10.0)
            led.commit_many([k], t=10.05)
        for i in range(50):
            k = f"slow/{i}"
            led.stamp_enqueue(k, t=100.0)
            led.commit_many([k], t=106.0)
        now = 110.0
        assert led.percentile(0.99) == pytest.approx(0.05)
        assert led.slo_ok() == 1.0
        assert led.window_percentile(0.99, now=now) == pytest.approx(6.0)
        assert led.window_percentile(0.50, now=now) == pytest.approx(6.0)
        assert led.window_slo_ok(now=now) == 0.0
        assert led.burn_rate(now=now) == pytest.approx(100.0)
        assert led.window_percentile(0.99, now=now + 60.0) == 0.0
        assert led.window_slo_ok(now=now + 60.0) == 1.0

    def test_windowed_fields_in_snapshot(self):
        led = PodLifecycleLedger()
        led.stamp_enqueue("a/b", t=1.0)
        led.commit_many(["a/b"], t=1.2)
        snap = led.snapshot()
        for k in ("startup_p50_windowed", "startup_p99_windowed",
                  "startup_slo_ok_windowed", "slo_burn_rate"):
            assert k in snap, k

    def test_global_windowed_and_process_gauges_registered(self):
        text = obs.render_global()
        assert lint_exposition(text) == []
        for fam in ("pod_startup_seconds_p50_windowed",
                    "pod_startup_seconds_p99_windowed",
                    "pod_startup_slo_ok_windowed", "slo_burn_rate",
                    "process_resident_memory_bytes",
                    "process_virtual_memory_bytes", "process_open_fds",
                    "process_threads", "python_gc_pause_seconds",
                    "python_gc_collected_total",
                    "timeseries_samples_total",
                    "timeseries_scrape_seconds"):
            assert fam in text, fam


class TestWatcherLagSummary:
    def test_one_pass_summary_and_ttl_cache(self):
        from kubernetes_tpu_torch.api.types import Container, Pod
        from kubernetes_tpu_torch.store.store import PODS, Store
        store = Store()
        watches = [store.watch(PODS) for _ in range(4)]
        try:
            for i in range(10):
                store.create(PODS, Pod(name=f"p{i}", containers=(
                    Container.make(name="c", requests={"cpu": 100}),)))
            s = store.watcher_lag_summary(ttl=0)
            assert s == {"count": 4, "max": 10, "p99": 10, "total": 40}
            watches[0].drain()
            assert store.watcher_lag_summary()["total"] == 40
            assert store.watcher_lag_summary(ttl=0)["total"] == 30
            assert store.debug_state()["watcher_lag_summary"]["count"] == 4
        finally:
            for w in watches:
                w.stop()

    def test_empty_store_summary(self):
        from kubernetes_tpu_torch.store.store import Store
        s = Store().watcher_lag_summary(ttl=0)
        assert s == {"count": 0, "max": 0, "p99": 0, "total": 0}


# -- process metrics ----------------------------------------------------------
class TestProcMetrics:
    def test_callback_gauges_never_raise(self, monkeypatch):
        for g in (procmetrics.RSS, procmetrics.VSZ, procmetrics.OPEN_FDS,
                  procmetrics.THREADS):
            v = float(g.value)
            assert v >= 0.0 and not math.isnan(v)
        assert float(procmetrics.THREADS.value) >= 1.0

        def no_procfs(*a, **k):
            raise OSError("no procfs")
        monkeypatch.setattr(procmetrics.os, "listdir", no_procfs)
        monkeypatch.setattr(procmetrics.os, "open", no_procfs)
        monkeypatch.setattr(procmetrics, "_proc_last",
                            (float("-inf"), 1.0, 1.0, 1.0))
        assert procmetrics.resident_memory_bytes() == 0.0
        assert procmetrics.virtual_memory_bytes() == 0.0
        assert procmetrics.open_fds() == 0.0

    def test_proc_gauges_are_the_references_read_at_most_every_250ms(
            self, monkeypatch):
        """The resident and virtual sizes (one read of /proc/self/statm)
        are the VmRSS / VmSize the reference scans /proc/self/status
        for, in bytes, and the fd count its listing; a read serves the
        three gauges for PROC_REFRESH_S."""
        from kubernetes_tpu.obs import procmetrics as jproc
        stale = (float("-inf"), 0.0, 0.0, 0.0)
        for _ in range(3):
            monkeypatch.setattr(procmetrics, "_proc_last", stale)
            got = (procmetrics.resident_memory_bytes(),
                   procmetrics.virtual_memory_bytes(),
                   procmetrics.open_fds())
            want = (jproc.resident_memory_bytes(),
                    jproc.virtual_memory_bytes(), jproc.open_fds())
            if got == want:
                break
        # the resident size may move between the two reads
        assert got == want
        reads = []
        real = procmetrics.os.listdir

        def counted(path):
            reads.append(path)
            return real(path)
        monkeypatch.setattr(procmetrics.os, "listdir", counted)
        monkeypatch.setattr(procmetrics, "_proc_last", stale)
        for _ in range(5):
            procmetrics.open_fds()
            procmetrics.resident_memory_bytes()
        assert len(reads) == 1
        t, *vals = procmetrics._proc_last
        monkeypatch.setattr(procmetrics, "_proc_last",
                            (t - procmetrics.PROC_REFRESH_S, *vals))
        procmetrics.open_fds()
        assert len(reads) == 2

    def test_gc_bracket_install_is_idempotent_and_uninstalls(self):
        assert procmetrics._installed
        try:
            procmetrics.install()
            assert gc.callbacks.count(procmetrics._gc_callback) == 1
            child = procmetrics.GC_PAUSE.labels("2")
            before = child.count
            gc.collect()
            after = child.count
            assert after >= before + 1
            procmetrics.uninstall()
            assert procmetrics._gc_callback not in gc.callbacks
            gc.collect()
            assert child.count == after
            procmetrics.uninstall()               # a second is harmless
        finally:
            procmetrics.install()
        assert gc.callbacks.count(procmetrics._gc_callback) == 1

    def test_a_collection_inside_a_held_child_lock_is_deferred(self):
        """A collection that runs in a thread holding a gc child's lock
        (the scraper's snapshot, a render) folds later instead of waiting
        on that lock forever. In a child interpreter, so a regression
        hangs it, not this worker."""
        import subprocess
        import sys
        from pathlib import Path
        code = (
            "import gc\n"
            "from kubernetes_tpu_torch.obs import procmetrics as p\n"
            "child = p.GC_PAUSE.labels('2')\n"
            "before = child.count\n"
            "with child._lock:\n"
            "    gc.collect()\n"
            "held = child.count\n"
            "gc.collect()\n"
            "print(before, held, child.count, len(p._pending))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             cwd=Path(__file__).resolve().parents[1],
                             capture_output=True, text=True, timeout=120,
                             check=True)
        before, held, after, pending = map(int, out.stdout.split())
        assert held == before            # deferred, not deadlocked
        assert after == before + 2       # both folded at the next one
        assert pending == 0

    def test_families_match_the_reference(self):
        from kubernetes_tpu.obs import procmetrics as jproc
        for name in ("RSS", "VSZ", "OPEN_FDS", "THREADS", "GC_PAUSE",
                     "GC_COLLECTED"):
            p, j = getattr(procmetrics, name), getattr(jproc, name)
            assert (p.name, p.kind, p.labelnames) == \
                (j.name, j.kind, j.labelnames)


# -- the readouts the scraper samples: equal to the reference's ---------------
def fill_ledgers(seed, ordered, n=300, reservoir=1 << 16):
    """The same stamps into the port's ledger and the reference's: commit
    waves of 1-80 pods, their stamps in order (perf_counter-like) or
    stepping back (a synthetic clock), two lanes of pod keys."""
    import random
    from kubernetes_tpu.obs.ledger import PodLifecycleLedger as JLedger
    rng = random.Random(seed)
    port = PodLifecycleLedger(reservoir=reservoir)
    ref = JLedger(reservoir=reservoir)
    t = 100.0
    checkpoints = []
    i = 0
    for wave in range(n // 10):
        keys = []
        for _ in range(rng.choice([1, 1, 3, 17, 80])):
            key = f"ns/{'tn-i-' if rng.random() < 0.5 else 'tn-s-'}{i}"
            i += 1
            t0 = t - rng.expovariate(1.0) * rng.choice([0.01, 1.0, 10.0])
            for led in (port, ref):
                led.stamp_enqueue(key, t=t0)
            keys.append(key)
        tc = t if ordered else t + rng.uniform(-3.0, 3.0)
        for led in (port, ref):
            led.commit_many(keys, t=tc)
        t += rng.uniform(0.0, 5.0)
        if wave % 4 == 0:
            checkpoints.append(t)
    return port, ref, checkpoints


def readouts(led, now, window):
    lane = prefix_lanes_match("tn-i-")
    return (led.percentile(0.5), led.percentile(0.99), led.slo_ok(),
            led.window_percentile(0.99, window, now),
            led.window_percentile(0.5, window, now),
            led.window_percentile(0.99, window, now, lane),
            led.window_count(window, now), led.window_count(window, now,
                                                            lane),
            led.window_violation_fraction(5.0, window, now),
            led.window_slo_ok(window=window, now=now),
            led.burn_rate(window=window, now=now))


def prefix_lanes_match(prefix):
    return lambda key: key.split("/", 1)[-1].startswith(prefix)


@pytest.mark.parametrize("reservoir", [1 << 16, 50])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ordered", [True, False])
def test_ledger_readouts_equal_the_reference(ordered, seed, reservoir):
    """The port's ledger keeps its reservoir in a ring and its sorted
    reservoir and window between calls; every readout equals the
    reference's, which sorts a deque each call, at windows and clocks
    before, inside and past the stamps (a reservoir of 50 wraps, and an
    80-pod wave overfills it)."""
    port, ref, checkpoints = fill_ledgers(seed, ordered,
                                          reservoir=reservoir)
    assert port._ordered is ordered
    counts = set()
    for t in checkpoints:
        for now in (t - 5.0, t, t + 10.0, t + 25.0, t + 40.0):
            for window in (None, 5.0, 60.0):
                got = readouts(port, now, window)
                assert got == readouts(ref, now, window)
                counts.add(got[6])
                # the second read comes from the memo: the same answer
                assert readouts(port, now, window) == got
    assert 0 in counts and len(counts) > 3     # empty and full windows
    port.reset()
    assert port._ordered and port.percentile(0.99) == 0.0
    assert port.window_count(now=1e9) == 0


class TestClusterUtilizationGauge:
    def test_gauge_reads_the_snapshot_sums(self):
        """tests/test_tuner.py's gauge check on the port's shell; then,
        through binds, a node's new allocatable, a node deleted and one
        added, the gauge (the snapshot's sums, kept by update_snapshot)
        equals a walk of the snapshot at every step."""
        from kubernetes_tpu_torch import obs
        from kubernetes_tpu_torch.api.types import Container, Node, Pod
        from kubernetes_tpu_torch.cache.node_info import cluster_utilization
        from kubernetes_tpu_torch.scheduler import (
            CLUSTER_UTILIZATION, Scheduler)
        from kubernetes_tpu_torch.store.store import NODES, PODS, Store
        GI = 1024 ** 3

        def node(i, cpu=1000):
            return Node(name=f"n{i}", allocatable={
                "cpu": cpu, "memory": 32 * GI, "pods": 110,
                "ephemeral-storage": 10 * GI})

        def pod(name, cpu):
            return Pod(name=name, containers=(Container.make(
                name="c", requests={"cpu": cpu, "memory": GI,
                                    "ephemeral-storage": GI}),))
        store = Store()
        for i in range(2):
            store.create(NODES, node(i))
        sched = Scheduler(store, percentage_of_nodes_to_score=100,
                          device="cpu")
        sched.sync()

        def cycle(name, cpu):
            store.create(PODS, pod(name, cpu))
            sched.pump()
            sched.schedule_one()
            sched.pump()

        def gauge():
            return {r: float(CLUSTER_UTILIZATION.labels(r).value)
                    for r in ("cpu", "memory", "ephemeral_storage")}
        cycle("a", 500)
        cycle("b", 100)
        assert gauge()["cpu"] == pytest.approx(0.25)     # 500 / 2000
        steps = [lambda: store.update(NODES, node(1, cpu=3000)),
                 lambda: store.create(NODES, node(2)),
                 lambda: store.delete(NODES, "n0"),
                 lambda: None]
        for k, step in enumerate(steps):
            step()
            sched.pump()
            cycle(f"c{k}", 200)
            assert gauge() == cluster_utilization(
                sched._snapshot.node_infos)
            assert obs.debug_snapshot()["scheduler"]["utilization"] == \
                gauge()
        assert 0.0 < gauge()["cpu"] < 1.0
