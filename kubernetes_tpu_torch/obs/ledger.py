"""Pod-lifecycle ledger — per-pod phase-stamped latency decomposition.

The paper's claim is throughput *with identical decisions*, and the soak
scoreboard (ROADMAP item 5) scores pod-startup SLO percentiles — but until
this round no pod could answer "where did my 5 seconds go?". The ledger is
a low-overhead per-pod phase stamper: monotonic (`time.perf_counter`)
timestamps at each lifecycle boundary,

    admission -> enqueue -> pop -> encode -> dispatch -> fetch
              -> commit -> copyout

stamped by the admission surface (admission — the apiserver/store accept
of the pod create, BEFORE the informer delivers it to queue.add; absent
for pods that never crossed an admission gate, where it collapses onto
enqueue), the queue (enqueue/pop), the device burst drivers
(encode/dispatch/fetch — one shared stamp per launch, so a 10k-pod burst
pays O(1) clock reads plus O(pods) dict writes, never a per-pod syscall),
the store's commit verbs (commit — the `commit_wave` landing), and the
commit core's watch copy-out sink (copyout — stamped from inside
`PyCommitCore` via the fan-out sink).

Phase durations are differences of consecutive stamps, so they telescope:
the seven phases sum EXACTLY to copyout - admission (the contract test
pins per-pod sums against measured burst wall time; admission collapses
onto enqueue when no gate stamped it). Folds are batched: one vectorized
`observe_batch` per phase per committed wave, not 7 histogram walks per
pod.

A 429-shed pod's record is EVICTED at rejection (`evict`): first-stamp-
wins semantics would otherwise carry the shed attempt's timestamp into
the readmitted pod's record and bill the client's backoff as startup
latency — the readmit must measure from its own accepted create.

Exposed families:
- pod_e2e_duration_seconds{phase} — the decomposition histograms
  (LATENCY_BUCKETS: the µs..100s ladder; queue waits and µs commits share
  one family without crushing either end);
- pod_startup_seconds_p50 / _p99 — callback gauges over a bounded
  reservoir of enqueue->commit latencies (the density.go-style SLO view);
- pod_startup_slo_ok — 1 when p99 <= slo_seconds (default 5s, density.go:56).

Copied from the reference with the port's imports:
`kubernetes_tpu.obs.ledger`. One departure, in cost only: the startup
reservoir is a numpy ring (the newest `reservoir` latencies), and the
readouts keep its sorted copy and the sorted trailing window of their
last call, keyed by a version that every commit and reset moves (the
window also by its first entry, found by bisection while the commit
stamps run in order: the window is then the ring's newest entries, since
`_recent` takes the same latencies in the same order). A time-series
scraper reads seven of these gauges every sample; the reference sorts a
deque of up to 65,536 latencies in Python once a gauge (~20 ms on one
host core), and the scheduler's commit thread waits for it. The values
are the reference's; the per-lane readouts (`match=`) and out-of-order
stamps take the reference's walk.
"""
from __future__ import annotations

import bisect
import operator
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.obs.registry import LATENCY_BUCKETS

# stamp slots (indices into a pod's record)
(ADMISSION, ENQUEUE, POP, ENCODE, DISPATCH, FETCH, COMMIT,
 COPYOUT) = range(8)

#: phase names, in stamp order; PHASES[i] = stamps[i+1] - stamps[i]
PHASES = ("admission", "queue", "encode", "dispatch", "fetch", "commit",
          "fanout")

POD_E2E = obs.histogram(
    "pod_e2e_duration_seconds",
    "Per-pod lifecycle phase durations: admission (apiserver/store "
    "accept->informer-delivered enqueue; zero for pods that never "
    "crossed an admission gate), queue (enqueue->pop), encode "
    "(pop->features encoded), dispatch (encode->device program "
    "dispatched), fetch (dispatch->packed block fetched), commit "
    "(fetch->commit_wave landed in the store), fanout (commit->first "
    "watch copy-out, stamped by the commit core).",
    ("phase",), buckets=LATENCY_BUCKETS)

LEDGER_EVICTED = obs.counter(
    "pod_ledger_evicted_total",
    "Pod ledger records evicted before completing (bound on in-flight "
    "records; an eviction means a pod sat pending longer than the "
    "ledger's capacity window).")

LEDGER_FINALIZED = obs.counter(
    "pod_ledger_finalized_total",
    "Pod ledger records finalized at pod DELETION while still holding an "
    "in-flight slot (pending record, or bound and awaiting the copy-out "
    "stamp): the completion reaper and PodGC delete pods whose bind "
    "events no watcher may ever copy out — without this hook those "
    "records would be retained until the capacity bound evicts them.")

#: density.go:56 — the pod-startup latency SLO the gauges score against
STARTUP_SLO_SECONDS = 5.0

#: rolling window (seconds) the windowed SLO twins score over — long
#: enough to smooth a single launch, short enough that a minute-40
#: degradation flips the gauge within a window
STARTUP_WINDOW_SECONDS = 30.0

#: SLO error budget: the fraction of pods allowed to miss the startup
#: SLO before the burn rate reads 1.0 (burn = violation_frac / budget)
STARTUP_ERROR_BUDGET = 0.01


class PodLifecycleLedger:
    """Process-global per-pod phase stamper (see module docstring)."""

    def __init__(self, capacity: int = 1 << 17,
                 reservoir: int = 1 << 16):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._recs: dict[str, list] = {}      # key -> [t0..t6] (pre-commit)
        self._awaiting: dict[str, float] = {}  # key -> commit ts (fan-out)
        # admission->commit latencies: a ring of the newest `reservoir`
        self._e2e = np.zeros(reservoir, dtype=np.float64)
        self._e2e_n = 0           # filled slots
        self._e2e_at = 0          # the next slot written
        # (commit_ts, latency) pairs for the WINDOWED twins: the
        # cumulative reservoir above is since-reset and averages a
        # late-run stall away; this one is filtered by commit time
        self._recent: deque = deque(maxlen=reservoir)
        #: windowed-reservoir retention (round 23): commit_many trims
        #: `_recent` entries older than this at APPEND time — 4x the
        #: default startup window so every in-repo readout (30 s
        #: windowed twins, the tuner's 60 s lane windows) stays whole
        #: while minutes-scale soaks hold O(window) memory
        self.retention_seconds = 4 * STARTUP_WINDOW_SECONDS
        self._phase_sum = {p: 0.0 for p in PHASES}
        self._completed = 0
        self._trace: Optional[dict] = None    # key -> stamps (test mode)
        # the readouts' memo (module docstring): moved by every commit
        # and reset; `_ordered` while `_recent`'s commit stamps never
        # step back (perf_counter stamps; a synthetic clock may)
        self._version = 0
        self._ordered = True
        self._sorted_e2e: Optional[tuple] = None    # (version, sorted)
        self._sorted_win: Optional[tuple] = None    # ((version, m), sorted)

    # -- configuration -------------------------------------------------------
    def set_trace(self, on: bool) -> None:
        """Keep completed records' raw stamps (contract-test mode)."""
        with self._lock:
            self._trace = {} if on else None

    def reset(self) -> None:
        """Drop every record and accumulated stat (bench run isolation)."""
        with self._lock:
            self._recs.clear()
            self._awaiting.clear()
            self._e2e_n = self._e2e_at = 0
            self._recent.clear()
            self._phase_sum = {p: 0.0 for p in PHASES}
            self._completed = 0
            if self._trace is not None:
                self._trace = {}
            self._version += 1
            self._ordered = True

    # -- stamping ------------------------------------------------------------
    def _open_rec(self, key: str, slot: int, t: Optional[float]) -> None:
        """First stamp wins per slot: a re-queued (backoff) pod keeps its
        original arrival, so queue time honestly includes backoff waits —
        and an admission-stamped pod's later enqueue fills ENQUEUE without
        disturbing the accepted-create stamp."""
        with self._lock:
            rec = self._recs.get(key)
            if rec is None:
                if len(self._recs) >= self._capacity:
                    # bound in-flight records: evict the oldest insertion
                    self._recs.pop(next(iter(self._recs)))
                    LEDGER_EVICTED.inc()
                rec = self._recs[key] = [None] * 8
            if rec[slot] is None:
                rec[slot] = t if t is not None else time.perf_counter()

    def stamp_admission(self, key: str, t: Optional[float] = None) -> None:
        """Apiserver/store accept of the pod create — stamped BEFORE the
        informer delivers the pod to queue.add, so the admission phase
        measures watch-to-enqueue time. First accept wins."""
        self._open_rec(key, ADMISSION, t)

    def stamp_enqueue(self, key: str, t: Optional[float] = None) -> None:
        """First enqueue wins (see _open_rec)."""
        self._open_rec(key, ENQUEUE, t)

    def _open_many(self, keys, slot: int, t: Optional[float]) -> None:
        """Batched _open_rec: one lock + one shared timestamp for a whole
        accepted-create / enqueue batch (first stamp still wins per
        slot)."""
        tt = t if t is not None else time.perf_counter()
        with self._lock:
            recs = self._recs
            for key in keys:
                rec = recs.get(key)
                if rec is None:
                    if len(recs) >= self._capacity:
                        recs.pop(next(iter(recs)))
                        LEDGER_EVICTED.inc()
                    rec = recs[key] = [None] * 8
                if rec[slot] is None:
                    rec[slot] = tt

    def stamp_admission_many(self, keys,
                             t: Optional[float] = None) -> None:
        """One batched admission stamp per accepted create_many flush —
        the serving ingest path's one-ledger-call-per-batch contract."""
        self._open_many(keys, ADMISSION, t)

    def stamp_enqueue_many(self, keys, t: Optional[float] = None) -> None:
        """One batched enqueue stamp per queue.add_many batch."""
        self._open_many(keys, ENQUEUE, t)

    def evict(self, key: str) -> None:
        """Admission rejected the pod (429 shed): drop its in-flight
        record outright. First-stamp-wins would otherwise let a
        shed-then-readmitted pod keep the SHED attempt's stamps and bill
        the client's backoff as startup latency — the readmit opens a
        fresh record at its own accepted create."""
        with self._lock:
            self._recs.pop(key, None)

    def evict_many(self, keys) -> None:
        """Batched evict — one lock for a whole shed batch (the gated
        create_many path's 429 tail)."""
        with self._lock:
            recs = self._recs
            for key in keys:
                recs.pop(key, None)

    def finalize_delete(self, key: str) -> None:
        """The pod was DELETED from the store: drop whatever in-flight
        slot it still holds — a pending record (arrived, never bound) or
        the awaiting-copy-out commit stamp (bound, but its bind event was
        never copied out by a watcher and now never will be). Without
        this hook a completion reaper or PodGC deleting bound pods leaks
        one awaiting entry per deletion until the capacity bound evicts
        them — the round-17 leak fix; the soak-shaped unit test pins the
        steady-state map sizes."""
        with self._lock:
            dropped = self._recs.pop(key, None) is not None
            dropped = (self._awaiting.pop(key, None) is not None) or dropped
        if dropped:
            LEDGER_FINALIZED.inc()

    def stamp(self, key: str, slot: int, t: Optional[float] = None) -> None:
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None:
                rec[slot] = t if t is not None else time.perf_counter()

    def stamp_many(self, keys, slot: int,
                   t: Optional[float] = None) -> None:
        """One shared timestamp for a whole wave/burst boundary — O(1)
        clock reads, O(pods) dict writes."""
        tt = t if t is not None else time.perf_counter()
        with self._lock:
            recs = self._recs
            for k in keys:
                rec = recs.get(k)
                if rec is not None:
                    rec[slot] = tt

    def stamp_serial(self, key: str, t: Optional[float] = None) -> None:
        """Serial-cycle boundary: the host twin has no separate device
        dispatch/fetch, so encode/dispatch/fetch land on one stamp and the
        telescoping identity holds on every path."""
        tt = t if t is not None else time.perf_counter()
        with self._lock:
            rec = self._recs.get(key)
            if rec is not None:
                rec[ENCODE] = rec[DISPATCH] = rec[FETCH] = tt

    # -- completion ----------------------------------------------------------
    def commit_many(self, keys, t: Optional[float] = None) -> None:
        """A wave of bindings landed (`Store.commit_wave` / bind verbs):
        fold each pod's pre-commit phases into the histograms in one
        vectorized batch per phase, record the admission->commit latency
        in the startup reservoir (= enqueue->commit for pods no admission
        gate stamped), and park the commit stamp for the fan-out phase
        (completed by the commit core's copy-out sink)."""
        tt = t if t is not None else time.perf_counter()
        folds: list[list] = []
        fold_keys: list[str] = []
        with self._lock:
            recs = self._recs
            for k in keys:
                rec = recs.pop(k, None)
                if rec is None:
                    continue
                fold_keys.append(k)
                rec[COMMIT] = tt
                # a pod that never crossed an admission gate collapses the
                # admission phase to zero width at its enqueue stamp
                if rec[ADMISSION] is None:
                    rec[ADMISSION] = rec[ENQUEUE]
                # missing intermediate stamps (a path that skipped a
                # boundary) inherit the previous stamp: the phase reads 0
                # and the telescoping identity survives
                for i in range(ENQUEUE, COMMIT + 1):
                    if rec[i] is None:
                        rec[i] = rec[i - 1]
                folds.append(rec)
                self._awaiting[k] = tt
                if len(self._awaiting) > self._capacity:
                    self._awaiting.pop(next(iter(self._awaiting)))
                if self._trace is not None:
                    self._trace[k] = rec
            if not folds:
                return
            self._version += 1
            if self._recent and tt < self._recent[-1][0]:
                self._ordered = False
            lats = []
            for k, rec in zip(fold_keys, folds):
                lat = rec[COMMIT] - rec[ADMISSION]
                lats.append(lat)
                # the key rides along so windowed readouts can filter by
                # lane (round 22: the tuner's shadow-vs-incumbent split)
                self._recent.append((tt, lat, k))
            self._e2e_extend(lats)
            # age-out at append time (round 23): entries older than every
            # readout window can never be walked again (_recent is
            # commit-time ordered), so a minutes-scale soak holds
            # O(window) memory instead of riding the reservoir cap. The
            # retention carries slack past the default 30 s window because
            # the tuner's lane readouts ask for 60 s; the cutoff keys off
            # this batch's stamp, so synthetic clocks trim exactly like
            # wall time.
            cutoff = tt - self.retention_seconds
            recent = self._recent
            while recent and recent[0][0] < cutoff:
                recent.popleft()
            self._completed += len(folds)
        # histogram folds outside the ledger lock (families self-lock)
        for slot, phase in ((ENQUEUE, "admission"), (POP, "queue"),
                            (ENCODE, "encode"), (DISPATCH, "dispatch"),
                            (FETCH, "fetch"), (COMMIT, "commit")):
            vals = [max(0.0, r[slot] - r[slot - 1]) for r in folds]
            POD_E2E.labels(phase).observe_batch(vals)
            self._phase_sum[PHASES[slot - 1]] += sum(vals)

    def has_awaiting(self) -> bool:
        return bool(self._awaiting)

    def copyout(self, key: str, t: Optional[float] = None) -> None:
        """First watch copy-out of the pod's bind event (stamped via the
        commit core's fan-out sink — both native and twin)."""
        with self._lock:
            committed = self._awaiting.pop(key, None)
            if committed is None:
                return
            tt = t if t is not None else time.perf_counter()
            d = max(0.0, tt - committed)
            self._phase_sum["fanout"] += d
            if self._trace is not None and key in self._trace:
                self._trace[key][COPYOUT] = tt
        POD_E2E.labels("fanout").observe(d)

    # -- readout -------------------------------------------------------------
    def trace_record(self, key: str) -> Optional[list]:
        with self._lock:
            return None if self._trace is None else self._trace.get(key)

    def _e2e_extend(self, lats: list) -> None:
        """Write a commit's latencies into the ring (under the lock)."""
        buf = self._e2e
        cap = len(buf)
        if len(lats) >= cap:
            buf[:] = lats[len(lats) - cap:]
            self._e2e_at, self._e2e_n = 0, cap
            return
        at = self._e2e_at
        head = min(len(lats), cap - at)
        buf[at:at + head] = lats[:head]
        buf[:len(lats) - head] = lats[head:]
        self._e2e_at = (at + len(lats)) % cap
        self._e2e_n = min(cap, self._e2e_n + len(lats))

    def _e2e_newest(self, m: int) -> np.ndarray:
        """The ring's newest `m` latencies, in no particular order (a
        copy: the caller sorts it)."""
        at = self._e2e_at
        if m <= at:
            return self._e2e[at - m:at].copy()
        return np.concatenate((self._e2e[:at],
                               self._e2e[len(self._e2e) - (m - at):]))

    def percentile(self, q: float) -> float:
        """Startup (admission->commit; enqueue->commit when no admission
        gate stamped the pod) latency percentile over the bounded
        reservoir; 0.0 with no data."""
        with self._lock:
            memo = self._sorted_e2e
            if memo is None or memo[0] != self._version:
                memo = None
                key, vals = self._version, self._e2e_newest(self._e2e_n)
        if memo is None:
            # the sort runs outside the lock, and numpy releases the GIL
            # for it: a commit never waits for a reader's sort
            vals.sort()
            memo = (key, vals)
            with self._lock:
                self._sorted_e2e = memo
        vals = memo[1]
        if not len(vals):
            return 0.0
        return float(vals[min(len(vals) - 1, int(q * len(vals)))])

    def slo_ok(self, slo: float = STARTUP_SLO_SECONDS) -> float:
        p99 = self.percentile(0.99)
        return 1.0 if p99 <= slo else 0.0

    # -- windowed twins ------------------------------------------------------
    def _window_vals(self, window: Optional[float],
                     now: Optional[float], match=None) -> list:
        """Startup latencies of pods committed within the trailing
        window (commit-stamp clock: perf_counter). `match` filters by
        pod key — the per-lane readout (tuner shadow vs incumbent)."""
        w = STARTUP_WINDOW_SECONDS if window is None else window
        tt = time.perf_counter() if now is None else now
        cutoff = tt - w
        with self._lock:
            # _recent is commit-time ordered: walk from the newest end
            out = []
            for t, lat, key in reversed(self._recent):
                if t < cutoff:
                    break
                if match is None or match(key):
                    out.append(lat)
        return out

    def _window_sorted(self, window: Optional[float],
                       now: Optional[float], match=None):
        """`_window_vals` sorted (a list, or a numpy array). Unfiltered and
        with the stamps in order, the window is `_recent`'s entries from
        the first at or past the cutoff (bisection): the ring's newest
        that many, whose sorted copy is kept for the next call with the
        same version and size (sorted outside the lock, as in
        `percentile`)."""
        if match is not None or not self._ordered:
            return sorted(self._window_vals(window, now, match))
        w = STARTUP_WINDOW_SECONDS if window is None else window
        tt = time.perf_counter() if now is None else now
        cutoff = tt - w
        with self._lock:
            ordered = self._ordered
            if ordered:
                recent = self._recent
                m = len(recent) - bisect.bisect_left(
                    recent, cutoff, key=operator.itemgetter(0))
                key = (self._version, m)
                memo = self._sorted_win
                if memo is None or memo[0] != key:
                    memo, vals = None, self._e2e_newest(m)
        if not ordered:
            return sorted(self._window_vals(window, now, match))
        if memo is None:
            vals.sort()
            memo = (key, vals)
            with self._lock:
                self._sorted_win = memo
        return memo[1]

    def window_percentile(self, q: float, window: Optional[float] = None,
                          now: Optional[float] = None,
                          match=None) -> float:
        """Startup percentile over pods committed in the trailing window
        only — the rolling twin of `percentile` (which is since-reset
        and shows a late-run stall only after it has drowned the early
        samples). 0.0 with no pods in the window. `match` (key ->
        bool) restricts to one lane's pods."""
        vals = self._window_sorted(window, now, match)
        if not len(vals):
            return 0.0
        return float(vals[min(len(vals) - 1, int(q * len(vals)))])

    def window_count(self, window: Optional[float] = None,
                     now: Optional[float] = None, match=None) -> int:
        """Pods committed in the trailing window (optionally one lane's)
        — the promotion gate's minimum-evidence denominator."""
        return len(self._window_sorted(window, now, match))

    def window_violation_fraction(self, slo: float = STARTUP_SLO_SECONDS,
                                  window: Optional[float] = None,
                                  now: Optional[float] = None) -> float:
        """Fraction of pods committed in the trailing window whose
        startup latency missed the SLO; 0.0 with no pods."""
        vals = self._window_sorted(window, now)
        if not len(vals):
            return 0.0
        return (len(vals) - bisect.bisect_right(vals, slo)) / len(vals)

    def window_slo_ok(self, slo: float = STARTUP_SLO_SECONDS,
                      window: Optional[float] = None,
                      now: Optional[float] = None) -> float:
        p99 = self.window_percentile(0.99, window=window, now=now)
        return 1.0 if p99 <= slo else 0.0

    def burn_rate(self, slo: float = STARTUP_SLO_SECONDS,
                  budget: float = STARTUP_ERROR_BUDGET,
                  window: Optional[float] = None,
                  now: Optional[float] = None) -> float:
        """SLO burn rate over the trailing window: the violation
        fraction divided by the error budget (1.0 = burning budget
        exactly as provisioned; >1 = on track to exhaust it)."""
        return self.window_violation_fraction(slo, window, now) / budget

    def snapshot(self) -> dict:
        """Bench/harness readout: startup percentiles + the per-phase
        split over everything folded since the last reset(). phase_split
        values are POD-SECONDS (the sum over pods of that phase's
        duration) — burst-shared boundaries mean each pod's phase spans
        the launch's wall time, so the split reads as relative weight,
        not as wall seconds."""
        with self._lock:
            split = dict(self._phase_sum)
            n = self._completed
        return {
            "startup_p50": round(self.percentile(0.50), 6),
            "startup_p99": round(self.percentile(0.99), 6),
            "startup_slo_ok": bool(self.slo_ok()),
            "startup_p50_windowed": round(self.window_percentile(0.50), 6),
            "startup_p99_windowed": round(self.window_percentile(0.99), 6),
            "startup_slo_ok_windowed": bool(self.window_slo_ok()),
            "slo_burn_rate": round(self.burn_rate(), 6),
            "phase_split": {p: round(v, 6) for p, v in split.items()},
            "pods_completed": n,
        }

    def debug_state(self) -> dict:
        with self._lock:
            return {"in_flight": len(self._recs),
                    "awaiting_fanout": len(self._awaiting),
                    "completed": self._completed}


#: the process-global ledger every layer stamps into
LEDGER = PodLifecycleLedger()

# first-class SLO gauges: read the ledger at collect time (GaugeFunc)
_P50 = obs.gauge("pod_startup_seconds_p50",
                 "Median pod startup (enqueue->commit) latency over the "
                 "ledger reservoir.")
_P50.set_function(lambda: LEDGER.percentile(0.50))
_P99 = obs.gauge("pod_startup_seconds_p99",
                 "p99 pod startup (enqueue->commit) latency over the "
                 "ledger reservoir.")
_P99.set_function(lambda: LEDGER.percentile(0.99))
_SLO = obs.gauge("pod_startup_slo_ok",
                 "1 when the p99 pod-startup latency meets the 5s SLO "
                 "(density.go:56); vacuously 1 with no data.")
_SLO.set_function(lambda: LEDGER.slo_ok())

# windowed twins: the rolling-window view the soak scoreboard samples —
# a late-run stall flips these while the cumulative gauges above are
# still averaging it away (pinned by the stall test)
_P50W = obs.gauge("pod_startup_seconds_p50_windowed",
                  "Median pod startup latency over pods committed in the "
                  "trailing 30s window (rolling twin of "
                  "pod_startup_seconds_p50; 0 with no pods in window).")
_P50W.set_function(lambda: LEDGER.window_percentile(0.50))
_P99W = obs.gauge("pod_startup_seconds_p99_windowed",
                  "p99 pod startup latency over pods committed in the "
                  "trailing 30s window (rolling twin of "
                  "pod_startup_seconds_p99; 0 with no pods in window).")
_P99W.set_function(lambda: LEDGER.window_percentile(0.99))
_SLOW = obs.gauge("pod_startup_slo_ok_windowed",
                  "1 when the trailing-window p99 startup latency meets "
                  "the 5s SLO; vacuously 1 with no pods in window.")
_SLOW.set_function(lambda: LEDGER.window_slo_ok())
_BURN = obs.gauge("slo_burn_rate",
                  "Startup-SLO burn rate over the trailing window: "
                  "fraction of pods missing the 5s SLO divided by the 1% "
                  "error budget (1.0 = burning exactly as provisioned).")
_BURN.set_function(lambda: LEDGER.burn_rate())
