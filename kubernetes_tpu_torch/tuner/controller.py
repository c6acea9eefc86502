"""Shadow-profile controller + promotion gate (the online half).

The offline search ends with a candidate row; serving it is a
`ProfileSet.set_row` write into the SHADOW profile — the fleet already
partitions responsibility by claimed profile (round 18), so exactly one
instance serves the candidate and the cluster runs a live A/B split
with zero new serving machinery. `ShadowTuner` owns the writes (and the
`Scheduler.reload_profiles` refresh that makes them live), publishes the
per-lane measurement gauges each observe tick, and applies the gate's
verdicts.

`PromotionGate` reads the evidence the way the soak verdict engine does
(round 21): a `SeriesView` over the timeseries scraper's document, lane
columns `tuner_lane_p99_seconds{lane}` / `tuner_lane_utilization{lane}`,
judged over the trailing `tail` fraction of the observation window.

The asymmetry is deliberate and load-bearing:
- PROMOTE requires positive evidence: enough valid samples in BOTH
  lanes, the shadow beating the incumbent on p99 and/or utilization,
  and no regression past tolerance on the other axis.
- HOLD is the default: NaN columns, missing families, and thin windows
  all hold. No data NEVER promotes.
- DEMOTE fires on an SLO breach of the shadow lane alone — a bad row is
  pulled without waiting for a full comparison window.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from kubernetes_tpu_torch.obs.timeseries import SeriesView

#: default shadow observation window knobs
DEFAULT_SLO_SECONDS = 5.0
DEFAULT_MIN_SAMPLES = 4
DEFAULT_TAIL = 0.5


def lane_series(view, family: str, lane: str,
                col: str = "value") -> np.ndarray:
    """One lane's column from a series document — the per-child twin of
    SeriesView.col (which SUMS children and would blend the lanes)."""
    if not isinstance(view, SeriesView):
        view = SeriesView(view)
    n = len(view.t)
    fam = view.doc.get("families", {}).get(family)
    if fam is None:
        return np.full(n, np.nan)
    ser = fam["series"].get(f'lane="{lane}"')
    if ser is None:
        return np.full(n, np.nan)
    vals = ser.get(col)
    if vals is None:
        return np.full(n, np.nan)
    return np.asarray([np.nan if v is None else float(v) for v in vals],
                      dtype=np.float64)


class PromotionGate:
    """Promote / hold / demote over the shadow lane's evidence window."""

    def __init__(self, slo: float = DEFAULT_SLO_SECONDS,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 p99_tolerance: float = 0.10,
                 util_tolerance: float = 0.05,
                 tail: float = DEFAULT_TAIL):
        self.slo = float(slo)
        self.min_samples = int(min_samples)
        self.p99_tolerance = float(p99_tolerance)
        self.util_tolerance = float(util_tolerance)
        self.tail = float(tail)

    def decide(self, view_or_doc) -> dict:
        """Render one verdict from a timeseries document (or SeriesView).
        Returns {"decision": promote|hold|demote, "reason", "stats"}."""
        from kubernetes_tpu_torch.tuner import TUNER_DECISIONS
        view = (view_or_doc if isinstance(view_or_doc, SeriesView)
                else SeriesView(view_or_doc))
        lo = 1.0 - self.tail
        stats: dict = {}
        cols: dict = {}
        for lane in ("incumbent", "shadow"):
            p99 = lane_series(view, "tuner_lane_p99_seconds", lane)
            util = lane_series(view, "tuner_lane_utilization", lane)
            cols[lane] = (p99, util)
            stats[lane] = {
                "p99": view.seg_mean(p99, lo, 1.0),
                "utilization": view.seg_mean(util, lo, 1.0),
                "p99_samples": view.valid(p99),
                "util_samples": view.valid(util),
            }

        def verdict(decision: str, reason: str) -> dict:
            TUNER_DECISIONS.labels(decision).inc()
            return {"decision": decision, "reason": reason,
                    "stats": {l: {k: (None if isinstance(v, float)
                                      and np.isnan(v) else
                                      (round(v, 6) if isinstance(v, float)
                                       else v))
                                  for k, v in s.items()}
                              for l, s in stats.items()}}

        sh_p99 = stats["shadow"]["p99"]
        # demote needs only the shadow's own evidence: a breaching row
        # is pulled even while the incumbent lane is still dark
        if stats["shadow"]["p99_samples"] >= self.min_samples \
                and not np.isnan(sh_p99) and sh_p99 > self.slo:
            return verdict(
                "demote", f"shadow windowed p99 {sh_p99:.3f}s breaches "
                          f"the {self.slo:.1f}s SLO")
        for lane in ("incumbent", "shadow"):
            s = stats[lane]
            if s["p99_samples"] < self.min_samples \
                    or s["util_samples"] < self.min_samples:
                return verdict("hold", f"{lane} lane has insufficient "
                                       f"valid samples (no-data holds, "
                                       f"never promotes)")
            if np.isnan(s["p99"]) or np.isnan(s["utilization"]):
                return verdict("hold", f"{lane} lane window is NaN "
                                       f"(no-data holds, never promotes)")
        in_p99 = stats["incumbent"]["p99"]
        sh_u = stats["shadow"]["utilization"]
        in_u = stats["incumbent"]["utilization"]
        p99_ok = sh_p99 <= in_p99 * (1.0 + self.p99_tolerance) \
            or sh_p99 <= self.slo * 0.1
        util_ok = sh_u >= in_u * (1.0 - self.util_tolerance)
        wins = (sh_p99 < in_p99) or (sh_u > in_u)
        if p99_ok and util_ok and wins:
            return verdict(
                "promote",
                f"shadow wins (p99 {sh_p99:.3f}s vs {in_p99:.3f}s, "
                f"utilization {sh_u:.3f} vs {in_u:.3f}) without "
                f"regression past tolerance")
        return verdict("hold", "shadow does not beat the incumbent on "
                               "p99 or utilization yet")


def prefix_lanes(incumbent_prefix: str,
                 shadow_prefix: str) -> dict:
    """Lane predicates over ledger pod keys ("namespace/name"): the
    harness names each lane's pods with a distinct prefix."""
    def match(prefix: str) -> Callable[[str], bool]:
        return lambda key: key.split("/", 1)[-1].startswith(prefix)
    return {"incumbent": match(incumbent_prefix),
            "shadow": match(shadow_prefix)}


def lane_utilization(node_infos, match: Callable[[str], bool]) -> float:
    """Mean cpu fill of the nodes hosting >= 1 pod the lane predicate
    claims — the packing objective, measured on the LIVE cluster. NaN
    when the lane hosts nothing (no-data, not zero)."""
    fills = []
    for ni in (node_infos.values() if hasattr(node_infos, "values")
               else node_infos):
        if ni.node is None or not ni.pods:
            continue
        if any(match(p.key) for p in ni.pods):
            alloc = ni.allocatable.milli_cpu
            fills.append(ni.requested.milli_cpu / alloc
                         if alloc > 0 else 0.0)
    return sum(fills) / len(fills) if fills else float("nan")


class ShadowTuner:
    """Owns the shadow row: install, measure, and apply gate verdicts."""

    def __init__(self, profiles, shadow: str,
                 incumbent: Optional[str] = None,
                 schedulers=(), lane_match: Optional[dict] = None,
                 window: Optional[float] = None, ledger=None):
        self.profiles = profiles
        self.shadow = shadow
        self.incumbent = (incumbent if incumbent is not None
                          else profiles.default.name)
        if profiles.index_of(shadow) is None:
            raise ValueError(f"shadow profile {shadow!r} not in the set")
        if profiles.index_of(self.incumbent) is None:
            raise ValueError(
                f"incumbent profile {self.incumbent!r} not in the set")
        self.schedulers = list(schedulers)
        self.lane_match = lane_match or prefix_lanes("tn-i-", "tn-s-")
        self.window = window
        if ledger is None:
            from kubernetes_tpu_torch.obs.ledger import LEDGER as ledger
        self.ledger = ledger
        self.last_decision: Optional[dict] = None
        self.installed: Optional[dict] = None
        self._register_debug()

    # -- writes --------------------------------------------------------------
    def _refresh(self) -> None:
        """Make a row write LIVE on every serving scheduler (oracle
        config lists + the device weight tensor)."""
        for s in self.schedulers:
            reload = getattr(s, "reload_profiles", None)
            if reload is None:           # a FleetInstance: unwrap
                s.sched.reload_profiles()
            else:
                reload()

    def install(self, weights: dict):
        """Write the candidate into the SHADOW row (ctor-equivalent
        validation inside set_row; nothing mutates on failure)."""
        from kubernetes_tpu_torch.tuner import TUNER_ROWS_WRITTEN
        prof = self.profiles.set_row(self.shadow, dict(weights))
        self.installed = dict(weights)
        TUNER_ROWS_WRITTEN.labels("shadow").inc()
        self._refresh()
        return prof

    def promote(self):
        """Write the shadow's row into the INCUMBENT row."""
        from kubernetes_tpu_torch.tuner import TUNER_ROWS_WRITTEN
        shadow = self.profiles.profile_for(self.shadow)
        prof = self.profiles.set_row(
            self.incumbent, shadow.name_weights(),
            rank_aware=shadow.rank_aware, gang_weight=shadow.gang_weight)
        TUNER_ROWS_WRITTEN.labels("incumbent").inc()
        self._refresh()
        return prof

    def demote(self):
        """Pull the experiment: the shadow row reverts to the incumbent's
        weights (the lane keeps serving, just not the candidate)."""
        from kubernetes_tpu_torch.tuner import TUNER_ROWS_WRITTEN
        inc = self.profiles.profile_for(self.incumbent)
        prof = self.profiles.set_row(
            self.shadow, inc.name_weights(),
            rank_aware=inc.rank_aware, gang_weight=inc.gang_weight)
        self.installed = None
        TUNER_ROWS_WRITTEN.labels("shadow").inc()
        self._refresh()
        return prof

    def apply(self, decision: dict) -> dict:
        """Apply a gate verdict (promote/demote write rows; hold is a
        no-op). Returns the decision for chaining."""
        self.last_decision = decision
        d = decision.get("decision")
        if d == "promote":
            self.promote()
        elif d == "demote":
            self.demote()
        return decision

    # -- measurement ---------------------------------------------------------
    def observe(self, node_infos, now: Optional[float] = None) -> dict:
        """One measurement tick: publish each lane's windowed p99 (ledger,
        per-lane key filter) and live packing utilization to the
        `tuner_lane_*` gauges — the scraper samples them into the series
        the gate reads. NaN = the lane produced nothing this window."""
        from kubernetes_tpu_torch.tuner import (
            TUNER_LANE_P99, TUNER_LANE_UTILIZATION)
        out = {}
        for lane, match in self.lane_match.items():
            n = self.ledger.window_count(self.window, now, match)
            p99 = (self.ledger.window_percentile(
                0.99, self.window, now, match) if n else float("nan"))
            util = lane_utilization(node_infos, match)
            TUNER_LANE_P99.labels(lane).set(p99)
            TUNER_LANE_UTILIZATION.labels(lane).set(util)
            out[lane] = {"p99": p99, "utilization": util, "committed": n}
        return out

    # -- /debug/sched --------------------------------------------------------
    def _register_debug(self) -> None:
        import weakref
        from kubernetes_tpu_torch import obs
        ref = weakref.ref(self)

        def snap():
            t = ref()
            return None if t is None else t.debug_state()
        obs.register_debug("tuner", snap)

    def debug_state(self) -> dict:
        shadow = self.profiles.profile_for(self.shadow)
        inc = self.profiles.profile_for(self.incumbent)
        return {
            "shadow": self.shadow,
            "incumbent": self.incumbent,
            "profile_version": self.profiles.version,
            "installed": self.installed,
            "shadow_weights": dict(shadow.name_weights()),
            "incumbent_weights": dict(inc.name_weights()),
            "last_decision": self.last_decision,
        }
