"""Closed-loop learned scoring — the tuner writes profile tensor rows.

Copied whole from the reference (`kubernetes_tpu.tuner`) with the port's
imports: the worlds come from the port's flight recorder, the simulator
replays them through the port's copy of the oracle, the search is bounded
by the port's `apis/policy.MAX_WEIGHT`, and the shadow controller writes
the rows the port's TorchScheduler scores with on the card. `tuner.cell`
adds the reference harness's tuner cell (`run_tuner_cell`) on the port.

The round-19 `[profiles x priorities]` tensor was designed so a learner
only writes ROWS: kernels, parity contracts, and the oracle referee are
untouched — a tuned row is just data, and every decision stays
bit-identical to the serial oracle given the same tensor. The loop:

    flight-recorder worlds ──> offline simulator ──> reward
             ^                        │
             │                 seeded CEM search
             │                        │ best row
    live decisions <── ProfileSet.set_row(shadow) ── shadow controller
             │                        ^
       obs/timeseries ──> promotion gate (promote / hold / demote)

- `tuner.simulator`: replays recorded flight-recorder worlds through the
  serial oracle with a CANDIDATE weight row substituted; the reward is a
  deterministic placement-quality objective (placed fraction, packing
  utilization, zone spread, gang locality). Same seed + same worlds =>
  identical reward — the search is reproducible by construction.
- `tuner.search`: seeded cross-entropy method over integer weight rows
  (bandit fallback when the world set is too thin to rank populations),
  bounded by the SAME apis/policy weight validation construction runs.
- `tuner.controller`: installs the best row as a SHADOW profile via
  `ProfileSet.set_row` (ctor-equivalent validation; serving schedulers
  refresh through `Scheduler.reload_profiles`), measures the shadow
  lane against the incumbent (fleet already partitions by claimed
  profile — the free A/B lane), and a promotion gate reads windowed
  p99 + utilization from `obs/timeseries.SeriesView`: promote (write
  the incumbent row), hold, or demote on SLO breach. NaN / no-data
  windows HOLD — the gate never promotes blind.
"""
from __future__ import annotations

from kubernetes_tpu_torch import obs

TUNER_CANDIDATES = obs.counter(
    "tuner_candidates_evaluated_total",
    "Candidate weight rows scored by the offline simulator, by search "
    "strategy (cem | bandit).", ("strategy",))
TUNER_ROWS_WRITTEN = obs.counter(
    "tuner_rows_written_total",
    "ProfileSet.set_row writes performed by the tuner, by target row "
    "(shadow = candidate installed for A/B serving; incumbent = a "
    "promoted row).", ("row",))
TUNER_DECISIONS = obs.counter(
    "tuner_promotion_decisions_total",
    "Promotion-gate verdicts rendered, by decision "
    "(promote | hold | demote).", ("decision",))
TUNER_BEST_REWARD = obs.gauge(
    "tuner_best_reward",
    "Best simulator reward found by the most recent offline search.")
TUNER_LANE_P99 = obs.gauge(
    "tuner_lane_p99_seconds",
    "Windowed startup p99 of one serving lane (shadow vs incumbent), "
    "published by the shadow controller's observe tick; NaN when the "
    "lane committed nothing inside the window (the gate reads NaN as "
    "no-data and holds).", ("lane",))
TUNER_LANE_UTILIZATION = obs.gauge(
    "tuner_lane_utilization",
    "Mean cpu fill of the nodes hosting one lane's pods (the packing "
    "objective the reward optimizes), published by the shadow "
    "controller's observe tick; NaN when the lane hosts nothing.",
    ("lane",))

from kubernetes_tpu_torch.tuner.simulator import (   # noqa: E402
    SimWorld, SimResult, simulate, worlds_from_recorder,
)
from kubernetes_tpu_torch.tuner.search import (      # noqa: E402
    CEMSearch, BanditSearch, TuneResult, tune,
)
from kubernetes_tpu_torch.tuner.controller import (  # noqa: E402
    PromotionGate, ShadowTuner, lane_series,
)

__all__ = [
    "SimWorld", "SimResult", "simulate", "worlds_from_recorder",
    "CEMSearch", "BanditSearch", "TuneResult", "tune",
    "PromotionGate", "ShadowTuner", "lane_series",
    "TUNER_CANDIDATES", "TUNER_ROWS_WRITTEN", "TUNER_DECISIONS",
    "TUNER_BEST_REWARD", "TUNER_LANE_P99", "TUNER_LANE_UTILIZATION",
]
