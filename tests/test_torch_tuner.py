"""The port's tuner against the JAX package's, on the CPU
(`tests/test_tuner.py` on the port).

- `simulate`'s reward equal to JAX's, bit for bit, on worlds both packages
  recorded from the same pods and nodes (the port's `Scheduler(device=
  "cpu")`, JAX's `Scheduler(use_tpu=True)`), for several rows and gang
  weights;
- `tune`'s winner, reward and history equal to JAX's for the same seed
  (CEM, and the bandit fallback on one world); every searched row inside
  `apis/policy.MAX_WEIGHT`;
- `ProfileSet.set_row` refusals with the reference's messages, and the
  flight recorder's pinned rows across a mid-run write (replay green, a
  tampered table caught);
- the `PromotionGate` verdict table, each verdict equal to JAX's;
- `ShadowTuner`'s writes and the refresh reaching a live `Scheduler(
  device="cpu")`;
- the lane windows (ledger percentiles by lane, lane utilization);
- the tuner cell end to end on the CPU at the reference's smoke size
  (`slow`, as the reference's: it runs on the wall clock; the card's
  `[tuner]` phase runs the cell at its defaults).
"""
import math

import numpy as np
import pytest

from kubernetes_tpu import profiles as jprofiles
from kubernetes_tpu import tuner as jtuner
from kubernetes_tpu.api import types as JT
from kubernetes_tpu.obs import flight as jflight
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store import store as JS
from tests.test_torch_encoders import to_port
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import tuner as ptuner
from kubernetes_tpu_torch.apis.policy import MAX_WEIGHT
from kubernetes_tpu_torch.obs import flight as pflight
from kubernetes_tpu_torch.obs.ledger import PodLifecycleLedger
from kubernetes_tpu_torch.obs.timeseries import SeriesView
from kubernetes_tpu_torch.ops import PRIORITY_AXIS
from kubernetes_tpu_torch.profiles import DEFAULT_PROFILE_NAME
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store.store import NODES, PODS, Store
from kubernetes_tpu_torch.tuner.controller import (
    lane_series, lane_utilization, prefix_lanes,
)

GI = 1024 ** 3


def jnode(i, cpu=4000):
    return JT.Node(name=f"n{i}",
                   labels={"kubernetes.io/hostname": f"n{i}",
                           "failure-domain.beta.kubernetes.io/zone":
                           f"z{i % 2}"},
                   allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def jpod(name, cpu=100, sched=DEFAULT_PROFILE_NAME, **kw):
    return JT.Pod(name=name, scheduler_name=sched,
                  containers=(JT.Container.make(
                      name="c", requests={"cpu": cpu, "memory": GI}),), **kw)


def mknode(i, cpu=4000):
    return to_port(jnode(i, cpu))


def mkpod(name, cpu=100, sched=DEFAULT_PROFILE_NAME, **kw):
    return to_port(jpod(name, cpu, sched, **kw))


@pytest.fixture
def replay_recorders():
    """Both packages' flight recorders in replay mode for the test."""
    recs = (pflight.RECORDER, jflight.RECORDER)
    for r in recs:
        r.configure(mode="replay", capacity=32)
        r.clear()
    yield recs
    for r in recs:
        r.configure(mode="digest")
        r.clear()


def two_profiles(mod=None):
    mod = mod or __import__("kubernetes_tpu_torch.profiles",
                            fromlist=["ProfileSet"])
    return mod.ProfileSet([mod.SchedulingProfile(mod.DEFAULT_PROFILE_NAME),
                           mod.SchedulingProfile("shadow-tuner")])


def record_worlds(port, n_nodes=5, n_pods=10, burst=8):
    """One mixed-size workload through either package's device shell with
    the recorder in replay mode; the recorded bursts as SimWorlds."""
    S = Store if port else JS.Store
    store = S()
    conv = to_port if port else (lambda o: o)
    for i in range(n_nodes):
        store.create(NODES, conv(jnode(i)))
    if port:
        sched = Scheduler(store, use_device=True, device="cpu",
                          percentage_of_nodes_to_score=100)
    else:
        sched = JScheduler(store, use_tpu=True,
                           percentage_of_nodes_to_score=100)
    sched.sync()
    for j in range(n_pods):
        store.create(PODS, conv(jpod(f"p{j}", cpu=(100, 300, 700)[j % 3],
                                     labels={"app": "x"})))
    sched.pump()
    while sched.schedule_burst(max_pods=burst):
        pass
    sched.pump()
    worlds = (ptuner if port else jtuner).worlds_from_recorder()
    assert worlds
    return worlds


@pytest.fixture
def both_worlds(replay_recorders):
    return record_worlds(True), record_worlds(False)


# -- the simulator and the search against the reference ---------------------
ROWS = [
    {"MostRequestedPriority": 13, "SelectorSpreadPriority": 2},
    {"LeastRequestedPriority": 100},
    {"MostRequestedPriority": 100},
    {"LeastRequestedPriority": 3, "BalancedResourceAllocation": 7,
     "SelectorSpreadPriority": 11, "MostRequestedPriority": 1},
]


@pytest.mark.parametrize("gang_weight", [0, 5])
def test_simulate_reward_equals_the_reference_bit_for_bit(both_worlds,
                                                          gang_weight):
    pw, jw = both_worlds
    assert len(pw) == len(jw)
    assert [w.n_pods for w in pw] == [w.n_pods for w in jw]
    for row in ROWS:
        for a, b in zip(pw, jw):
            p = ptuner.simulate(a, row, gang_weight=gang_weight)
            j = jtuner.simulate(b, row, gang_weight=gang_weight)
            assert p.as_dict() == j.as_dict()
            assert p.reward == j.reward          # the float, not rounded
            # and again: deterministic
            assert ptuner.simulate(a, row, gang_weight=gang_weight
                                   ).reward == p.reward


def test_reward_separates_packing_from_spreading(both_worlds):
    pw, _jw = both_worlds
    pack = sum(ptuner.simulate(w, {"MostRequestedPriority": 100}).packing
               for w in pw)
    spread = sum(ptuner.simulate(w, {"LeastRequestedPriority": 100}).packing
                 for w in pw)
    assert pack > spread


def test_cem_ranking_equals_the_reference(both_worlds):
    pw, jw = both_worlds
    keys = ["LeastRequestedPriority", "MostRequestedPriority",
            "BalancedResourceAllocation"]

    def scorer(mod, worlds):
        return lambda w: sum(mod.simulate(x, w).reward for x in worlds)
    p = ptuner.CEMSearch(keys, seed=5, population=8,
                         iterations=2).run(scorer(ptuner, pw))
    j = jtuner.CEMSearch(keys, seed=5, population=8,
                         iterations=2).run(scorer(jtuner, jw))
    assert (p.best_weights, p.best_reward, p.history, p.evaluated) == \
        (j.best_weights, j.best_reward, j.history, j.evaluated)
    again = ptuner.CEMSearch(keys, seed=5, population=8,
                             iterations=2).run(scorer(ptuner, pw))
    assert again.as_dict() == p.as_dict()


@pytest.mark.parametrize("seed", [3, 11])
def test_tune_winner_equals_the_reference(both_worlds, seed):
    pw, jw = both_worlds
    keys = ["LeastRequestedPriority", "MostRequestedPriority",
            "SelectorSpreadPriority"]
    from kubernetes_tpu_torch.factory import DEFAULT_PRIORITY_WEIGHTS
    p = ptuner.tune(pw, keys, seed=seed, budget=32,
                    incumbent=DEFAULT_PRIORITY_WEIGHTS)
    j = jtuner.tune(jw, keys, seed=seed, budget=32,
                    incumbent=DEFAULT_PRIORITY_WEIGHTS)
    assert p.strategy == j.strategy == "cem"
    assert p.as_dict() == j.as_dict()
    assert (p.best_weights, p.best_reward) == (j.best_weights, j.best_reward)
    for v in p.best_weights.values():
        assert 0 < v < MAX_WEIGHT
    two_profiles().set_row("shadow-tuner", p.best_weights)


def test_bandit_fallback_on_thin_worlds_equals_the_reference(both_worlds):
    pw, jw = both_worlds
    p = ptuner.tune(pw[:1], ["LeastRequestedPriority"], seed=1, budget=8)
    j = jtuner.tune(jw[:1], ["LeastRequestedPriority"], seed=1, budget=8)
    assert p.strategy == j.strategy == "bandit"
    assert p.as_dict() == j.as_dict()
    assert ptuner.tune(pw[:1], ["LeastRequestedPriority"], seed=1,
                       budget=8).best_weights == p.best_weights


def test_search_bounds_clip_under_max_weight():
    s = ptuner.CEMSearch(["LeastRequestedPriority"], hi=MAX_WEIGHT * 2)
    assert s.hi == MAX_WEIGHT - 1
    b = ptuner.BanditSearch(["LeastRequestedPriority"], lo=-5,
                            hi=MAX_WEIGHT * 2)
    assert (b.lo, b.hi) == (1, MAX_WEIGHT - 1)
    with pytest.raises(ValueError):
        ptuner.CEMSearch([])


def test_worlds_refuse_records_without_a_capture(replay_recorders):
    rec = pflight.BurstRecord("uniform", [], [], 0, 0, None, None, 0, None,
                              None)
    with pytest.raises(ValueError, match="replay capture"):
        ptuner.SimWorld.from_record(rec)


# -- set_row and the flight recorder's pinned rows ------------------------------
@pytest.mark.parametrize("target,weights", [
    ("shadow-tuner", {"NoSuchPriority": 1}),
    ("shadow-tuner", {"LeastRequestedPriority": 0}),
    ("shadow-tuner", {"LeastRequestedPriority": -3}),
    ("shadow-tuner", {"LeastRequestedPriority": 1 << 31}),
    ("nobody", {"LeastRequestedPriority": 1}),
    (7, {"LeastRequestedPriority": 1}),
])
def test_bad_row_writes_refused_as_the_reference(target, weights):
    msgs = []
    for mod in (__import__("kubernetes_tpu_torch.profiles",
                           fromlist=["x"]), jprofiles):
        ps = two_profiles(mod)
        before = [p.name_weights() for p in ps.profiles]
        with pytest.raises(mod.ProfileValidationError) as ei:
            ps.set_row(target, weights)
        assert [p.name_weights() for p in ps.profiles] == before
        assert ps.version == 0
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


class TestFlightRowPin:
    def _cluster(self, profiles):
        store = Store()
        for i in range(6):
            store.create(NODES, mknode(i))
        sched = Scheduler(store, use_device=True, device="cpu",
                          percentage_of_nodes_to_score=100,
                          profiles=profiles)
        sched.sync()
        return store, sched

    def _burst(self, store, sched, names):
        for name, sname in names:
            store.create(PODS, mkpod(name, sched=sname))
        sched.pump()
        while sched.schedule_burst(max_pods=64):
            pass
        sched.pump()

    def test_replay_green_across_mid_run_row_write(self, replay_recorders):
        rec_p = replay_recorders[0]
        ps = two_profiles()
        store, sched = self._cluster(ps)
        self._burst(store, sched,
                    [(f"a{j}", "shadow-tuner" if j % 2 else
                      DEFAULT_PROFILE_NAME) for j in range(8)])
        ps.set_row("shadow-tuner", {"MostRequestedPriority": 40})
        sched.reload_profiles()
        self._burst(store, sched,
                    [(f"b{j}", "shadow-tuner" if j % 2 else
                      DEFAULT_PROFILE_NAME) for j in range(8)])
        recs = rec_p.records()
        assert len(recs) >= 2
        for rec in recs:
            assert rec_p.replay(rec) == [], rec.kind
        w_pre, w_post = recs[0].capture["wtab"], recs[-1].capture["wtab"]
        i = ps.index_of("shadow-tuner")
        col = PRIORITY_AXIS.index("most_requested")
        assert w_pre[i, col] != 40 and w_post[i, col] == 40
        # the algorithm's weight table is the written one
        assert sched.algorithm.profiles.weight_table()[i, col] == 40

    def test_tampered_pinned_table_fails_replay(self, replay_recorders):
        rec_p = replay_recorders[0]
        store, sched = self._cluster(two_profiles())
        self._burst(store, sched, [(f"p{j}", DEFAULT_PROFILE_NAME)
                                   for j in range(4)])
        rec = rec_p.records()[0]
        rec.capture["wtab"] = rec.capture["wtab"] + 1
        errs = rec_p.replay(rec)
        assert errs and "weight table" in errs[0]


# -- the promotion gate ---------------------------------------------------------
def gate_doc(sh_p99, in_p99, sh_u, in_u):
    n = len(sh_p99)

    def fam(sh, inc):
        return {"type": "gauge", "series": {
            'lane="shadow"': {"value": list(sh)},
            'lane="incumbent"': {"value": list(inc)}}}
    return {"interval": 0.25, "samples": n, "window": n,
            "t": [0.25 * k for k in range(n)],
            "families": {"tuner_lane_p99_seconds": fam(sh_p99, in_p99),
                         "tuner_lane_utilization": fam(sh_u, in_u)}}


GATE_CASES = [
    ("wins_both", gate_doc([0.2] * 8, [0.5] * 8, [0.6] * 8, [0.4] * 8),
     "promote"),
    ("wins_p99", gate_doc([0.2] * 8, [0.5] * 8, [0.39] * 8, [0.40] * 8),
     "promote"),
    ("no_win", gate_doc([0.5] * 8, [0.5] * 8, [0.4] * 8, [0.4] * 8), "hold"),
    ("util_regress", gate_doc([0.2] * 8, [0.5] * 8, [0.2] * 8, [0.4] * 8),
     "hold"),
    ("p99_regress", gate_doc([0.9] * 8, [0.5] * 8, [0.6] * 8, [0.4] * 8),
     "hold"),
    ("slo_breach", gate_doc([6.0] * 8, [0.5] * 8, [0.6] * 8, [0.4] * 8),
     "demote"),
    ("breach_dark_incumbent", gate_doc([6.0] * 8, [None] * 8, [0.6] * 8,
                                       [None] * 8), "demote"),
    ("nan_shadow", gate_doc([None] * 8, [0.5] * 8, [None] * 8, [0.4] * 8),
     "hold"),
    ("nan_incumbent", gate_doc([0.2] * 8, [None] * 8, [0.6] * 8,
                               [None] * 8), "hold"),
    ("thin", gate_doc([0.2] * 2, [0.5] * 2, [0.6] * 2, [0.4] * 2), "hold"),
    ("empty", {"t": [], "families": {}}, "hold"),
    ("missing_family", {"t": [0.0, 0.25], "families": {}}, "hold"),
    ("tail_wins", gate_doc([3.0] * 4 + [0.2] * 4, [0.5] * 8, [0.6] * 8,
                           [0.4] * 8), "promote"),
]


@pytest.mark.parametrize("case,doc,want", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_verdict_table_equals_the_reference(case, doc, want):
    got = ptuner.PromotionGate().decide(doc)
    assert got["decision"] == want, (case, got["reason"])
    assert got == jtuner.PromotionGate().decide(doc)
    assert ptuner.PromotionGate().decide(SeriesView(doc)) == got


def test_lane_series_reads_one_child():
    doc = gate_doc([0.1, 0.2], [0.7, 0.8], [0.5, 0.5], [0.4, 0.4])
    v = SeriesView(doc)
    assert list(lane_series(v, "tuner_lane_p99_seconds", "shadow")) == \
        [0.1, 0.2]
    assert list(lane_series(doc, "tuner_lane_p99_seconds",
                            "incumbent")) == [0.7, 0.8]
    assert list(v.col("tuner_lane_p99_seconds", "value")) == \
        [pytest.approx(0.8), pytest.approx(1.0)]
    assert np.all(np.isnan(lane_series(v, "no_such_family", "shadow")))


# -- the shadow controller ------------------------------------------------------
class TestShadowTuner:
    def test_install_promote_demote_write_rows(self):
        ps = two_profiles()
        t = ptuner.ShadowTuner(ps, "shadow-tuner")
        assert t.incumbent == DEFAULT_PROFILE_NAME
        row = {"MostRequestedPriority": 21}
        t.install(row)
        assert ps.profile_for("shadow-tuner").name_weights() == row
        t.apply({"decision": "promote"})
        assert ps.default.name_weights() == row
        t.install({"MostRequestedPriority": 99})
        t.apply({"decision": "demote"})
        assert ps.profile_for("shadow-tuner").name_weights() == row
        assert t.installed is None
        v = ps.version
        t.apply({"decision": "hold"})
        assert ps.version == v

    @staticmethod
    def _live(port):
        """Either package's device shell over two profiles, a row written
        through its ShadowTuner, then a burst of the shadow's pods.
        Returns (the scheduler, the profile set, {pod: node})."""
        mod = __import__("kubernetes_tpu_torch.profiles" if port
                         else "kubernetes_tpu.profiles", fromlist=["x"])
        ps = two_profiles(mod)
        conv = to_port if port else (lambda o: o)
        store = Store() if port else JS.Store()
        for i in range(4):
            store.create(NODES, conv(jnode(i)))
        if port:
            sched = Scheduler(store, use_device=True, device="cpu",
                              percentage_of_nodes_to_score=100, profiles=ps)
        else:
            sched = JScheduler(store, use_tpu=True,
                               percentage_of_nodes_to_score=100, profiles=ps)
        sched.sync()
        t = (ptuner if port else jtuner).ShadowTuner(
            ps, "shadow-tuner", schedulers=[sched])
        t.install({"MostRequestedPriority": 17, "SelectorSpreadPriority": 1})
        for j in range(6):
            store.create(PODS, conv(jpod(f"s{j}", cpu=700 + 100 * j,
                                         sched="shadow-tuner")))
            store.create(PODS, conv(jpod(f"d{j}", cpu=700 + 100 * j)))
        sched.pump()
        while sched.schedule_burst(max_pods=16):
            pass
        sched.pump()
        return sched, ps, {p.name: p.node_name
                           for p in store.list(PODS)[0]}

    def test_refresh_reaches_live_scheduler(self):
        sched, ps, hosts = self._live(True)
        col = PRIORITY_AXIS.index("most_requested")
        assert sched.algorithm.profiles.weight_table()[
            ps.index_of("shadow-tuner"), col] == 17
        # the burst after the write scores the shadow's pods with the new
        # row: the same bindings as the reference's after its own write
        assert all(hosts.values())
        assert hosts == self._live(False)[2]

    def test_unknown_rows_refused_at_ctor(self):
        ps = two_profiles()
        with pytest.raises(ValueError):
            ptuner.ShadowTuner(ps, "nobody")
        with pytest.raises(ValueError):
            ptuner.ShadowTuner(ps, "shadow-tuner", incumbent="nobody")

    def test_debug_section_and_observe(self):
        from kubernetes_tpu_torch import obs
        ps = two_profiles()
        led = PodLifecycleLedger()
        t = ptuner.ShadowTuner(ps, "shadow-tuner", window=60.0, ledger=led)
        t.install({"MostRequestedPriority": 5})
        state = obs.debug_snapshot()["tuner"]
        assert state["shadow"] == "shadow-tuner"
        assert state["shadow_weights"] == {"MostRequestedPriority": 5}
        assert state["profile_version"] == ps.version
        led.stamp_enqueue("ns/tn-s-1", t=100.0)
        led.commit_many(["ns/tn-s-1"], t=100.5)
        out = t.observe({}, now=101.0)
        assert out["shadow"]["committed"] == 1
        assert out["shadow"]["p99"] == pytest.approx(0.5)
        assert out["incumbent"]["committed"] == 0
        assert math.isnan(out["incumbent"]["p99"])
        assert float(ptuner.TUNER_LANE_P99.labels("shadow").value) == \
            pytest.approx(0.5)


# -- lane windows ---------------------------------------------------------------
class TestLaneWindows:
    def test_window_percentile_filters_by_lane(self):
        led = PodLifecycleLedger()
        lanes = prefix_lanes("tn-i-", "tn-s-")
        t0 = 1000.0
        for k, lat in (("ns/tn-i-1", 1.0), ("ns/tn-i-2", 3.0),
                       ("ns/tn-s-1", 0.1), ("ns/tn-s-2", 0.3)):
            led.stamp_enqueue(k, t=t0)
            led.commit_many([k], t=t0 + lat)
        now = t0 + 10.0
        assert led.window_percentile(0.99, window=60.0, now=now,
                                     match=lanes["incumbent"]) == \
            pytest.approx(3.0)
        assert led.window_percentile(0.99, window=60.0, now=now,
                                     match=lanes["shadow"]) == \
            pytest.approx(0.3)
        assert led.window_count(60.0, now, lanes["incumbent"]) == 2
        assert led.window_count(60.0, now) == 4
        assert led.window_count(5.0, t0 + 100.0, lanes["shadow"]) == 0

    def test_lane_utilization_reads_hosting_nodes_only(self):
        from kubernetes_tpu_torch.cache.node_info import NodeInfo
        lanes = prefix_lanes("tn-i-", "tn-s-")
        nis = {}
        for i in range(3):
            ni = NodeInfo()
            ni.set_node(mknode(i, cpu=1000))
            nis[f"n{i}"] = ni
        p = mkpod("tn-i-0", cpu=500)
        p.node_name = "n0"
        nis["n0"].add_pod(p)
        q = mkpod("tn-s-0", cpu=250)
        q.node_name = "n1"
        nis["n1"].add_pod(q)
        assert lane_utilization(nis, lanes["incumbent"]) == \
            pytest.approx(0.5)
        assert lane_utilization(nis, lanes["shadow"]) == pytest.approx(0.25)
        assert math.isnan(lane_utilization({}, lanes["shadow"]))


# -- the whole loop, small ------------------------------------------------------
@pytest.mark.slow
def test_small_tuner_cell_end_to_end():
    from kubernetes_tpu_torch.tuner.cell import run_tuner_cell
    r = run_tuner_cell(n_nodes=24, arrival_rate=50, duration=4, window=64,
                       search_budget=32, record_worlds=2, device="cpu")
    assert r["search_deterministic"]
    assert r["parity_violations"] == 0 and r["records_replayed"] > 0
    assert r["double_binds"] == 0
    assert r["lanes"]["shadow"]["committed"] > 0
    assert r["lanes"]["incumbent"]["committed"] > 0
    assert r["gate_decision"] in ("promote", "hold", "demote")
