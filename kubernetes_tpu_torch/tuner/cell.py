"""The tuner cell: the whole closed loop in one run, on the port.

Copied from the reference harness (`kubernetes_tpu/perf/harness.py`
`run_tuner_cell`) with the port's imports: the schedulers are the port's
shell on a TorchScheduler (`device`, `cuda` unless the caller asks for the
CPU's plain versions), so phase A's recorded bursts, phase C's two lanes
and the mid-run row write all run on the card's kernels. The drive stays
the reference's: one thread, the two fleet instances stepped in turn, so
the row write lands between steps, never inside a burst. An error of a
step (a CUDA error of a kernel) ends the cell with that error.
"""
from __future__ import annotations

#: the shadow profile of the tuner cell: starts with the DefaultProvider
#: vector; the tuner writes the candidate row into it
TUNE_SHADOW_PROFILE = "shadow-tuner"


def run_tuner_cell(n_nodes: int = 256, arrival_rate: float = 250.0,
                   duration: float = 12.0, window: int = 512,
                   depth: int = 2, use_device: bool = True, device=None,
                   seed: int = 0, search_budget: int = 48,
                   record_worlds: int = 4,
                   install_at_frac: float = 0.3) -> dict:
    """Closed-loop learned-scoring cell — three phases:

    A. RECORD: a solo scheduler (replay-mode flight recorder) schedules
       a mixed-size workload; the recorded bursts become the offline
       simulator's worlds.
    B. SEARCH: a seeded CEM (`tuner.tune`) over integer weight rows
       scores candidates against the worlds; the same search re-run with
       the same seed must reproduce the winner bit-for-bit (the
       determinism audit, checked in-cell).
    C. SHADOW SERVE: two FleetInstances over one store — the incumbent
       profile on one, the shadow profile on the other (partitioning by
       claimed profile = the A/B lane). Two arrival streams (tn-i-* /
       tn-s-*) feed the lanes at arrival_rate/2 each; MID-RUN the tuner
       installs the searched row into the shadow via ProfileSet.set_row +
       reload_profiles (a live tensor-row write). The replay-mode
       recorder runs the whole phase, so the final parity pass proves
       records straddling the write still replay bit-identically (the
       capture pins a ProfileSet snapshot). A ShadowTuner observe tick +
       timeseries scrape each ~250 ms builds the evidence the
       PromotionGate judges at the end.

    In-cell audits (each raises): zero double-binds (BindAuditor), all
    arrivals bound, zero flight-replay mismatches while rows churned,
    deterministic search. Returns the objective readout (windowed
    per-lane p99 + packing utilization, shadow-vs-incumbent bound ratio)
    and the gate's verdict."""
    import random as _random
    import time as _t
    import zlib as _zlib
    from kubernetes_tpu_torch.api.types import Container, Node, Pod
    from kubernetes_tpu_torch.factory import DEFAULT_PRIORITY_WEIGHTS
    from kubernetes_tpu_torch.fleet import BindAuditor, FleetInstance
    from kubernetes_tpu_torch.obs.flight import RECORDER
    from kubernetes_tpu_torch.obs.ledger import LEDGER
    from kubernetes_tpu_torch.obs.timeseries import SCRAPER, SeriesView
    from kubernetes_tpu_torch.profiles import (
        DEFAULT_PROFILE_NAME, ProfileSet, SchedulingProfile)
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.serve import ArrivalGenerator
    from kubernetes_tpu_torch.store.store import NODES, PODS, Store
    from kubernetes_tpu_torch.tuner import (
        PromotionGate, ShadowTuner, simulate, tune, worlds_from_recorder)
    from kubernetes_tpu_torch.tuner.controller import (
        lane_utilization, prefix_lanes)
    GI = 1024 ** 3
    MI = 1024 ** 2
    cpu_sizes = (100, 150, 250)     # mixed sizes give packing traction

    def mknode(i: int) -> Node:
        return Node(
            name=f"node-{i}",
            labels={"failure-domain.beta.kubernetes.io/zone":
                    f"zone-{i % 3}",
                    "kubernetes.io/hostname": f"node-{i}"},
            allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})

    # ---- phase A: record worlds --------------------------------------------
    RECORDER.configure(mode="replay", capacity=max(8, record_worlds))
    RECORDER.clear()
    store_a = Store()
    for i in range(max(16, n_nodes // 8)):
        store_a.create(NODES, mknode(i))
    sched_a = Scheduler(store_a, use_device=use_device, device=device,
                        percentage_of_nodes_to_score=100)
    sched_a.sync()
    rng = _random.Random(seed)
    for j in range(16 * record_worlds):
        store_a.create(PODS, Pod(
            name=f"w{j}", labels={"app": "tune"},
            containers=(Container.make(
                name="c", requests={"cpu": rng.choice(cpu_sizes),
                                    "memory": rng.choice(
                                        (1, 2, 4)) * GI}),)))
    sched_a.pump()
    while sched_a.schedule_burst(max_pods=16):
        pass
    sched_a.pump()
    worlds = worlds_from_recorder(limit=record_worlds)
    if not worlds:
        raise RuntimeError("tuner cell: phase A recorded no replayable "
                           "worlds")

    # ---- phase B: seeded search + determinism audit ------------------------
    keys = ["LeastRequestedPriority", "MostRequestedPriority",
            "BalancedResourceAllocation", "SelectorSpreadPriority"]
    t_search0 = _t.perf_counter()
    result = tune(worlds, keys, seed=seed,
                  incumbent=DEFAULT_PRIORITY_WEIGHTS,
                  budget=search_budget)
    search_s = _t.perf_counter() - t_search0
    twin = tune(worlds, keys, seed=seed,
                incumbent=DEFAULT_PRIORITY_WEIGHTS, budget=search_budget)
    if (twin.best_weights, twin.best_reward) != \
            (result.best_weights, result.best_reward):
        raise RuntimeError("tuner cell: the search is nondeterministic "
                           "under a fixed seed")
    incumbent_reward = sum(
        simulate(w, DEFAULT_PRIORITY_WEIGHTS).reward for w in worlds)

    # ---- phase C: shadow serve + mid-run row write + gate ------------------
    RECORDER.configure(mode="replay", capacity=16)
    RECORDER.clear()
    store = Store(watch_log_size=1 << 16)
    for i in range(n_nodes):
        store.create(NODES, mknode(i))
    pset = ProfileSet([
        SchedulingProfile(DEFAULT_PROFILE_NAME),
        SchedulingProfile(TUNE_SHADOW_PROFILE),   # starts = default row
    ])
    lanes = ((DEFAULT_PROFILE_NAME, "tn-i-"),
             (TUNE_SHADOW_PROFILE, "tn-s-"))
    idents = ["tune-inc", "tune-shd"]
    fleet = [FleetInstance(store, idents[k], [idents[k]],
                           profile=lanes[k][0], profiles=pset,
                           use_device=use_device, device=device,
                           window=window, depth=depth,
                           n_shards=8, lease_duration=5.0,
                           renew_deadline=3.0,
                           percentage_of_nodes_to_score=100)
             for k in range(2)]
    for inst in fleet:
        inst.sync()

    def mkpod_for(profile: str):
        def mk(name: str) -> Pod:
            h = _zlib.crc32(name.encode())
            return Pod(name=name, namespace=f"ns-{h % 32}",
                       labels={"app": "tune"}, scheduler_name=profile,
                       containers=(Container.make(
                           name="c",
                           requests={"cpu": cpu_sizes[h % len(cpu_sizes)],
                                     "memory": 500 * MI}),))
        return mk

    def fleet_idle() -> bool:
        for inst in fleet:
            if inst.sched.queue.num_pending() > 0:
                return False
            if inst.sched.informers.informer(PODS).backlog() > 0:
                return False
        return True

    # warmup (first launches + claim settling for both profiles), outside
    # the clock
    for prof, prefix in lanes:
        warm = ArrivalGenerator(store, rate=10 ** 9, total=16,
                                pod_fn=mkpod_for(prof),
                                name_prefix=f"{prefix}warm-", seed=seed)
        for _ in range(3):
            warm.tick()
            for inst in fleet:
                inst.step()
    deadline_warm = _t.perf_counter() + 60.0
    while _t.perf_counter() < deadline_warm:
        if sum(inst.step() for inst in fleet) == 0 and fleet_idle():
            break

    auditor = BindAuditor(store)
    LEDGER.reset()
    SCRAPER.reset()
    lane_match = prefix_lanes("tn-i-", "tn-s-")
    tuner = ShadowTuner(pset, TUNE_SHADOW_PROFILE,
                        incumbent=DEFAULT_PROFILE_NAME,
                        schedulers=fleet, lane_match=lane_match,
                        window=max(duration, 10.0))
    gens = [ArrivalGenerator(store, rate=arrival_rate / 2,
                             pod_fn=mkpod_for(prof), name_prefix=prefix,
                             seed=seed + k)
            for k, (prof, prefix) in enumerate(lanes)]
    installed_at = None
    last_obs = 0.0
    bound0 = [inst.loop.pods_bound for inst in fleet]
    t0 = _t.perf_counter()
    t_end = t0 + duration
    # single-threaded round-robin drive: the mid-run set_row +
    # reload_profiles lands BETWEEN steps, never inside a burst
    while _t.perf_counter() < t_end:
        for g in gens:
            g.tick()
        for inst in fleet:
            inst.step()
        auditor.scan()
        now = _t.perf_counter()
        if installed_at is None and now - t0 >= install_at_frac * duration:
            tuner.install(result.best_weights)      # the live row write
            installed_at = now - t0
        if now - last_obs >= 0.25:
            tuner.observe(fleet[0].sched._snapshot.node_infos)
            SCRAPER.sample()
            last_obs = now
    elapsed = _t.perf_counter() - t0
    if installed_at is None:          # degenerate short durations
        tuner.install(result.best_weights)
        installed_at = elapsed
    # settle: drain both lanes, then one last observe/scrape
    settle_deadline = _t.perf_counter() + 60.0
    while _t.perf_counter() < settle_deadline:
        for g in gens:
            g.flush_retries(timeout=0.1)
        if sum(inst.step() for inst in fleet) == 0 and fleet_idle() \
                and all(g.stats()["pending_retry"] == 0 for g in gens):
            break
    auditor.scan()
    tuner.observe(fleet[0].sched._snapshot.node_infos)
    SCRAPER.sample()
    auditor.stop()

    # parity while rows churn: every recorded burst (both lanes, before
    # AND after the set_row write) must replay bit-identically — the
    # flight capture pinned a ProfileSet snapshot per burst
    replayed = len(RECORDER.records())
    parity_errs = RECORDER.replay_all()
    RECORDER.configure(mode="digest")
    RECORDER.clear()
    if parity_errs:
        raise RuntimeError(f"tuner cell: flight replay mismatches across "
                           f"the row write: {parity_errs[:5]}")

    measured = [p for p in store.list(PODS)[0]
                if p.name.startswith("tn-")]
    unbound = [p.key for p in measured if not p.node_name]
    if unbound:
        raise RuntimeError(f"tuner cell: {len(unbound)} arrivals never "
                           f"bound")
    if auditor.violations:
        raise RuntimeError(f"tuner cell: DOUBLE BINDS observed: "
                           f"{auditor.violations[:5]}")

    # objective readout + the gate's verdict
    snapshot_infos = fleet[0].sched._snapshot.node_infos
    now = _t.perf_counter()
    lane_stats = {}
    for lane, match in lane_match.items():
        lane_stats[lane] = {
            "p99": LEDGER.window_percentile(
                0.99, window=elapsed + 60.0, now=now, match=match),
            "utilization": lane_utilization(snapshot_infos, match),
            "committed": LEDGER.window_count(
                window=elapsed + 60.0, now=now, match=match),
        }
    bound_by = {idents[k]: fleet[k].loop.pods_bound - bound0[k]
                for k in range(2)}
    inc_bound = bound_by["tune-inc"]
    shd_bound = bound_by["tune-shd"]
    gate = PromotionGate()
    decision = tuner.apply(gate.decide(SeriesView(SCRAPER.series())))
    sh, inc = lane_stats["shadow"], lane_stats["incumbent"]
    util_win = sh["utilization"] > inc["utilization"]
    p99_win = sh["p99"] < inc["p99"]
    led = LEDGER.snapshot()
    return {
        "nodes": n_nodes,
        "arrival_rate": arrival_rate,
        "duration": round(elapsed, 2),
        "worlds_recorded": len(worlds),
        "search": result.as_dict(),
        "search_seconds": round(search_s, 3),
        "search_deterministic": True,      # checked above
        "incumbent_sim_reward": round(incumbent_reward, 3),
        "tuned_vs_incumbent_reward": round(
            result.best_reward / incumbent_reward, 4)
        if incumbent_reward else None,
        "installed_at_s": round(installed_at, 2),
        "profile_version": pset.version,
        "lanes": {l: {"p99": round(s["p99"], 4),
                      "utilization": (None if s["utilization"] !=
                                      s["utilization"] else
                                      round(s["utilization"], 4)),
                      "committed": s["committed"]}
                  for l, s in lane_stats.items()},
        "shadow_bound": shd_bound,
        "incumbent_bound": inc_bound,
        "shadow_vs_incumbent_throughput": round(
            shd_bound / inc_bound, 4) if inc_bound else None,
        "objective_win_utilization": util_win,
        "objective_win_p99": p99_win,
        "objective_win": bool(util_win or p99_win),
        "gate_decision": decision["decision"],
        "gate_reason": decision["reason"],
        "gate_stats": decision["stats"],
        "records_replayed": replayed,
        "parity_violations": 0,            # checked above
        "double_binds": len(auditor.violations),
        "audit_no_double_bind": True,
        "startup_p99": led["startup_p99"],
        "startup_p99_windowed": led["startup_p99_windowed"],
        "pods_completed": led["pods_completed"],
    }
