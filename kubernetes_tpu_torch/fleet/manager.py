"""Fleet orchestration: round-robin driver, double-bind tripwire, and
the differential replay harness behind the per-partition parity claim.

Copied from the reference (`kubernetes_tpu.fleet.manager`) with the
port's imports. Nothing here catches an error of an instance's step but
the `sched.crash` seam's SchedulerCrash: a CUDA error stops the run.

`FleetManager` steps N `FleetInstance`s against one store in a
DETERMINISTIC round-robin (the sweeps' requirement: trial N always
interleaves the same way), catches the `sched.crash` seam as a mid-burst
instance kill, and — with `record=True` — writes a timeline of
everything that is an INPUT to any one instance's decisions: the initial
store snapshot, every arrival batch, every clock step, and per step the
stepping instance's claim map, the store's fence table, and the binds
that landed (attributed exactly, because steps are serialized).

`BindAuditor` is the zero-double-bind tripwire: it folds the shared
store's pod watch stream and counts any nodeName transition from one
non-empty value to a different one on `fleet_double_binds_total` — the
counter every fleet test, sweep, and bench audit pins at zero.

`replay_instance` is the parity referee: re-run ONE instance's recorded
trajectory in a fresh world — same initial snapshot, same arrivals, same
clock, same claim timeline (ScriptedClaims; no lease traffic), every
OTHER instance's binds applied verbatim as store writes at the recorded
points, the recorded fence table re-applied before each step — and
require the solo re-run's bind stream to be bit-identical, step by step,
to what the live instance committed. A reclaimed partition's
post-failover stream therefore equals a solo scheduler that observed the
same pod subset, which is the tentpole's recovery contract. Steps where
the live instance was killed MID-BURST (`crashed`) are applied as
foreign writes instead of compared: a partial wave is real history for
the survivors, but not a deterministic program point to re-derive.
"""
from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch import chaos
from kubernetes_tpu_torch.fleet import DOUBLE_BINDS
from kubernetes_tpu_torch.store.store import (
    DELETED, NODES, PODS, ExpiredError, Store,
)


class BindAuditor:
    """Fold the shared store's pod watch into (a) the per-scan list of
    fresh bindings, in commit order, and (b) the double-bind tripwire."""

    def __init__(self, store):
        # seed current nodeName state, THEN attach: a pod bound before
        # the auditor existed must not read as freshly bound
        self._node = {p.key: p.node_name for p in store.list(PODS)[0]}
        self._watch = store.watch(PODS)
        self.violations: list = []

    def scan(self) -> list:
        """Drain the watch; returns [(pod_key, node), ...] for bindings
        that landed since the last scan, in commit (rv) order."""
        try:
            events = self._watch.drain()
        except ExpiredError as e:
            # the audit window is load-bearing: a dropped auditor cannot
            # certify zero double-binds, so fail the harness loudly
            raise RuntimeError(
                f"bind auditor fell behind the watch window: {e}") from e
        binds = []
        for ev in events:
            key = ev.obj.key
            if ev.type == DELETED:
                self._node.pop(key, None)
                continue
            prev = self._node.get(key, "")
            cur = ev.obj.node_name
            if cur and not prev:
                binds.append((key, cur))
            elif cur and prev and cur != prev:
                DOUBLE_BINDS.inc()
                self.violations.append((key, prev, cur))
            self._node[key] = cur
        return binds

    def stop(self) -> None:
        self._watch.stop()


class FleetManager:
    """Deterministic round-robin driver over one shared store."""

    def __init__(self, store: Store, identities: list,
                 make_instance: Callable[[str], object],
                 clock=None, record: bool = False, profiles=None):
        self.store = store
        self.clock = clock
        self.identities = list(identities)
        self.make_instance = make_instance
        # round-19 scheduling profiles: when the fleet serves a
        # ProfileSet, create_pods REPORTS arrivals whose schedulerName no
        # fleet profile claims (scheduler_profile_unknown_total + event)
        # — such a pod would otherwise sit unowned forever, silently
        self.profiles = profiles
        self._recorder = None
        self.instances = {}
        for ident in self.identities:
            inst = make_instance(ident)
            inst.sync()
            self.instances[ident] = inst
        self.timeline: Optional[list] = [] if record else None
        if self.timeline is not None:
            self.timeline.append({
                "op": "start",
                "t": float(clock.now()) if clock is not None else 0.0,
                "nodes": [n.clone() for n in store.list(NODES)[0]],
                "pods": [p.clone() for p in store.list(PODS)[0]],
            })
        self.auditor = BindAuditor(store)
        self.crashes: list = []

    # -- recorded world inputs ----------------------------------------------
    def create_pods(self, pods: list) -> None:
        """Arrival batch: written to the store AND recorded (clones), so
        the replay feeds the identical sequence. Pods whose schedulerName
        no fleet profile claims are reported (never default-scored; they
        stay pending until a profile claims them)."""
        if self.timeline is not None:
            self.timeline.append(
                {"op": "create", "pods": [p.clone() for p in pods]})
        for pod in pods:
            self.store.create(PODS, pod)
            if self.profiles is not None \
                    and self.profiles.index_of(pod.scheduler_name) is None:
                if self._recorder is None:
                    from kubernetes_tpu_torch.store.record import EventRecorder
                    self._recorder = EventRecorder(
                        self.store, component="fleet-manager")
                self.profiles.report_unknown(pod, recorder=self._recorder)

    def advance_clock(self, dt: float) -> None:
        if self.clock is None:
            raise RuntimeError("advance_clock needs the shared FakeClock")
        self.clock.step(dt)
        if self.timeline is not None:
            self.timeline.append({"op": "clock", "dt": float(dt)})

    # -- stepping ------------------------------------------------------------
    def step(self, ident: str) -> int:
        """Step one instance; attribute the binds that landed; record.
        A SchedulerCrash (the sched.crash seam) is the mid-burst kill:
        the instance is marked dead where it stood — a partial wave may
        have landed, which the auditor attributes faithfully."""
        inst = self.instances[ident]
        if inst.dead:
            return 0
        crashed = False
        bound = 0
        try:
            bound = inst.step()
        except chaos.SchedulerCrash:
            crashed = True
            inst.kill()
            self.crashes.append(ident)
        binds = self.auditor.scan()
        if self.timeline is not None:
            entry = {
                "op": "step",
                "inst": ident,
                "claims": dict(inst.claims.tokens()),
                "fences": (self.store.fence_table()
                           if hasattr(self.store, "fence_table") else {}),
                "binds": list(binds),
            }
            if crashed:
                entry["crashed"] = True
            self.timeline.append(entry)
        return bound

    def step_all(self) -> int:
        bound = 0
        for ident in self.identities:
            bound += self.step(ident)
        return bound

    def kill(self, ident: str) -> None:
        """Silent process death: leases expire on their own."""
        self.instances[ident].kill()
        if self.timeline is not None:
            self.timeline.append({"op": "kill", "inst": ident})

    def restart(self, ident: str) -> None:
        """Fresh process under the same identity: new scheduler, full
        re-list, empty claims (re-acquired through the normal protocol)."""
        inst = self.make_instance(ident)
        inst.sync()
        self.instances[ident] = inst
        if self.timeline is not None:
            self.timeline.append({"op": "restart", "inst": ident})

    def live_instances(self) -> list:
        return [i for i in self.instances.values() if not i.dead]

    def owned_disjoint(self) -> bool:
        """No shard is BELIEVED-owned by two live, claim-maintaining
        instances (partition sanity — the lease CAS makes true overlap
        impossible; this is the cheap assertion sweeps run every round).
        An instance whose claim maintenance is PAUSED (the
        fleet.lease-loss zombie window) is excluded: its stale belief is
        EXPECTED to overlap the usurper's fresh claim — that window is
        precisely what the store's fencing covers, and the zombie's
        writes are rejected there, not here."""
        seen: set = set()
        for inst in self.live_instances():
            if getattr(inst, "paused_claims", 0) > 0:
                continue
            owned = inst.claims.owned()
            if owned & seen:
                return False
            seen |= owned
        return True

    def stats(self) -> dict:
        return {
            "instances": {i: inst.stats()
                          for i, inst in self.instances.items()},
            "double_binds": len(self.auditor.violations),
            "crashes": list(self.crashes),
        }


def replay_instance(timeline: list, target: str,
                    make_solo: Callable[[Store, object], object]) -> dict:
    """Differential replay of one instance's recorded trajectory (see
    module docstring). `make_solo(store, clock)` must build a
    FleetInstance for `target` with ScriptedClaims and the same
    scheduler configuration the live run used. Returns
    {"compared": n, "mismatches": [...]} — an empty mismatch list is the
    per-partition bit-identity verdict."""
    from kubernetes_tpu_torch.utils.clock import FakeClock
    store: Optional[Store] = None
    clock = None
    solo = None
    auditor: Optional[BindAuditor] = None
    mismatches: list = []
    compared = 0
    for i, entry in enumerate(timeline):
        op = entry["op"]
        if op == "start":
            clock = FakeClock(entry["t"])
            store = Store(watch_log_size=1 << 17)
            for node in entry["nodes"]:
                store.create(NODES, node.clone())
            for pod in entry["pods"]:
                store.create(PODS, pod.clone())
            solo = make_solo(store, clock)
            solo.sync()
            auditor = BindAuditor(store)
        elif op == "nodes":
            for node in entry["nodes"]:
                store.create(NODES, node.clone())
        elif op == "create":
            for pod in entry["pods"]:
                store.create(PODS, pod.clone())
        elif op == "clock":
            clock.step(entry["dt"])
        elif op == "restart" and entry["inst"] == target:
            # the live run restarted the instance as a fresh process:
            # rebuild the solo the same way (full re-list, empty claims)
            solo = make_solo(store, clock)
            solo.sync()
        elif op == "step":
            # the store-side fence evolution is an input to every
            # instance's decisions: re-apply the recorded table BEFORE
            # the step (advance is monotonic, so replaying a snapshot
            # is idempotent)
            if hasattr(store, "advance_fence"):
                for scope, token in sorted(entry["fences"].items()):
                    store.advance_fence(scope, token)
            binds = [tuple(b) for b in entry["binds"]]
            if entry["inst"] == target and not entry.get("crashed"):
                solo.apply_claims(entry["claims"])
                solo.loop.step()
                got = auditor.scan()
                compared += 1
                if got != binds:
                    mismatches.append({
                        "step": i,
                        "want": binds,
                        "got": got,
                    })
            elif binds:
                # every other instance's committed decisions (and the
                # target's own crashed partial wave) are foreign store
                # writes, applied verbatim at the recorded point
                store.bind_pods(binds)
                auditor.scan()
    if auditor is not None:
        auditor.stop()
    return {
        "compared": compared,
        "mismatches": mismatches,
        "replay_double_binds": list(auditor.violations)
        if auditor is not None else [],
    }
