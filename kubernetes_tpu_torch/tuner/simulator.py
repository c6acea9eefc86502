"""Offline simulator — recorded worlds replayed under a candidate row.

A `SimWorld` is one flight-recorder burst capture (round 12's replay
mode): the pre-burst NodeInfo clones, the NodeTree cursor state, the
service/replicaset lists, and the pod segments — everything that
determined the live decision. `simulate(world, candidate)` re-runs the
world through the SAME pure-Python oracle the parity replay uses, but
with the candidate's priority weights substituted, then scores the
resulting placements with a deterministic reward.

Determinism is the contract the search stands on: the oracle has no RNG,
the worlds are frozen clones, and every reward term is a pure function
of the final placements — same worlds + same candidate => identical
reward, bit-for-bit, across processes. (The CEM's only randomness is its
own seeded sampler.)

The reward is a placement-quality objective, largest term first:
- placed fraction (a row that strands pods loses outright),
- packing utilization: mean cpu fill of the nodes the burst USED —
  the `cluster_resource_utilization` satellite's per-decision twin
  (bin-packing rows concentrate load, spread rows dilute it),
- zone spread: 1 - (max-min)/placed over per-zone placement counts
  (tie-breaker so pure packing doesn't collapse a zone),
- gang locality: modal-zone fraction over each gang segment (the
  round-19 rank-aware objective, scored on the outcome).
"""
from __future__ import annotations

from typing import Optional

REWARD_PLACED = 1000.0
REWARD_PACK = 100.0
REWARD_SPREAD = 10.0
REWARD_LOCALITY = 10.0


class SimWorld:
    """One recorded burst, frozen for candidate replays."""

    __slots__ = ("infos", "tree_snap", "services", "replicasets", "pct",
                 "hpaw", "enabled", "segments", "names", "li", "lni",
                 "kind")

    def __init__(self, infos, tree_snap, services, replicasets, pct,
                 hpaw, enabled, segments, names, li, lni, kind):
        self.infos = infos            # {name: NodeInfo} (already clones)
        self.tree_snap = tree_snap    # FlightRecorder tree snapshot dict
        self.services = services
        self.replicasets = replicasets
        self.pct = pct
        self.hpaw = hpaw
        self.enabled = enabled
        self.segments = segments      # [(pods, is_gang), ...]
        self.names = names            # first enumeration of the burst
        self.li = li
        self.lni = lni
        self.kind = kind

    @staticmethod
    def from_record(rec) -> "SimWorld":
        """Build a world from a replay-mode BurstRecord. The record's
        capture is shared read-only; simulate() clones per candidate."""
        if rec.capture is None:
            raise ValueError("record has no replay capture "
                             "(RECORDER.configure(mode='replay') first)")
        if rec.kind not in ("uniform", "scan", "fused"):
            raise ValueError(f"{rec.kind} records are dump-only")
        cap = rec.capture
        return SimWorld(
            infos=cap["infos"], tree_snap=cap["tree"],
            services=cap["services"], replicasets=cap["replicasets"],
            pct=cap["pct"], hpaw=cap["hpaw"], enabled=cap["enabled"],
            segments=rec.segments, names=list(rec.names),
            li=rec.li, lni=rec.lni, kind=rec.kind)

    @property
    def n_pods(self) -> int:
        return sum(len(seg) for seg, _g in self.segments)


def worlds_from_recorder(recorder=None, limit: Optional[int] = None) -> list:
    """Harvest every replayable record from a flight recorder (default:
    the process-global RECORDER) as SimWorlds, oldest first."""
    if recorder is None:
        from kubernetes_tpu_torch.obs.flight import RECORDER as recorder
    out = []
    for rec in recorder.records():
        if rec.capture is None or rec.kind not in ("uniform", "scan",
                                                   "fused"):
            continue
        out.append(SimWorld.from_record(rec))
        if limit is not None and len(out) >= limit:
            break
    return out


class SimResult:
    __slots__ = ("reward", "placed", "total", "packing", "spread",
                 "locality")

    def __init__(self, reward, placed, total, packing, spread, locality):
        self.reward = reward
        self.placed = placed
        self.total = total
        self.packing = packing
        self.spread = spread
        self.locality = locality

    def as_dict(self) -> dict:
        return {"reward": round(self.reward, 6), "placed": self.placed,
                "total": self.total, "packing": round(self.packing, 6),
                "spread": round(self.spread, 6),
                "locality": round(self.locality, 6)}


def _cpu_fill(ni) -> float:
    alloc = ni.allocatable.milli_cpu
    return ni.requested.milli_cpu / alloc if alloc > 0 else 0.0


def simulate(world: SimWorld, name_weights: dict,
             gang_weight: int = 0) -> SimResult:
    """Run one world under `name_weights` (reference priority names ->
    integer weights, the exact shape a SchedulingProfile row carries)
    and score the placements. Deterministic: no RNG anywhere."""
    from kubernetes_tpu_torch.api.types import get_zone_key
    from kubernetes_tpu_torch.factory import (
        DEFAULT_PREDICATE_NAMES, build_predicate_set,
        build_priority_configs)
    from kubernetes_tpu_torch.obs.flight import FlightRecorder
    from kubernetes_tpu_torch.oracle.generic_scheduler import (
        FitError, GenericScheduler, PriorityConfig)
    from kubernetes_tpu_torch.oracle import priorities as prios

    infos = {k: ni.clone() for k, ni in world.infos.items()}
    tree = FlightRecorder._rebuild_tree(world.tree_snap)
    services = world.services
    replicasets = world.replicasets
    oracle = GenericScheduler(
        percentage_of_nodes_to_score=world.pct,
        hard_pod_affinity_weight=world.hpaw,
        nominated_pods_fn=lambda _n: [])
    oracle.last_index, oracle.last_node_index = world.li, world.lni
    cfgs = build_priority_configs(
        dict(name_weights), services_fn=lambda: services,
        replicasets_fn=lambda: replicasets,
        hard_pod_affinity_weight=world.hpaw)
    pred_names = (sorted(world.enabled) if world.enabled
                  else DEFAULT_PREDICATE_NAMES)
    t_consumed = 0

    def take_names() -> list:
        nonlocal t_consumed
        if t_consumed == 0:
            ns = list(world.names)
        elif tree is not None:
            ns = tree.list_names()
        else:
            ns = list(world.names)
        t_consumed += 1
        return ns

    def run_pod(pod, gang_zones=None):
        funcs = build_predicate_set(
            pred_names, infos, services_fn=lambda: services)
        pod_cfgs = cfgs
        if gang_weight and gang_zones is not None:
            pod_cfgs = list(cfgs) + [PriorityConfig(
                "GangLocalityPriority", gang_weight,
                function=lambda _p, nis, nodes: [
                    prios.gang_locality_map(gang_zones, nis[n.name])
                    for n in nodes])]
        try:
            r = oracle.schedule(pod, infos, take_names(),
                                predicate_funcs=funcs,
                                priority_configs=pod_cfgs)
        except FitError:
            return None
        host = r.suggested_host
        assumed = pod.clone()
        assumed.node_name = host
        ni = infos[host].clone()
        ni.add_pod(assumed)
        infos[host] = ni
        if gang_zones is not None:
            node = infos[host].node
            z = get_zone_key(node) if node is not None else ""
            if z:
                gang_zones[z] = gang_zones.get(z, 0) + 1
        return host

    placed_hosts: list = []        # (host, zone) of every placement kept
    gang_localities: list = []
    total = 0
    for seg_pods, is_gang in world.segments:
        total += len(seg_pods)
        if is_gang:
            # all-or-nothing, the kernel's contract: checkpoint, place,
            # rewind on any member's failure
            chk = (dict(infos), oracle.last_index, oracle.last_node_index,
                   t_consumed, None if tree is None else tree.checkpoint())
            gang_zones: dict = {}
            hosts = []
            failed = False
            for p in seg_pods:
                h = run_pod(p, gang_zones=gang_zones)
                if h is None:
                    failed = True
                    break
                hosts.append(h)
            if failed:
                infos = chk[0]
                oracle.last_index, oracle.last_node_index = chk[1], chk[2]
                t_consumed = chk[3]
                if tree is not None:
                    tree.restore(chk[4])
                continue
            for h in hosts:
                node = infos[h].node
                placed_hosts.append(
                    (h, get_zone_key(node) if node is not None else ""))
            if gang_zones:
                n = sum(gang_zones.values())
                gang_localities.append(max(gang_zones.values()) / n)
        else:
            for p in seg_pods:
                h = run_pod(p)
                if h is None:
                    continue
                node = infos[h].node
                placed_hosts.append(
                    (h, get_zone_key(node) if node is not None else ""))

    placed = len(placed_hosts)
    placed_frac = placed / total if total else 0.0
    used = sorted({h for h, _z in placed_hosts})
    packing = (sum(_cpu_fill(infos[h]) for h in used) / len(used)
               if used else 0.0)
    zone_counts: dict = {}
    for _h, z in placed_hosts:
        zone_counts[z] = zone_counts.get(z, 0) + 1
    if placed and len(zone_counts) > 0:
        spread = 1.0 - (max(zone_counts.values())
                        - min(zone_counts.values())) / placed
    else:
        spread = 0.0
    locality = (sum(gang_localities) / len(gang_localities)
                if gang_localities else 0.0)
    reward = (REWARD_PLACED * placed_frac + REWARD_PACK * packing
              + REWARD_SPREAD * spread + REWARD_LOCALITY * locality)
    return SimResult(reward, placed, total, packing, spread, locality)
