"""Burst flight recorder — a bounded ring of the last N fused bursts.

Copied from the reference (`kubernetes_tpu.obs.flight`); replay re-derives
each burst through the port's copies of the oracle
(`oracle.generic_scheduler`), the predicate set (`factory.
build_predicate_set`) and the NodeTree (`cache.node_tree`).

A parity-fuzz failure used to leave nothing to replay: one-in-42-seed
catches died with an assert diff and no artifact. The recorder keeps, for
each single-launch burst (uniform K-batch, generic scan, fused segmented
window, pressure wave), the inputs that determine the decision — pod set,
walk state (last_index / last_node_index), rotation cursor, NodeTree
epoch, device-matrix epoch, victim-table shape — plus the packed fetch
block and the commit outcome. `dump()` turns the ring into an attachable
JSON artifact; `replay()` re-runs a recorded burst through the pure-Python
oracle (the serial referee) and asserts bit-identity, turning a fuzz catch
into a reproducible unit.

Two capture levels (module-global `RECORDER`):
- "digest" (default, always on): O(1) refs + one ndarray copy per burst —
  cheap enough for the headline bench (no clones). The block is copied
  once its device-to-host copy has completed: the pinned buffer it sits
  in is reused by a later launch.
- "replay": additionally clones the node snapshot, the NodeTree cursor
  state, and the service/replicaset lists, so `replay()` can re-derive the
  burst's decisions from scratch. Opt-in (the shell fuzzes turn it on;
  KTPU_FLIGHT=replay forces it) because the clone is O(cluster) per burst.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Optional

import numpy as np


class BurstRecord:
    __slots__ = ("kind", "segments", "names", "li", "lni", "zone_index",
                 "tree_epoch", "dev_epoch", "vic", "blocks", "outcome",
                 "capture", "notes")

    def __init__(self, kind: str, segments, names, li: int, lni: int,
                 zone_index, tree_epoch, dev_epoch: int, vic,
                 capture: Optional[dict]):
        self.kind = kind              # uniform | scan | fused | pressure
        self.segments = segments      # [(pods, is_gang), ...] (refs)
        self.names = names            # the burst's first enumeration (ref)
        self.li = li                  # last_index before the launch
        self.lni = lni                # last_node_index before the launch
        self.zone_index = zone_index  # rotation cursor before the launch
        self.tree_epoch = tree_epoch  # NodeTree membership epoch
        self.dev_epoch = dev_epoch    # device-matrix upload/scatter epoch
        self.vic = vic                # victim-table digest (shape/rows)
        self.blocks: list = []        # packed fetch block copies
        self.outcome: Optional[dict] = None
        self.capture = capture        # deep replay inputs (replay mode)
        self.notes: list[str] = []

    @property
    def pods(self) -> list:
        return [p for seg, _g in self.segments for p in seg]


class FlightRecorder:
    def __init__(self, capacity: int = 8):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self.mode = os.environ.get("KTPU_FLIGHT", "digest")

    # -- configuration -------------------------------------------------------
    def configure(self, mode: Optional[str] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if mode is not None:
                if mode not in ("off", "digest", "replay"):
                    raise ValueError(f"unknown flight mode {mode!r}")
                self.mode = mode
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=max(int(capacity), 1))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    # -- capture (called by the device burst drivers) ------------------------
    def begin(self, kind: str, algo, segments, names,
              node_infos) -> Optional[BurstRecord]:
        """Open a record for one burst launch. Must run BEFORE the first
        wave commit can mutate the cache's NodeInfos (the deep clone has to
        see the pre-burst world)."""
        if self.mode == "off":
            return None
        tree = getattr(algo, "node_tree", None)
        vt = getattr(getattr(algo, "encoder", None), "_vt", None)
        vic = None if vt is None else {
            "P": int(vt.P), "rows": int(vt.valid.shape[0]),
            "dirty_rows": (None if vt.dirty_rows is None
                           else len(vt.dirty_rows))}
        capture = None
        if self.mode == "replay":
            capture = {
                "infos": {k: ni.clone() for k, ni in node_infos.items()},
                "tree": self._tree_snapshot(tree),
                "services": list(algo.services_fn()),
                "replicasets": list(algo.replicasets_fn()),
                "pct": algo.percentage_of_nodes_to_score,
                "hpaw": algo.hard_pod_affinity_weight,
                "enabled": (None if algo.enabled_predicates is None
                            else set(algo.enabled_predicates)),
                "weights": algo.priority_name_weights,
            }
            # round-19 scheduling profiles: the set is decision INPUT
            # (per-pod weight rows + the rank-aware gang objective), so
            # replay must select configs per pod the same way. Round 22
            # makes rows WRITABLE (the tuner), so the capture pins a
            # SNAPSHOT + the active weight-table slice — a mid-run
            # set_row() must not retro-edit an already-recorded burst
            # (round-18 rule: every cross-run input is RECORDED).
            profs = getattr(algo, "profiles", None)
            if profs is not None:
                capture["profiles"] = profs.snapshot()
                capture["wtab"] = profs.weight_table().copy()
                capture["profile_version"] = profs.version
            else:
                capture["profiles"] = None
        rec = BurstRecord(
            kind, [(list(seg), bool(g)) for seg, g in segments],
            list(names), algo.last_index, algo.last_node_index,
            None if tree is None else tree.zone_index,
            None if tree is None else getattr(tree, "epoch", None),
            getattr(algo, "_dev_epoch", 0), vic, capture)
        with self._lock:
            self._ring.append(rec)
        return rec

    @staticmethod
    def note_block(rec: Optional[BurstRecord], block) -> None:
        """Attach (a copy of) one packed fetch block to the record."""
        if rec is not None:
            rec.blocks.append(np.asarray(block).copy())

    @staticmethod
    def note_outcome(rec: Optional[BurstRecord], outcome: dict) -> None:
        if rec is not None:
            rec.outcome = outcome

    def note_crash(self, tag: str) -> None:
        """Annotate the most recent record (the commit crash-seam hook:
        the burst whose commit died is the one worth dumping)."""
        with self._lock:
            if self._ring:
                self._ring[-1].notes.append(tag)

    @staticmethod
    def _tree_snapshot(tree) -> Optional[dict]:
        if tree is None:
            return None
        return {"tree": {z: list(ns) for z, ns in tree._tree.items()},
                "zones": list(tree._zones),
                "chk": tree.checkpoint()}

    @staticmethod
    def _rebuild_tree(snap: Optional[dict]):
        if snap is None:
            return None
        from kubernetes_tpu_torch.cache.node_tree import NodeTree
        t = NodeTree()
        t._tree = {z: list(ns) for z, ns in snap["tree"].items()}
        t._zones = list(snap["zones"])
        t.num_nodes = sum(len(ns) for ns in t._tree.values())
        t._last_index = {z: 0 for z in t._zones}
        # adopt the recorded epoch so restore() replays the cursors
        # exactly (an epoch mismatch means membership churned under the
        # checkpoint and restore re-grounds instead)
        t.epoch = snap["chk"][3]
        t.restore(snap["chk"])
        return t

    # -- artifacts -----------------------------------------------------------
    def describe(self) -> dict:
        """JSON-able view of the ring (newest last)."""
        out = []
        for rec in self.records():
            out.append({
                "kind": rec.kind,
                "segments": [{"pods": [p.key for p in seg],
                              "gang": g} for seg, g in rec.segments],
                "classes": sorted({p.labels.get("app", "")
                                   for p in rec.pods}),
                "last_index": rec.li,
                "last_node_index": rec.lni,
                "zone_index": rec.zone_index,
                "node_tree_epoch": rec.tree_epoch,
                "dev_epoch": rec.dev_epoch,
                "victim_table": rec.vic,
                "n_nodes": len(rec.names),
                "blocks": [b.tolist() for b in rec.blocks],
                "outcome": rec.outcome,
                "replayable": rec.capture is not None
                and rec.kind in ("uniform", "scan", "fused"),
                "notes": list(rec.notes),
            })
        return {"flight_records": out}

    def dump(self, path: Optional[str] = None):
        """Write the ring as a JSON artifact; returns the path (or the
        document when no path is given)."""
        doc = self.describe()
        if path is None:
            return doc
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path

    # -- replay (the oracle referee) -----------------------------------------
    def replay(self, rec: BurstRecord) -> list[str]:
        """Re-run a recorded burst through the pure-Python oracle and
        compare decision-for-decision with the recorded outcome. Returns a
        list of mismatch descriptions (empty = bit-identical). Requires a
        replay-mode record; pressure records are dump-only."""
        if rec.capture is None:
            raise ValueError("record has no replay capture "
                             "(RECORDER.configure(mode='replay') first)")
        if rec.kind not in ("uniform", "scan", "fused"):
            raise ValueError(f"{rec.kind} records are dump-only")
        from kubernetes_tpu_torch.factory import (build_predicate_set,
                                            build_priority_configs,
                                            DEFAULT_PREDICATE_NAMES)
        from kubernetes_tpu_torch.oracle.generic_scheduler import (
            FitError, GenericScheduler, default_priority_configs)
        cap = rec.capture
        infos = {k: ni.clone() for k, ni in cap["infos"].items()}
        tree = self._rebuild_tree(cap["tree"])
        services = cap["services"]
        replicasets = cap["replicasets"]
        hpaw = cap["hpaw"]
        oracle = GenericScheduler(
            percentage_of_nodes_to_score=cap["pct"],
            hard_pod_affinity_weight=hpaw,
            nominated_pods_fn=lambda _n: [])
        oracle.last_index, oracle.last_node_index = rec.li, rec.lni
        profiles = cap.get("profiles")
        if profiles is not None and cap.get("wtab") is not None:
            # the recorded tensor slice must still derive from the
            # snapshot — a divergence means the capture failed to pin the
            # rows across a tuner set_row() (replay would silently score
            # with the WRONG weights otherwise)
            if not np.array_equal(profiles.weight_table(), cap["wtab"]):
                return ["recorded weight table diverges from the profile "
                        "snapshot (capture did not pin the tensor rows)"]
        if profiles is not None:
            prof_cfgs = [profiles.oracle_configs(
                i, services_fn=lambda: services,
                replicasets_fn=lambda: replicasets,
                hard_pod_affinity_weight=hpaw)
                for i in range(len(profiles))]

            def cfgs_for(pod):
                pid = profiles.index_of(pod.scheduler_name)
                return prof_cfgs[0 if pid is None else pid]
        elif cap["weights"] is not None:
            cfgs = build_priority_configs(
                cap["weights"], services_fn=lambda: services,
                replicasets_fn=lambda: replicasets,
                hard_pod_affinity_weight=hpaw)
            cfgs_for = lambda _pod: cfgs
        else:
            cfgs = default_priority_configs(
                services_fn=lambda: services,
                replicasets_fn=lambda: replicasets,
                hard_pod_affinity_weight=hpaw)
            cfgs_for = lambda _pod: cfgs
        pred_names = (sorted(cap["enabled"]) if cap["enabled"]
                      else DEFAULT_PREDICATE_NAMES)
        t_consumed = 0   # enumerations consumed (the kernel's carried t)

        def take_names() -> list[str]:
            nonlocal t_consumed
            if t_consumed == 0:
                ns = list(rec.names)
            elif tree is not None:
                ns = tree.list_names()
            else:
                ns = list(rec.names)
            t_consumed += 1
            return ns

        def run_pod(pod, gang_zones=None) -> Optional[str]:
            funcs = build_predicate_set(pred_names, infos)
            pod_cfgs = cfgs_for(pod)
            gw = (profiles.gang_weight_for(pod.scheduler_name)
                  if profiles is not None and gang_zones is not None else 0)
            if gw:
                # rank-aware gang set-scoring: the replay's twin of the
                # kernel's per-segment zone-count carry
                from kubernetes_tpu_torch.oracle import priorities as prios
                from kubernetes_tpu_torch.oracle.generic_scheduler import (
                    PriorityConfig)
                pod_cfgs = list(pod_cfgs) + [PriorityConfig(
                    "GangLocalityPriority", gw,
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
                from kubernetes_tpu_torch.api.types import get_zone_key
                node = infos[host].node
                z = get_zone_key(node) if node is not None else ""
                if z:
                    gang_zones[z] = gang_zones.get(z, 0) + 1
            return host

        # normalize: uniform/scan records are one non-gang segment
        if rec.kind == "fused":
            expects = rec.outcome["segments"] if rec.outcome else []
        else:
            out = rec.outcome or {}
            expects = [{"status": "failed" if out.get("failed")
                        else "decided", "hosts": out.get("hosts", [])}]
        mism: list[str] = []
        stop = False
        for (seg_pods, is_gang), expect in zip(rec.segments, expects):
            if stop or expect.get("status") == "undecided":
                break
            if is_gang:
                chk = (dict(infos), oracle.last_index,
                       oracle.last_node_index, t_consumed,
                       None if tree is None else tree.checkpoint())
                hosts: list = []
                fail_at = None
                gang_zones: dict = {}   # per-segment zone-count tracker
                for i, p in enumerate(seg_pods):
                    h = run_pod(p, gang_zones=gang_zones)
                    if h is None:
                        fail_at = i
                        break   # the kernel skips the rest of the segment
                    hosts.append(h)
                if fail_at is not None:
                    infos = chk[0]
                    oracle.last_index, oracle.last_node_index = chk[1], chk[2]
                    t_consumed = chk[3]
                    if tree is not None:
                        tree.restore(chk[4])
                    if expect["status"] != "rejected":
                        mism.append(
                            f"gang: oracle rejects at member {fail_at}, "
                            f"device says {expect['status']}")
                    elif expect.get("placed") != fail_at:
                        mism.append(
                            f"gang placed count: oracle {fail_at}, "
                            f"device {expect.get('placed')}")
                else:
                    if expect["status"] != "decided":
                        mism.append(
                            f"gang: oracle places all {len(seg_pods)}, "
                            f"device says {expect['status']}")
                    elif hosts != expect.get("hosts"):
                        mism.append(
                            f"gang hosts diverge: oracle {hosts} != "
                            f"device {expect.get('hosts')}")
                continue
            # singleton run: compare the device-decided prefix; on a
            # recorded failure, the next pod must fail here too and
            # everything after is undecided
            want = list(expect.get("hosts", []))
            for i, p in enumerate(seg_pods):
                if i < len(want):
                    h = run_pod(p)
                    if h != want[i]:
                        mism.append(
                            f"pod {p.key}: oracle {h} != device {want[i]}")
                        stop = True
                        break
                elif expect["status"] == "failed" and i == len(want):
                    h = run_pod(p)
                    if h is not None:
                        mism.append(
                            f"pod {p.key}: oracle places on {h}, device "
                            f"found no node")
                    stop = True
                    break
                else:
                    stop = True   # undecided tail (commit abort)
                    break
        return mism

    def replay_all(self) -> list[str]:
        """Replay every replayable record in the ring; returns the
        accumulated mismatches (empty = every recorded burst re-derives
        bit-identically through the oracle)."""
        errs: list[str] = []
        for i, rec in enumerate(self.records()):
            if rec.capture is None or rec.kind not in ("uniform", "scan",
                                                       "fused"):
                continue
            try:
                for m in self.replay(rec):
                    errs.append(f"record {i} [{rec.kind}]: {m}")
            except Exception as e:   # replay harness bug ≠ silent pass
                errs.append(f"record {i} [{rec.kind}]: replay error: {e!r}")
        return errs


#: the process-global recorder the burst drivers feed
RECORDER = FlightRecorder()


def dump(path: Optional[str] = None):
    """Module-level convenience: `obs.flight.dump()`."""
    return RECORDER.dump(path)
