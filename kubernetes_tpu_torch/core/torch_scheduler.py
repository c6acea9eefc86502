"""TorchScheduler — the port's counterpart of `kubernetes_tpu.core.
tpu_scheduler.TPUScheduler` on PyTorch and CUDA.

Same contract as the JAX driver for the paths this slice carries:

- schedule(): one pod per launch (K2 `schedule_cycle`), with the same
  ScheduleResult/FitError, feasible sets, evaluated counts and scores;
- schedule_burst(): spec-identical windows through the uniform K-batch
  kernel (K3 `uniform_burst`), one launch and one packed device-to-host
  copy per chunk, folds kept on the device.

The node matrix is uploaded whole once and then kept current by the
dirty-row scatter (K4 `scatter_rows`). Every entry point runs on `cuda`
unless `device="cpu"` is passed; a CUDA error propagates (no host twin,
no silent degrade). A burst window that is not uniform is refused whole
(None), counted under `refusal.<reason>`: the generic scan is later work.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo, calculate_resource
from kubernetes_tpu_torch.oracle import predicates as P
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    ScheduleResult, FitError, num_feasible_nodes_to_find,
    DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
)
from kubernetes_tpu_torch.ops import PRIORITY_AXIS, resolve_device
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.ops.node_state import (
    NodeStateEncoder, PodEncoder, PodFeatures, NodeBatch,
    IPA_EXISTING_ANTI, IPA_OWN_AFFINITY,
)
from kubernetes_tpu_torch.ops.pod_rows import pod_class_signature

#: rotation-row cache miss sentinel (None is a legal cached value:
#: "this order IS the identity")
_ROT_MISS = object()


def _pad_pow2(n: int, minimum: int = 1) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


class TorchScheduler:
    # node fields of the resident matrix, in upload order
    _NODE_FIELDS = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
                    "allowed_pods", "req_cpu", "req_mem", "req_eph",
                    "nz_cpu", "nz_mem", "pod_count", "alloc_scalar",
                    "req_scalar", "zone_id")
    # per-node mask fields that CANNOT change from in-burst placements
    _STATIC_MASKS = ("sel_ok", "taints_ok", "unsched_ok", "host_ok",
                     "ports_ok")
    # score/filter families the uniform kernel does not model at all
    _INERT_REQUIRED = ("disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok",
                       "node_aff_counts", "taint_counts", "spread_counts",
                       "image_sums", "prefer_avoid")
    # launches in flight ahead of the one being fetched
    launch_depth = 2
    # encode-at-admission pod-row cache (ops.pod_rows.PodRowCache); None =
    # per-window signatures (identical decisions either way)
    pod_rows = None

    def __init__(self,
                 percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
                 hard_pod_affinity_weight: int = 1,
                 services_fn=lambda: [],
                 replicasets_fn=lambda: [],
                 collect_host_priority: bool = True,
                 node_tree=None,
                 device=None):
        self.device = resolve_device(device)
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.services_fn = services_fn
        self.replicasets_fn = replicasets_fn
        self.collect_host_priority = collect_host_priority
        self.check_resources = True   # PodFitsResources enabled
        self.weights = None           # None -> kernels.DEFAULT_WEIGHTS
        self.enabled_predicates = None  # None -> all
        # weight-tensor mode (a [profiles x priorities] table carried in
        # with load_state): every pod scores with row 0 until the profile
        # set (scheduler name -> row) is ported with the shell
        self._ptab: Optional[np.ndarray] = None
        self._wtab_dev: Optional[torch.Tensor] = None
        self._union_weights: Optional[dict] = None
        # NodeTree handle: burst decisions replay the per-cycle
        # zone-interleaved enumeration rotation; None = fixed name order
        self.node_tree = node_tree
        self.last_index = 0
        self.last_node_index = 0
        self.encoder = NodeStateEncoder()
        # resident node matrix: full upload on rebuild, dirty-row scatter
        # otherwise
        self._dev_nodes: Optional[dict] = None
        self._dev_key = None
        self._dev_epoch = 0
        # inert per-pod fields are shape [1]; the kernels skip or
        # broadcast them
        self._defaults = {
            "ones_bool": np.ones(1, dtype=bool),
            "zeros_i64": np.zeros(1, dtype=np.int64),
            "zeros_i8": np.zeros(1, dtype=np.int8),
            "zeros_bool": np.zeros(1, dtype=bool),
            "tens_i64": np.full(1, 10, dtype=np.int64),
        }
        # rotation-row cache keyed per NodeBatch object (a rebuild or
        # permute makes a fresh batch, invalidating by identity)
        self._rot_rows: dict = {}
        self._rot_rows_b: Optional[int] = None
        # pinned host buffers for the packed decision blocks, by (cap, slot)
        self._pinned: dict = {}
        # host seconds of the last burst, by phase (encode, of which
        # mirror; dispatch; fetch)
        self.last_burst_phases: Optional[dict] = None

    # -- weight tensor ---------------------------------------------------------
    def _set_weight_table(self, ptab: Optional[np.ndarray]) -> None:
        """Attach (or drop) the [P, K] weight table: every score family
        any row weights runs, scaled per pod by its row."""
        self._wtab_dev = None
        if ptab is None:
            self._ptab = self._union_weights = None
            return
        self._ptab = np.asarray(ptab, dtype=np.int64)
        self._union_weights = {
            name: int(self._ptab[:, i].max()) if len(self._ptab) else 0
            for i, name in enumerate(PRIORITY_AXIS)}

    def _wtab(self) -> torch.Tensor:
        if self._wtab_dev is None:
            self._wtab_dev = torch.as_tensor(self._ptab).to(self.device)
        return self._wtab_dev

    # -- device input assembly -------------------------------------------------
    def _node_arrays(self, b: NodeBatch) -> dict:
        """The resident node matrix; only rows the encoder marked
        generation-dirty are re-uploaded (one K4 launch for all fields)."""
        key = (b.n_pad, len(b.scalar_names), id(b))
        if self._dev_nodes is None or self._dev_key != key \
                or b.dirty_rows is None:
            self._dev_nodes = {
                k: torch.as_tensor(np.asarray(getattr(b, k))).to(self.device,
                                                            copy=True)
                for k in self._NODE_FIELDS}
            obs.inc("dispatch.upload")
            self._dev_epoch += 1
            self._dev_key = key
            b.dirty_rows = []   # host state fully mirrored; start tracking
            return self._dev_nodes
        if b.dirty_rows:
            # dedupe, then pad the row list to a power-of-two bucket by
            # repeating row 0 (duplicate writes carry identical values)
            rows = np.asarray(sorted(set(b.dirty_rows)), dtype=np.int32)
            bucket = _pad_pow2(len(rows), 16)
            rows = np.concatenate(
                [rows, np.full(bucket - len(rows), rows[0], dtype=np.int32)])
            upd = {k: getattr(b, k)[rows] for k in self._NODE_FIELDS}
            K.scatter_rows(self._dev_nodes, rows, upd)
            obs.inc("dispatch.scatter")
            self._dev_epoch += 1
            b.dirty_rows = []
        return self._dev_nodes

    def _pod_arrays(self, f: PodFeatures) -> dict:
        """Host inputs for one pod; feature fields the pod does not
        exercise stay shape [1]."""
        d = self._defaults
        return {
            "req_cpu": np.int64(f.req_cpu),
            "req_mem": np.int64(f.req_mem),
            "req_eph": np.int64(f.req_eph),
            "req_scalar": f.req_scalar,
            "has_request": np.bool_(f.has_request),
            "unknown_scalar": np.bool_(bool(f.unknown_scalars)),
            "skip": np.bool_(False),
            "check_resources": np.bool_(self.check_resources),
            "nz_cpu": np.int64(f.nz_cpu),
            "nz_mem": np.int64(f.nz_mem),
            "sel_ok": f.sel_ok if f.sel_ok is not None else d["ones_bool"],
            "taints_ok": f.taints_ok if f.taints_ok is not None else d["ones_bool"],
            "unsched_ok": f.unsched_ok if f.unsched_ok is not None else d["ones_bool"],
            "ports_ok": f.ports_ok if f.ports_ok is not None else d["ones_bool"],
            "host_ok": f.host_ok if f.host_ok is not None else d["ones_bool"],
            "disk_ok": f.disk_ok if f.disk_ok is not None else d["ones_bool"],
            "maxvol_ok": f.maxvol_ok if f.maxvol_ok is not None else d["ones_bool"],
            "volbind_ok": f.volbind_ok if f.volbind_ok is not None else d["ones_bool"],
            "volzone_ok": f.volzone_ok if f.volzone_ok is not None else d["ones_bool"],
            "interpod_code": f.interpod_code if f.interpod_code is not None else d["zeros_i8"],
            "node_aff_counts": f.node_aff_counts if f.node_aff_counts is not None else d["zeros_i64"],
            "taint_counts": f.taint_counts if f.taint_counts is not None else d["zeros_i64"],
            "spread_counts": f.spread_counts if f.spread_counts is not None else d["zeros_i64"],
            "interpod_counts": f.interpod_counts if f.interpod_counts is not None else d["zeros_i64"],
            "interpod_tracked": f.interpod_tracked if f.interpod_tracked is not None else d["zeros_bool"],
            "image_sums": f.image_sums if f.image_sums is not None else d["zeros_i64"],
            "prefer_avoid": f.prefer_avoid if f.prefer_avoid is not None else d["tens_i64"],
        }

    # -- reason decoding -------------------------------------------------------
    def _decode_reasons(self, b: NodeBatch, f: PodFeatures, idx: int,
                        fail_first: np.ndarray,
                        general_bits: np.ndarray) -> list[str]:
        code = int(fail_first[idx])
        if code == K.FAIL_UNSCHEDULABLE:
            return [P.ERR_NODE_UNSCHEDULABLE]
        if code == K.FAIL_TAINTS:
            return [P.ERR_TAINTS_TOLERATIONS_NOT_MATCH]
        if code == K.FAIL_DISK:
            return ["NoDiskConflict"]
        if code == K.FAIL_MAXVOL:
            return ["MaxVolumeCount"]
        if code in (K.FAIL_VOLBIND, K.FAIL_VOLZONE):
            if f.volbind_reasons and idx in f.volbind_reasons:
                return list(f.volbind_reasons[idx])
            return (["VolumeBindingNoMatch"] if code == K.FAIL_VOLBIND
                    else ["NoVolumeZoneConflict"])
        if code == K.FAIL_INTERPOD:
            ipa = int(f.interpod_code[idx]) if f.interpod_code is not None else 0
            if ipa == IPA_EXISTING_ANTI:
                return [P.ERR_POD_AFFINITY_NOT_MATCH,
                        P.ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH]
            if ipa == IPA_OWN_AFFINITY:
                return [P.ERR_POD_AFFINITY_NOT_MATCH,
                        P.ERR_POD_AFFINITY_RULES_NOT_MATCH]
            return [P.ERR_POD_AFFINITY_NOT_MATCH,
                    P.ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH]
        # general predicates, reason order as predicates.general_predicates
        bits = int(general_bits[idx])
        reasons = []
        if bits & (1 << K.BIT_PODS):
            reasons.append(P.insufficient_resource("pods"))
        if bits & (1 << K.BIT_CPU):
            reasons.append(P.insufficient_resource("cpu"))
        if bits & (1 << K.BIT_MEM):
            reasons.append(P.insufficient_resource("memory"))
        if bits & (1 << K.BIT_EPH):
            reasons.append(P.insufficient_resource("ephemeral-storage"))
        for s, name in enumerate(b.scalar_names):
            if bits & (1 << (K.BIT_SCALAR0 + s)):
                reasons.append(P.insufficient_resource(name))
        if bits & (1 << K.BIT_UNKNOWN_SCALAR):
            reasons.extend(P.insufficient_resource(n) for n in f.unknown_scalars)
        if bits & (1 << K.BIT_HOST):
            reasons.append(P.ERR_POD_NOT_MATCH_HOST_NAME)
        if bits & (1 << K.BIT_PORTS):
            reasons.append(P.ERR_POD_NOT_FITS_HOST_PORTS)
        if bits & (1 << K.BIT_SELECTOR):
            reasons.append(P.ERR_NODE_SELECTOR_NOT_MATCH)
        return reasons

    def _pod_encoder(self, node_infos, b: NodeBatch) -> PodEncoder:
        return PodEncoder(node_infos, b, self.services_fn(),
                          self.replicasets_fn(),
                          hard_pod_affinity_weight=self.hard_pod_affinity_weight,
                          enabled=self.enabled_predicates,
                          state_encoder=self.encoder)

    # -- single-pod cycle --------------------------------------------------------
    def schedule(self, pod: Pod, node_infos: dict[str, NodeInfo],
                 all_node_names: list[str]) -> ScheduleResult:
        if not all_node_names:
            raise FitError(pod, 0, {})
        return self._schedule_device(pod, node_infos, all_node_names)

    def _schedule_device(self, pod: Pod, node_infos: dict[str, NodeInfo],
                         all_node_names: list[str]) -> ScheduleResult:
        b = self.encoder.encode(node_infos, all_node_names)
        nodes = self._node_arrays(b)
        feats = self._pod_encoder(node_infos, b).encode(pod)
        pod_in = self._pod_arrays(feats)
        wtab = None
        weights = self.weights
        if self._ptab is not None:
            pod_in["profile_id"] = np.int64(0)
            wtab = self._wtab()
            weights = self._union_weights
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        z_pad = _pad_pow2(len(b.zone_names), 4)
        out = K.schedule_cycle(nodes, pod_in, self.last_index,
                               self.last_node_index, num_to_find, n, z_pad,
                               weights=weights, wtab=wtab)
        obs.inc("dispatch.cycle")
        keys = ["selected", "found", "evaluated", "next_last_index",
                "next_last_node_index", "kept", "total", "fail_first",
                "general_bits"]
        h = {k: out[k].cpu().numpy() for k in keys}
        obs.inc("fetch.cycle")
        found = int(h["found"])
        evaluated = int(h["evaluated"])
        start = self.last_index
        self.last_index = int(h["next_last_index"])
        fail_first, general_bits = h["fail_first"], h["general_bits"]
        if found == 0:
            failed = {}
            for pos in range(evaluated):
                idx = (start + pos) % n
                failed[b.names[idx]] = self._decode_reasons(
                    b, feats, idx, fail_first, general_bits)
            raise FitError(pod, n, failed)
        self.last_node_index = int(h["next_last_node_index"])
        host = b.names[int(h["selected"])]
        host_priority = []
        failed = {}
        if self.collect_host_priority:
            kept, total = h["kept"], h["total"]
            for pos in range(evaluated):
                idx = (start + pos) % n
                if kept[idx]:
                    # single-feasible-node cycles skip scoring entirely
                    score = 0 if found == 1 else int(total[idx])
                    host_priority.append((b.names[idx], score))
                elif fail_first[idx] != K.FAIL_NONE:
                    failed[b.names[idx]] = self._decode_reasons(
                        b, feats, idx, fail_first, general_bits)
        return ScheduleResult(host, evaluated, found, host_priority, failed)

    # -- burst path --------------------------------------------------------------
    def _signatures(self, pods: list) -> list:
        rc = self.pod_rows
        if rc is not None:
            return rc.signatures(pods)
        return [pod_class_signature(p) for p in pods]

    def _uniform_class(self, p0: Pod, f0, b: NodeBatch,
                       node_infos: dict[str, NodeInfo]) -> Optional[tuple]:
        """Eligibility + class extraction for a burst of pods spec-identical
        to `p0`: (cls_scalars, extra_ok, ban) when the feature interactions
        reduce to a static per-node mask plus an optional self-node ban,
        else None (TPUScheduler._uniform_class, same rules)."""
        from kubernetes_tpu_torch.api.types import (
            get_container_ports, LABEL_HOSTNAME)
        if f0.unknown_scalars:
            return None
        upd = calculate_resource(p0)
        upd_scalar = np.zeros_like(f0.req_scalar)
        for name, q in upd.scalar.items():
            upd_scalar[list(self.encoder._scalar_vocab).index(name)] = q
        cls = {"req_cpu": f0.req_cpu, "req_mem": f0.req_mem,
               "req_eph": f0.req_eph, "req_scalar": f0.req_scalar,
               "nz_cpu": f0.nz_cpu, "nz_mem": f0.nz_mem,
               "upd_cpu": upd.milli_cpu, "upd_mem": upd.memory,
               "upd_eph": upd.ephemeral_storage,
               "upd_scalar": upd_scalar,
               "has_request": f0.has_request}
        for field in self._INERT_REQUIRED:
            if getattr(f0, field) is not None:
                return None
        nreal = b.n_real
        # interpod scores must be a constant shift: every valid node
        # tracked and equal counts
        if f0.interpod_counts is not None or f0.interpod_tracked is not None:
            tr, ic = f0.interpod_tracked, f0.interpod_counts
            if tr is None or not bool(np.all(tr[:nreal])):
                return None
            if ic is None or (nreal and int(np.ptp(ic[:nreal])) != 0):
                return None
        extra: Optional[np.ndarray] = None

        def and_mask(m) -> None:
            nonlocal extra
            if m is not None:
                mm = np.asarray(m, dtype=bool)
                if mm.shape[0] != b.n_pad:      # inert [1] fields
                    return
                extra = mm.copy() if extra is None else (extra & mm)

        for field in self._STATIC_MASKS:
            and_mask(getattr(f0, field))
        if f0.interpod_code is not None:
            and_mask(f0.interpod_code == 0)
        ban = bool(get_container_ports(p0))   # identical host ports conflict
        a = p0.affinity
        if a is not None and (a.pod_affinity is not None
                              or a.pod_anti_affinity is not None):
            pa, paa = a.pod_affinity, a.pod_anti_affinity
            if (pa and pa.preferred) or (paa and paa.preferred):
                return None

            def self_match(term) -> bool:
                if term.namespaces and p0.namespace not in term.namespaces:
                    return False
                return term.label_selector is not None \
                    and term.label_selector.matches(p0.labels)

            ban_anti = False
            for term in (paa.required if paa else ()):
                if self_match(term):
                    # the node-ban fold is exact only for singleton groups
                    if term.topology_key != LABEL_HOSTNAME:
                        return None
                    ban_anti = True
            for term in (pa.required if pa else ()):
                if self_match(term):
                    # static only when every valid node is in ONE group
                    vals = set()
                    for i in range(nreal):
                        node = node_infos[b.names[i]].node
                        vals.add(None if node is None
                                 else node.labels.get(term.topology_key))
                    if len(vals) != 1 or None in vals:
                        return None
            if ban_anti:
                hosts = set()
                for i in range(nreal):
                    node = node_infos[b.names[i]].node
                    h = None if node is None else node.labels.get(LABEL_HOSTNAME)
                    if h is None or h in hosts:
                        return None       # hostname groups must be singleton
                    hosts.add(h)
                ban = True
        return cls, extra, ban

    def _tree_rotates(self) -> bool:
        """True when the NodeTree's per-cycle enumeration can ever differ
        from the device axis: several zones of uneven sizes."""
        tree = self.node_tree
        if tree is None or len(tree._zones) <= 1:
            return False
        sizes = {len(tree._tree[z]) for z in tree._zones}
        return len(sizes) > 1

    def _axis_order(self, all_node_names: list):
        """(axis_order, start0): keep the resident axis when this launch's
        enumeration is provably order_for_start(start0) of it; any doubt
        falls back to axis == enumeration."""
        tree = self.node_tree
        b = self.encoder._batch
        if tree is None or b is None or b.names == all_node_names \
                or not self._tree_rotates():
            return all_node_names, None
        rr = tree.last_enum_start
        if rr is None:
            return all_node_names, None
        order = tree._order_cache.get(rr)
        if order is None or order != all_node_names:
            return all_node_names, None
        if len(b.names) != len(all_node_names) \
                or set(b.names) != set(all_node_names):
            return all_node_names, None   # membership moved: rebuild
        return b.names, rr

    def _rot_cached(self, b: NodeBatch, rr: int, identity: np.ndarray):
        """Padded axis-index row (scratch n_pad) of the enumeration
        starting at zone index `rr`, or None when it is the identity."""
        if self._rot_rows_b != id(b):
            self._rot_rows = {}
            self._rot_rows_b = id(b)
        got = self._rot_rows.get(rr, _ROT_MISS)
        if got is not _ROT_MISS:
            return got
        names = self.node_tree.order_for_start(rr)
        raw = np.fromiter((b.index[nm] for nm in names), np.int32,
                          len(names))
        if np.array_equal(raw, identity[: len(raw)]):
            row = None
        else:
            row = np.concatenate([
                raw, np.full(b.n_pad + 1 - len(raw), b.n_pad,
                             dtype=np.int32)])
        self._rot_rows[rr] = row
        return row

    def _rot_identity(self, b: NodeBatch) -> np.ndarray:
        """The axis-order (identity) permutation row, scratch-padded."""
        if self._rot_rows_b != id(b):
            self._rot_rows = {}
            self._rot_rows_b = id(b)
        row = self._rot_rows.get("id")
        if row is None:
            row = self._rot_rows["id"] = np.concatenate([
                np.arange(b.n_real, dtype=np.int32),
                np.full(b.n_pad + 1 - b.n_real, b.n_pad, dtype=np.int32)])
        return row

    def _burst_rotation(self, b: NodeBatch, n_pods: int,
                        start0: Optional[int] = None):
        """Per-cycle enumeration orders for a burst: pod 0 rides the device
        axis; pod i >= 1 rides the order starting at the tree's current
        zone index walked i-1 steps through rotation_map. None only when
        the tree can never rotate; the row count pads to a power of two."""
        if not self._tree_rotates():
            return None
        tree = self.node_tree
        nxt = tree.rotation_map()
        r = tree.zone_index
        length = n_pods + K.K_BATCH
        identity = self._rot_identity(b)
        perm_rows = [identity]
        id_of_r: dict[int, int] = {}

        def order_id(rr: int) -> int:
            iid = id_of_r.get(rr)
            if iid is None:
                row = self._rot_cached(b, rr, identity)
                if row is None:
                    iid = 0
                else:
                    perm_rows.append(row)
                    iid = len(perm_rows) - 1
                id_of_r[rr] = iid
            return iid

        seq = np.zeros(length, dtype=np.int32)
        if start0 is not None:
            seq[0] = order_id(start0)
        if nxt[r] == r:
            seq[1:] = order_id(r)     # fixed-point walk
        else:
            for i in range(1, length):
                seq[i] = order_id(r)
                r = nxt[r]
        perms = np.stack(perm_rows)
        l_pad = _pad_pow2(len(perm_rows), 4)
        if len(perm_rows) < l_pad:
            perms = np.concatenate(
                [perms, np.repeat(perms[:1], l_pad - len(perm_rows), axis=0)])
        return perms, seq

    def _refuse(self, reason: str) -> None:
        obs.inc("refusal." + reason)
        return None

    def schedule_burst(self, pods: list[Pod], node_infos: dict[str, NodeInfo],
                       all_node_names: list[str],
                       bucket: Optional[int] = None
                       ) -> Optional[list[Optional[str]]]:
        """Schedule `pods` against one snapshot; returns per-pod host (or
        None when unschedulable), serially equivalent to schedule() per pod
        with cache assumes in between. Returns None — a whole-burst
        refusal, counted under `refusal.<reason>` — when the window is not
        one the uniform kernel takes (the shell then runs it serially).

        The folds stay on the device: the caller MUST apply the returned
        placements to its cache (assume + note_burst_assumed_many) before
        the next cycle."""
        if not all_node_names or not pods:
            return [None] * len(pods)
        t0 = time.perf_counter()
        axis_order, start0 = self._axis_order(all_node_names)
        b = self.encoder.encode(node_infos, axis_order)
        self._node_arrays(b)
        t_mirror = time.perf_counter() - t0
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        bucket = _pad_pow2(bucket if bucket else len(pods), 16)
        sigs = self._signatures(pods)
        s0 = sigs[0]
        if not all(s is s0 or s == s0 for s in sigs):
            return self._refuse("burst-mixed-spec")
        if num_to_find < n or self.last_index != 0:
            return self._refuse("burst-partial-scan")
        f0 = self._pod_encoder(node_infos, b).encode(pods[0])
        uniform = self._uniform_class(pods[0], f0, b, node_infos)
        if uniform is None:
            return self._refuse("burst-class-ineligible")
        cls, extra_ok, ban = uniform
        rotation = self._burst_rotation(b, len(pods), start0)
        # encode = the whole host prologue; mirror = its node-mirror
        # encode and upload part
        phases = {"encode": time.perf_counter() - t0, "mirror": t_mirror,
                  "dispatch": 0.0, "fetch": 0.0}
        self.last_burst_phases = phases
        sel = self._uniform_waves(pods, cls, extra_ok, ban, rotation, n,
                                  bucket, phases)
        return [b.names[s] for s in sel] + [None] * (len(pods) - len(sel))

    def _fetch_buffer(self, cap: int, slot: int) -> torch.Tensor:
        """Host buffer for one packed block: pinned when the block comes
        from a card, so its copy runs asynchronously on the stream."""
        key = (cap, slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(cap + 1, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self._pinned[key] = buf
        return buf

    def _uniform_waves(self, pods: list[Pod], cls, extra_ok, ban: bool,
                       rotation, n: int, bucket: int, phases: dict) -> list:
        """Launch driver of the uniform kernel: each chunk (up to B_CAP
        pods) is ONE K3 launch plus ONE packed [cap+1] device-to-host copy,
        started at dispatch; up to `launch_depth` chunks are in flight
        while the oldest is fetched. Returns the decided prefix (axis
        indices); the caller pads the undecided tail with None. The
        kernel's failures are a frozen-state suffix (F == 0 persists for
        identical pods), so the decided prefix is the block's leading
        non-negative run."""
        dev = self.device
        cap = _pad_pow2(max(1, min(bucket, K.B_CAP)), 16)
        n_pods = len(pods)
        chunks = [(lo, min(cap, n_pods - lo))
                  for lo in range(0, n_pods, cap)]
        depth = max(1, int(self.launch_depth))
        lni_dev = self.last_node_index   # a device scalar after chunk 0
        tensor = self._ptab is not None
        weights = self._union_weights if tensor else self.weights
        wtab = self._wtab() if tensor else None
        extra_dev = None if extra_ok is None \
            else torch.as_tensor(extra_ok).to(dev)
        perm_dev = None if rotation is None \
            else torch.as_tensor(rotation[0]).to(dev)
        sel: list[int] = []
        inflight: list[tuple] = []

        def dispatch(ci: int) -> None:
            nonlocal lni_dev
            t = time.perf_counter()
            lo, chunk = chunks[ci]
            rot = None
            if rotation is not None:
                win = np.empty(cap + K.K_BATCH, dtype=np.int32)
                piece = rotation[1][lo: lo + len(win)]
                win[: len(piece)] = piece
                win[len(piece):] = piece[-1] if len(piece) else 0
                rot = (perm_dev, torch.as_tensor(win).to(dev))
            rows, packed, lni_out = K.schedule_batch_uniform(
                self._dev_nodes, dict(cls), chunk, lni_dev, n,
                self.check_resources, weights=weights, rotation=rot,
                extra_ok=extra_dev, ban=ban, cap=cap, wtab=wtab)
            lni_dev = lni_out
            self._dev_nodes = {**self._dev_nodes, **rows}
            obs.inc("dispatch.burst_uniform")
            host = self._fetch_buffer(cap, ci % depth)
            host.copy_(packed, non_blocking=True)
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            inflight.append((chunk, host, event))
            phases["dispatch"] += time.perf_counter() - t

        next_ci = 1
        dispatch(0)
        while inflight:
            while len(inflight) < depth and next_ci < len(chunks):
                dispatch(next_ci)
                next_ci += 1
            chunk, host, event = inflight.pop(0)
            t = time.perf_counter()
            if event is not None:
                event.synchronize()
            h = host.numpy()
            obs.inc("fetch.burst_uniform")
            phases["fetch"] += time.perf_counter() - t
            chunk_sel = h[:chunk].tolist()
            bad = next((i for i, s in enumerate(chunk_sel) if s < 0), chunk)
            self.last_node_index += int(h[cap])
            sel.extend(chunk_sel[:bad])
            if bad < chunk:
                # later chunks decided nothing more (the state is frozen
                # once no node fits): drop them unfetched
                inflight.clear()
                break
        return sel

    # -- resident-state bookkeeping ------------------------------------------------
    def discard_burst_folds(self) -> None:
        """Forget the resident node matrix: folds for decisions the caller
        discarded must not leak into later cycles; the next use re-uploads
        from the host mirror."""
        if self._dev_nodes is not None:
            obs.inc("discarded_folds")
        self._dev_nodes = None

    def invalidate_node(self, host: str) -> None:
        """A node died mid-burst: drop the resident matrix and the
        encoder's generation entry for `host`."""
        self.discard_burst_folds()
        self.encoder._generations.pop(host, None)

    def note_burst_assumed(self, pod: Pod, host: str, generation: int) -> None:
        """Fold one placed pod into the host mirror (the device already
        folded it) and sync the encoder's generation map, so the next
        encode neither re-encodes nor re-uploads the row."""
        b = self.encoder._batch
        if b is None or host not in b.index:
            return
        self.encoder.note_assumed(b, host, pod, generation=generation,
                                  mark_dirty=False)

    def note_burst_assumed_many(self, pods: list[Pod], hosts: list[str],
                                generations: list) -> None:
        """Batched note_burst_assumed for a committed wave; entries whose
        node left the mirror or the cache (generation None) are skipped."""
        b = self.encoder._batch
        if b is None:
            return
        keep = [(p, h, g) for p, h, g in zip(pods, hosts, generations)
                if g is not None and h in b.index]
        if not keep:
            return
        kp, kh, kg = zip(*keep)
        self.encoder.note_assumed_many(b, list(kp), list(kh), list(kg))

    def load_state(self, state: dict, node_infos: dict[str, NodeInfo],
                   all_node_names: list[str]) -> None:
        """Adopt carried device state (carry.state_from_jax): encode the
        host mirror for `node_infos`, then make the carried node matrix
        the resident one and take over the walk counters and the weight
        table. The carried matrix must describe the same snapshot."""
        b = self.encoder.encode(node_infos, all_node_names)
        nodes = {k: v.to(self.device) for k, v in state["nodes"].items()}
        for k in self._NODE_FIELDS:
            want = tuple(np.shape(getattr(b, k)))
            if tuple(nodes[k].shape) != want:
                raise ValueError(f"carried {k} has shape "
                                 f"{tuple(nodes[k].shape)}, mirror {want}")
        self._dev_nodes = nodes
        self._dev_key = (b.n_pad, len(b.scalar_names), id(b))
        self._dev_epoch += 1
        b.dirty_rows = []
        self.last_index = int(state["last_index"])
        self.last_node_index = int(state["last_node_index"])
        ptab = state.get("ptab")
        self._set_weight_table(None if ptab is None
                               else ptab.cpu().numpy())

    def debug_state(self) -> dict:
        """Mirror shape and epoch, walk counters, device, counters."""
        dev = self._dev_nodes
        mirror = None
        if dev is not None:
            mirror = {"fields": len(dev),
                      "n_pad": int(dev["valid"].shape[-1])}
        return {
            "mirror": mirror,
            "dev_epoch": self._dev_epoch,
            "last_index": self.last_index,
            "last_node_index": self.last_node_index,
            "device": str(self.device),
            "launches": K.launches(),
            "refusals": obs.family("refusal"),
        }
