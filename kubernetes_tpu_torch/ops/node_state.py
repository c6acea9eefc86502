"""Dense node-state encoding: the NodeInfo snapshot as a struct-of-arrays.

The host keeps a numpy mirror of the per-node aggregates the predicates and
priorities read (reference: pkg/scheduler/nodeinfo/node_info.go:47,139); each
scheduling cycle uploads it (or just the changed rows) to HBM, where the
fused kernel evaluates every node at once. The node axis is ordered by the
cache's zone-interleaved NodeTree enumeration, padded to a static capacity so
XLA never recompiles as the cluster grows within a bucket.

String-world features (labels, taints, selectors, topology keys) are
dictionary-encoded host-side per pod into dense masks/counts — the shape the
device consumes (SURVEY §7 "Set/string matching on device").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from kubernetes_tpu_torch.api.types import (
    Pod, Taint, NO_SCHEDULE, NO_EXECUTE, PREFER_NO_SCHEDULE,
    TAINT_NODE_UNSCHEDULABLE, get_resource_request, get_pod_nonzero_requests,
    get_container_ports, get_zone_key, tolerations_tolerate_taint,
    find_intolerable_taint, has_pod_affinity_terms,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo, normalized_image_name
from kubernetes_tpu_torch.oracle.predicates import (
    pod_matches_node_selector_and_affinity, pod_matches_term_props,
    pod_matches_term_props_mask, selector_match_mask,
    InterPodAffinityChecker,
)
from kubernetes_tpu_torch.oracle.priorities import get_selectors
from kubernetes_tpu_torch import obs

def _pad_capacity(n: int, minimum: int = 8) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclass
class NodeBatch:
    """Host-side numpy mirror of the device node matrix.

    All integer fields are int64 (reference resource math is int64). Rows
    [n_real:] are padding with valid=False.
    """
    names: list[str]
    index: dict[str, int]
    n_real: int
    n_pad: int
    scalar_names: list[str]            # extended-resource vocab
    zone_names: list[str]              # zone vocab; index 0 reserved for ""
    valid: np.ndarray                  # [N] bool
    alloc_cpu: np.ndarray              # [N] i64 milli
    alloc_mem: np.ndarray              # [N] i64 bytes
    alloc_eph: np.ndarray              # [N] i64 bytes
    allowed_pods: np.ndarray           # [N] i64
    req_cpu: np.ndarray                # [N] i64
    req_mem: np.ndarray                # [N] i64
    req_eph: np.ndarray                # [N] i64
    nz_cpu: np.ndarray                 # [N] i64 (NonZeroRequest)
    nz_mem: np.ndarray                 # [N] i64
    pod_count: np.ndarray              # [N] i64
    alloc_scalar: np.ndarray           # [N,S] i64
    req_scalar: np.ndarray             # [N,S] i64
    zone_id: np.ndarray                # [N] i32 (0 = no zone)
    # rows rewritten by the latest encode(); None = full rebuild. Consumed by
    # the device mirror to upload only generation-dirty rows (SURVEY §2.4).
    dirty_rows: Optional[list] = None


class NodeStateEncoder:
    """Builds/refreshes a NodeBatch from a cache snapshot.

    Incremental: rows are rewritten only when the NodeInfo generation changed
    or the node moved within the enumeration order — mirroring the cache's
    own generation walk (reference: cache.go:210).
    """

    def __init__(self):
        self._batch: Optional[NodeBatch] = None
        self._generations: dict[str, int] = {}
        self._scalar_vocab: list[str] = []
        self._zone_vocab: list[str] = [""]
        # columnar pod-table cache (pod_table): per-node blocks keyed by
        # NodeInfo generation; vocabs grow monotonically so ids are stable
        self._pt_blocks: dict[str, tuple] = {}
        self._pt_ns_vocab: dict[str, int] = {}
        self._pt_key_vocab: dict[str, int] = {}
        self._pt_val_vocab: dict[str, int] = {}
        self._pt_val_ints: list[float] = []
        # assembled-table memo: when no block re-extracted and the batch is
        # the same object, the concatenated arrays are bit-identical — skip
        # the O(total pods) reassembly (victim_table + the per-burst
        # PodEncoder both read the table, often in the same cycle)
        self._pt_built: Optional["PodTable"] = None
        self._pt_built_key: Optional[tuple] = None
        # calculate_resource memo keyed by the containers tuple: victim
        # columns and uniform waves re-read the same specs constantly
        self._cr_memo: dict = {}
        # per-row SPEC flag planes (round 17): node-spec facts the
        # PodEncoder's cluster-wide feature gates read (taints present,
        # unschedulable, prefer-avoid annotations, image states) —
        # maintained in _write_row exactly like the aggregate mirror, so
        # a serving window reads four numpy any()s instead of four O(N)
        # python attribute scans per window. Spec fields are untouched by
        # assumes (which sync generations without _write_row), so the
        # generation-gated maintenance is exact.
        self._spec_flags: Optional[dict] = None
        # persistent [N, P] victim table (victim_table): re-sorted per node
        # generation, permuted with the mirror rows, reset on a rebuild
        self._vt: Optional["VictimStack"] = None
        self._vt_gens: dict[str, int] = {}
        self._vt_pdb_key: Optional[tuple] = None

    def encode(self, node_infos: dict[str, NodeInfo],
               node_order: list[str]) -> NodeBatch:
        # ONE generation walk collects the vocab additions AND the dirty
        # row list (the old _collect_vocab pass folded in): the serving
        # loop re-encodes every window, and at cluster scale each full
        # O(N) python pass over the snapshot is a measurable slice of the
        # window's host prologue
        gens = self._generations
        dirty_pairs: list = []
        known = zones = None
        scalar_vocab = self._scalar_vocab
        zone_vocab = self._zone_vocab
        for i, name in enumerate(node_order):
            ni = node_infos[name]
            if gens.get(name) == ni.generation:
                continue
            dirty_pairs.append((i, name, ni))
            if known is None:
                known = set(scalar_vocab)
                zones = set(zone_vocab)
            for sname in ni.allocatable.scalar:
                if sname not in known:
                    known.add(sname)
                    scalar_vocab.append(sname)
            for sname in ni.requested.scalar:
                if sname not in known:
                    known.add(sname)
                    scalar_vocab.append(sname)
            if ni.node is not None:
                z = get_zone_key(ni.node)
                if z not in zones:
                    zones.add(z)
                    zone_vocab.append(z)
        n_real = len(node_order)
        n_pad = _pad_capacity(n_real)
        s = max(1, len(self._scalar_vocab))
        b = self._batch
        rebuild = (
            b is None or b.n_pad != n_pad
            or len(b.scalar_names) != len(self._scalar_vocab)
            or b.names != node_order
        )
        if rebuild:
            if (b is not None and b.n_pad == n_pad and b.n_real == n_real
                    and len(b.scalar_names) == len(self._scalar_vocab)
                    and set(b.names) == set(node_order)):
                # same nodes, new enumeration order (uneven-zone clusters
                # rotate between bursts): permute the mirror rows instead
                # of re-extracting every NodeInfo through _write_row —
                # generations are name-keyed, so they stay valid. The
                # victim table's row planes ride the same permutation.
                self._vt_permute(b, node_order, n_real)
                self._flags_permute(b, node_order, n_real)
                b = self._permuted(b, node_order, n_real)
                obs.inc("encoder.mirror_permutes")
            else:
                b = self._fresh(node_order, n_real, n_pad, s)
                self._generations = {}
                self._vt = None           # rows realign on next victim scan
                self._vt_gens = {}
                self._spec_flags = {
                    k: np.zeros(n_pad, dtype=bool)
                    for k in ("taints", "unsched", "avoid", "images")}
                obs.inc("encoder.mirror_rebuilds")
            self._batch = b
        scalar_idx = {name: i for i, name in enumerate(self._scalar_vocab)}
        zone_idx = {name: i for i, name in enumerate(self._zone_vocab)}
        dirty = []
        reencoded = 0
        gens = self._generations   # rebind: _fresh resets the map
        if gens:
            # steady state: only the rows the single walk above found
            # dirty (positions in node_order == batch rows, permute
            # included — _permuted rebuilds the index from node_order)
            iter_rows = dirty_pairs
        else:
            iter_rows = [(i, name, node_infos[name])
                         for i, name in enumerate(node_order)]
        for i, name, ni in iter_rows:
            if gens.get(name) == ni.generation:
                continue
            gens[name] = ni.generation
            reencoded += 1
            # value-compare: a generation bump with identical aggregates
            # (assume→confirm, status-only updates, folds already applied on
            # device) must not trigger a device re-upload
            if self._write_row(b, i, ni, scalar_idx, zone_idx):
                dirty.append(i)
        if reencoded:
            obs.inc("encoder.row_reencodes", reencoded)
        # accumulate until the device mirror consumes (resets) the list;
        # None = full re-upload required
        if rebuild:
            b.dirty_rows = None
        elif b.dirty_rows is not None:
            b.dirty_rows.extend(dirty)
        return b

    def _permuted(self, b: NodeBatch, node_order: list[str],
                  n_real: int) -> NodeBatch:
        """Reorder an existing mirror to a new enumeration of the SAME node
        set: one numpy gather per field. Returned as a fresh NodeBatch
        (dirty_rows=None) so the device mirror re-uploads — row positions
        moved, the delta path can't express that."""
        perm = np.fromiter((b.index[nm] for nm in node_order), np.int64,
                           n_real)

        def take(arr):
            out = arr.copy()
            out[:n_real] = arr[perm]
            return out

        return NodeBatch(
            names=list(node_order),
            index={name: i for i, name in enumerate(node_order)},
            n_real=n_real, n_pad=b.n_pad,
            scalar_names=list(self._scalar_vocab),
            zone_names=list(self._zone_vocab),
            valid=b.valid.copy(),
            alloc_cpu=take(b.alloc_cpu), alloc_mem=take(b.alloc_mem),
            alloc_eph=take(b.alloc_eph), allowed_pods=take(b.allowed_pods),
            req_cpu=take(b.req_cpu), req_mem=take(b.req_mem),
            req_eph=take(b.req_eph),
            nz_cpu=take(b.nz_cpu), nz_mem=take(b.nz_mem),
            pod_count=take(b.pod_count),
            alloc_scalar=take(b.alloc_scalar), req_scalar=take(b.req_scalar),
            zone_id=take(b.zone_id),
        )

    def _fresh(self, node_order: list[str], n_real: int, n_pad: int, s: int) -> NodeBatch:
        z = lambda dt=np.int64: np.zeros(n_pad, dtype=dt)
        b = NodeBatch(
            names=list(node_order),
            index={name: i for i, name in enumerate(node_order)},
            n_real=n_real, n_pad=n_pad,
            scalar_names=list(self._scalar_vocab),
            zone_names=list(self._zone_vocab),
            valid=np.zeros(n_pad, dtype=bool),
            alloc_cpu=z(), alloc_mem=z(), alloc_eph=z(), allowed_pods=z(),
            req_cpu=z(), req_mem=z(), req_eph=z(),
            nz_cpu=z(), nz_mem=z(), pod_count=z(),
            alloc_scalar=np.zeros((n_pad, s), dtype=np.int64),
            req_scalar=np.zeros((n_pad, s), dtype=np.int64),
            zone_id=np.zeros(n_pad, dtype=np.int32),
        )
        b.valid[:n_real] = True
        return b

    def _write_row(self, b: NodeBatch, i: int, ni: NodeInfo,
                   scalar_idx: dict[str, int], zone_idx: dict[str, int]) -> bool:
        """Write one mirror row from its NodeInfo; returns True when any
        device-visible value actually changed."""
        changed = False

        def setf(arr, val):
            nonlocal changed
            if arr[i] != val:
                arr[i] = val
                changed = True

        setf(b.alloc_cpu, ni.allocatable.milli_cpu)
        setf(b.alloc_mem, ni.allocatable.memory)
        setf(b.alloc_eph, ni.allocatable.ephemeral_storage)
        setf(b.allowed_pods, ni.allocatable.allowed_pod_number)
        setf(b.req_cpu, ni.requested.milli_cpu)
        setf(b.req_mem, ni.requested.memory)
        setf(b.req_eph, ni.requested.ephemeral_storage)
        setf(b.nz_cpu, ni.nonzero_cpu)
        setf(b.nz_mem, ni.nonzero_mem)
        setf(b.pod_count, len(ni.pods))
        s = b.alloc_scalar.shape[1]
        new_alloc = np.zeros(s, dtype=np.int64)
        for name, q in ni.allocatable.scalar.items():
            new_alloc[scalar_idx[name]] = q
        if not np.array_equal(b.alloc_scalar[i], new_alloc):
            b.alloc_scalar[i] = new_alloc
            changed = True
        new_req = np.zeros(s, dtype=np.int64)
        for name, q in ni.requested.scalar.items():
            new_req[scalar_idx[name]] = q
        if not np.array_equal(b.req_scalar[i], new_req):
            b.req_scalar[i] = new_req
            changed = True
        if ni.node is not None:
            setf(b.zone_id, zone_idx[get_zone_key(ni.node)])
        flags = self._spec_flags
        if flags is not None:
            # spec facts for the PodEncoder's cluster-wide gates (not
            # device-visible: never feeds `changed`)
            flags["taints"][i] = bool(ni.taints)
            flags["unsched"][i] = (ni.node is not None
                                   and ni.node.unschedulable)
            flags["avoid"][i] = (ni.node is not None
                                 and bool(ni.node.prefer_avoid_pod_uids))
            flags["images"][i] = bool(ni.image_states)
        return changed

    def _flags_permute(self, b_old: NodeBatch, node_order: list[str],
                       n_real: int) -> None:
        """Reorder the spec-flag planes to a rotated enumeration of the
        same node set, mirroring _permuted."""
        flags = self._spec_flags
        if flags is None:
            return
        perm = np.fromiter((b_old.index[nm] for nm in node_order),
                           np.int64, n_real)
        for k, arr in flags.items():
            out = arr.copy()
            out[:n_real] = arr[perm]
            flags[k] = out

    def cluster_spec_flags(self, b: NodeBatch) -> Optional[dict]:
        """The four cluster-wide spec gates as O(1)-ish numpy any()s —
        valid only for the encoder's CURRENT batch (every row written at
        its generation); None tells the caller to fall back to the
        per-node scans."""
        if self._spec_flags is None or self._batch is not b:
            return None
        n = b.n_real
        f = self._spec_flags
        return {
            "any_taints": bool(f["taints"][:n].any()),
            "any_unschedulable": bool(f["unsched"][:n].any()),
            "any_prefer_avoid": bool(f["avoid"][:n].any()),
            "any_images": bool(f["images"][:n].any()),
        }

    # -- columnar pod table --------------------------------------------------
    def _pt_val_id(self, v: str) -> int:
        vid = self._pt_val_vocab.get(v)
        if vid is None:
            vid = self._pt_val_vocab[v] = len(self._pt_val_ints)
            try:
                self._pt_val_ints.append(float(int(v)))
            except ValueError:
                self._pt_val_ints.append(float("nan"))
        return vid

    def _pt_block(self, ni: NodeInfo):
        """One node's pods as dictionary-encoded rows. Vocab ids are
        monotonic (never reassigned) so cached blocks stay valid across
        encodes. Alongside the label rows, each pod's VICTIM columns are
        extracted here — priority, start time, calculate_resource sums
        (memoized by the containers tuple), and the inertness-class flags
        (affinity terms / container ports / scalar resources) — so the
        preemption path reads cached per-generation facts instead of
        re-deriving them per scan."""
        pods = list(ni.pods)
        p = len(pods)
        aff_ids = set(map(id, ni.pods_with_affinity))
        lmax = max((len(pd.labels) for pd in pods), default=0)
        kid = np.full((p, max(lmax, 1)), -1, np.int32)
        vid = np.full((p, max(lmax, 1)), -1, np.int32)
        ns = np.empty(p, np.int32)
        deleted = np.empty(p, bool)
        has_aff = np.empty(p, bool)
        prio = np.empty(p, np.int64)
        start = np.empty(p, np.float64)
        rcpu = np.empty(p, np.int64)
        rmem = np.empty(p, np.int64)
        reph = np.empty(p, np.int64)
        rscalar = np.empty(p, bool)
        aterms = np.empty(p, bool)
        ports = np.empty(p, bool)
        names = []
        nsv, kvoc = self._pt_ns_vocab, self._pt_key_vocab
        cr_memo = self._cr_memo
        for j, pd in enumerate(pods):
            nid = nsv.get(pd.namespace)
            if nid is None:
                nid = nsv[pd.namespace] = len(nsv)
            ns[j] = nid
            deleted[j] = pd.deleted
            has_aff[j] = id(pd) in aff_ids
            prio[j] = pd.priority
            start[j] = pd.start_time if pd.start_time is not None else np.inf
            key = pd.containers
            got = cr_memo.get(key)
            if got is None:
                from kubernetes_tpu_torch.cache.node_info import calculate_resource
                r = calculate_resource(pd)
                got = cr_memo[key] = (r.milli_cpu, r.memory,
                                      r.ephemeral_storage, bool(r.scalar),
                                      bool(get_container_ports(pd)))
            rcpu[j], rmem[j], reph[j], rscalar[j], ports[j] = got
            aterms[j] = has_pod_affinity_terms(pd)
            names.append(pd.node_name)
            for l, (k, v) in enumerate(pd.labels.items()):
                kk = kvoc.get(k)
                if kk is None:
                    kk = kvoc[k] = len(kvoc)
                kid[j, l] = kk
                vid[j, l] = self._pt_val_id(v)
        return (pods, ns, kid, vid, deleted, has_aff, names,
                (prio, start, rcpu, rmem, reph, rscalar, aterms, ports))

    def pod_table(self, node_infos: dict[str, NodeInfo],
                  b: NodeBatch) -> "PodTable":
        """Columnar table of every snapshot pod, cached per node by the
        NodeInfo generation exactly like the dirty-row encode: only nodes
        whose generation moved re-extract their pods' label rows; assembly
        of the cached blocks is pure numpy. Callers that feed the table to
        the vectorized matchers assume the batch axis covers the snapshot
        (node_infos keys ⊆ batch names), which is how every encoder
        consumer builds it."""
        blocks = []
        new_cache = {}
        all_hit = True
        for name, ni in node_infos.items():
            cached = self._pt_blocks.get(name)
            if cached is not None and cached[0] == ni.generation:
                blk = cached[1]
            else:
                blk = self._pt_block(ni)
                all_hit = False
            new_cache[name] = (ni.generation, blk)
            blocks.append((name, blk))
        if len(new_cache) != len(self._pt_blocks):
            all_hit = False              # a node left or joined the snapshot
        self._pt_blocks = new_cache   # prunes nodes that left the snapshot
        key = (id(b), len(blocks))
        if all_hit and self._pt_built is not None \
                and self._pt_built_key == key:
            # no block re-extracted against the same batch: the assembled
            # arrays are bit-identical — reuse them
            return self._pt_built
        total = sum(len(blk[0]) for _, blk in blocks)
        lmax = max((blk[2].shape[1] for _, blk in blocks if len(blk[0])),
                   default=1)
        pods: list = []
        holder_row = np.full(total, -1, np.int32)
        holder_has_obj = np.zeros(total, bool)
        name_row = np.full(total, -1, np.int32)
        ns_id = np.empty(total, np.int32)
        deleted = np.empty(total, bool)
        has_aff = np.empty(total, bool)
        key_ids = np.full((total, lmax), -1, np.int32)
        val_ids = np.full((total, lmax), -1, np.int32)
        prio = np.empty(total, np.int64)
        start = np.empty(total, np.float64)
        res_cpu = np.empty(total, np.int64)
        res_mem = np.empty(total, np.int64)
        res_eph = np.empty(total, np.int64)
        has_scalar = np.empty(total, bool)
        has_aff_terms = np.empty(total, bool)
        has_ports = np.empty(total, bool)
        off = 0
        for name, blk in blocks:
            bpods, ns, kid, vid, dele, haff, names, vcols = blk
            p = len(bpods)
            if not p:
                continue
            pods.extend(bpods)
            sl = slice(off, off + p)
            hrow = b.index.get(name, -1)
            holder_row[sl] = hrow
            holder_has_obj[sl] = node_infos[name].node is not None
            ns_id[sl] = ns
            deleted[sl] = dele
            has_aff[sl] = haff
            key_ids[sl, : kid.shape[1]] = kid
            val_ids[sl, : vid.shape[1]] = vid
            (prio[sl], start[sl], res_cpu[sl], res_mem[sl], res_eph[sl],
             has_scalar[sl], has_aff_terms[sl], has_ports[sl]) = vcols
            for j, nm in enumerate(names):
                if nm == name:
                    name_row[off + j] = hrow
                elif nm in node_infos:
                    name_row[off + j] = b.index.get(nm, -1)
            off += p
        out = PodTable(
            pods=pods, holder_row=holder_row, holder_has_obj=holder_has_obj,
            name_row=name_row, has_affinity=has_aff, deleted=deleted,
            ns_id=ns_id, key_ids=key_ids, val_ids=val_ids,
            ns_vocab=self._pt_ns_vocab, key_vocab=self._pt_key_vocab,
            val_vocab=self._pt_val_vocab,
            val_ints=np.asarray(self._pt_val_ints, dtype=np.float64),
            prio=prio, start=start, res_cpu=res_cpu, res_mem=res_mem,
            res_eph=res_eph, has_scalar=has_scalar,
            has_aff_terms=has_aff_terms, has_ports=has_ports)
        self._pt_built = out
        self._pt_built_key = key
        return out

    # -- persistent victim table --------------------------------------------
    def victim_table(self, node_infos: dict[str, NodeInfo], b: NodeBatch,
                     pdbs: list, cap: int = 128) -> "VictimStack":
        """Build/refresh the persistent [N, P] victim table against `b`.

        Incremental like encode(): only nodes whose NodeInfo generation
        moved since the last call re-sort their slots, in one vectorized
        np.lexsort over the dirty nodes' pod-table rows. A PDB-set change
        (object identity or disruptionsAllowed) dirties every node, since
        the violating flags feed the sort key. The NodeTree rotation case
        never lands here: encode()'s permute branch reorders the victim
        rows with the mirror rows.

        Assumed pods arrive through the cache's generation bump (the
        note_assumed hooks do NOT sync `_vt_gens`: the victim table needs
        the new pod's row, so the next call re-extracts exactly the
        bound-to nodes)."""
        t = self.pod_table(node_infos, b)
        pdb_key = tuple(sorted(
            (id(p), p.namespace, int(p.disruptions_allowed),
             p.selector is None) for p in pdbs))
        n_pad = b.n_pad
        hr = t.holder_row
        on_axis = hr >= 0
        counts = np.bincount(hr[on_axis], minlength=n_pad).astype(np.int64)
        maxp = int(counts.max()) if counts.size else 0
        P = min(_pad_capacity(max(maxp, 1), 8), cap)
        vt = self._vt
        if vt is not None and vt.valid.shape[0] == n_pad:
            P = max(P, vt.P)   # never shrink: avoids rebuild thrash
        if vt is None or vt.P != P or vt.valid.shape[0] != n_pad:
            zeros2 = lambda dt: np.zeros((n_pad, P), dtype=dt)
            vt = VictimStack(
                P=P, cpu=zeros2(np.int64), mem=zeros2(np.int64),
                eph=zeros2(np.int64), prio=zeros2(np.int64),
                start=np.full((n_pad, P), np.inf, np.float64),
                valid=zeros2(bool), viol=zeros2(bool), aff=zeros2(bool),
                ports=zeros2(bool), scalar=zeros2(bool),
                count=np.zeros(n_pad, np.int64),
                overflow=np.zeros(n_pad, bool),
                slots={}, table=t, dirty_rows=None)
            self._vt = vt
            self._vt_gens = {}
            self._vt_pdb_key = None
            obs.inc("encoder.victim_rebuilds")
        vt.table = t
        if pdb_key != self._vt_pdb_key:
            # the violating flags are part of the sort key: re-sort all
            self._vt_gens = {}
            self._vt_pdb_key = pdb_key
        gens = self._vt_gens
        dirty = []
        for i, name in enumerate(b.names):
            g = node_infos[name].generation
            if gens.get(name) != g:
                gens[name] = g
                dirty.append(i)
        if not dirty:
            return vt
        obs.inc("encoder.victim_row_resorts", len(dirty))
        d = np.asarray(dirty, np.int64)
        # reset the dirty rows, then scatter the re-sorted slots
        for f in ("cpu", "mem", "eph", "prio"):
            getattr(vt, f)[d] = 0
        vt.start[d] = np.inf
        for f in ("valid", "viol", "aff", "ports", "scalar"):
            getattr(vt, f)[d] = False
        vt.count[d] = counts[d]
        vt.overflow[d] = counts[d] > P
        for i in dirty:
            vt.slots[b.names[i]] = []
        is_dirty = np.zeros(n_pad, bool)
        is_dirty[d] = True
        rows = np.flatnonzero(on_axis & is_dirty[np.where(on_axis, hr, 0)])
        if rows.size:
            from kubernetes_tpu_torch.oracle.preemption import \
                pods_violating_pdbs_mask
            viol = pods_violating_pdbs_mask(t, pdbs)[rows] if pdbs \
                else np.zeros(rows.size, bool)
            holder = hr[rows].astype(np.int64)
            # reprieve processing order per node in ONE stable lexsort
            # (last key is primary): group by node row, violating first,
            # then descending importance = priority desc, start asc; the
            # sort is stable, so ties keep ni.pods order
            order = np.lexsort((t.start[rows], -t.prio[rows],
                                (~viol).astype(np.int8), holder))
            sr = rows[order]
            h = holder[order]
            viol_s = viol[order]
            newgrp = np.r_[True, h[1:] != h[:-1]]
            gstart = np.flatnonzero(newgrp)
            slot = np.arange(len(h)) - gstart[np.cumsum(newgrp) - 1]
            keep = slot < P
            hs, ss = h[keep], slot[keep]
            ks = sr[keep]
            vt.cpu[hs, ss] = t.res_cpu[ks]
            vt.mem[hs, ss] = t.res_mem[ks]
            vt.eph[hs, ss] = t.res_eph[ks]
            vt.prio[hs, ss] = t.prio[ks]
            vt.start[hs, ss] = t.start[ks]
            vt.valid[hs, ss] = True
            vt.viol[hs, ss] = viol_s[keep]
            vt.aff[hs, ss] = t.has_aff_terms[ks]
            vt.ports[hs, ss] = t.has_ports[ks]
            vt.scalar[hs, ss] = t.has_scalar[ks]
            pods_list = t.pods
            names_list = b.names
            slots = vt.slots
            for r, hi in zip(ks.tolist(), hs.tolist()):
                slots[names_list[hi]].append(pods_list[r])
        if vt.dirty_rows is not None:
            vt.dirty_rows.extend(dirty)
        return vt

    def _vt_permute(self, b_old: NodeBatch, node_order: list[str],
                    n_real: int) -> None:
        """Reorder the victim table to a rotated enumeration of the same
        node set, one gather per plane, mirroring _permuted. Row positions
        moved, so the device copy needs a full re-upload (dirty_rows None);
        slot content and the name-keyed slots/generation maps stay valid."""
        vt = self._vt
        if vt is None:
            return
        perm = np.fromiter((b_old.index[nm] for nm in node_order), np.int64,
                           n_real)
        for f in VictimStack._ROW_FIELDS:
            arr = getattr(vt, f)
            out = arr.copy()
            out[:n_real] = arr[perm]
            setattr(vt, f, out)
        vt.dirty_rows = None

    def note_assumed(self, b: NodeBatch, node_name: str, pod: Pod,
                     generation: Optional[int] = None,
                     mark_dirty: bool = True) -> None:
        """Apply an assume to the host mirror without a full re-encode,
        matching NodeInfo.add_pod's aggregate update (calculate_resource —
        regular containers only — NOT the predicate-side GetResourceRequest
        which maxes in init containers; reference: node_info.go:578).

        With `generation`, syncs `_generations` to the cache's post-assume
        generation; with mark_dirty=False the row is NOT queued for device
        upload — callers use that when the device already folded the same
        delta in-scan (the burst path), making the resident matrix
        authoritative."""
        from kubernetes_tpu_torch.cache.node_info import calculate_resource
        i = b.index[node_name]
        req = calculate_resource(pod)
        b.req_cpu[i] += req.milli_cpu
        b.req_mem[i] += req.memory
        b.req_eph[i] += req.ephemeral_storage
        if req.scalar:
            scalar_idx = {name: j for j, name in enumerate(b.scalar_names)}
            for name, q in req.scalar.items():
                b.req_scalar[i, scalar_idx[name]] += q
        ncpu, nmem = get_pod_nonzero_requests(pod)
        b.nz_cpu[i] += ncpu
        b.nz_mem[i] += nmem
        b.pod_count[i] += 1
        if generation is not None:
            self._generations[node_name] = generation
        if mark_dirty and b.dirty_rows is not None:
            b.dirty_rows.append(i)

    def note_assumed_many(self, b: NodeBatch, pods: list, hosts: list,
                          generations: list) -> None:
        """Vectorized note_assumed for a committed burst wave: the per-pod
        deltas land in the mirror via bincount-style scatters (np.add.at —
        duplicate hosts accumulate) and the generation map syncs in one
        dict.update, replacing one Python call chain per pod with one per
        wave. Never marks rows dirty: callers use this exactly when the
        device already folded the same deltas in-scan (the burst commit
        path), making the resident matrix authoritative.

        Delta extraction is memoized by the containers tuple — a uniform
        wave of spec-identical pods computes calculate_resource once."""
        from kubernetes_tpu_torch.cache.node_info import calculate_resource
        k = len(pods)
        if not k:
            return
        rows = np.fromiter((b.index[h] for h in hosts), np.int64, k)
        cache: dict = {}
        cpu = np.empty(k, np.int64)
        mem = np.empty(k, np.int64)
        eph = np.empty(k, np.int64)
        ncpu = np.empty(k, np.int64)
        nmem = np.empty(k, np.int64)
        scalar_pods = []
        for j, pod in enumerate(pods):
            key = pod.containers
            got = cache.get(key)
            if got is None:
                req = calculate_resource(pod)
                got = cache[key] = (req, get_pod_nonzero_requests(pod))
            req, (nc, nm) = got
            cpu[j] = req.milli_cpu
            mem[j] = req.memory
            eph[j] = req.ephemeral_storage
            ncpu[j] = nc
            nmem[j] = nm
            if req.scalar:
                scalar_pods.append((j, req.scalar))
        np.add.at(b.req_cpu, rows, cpu)
        np.add.at(b.req_mem, rows, mem)
        np.add.at(b.req_eph, rows, eph)
        np.add.at(b.nz_cpu, rows, ncpu)
        np.add.at(b.nz_mem, rows, nmem)
        np.add.at(b.pod_count, rows, 1)
        if scalar_pods:
            scalar_idx = {name: j for j, name in enumerate(b.scalar_names)}
            for j, scal in scalar_pods:
                for name, q in scal.items():
                    b.req_scalar[rows[j], scalar_idx[name]] += q
        # generations are read once per wave AFTER every assume, so the
        # name-keyed map lands at each touched node's final generation
        self._generations.update(
            (h, g) for h, g in zip(hosts, generations) if g is not None)


@dataclass
class PodTable:
    """Columnar snapshot pod table: one row per pod of every NodeInfo, with
    namespaces and label (key, value) pairs dictionary-encoded — the
    existing-pod axis twin of the node matrix (SURVEY §2.3 applied to
    selector matching). Consumed through the shared vectorized matchers in
    oracle.predicates (selector_match_mask / pod_matches_term_props_mask),
    so the per-existing-pod Python of selector-spread counting and
    inter-pod affinity scans becomes one boolean mask per selector/term.
    """
    pods: list                  # row -> Pod
    holder_row: np.ndarray      # [P] i32 batch row of the holding NodeInfo (-1 off-axis)
    holder_has_obj: np.ndarray  # [P] bool: holder NodeInfo.node is not None
    name_row: np.ndarray        # [P] i32 batch row of the node named pod.node_name (-1 unknown)
    has_affinity: np.ndarray    # [P] bool (mirrors NodeInfo.pods_with_affinity)
    deleted: np.ndarray         # [P] bool
    ns_id: np.ndarray           # [P] i32
    key_ids: np.ndarray         # [P, L] i32, -1 padding
    val_ids: np.ndarray         # [P, L] i32, -1 padding
    ns_vocab: dict
    key_vocab: dict
    val_vocab: dict
    val_ints: np.ndarray        # [V] f64 parsed-integer value (NaN unparseable)
    # victim columns (cached per node generation in the same blocks): the
    # facts preemption reads about every snapshot pod, so a victim scan
    # never re-derives them per pod
    prio: np.ndarray = None          # [P] i64 pod priority
    start: np.ndarray = None         # [P] f64 start time (+inf when None)
    res_cpu: np.ndarray = None       # [P] i64 calculate_resource milli-CPU
    res_mem: np.ndarray = None       # [P] i64 bytes
    res_eph: np.ndarray = None       # [P] i64 bytes
    has_scalar: np.ndarray = None    # [P] bool — extended resources requested
    has_aff_terms: np.ndarray = None  # [P] bool — any pod (anti-)affinity term
    has_ports: np.ndarray = None     # [P] bool — declares container ports


@dataclass
class VictimStack:
    """Persistent [N, P] victim table: every snapshot pod in its node's
    reprieve processing order (PDB-violating first, each group by
    descending importance), maintained incrementally beside the node
    mirror.

    Slots hold ALL pods, not just one preemptor's potential victims: the
    sort key (violating, -priority, start) is priority-monotone, so the
    device's mask `prio < max_prio` keeps the per-preemptor reprieve order,
    and one table serves every preemptor priority. The flag planes
    (aff/ports/scalar) make the eligibility gates mask reads, and
    `dirty_rows` feeds the device copy's sparse re-upload as NodeBatch
    does."""
    P: int                      # slot bucket (power of two, <= kernel cap)
    cpu: np.ndarray             # [N, P] i64 calculate_resource milli-CPU
    mem: np.ndarray             # [N, P] i64
    eph: np.ndarray             # [N, P] i64
    prio: np.ndarray            # [N, P] i64
    start: np.ndarray           # [N, P] f64 (+inf padding)
    valid: np.ndarray           # [N, P] bool
    viol: np.ndarray            # [N, P] bool — PDB-violating
    aff: np.ndarray             # [N, P] bool — pod carries affinity terms
    ports: np.ndarray           # [N, P] bool — pod declares container ports
    scalar: np.ndarray          # [N, P] bool — pod requests scalar resources
    count: np.ndarray           # [N] i64 total pods on the node
    overflow: np.ndarray        # [N] bool — count exceeded the slot cap
    slots: dict                 # node name -> ordered slot Pod list
    table: PodTable             # the pod table the rows were built from
    # rows rewritten since the device copy last consumed the list;
    # None = full re-upload required (rebuild or permute)
    dirty_rows: Optional[list] = None

    _ROW_FIELDS = ("cpu", "mem", "eph", "prio", "start", "valid", "viol",
                   "aff", "ports", "scalar", "count", "overflow")


def build_pod_table(node_infos: dict[str, NodeInfo], b: NodeBatch) -> PodTable:
    """Uncached one-shot table build (standalone PodEncoder uses); the
    scheduler path goes through NodeStateEncoder.pod_table for the
    generation cache."""
    return NodeStateEncoder().pod_table(node_infos, b)


# ---------------------------------------------------------------------------
# Per-pod encoding: masks + score counts over the node axis
# ---------------------------------------------------------------------------
# interpod failure codes (kernel output decoding)
IPA_OK = 0
IPA_EXISTING_ANTI = 1
IPA_OWN_AFFINITY = 2
IPA_OWN_ANTI = 3


@dataclass
class PodFeatures:
    """Everything the kernel needs about one pod, over a NodeBatch's axis.

    Mask arrays are None when the pod/cluster doesn't exercise the feature
    (all-pass) so the common case uploads nothing.
    """
    req_cpu: int
    req_mem: int
    req_eph: int
    req_scalar: np.ndarray             # [S] i64
    has_request: bool                  # reference: predicates.go:786 early-out
    nz_cpu: int
    nz_mem: int
    # filter masks (None => all pass)
    sel_ok: Optional[np.ndarray] = None        # [N] bool — selector + req. node affinity
    taints_ok: Optional[np.ndarray] = None     # [N] bool
    unsched_ok: Optional[np.ndarray] = None    # [N] bool
    ports_ok: Optional[np.ndarray] = None      # [N] bool
    host_ok: Optional[np.ndarray] = None       # [N] bool
    disk_ok: Optional[np.ndarray] = None       # [N] bool (NoDiskConflict)
    maxvol_ok: Optional[np.ndarray] = None     # [N] bool (Max*VolumeCount)
    volbind_ok: Optional[np.ndarray] = None    # [N] bool (CheckVolumeBinding)
    volzone_ok: Optional[np.ndarray] = None    # [N] bool (NoVolumeZoneConflict)
    volbind_reasons: Optional[dict] = None     # node idx -> reasons (decode)
    interpod_code: Optional[np.ndarray] = None  # [N] i8 IPA_* codes
    # scalars requested by the pod but absent from every node's capacity:
    # they fail PodFitsResources on all nodes (reference: predicates.go:806)
    unknown_scalars: tuple = ()
    # score inputs (None => zeros)
    node_aff_counts: Optional[np.ndarray] = None   # [N] i64
    taint_counts: Optional[np.ndarray] = None      # [N] i64
    spread_counts: Optional[np.ndarray] = None     # [N] i64
    interpod_counts: Optional[np.ndarray] = None   # [N] i64
    interpod_tracked: Optional[np.ndarray] = None  # [N] bool
    image_sums: Optional[np.ndarray] = None        # [N] i64
    prefer_avoid: Optional[np.ndarray] = None      # [N] i64 (0 or 10)


class PodEncoder:
    """Encodes one pod against a snapshot into dense per-node arrays.

    The string-matching work (selectors, taints, topology pairs) happens here
    once per pod in O(N) dict lookups; the reference instead does it inside
    every per-node goroutine (predicates.go:889,1531).
    """

    def __init__(self, node_infos: dict[str, NodeInfo], batch: NodeBatch,
                 services=None, replicasets=None, total_num_nodes: Optional[int] = None,
                 hard_pod_affinity_weight: int = 1,
                 enabled: Optional[set] = None,
                 state_encoder: Optional[NodeStateEncoder] = None):
        self.node_infos = node_infos
        self.batch = batch
        # predicate names enabled by the provider/policy; None = all
        self.enabled = enabled
        self.services = services or []
        self.replicasets = replicasets or []
        self.total_num_nodes = total_num_nodes or max(1, batch.n_real)
        self.hard_weight = hard_pod_affinity_weight
        # columnar pod table: generation-cached when the scheduler's
        # NodeStateEncoder is supplied, one-shot otherwise (lazy either way)
        self.state_encoder = state_encoder
        self._ptable: Optional[PodTable] = None
        self._taint_rows: Optional[dict] = None
        self._image_locality_rows: Optional[dict] = None
        self._ipa = InterPodAffinityChecker(node_infos)
        self._ipa.set_table_source(self._table, self._topo_values)
        # cluster-wide feature flags: skip whole mask families when inert.
        # Spec-derived flags read the state encoder's maintained planes
        # (four numpy any()s) instead of four O(N) python attribute scans
        # per window — bit-identical by the generation-gated row contract;
        # the affinity flag depends on held PODS (assumes change it), so
        # it keeps the direct scan.
        flags = state_encoder.cluster_spec_flags(batch) \
            if state_encoder is not None else None
        if flags is None:
            self._any_taints = any(ni.taints for ni in node_infos.values())
            self._any_unschedulable = any(
                ni.node is not None and ni.node.unschedulable
                for ni in node_infos.values())
            self._any_prefer_avoid = any(
                ni.node is not None and ni.node.prefer_avoid_pod_uids
                for ni in node_infos.values())
            self._any_images = any(
                ni.image_states for ni in node_infos.values())
        else:
            self._any_taints = flags["any_taints"]
            self._any_unschedulable = flags["any_unschedulable"]
            self._any_prefer_avoid = flags["any_prefer_avoid"]
            self._any_images = flags["any_images"]
        self._any_affinity_pods = any(
            ni.pods_with_affinity for ni in node_infos.values())
        # per-(topologyKey) dictionary encoding of node label values, built
        # lazily for the inter-pod segment-sum counting (SURVEY §2.3)
        self._topo_cache: dict[str, tuple[np.ndarray, dict]] = {}

    def _nodes(self):
        b = self.batch
        for i in range(b.n_real):
            yield i, self.node_infos[b.names[i]]

    def _table(self) -> PodTable:
        if self._ptable is None:
            if self.state_encoder is not None:
                self._ptable = self.state_encoder.pod_table(
                    self.node_infos, self.batch)
            else:
                self._ptable = build_pod_table(self.node_infos, self.batch)
        return self._ptable

    def _on(self, *names: str) -> bool:
        return self.enabled is None or any(n in self.enabled for n in names)

    def encode(self, pod: Pod) -> PodFeatures:
        b = self.batch
        req = get_resource_request(pod)
        req_scalar = np.zeros(max(1, len(b.scalar_names)), dtype=np.int64)
        scalar_idx = {name: i for i, name in enumerate(b.scalar_names)}
        unknown = []
        for name, q in req.scalar.items():
            if name in scalar_idx:
                req_scalar[scalar_idx[name]] = q
            elif q > 0:
                unknown.append(name)
        nz_cpu, nz_mem = get_pod_nonzero_requests(pod)
        f = PodFeatures(
            req_cpu=req.milli_cpu, req_mem=req.memory, req_eph=req.ephemeral_storage,
            req_scalar=req_scalar,
            has_request=bool(req.milli_cpu or req.memory or req.ephemeral_storage
                             or req.scalar),
            nz_cpu=nz_cpu, nz_mem=nz_mem,
            unknown_scalars=tuple(unknown),
        )
        self._encode_filters(pod, f)
        self._encode_scores(pod, f)
        return f

    # -- filter masks -------------------------------------------------------
    def _encode_filters(self, pod: Pod, f: PodFeatures) -> None:
        b = self.batch
        if (pod.node_selector or (pod.affinity and pod.affinity.node_affinity)) \
                and self._on("GeneralPredicates", "MatchNodeSelector"):
            m = np.zeros(b.n_pad, dtype=bool)
            for i, ni in self._nodes():
                m[i] = ni.node is not None and \
                    pod_matches_node_selector_and_affinity(pod, ni.node)
            f.sel_ok = m
        if self._any_taints and self._on("PodToleratesNodeTaints"):
            m = np.ones(b.n_pad, dtype=bool)
            for i, ni in self._nodes():
                bad = find_intolerable_taint(
                    ni.taints, pod.tolerations,
                    lambda t: t.effect in (NO_SCHEDULE, NO_EXECUTE))
                m[i] = bad is None
            f.taints_ok = m
        if self._any_unschedulable and self._on("CheckNodeUnschedulable"):
            tolerates = any(
                t.tolerates(Taint(key=TAINT_NODE_UNSCHEDULABLE, effect=NO_SCHEDULE))
                for t in pod.tolerations)
            m = np.ones(b.n_pad, dtype=bool)
            if not tolerates:
                for i, ni in self._nodes():
                    m[i] = not (ni.node is not None and ni.node.unschedulable)
            f.unsched_ok = m
        ports = get_container_ports(pod)
        if ports and self._on("GeneralPredicates", "PodFitsHostPorts"):
            m = np.ones(b.n_pad, dtype=bool)
            for i, ni in self._nodes():
                m[i] = not any(
                    ni.used_ports.check_conflict(p.host_ip, p.protocol, p.host_port)
                    for p in ports)
            f.ports_ok = m
        if pod.node_name and self._on("GeneralPredicates", "HostName"):
            m = np.zeros(b.n_pad, dtype=bool)
            idx = b.index.get(pod.node_name)
            if idx is not None:
                m[idx] = True
            f.host_ok = m
        has_own_terms = pod.affinity is not None and (
            pod.affinity.pod_affinity is not None
            or pod.affinity.pod_anti_affinity is not None)
        if (self._any_affinity_pods or has_own_terms) \
                and self._on("MatchInterPodAffinity"):
            f.interpod_code = self._interpod_codes(pod)

    def _interpod_codes(self, pod: Pod) -> np.ndarray:
        """Vectorized MatchInterPodAffinity over the node axis: the same
        (topologyKey, value) metadata the oracle's per-node check reads
        (predicates.InterPodAffinityChecker._metadata, itself vectorized
        over the pod table), resolved against the dictionary-encoded node
        label values — one membership mask per term instead of a Python
        check per node. Codes keep the oracle's first-failure precedence:
        existing-pods anti-affinity, then own affinity, then own anti."""
        b = self.batch
        violating, aff_terms, anti_terms = self._ipa._metadata(pod)
        fail_exist = np.zeros(b.n_pad, dtype=bool)
        for (key, value) in violating:
            ids, vocab = self._topo_values(key)
            vid = vocab.get(value)
            if vid is not None:
                fail_exist |= ids == vid
        fail_aff = np.zeros(b.n_pad, dtype=bool)
        for term, values, total in aff_terms:
            if not values:
                # first-pod-in-cluster waiver (predicates.go:1454-1464) is
                # node-independent: no pod anywhere matches the term
                if total[0] == 0 and pod_matches_term_props(pod, pod, term):
                    continue
                fail_aff[:] = True
                continue
            ids, vocab = self._topo_values(term.topology_key)
            vids = [vocab[v] for v in values if v in vocab]
            member = np.isin(ids, vids) if vids \
                else np.zeros(b.n_pad, dtype=bool)
            fail_aff |= ~member
        fail_anti = np.zeros(b.n_pad, dtype=bool)
        for term, values, _total in anti_terms:
            ids, vocab = self._topo_values(term.topology_key)
            vids = [vocab[v] for v in values if v in vocab]
            if vids:
                fail_anti |= np.isin(ids, vids)
        codes = np.where(
            fail_exist, IPA_EXISTING_ANTI,
            np.where(fail_aff, IPA_OWN_AFFINITY,
                     np.where(fail_anti, IPA_OWN_ANTI, 0))).astype(np.int8)
        codes[b.n_real:] = 0   # padding rows carry no verdict
        return codes

    # -- score inputs -------------------------------------------------------
    def _encode_scores(self, pod: Pod, f: PodFeatures) -> None:
        b = self.batch
        a = pod.affinity
        if a is not None and a.node_affinity is not None and a.node_affinity.preferred:
            counts = np.zeros(b.n_pad, dtype=np.int64)
            for i, ni in self._nodes():
                if ni.node is None:
                    continue
                c = 0
                for term in a.node_affinity.preferred:
                    if term.weight == 0:
                        continue
                    if term.preference.match_expressions and \
                            term.preference.matches(ni.node.labels):
                        c += term.weight
                counts[i] = c
            f.node_aff_counts = counts
        if self._any_taints:
            # group by unique taint (cached per snapshot): each distinct
            # PreferNoSchedule taint is toleration-checked ONCE, its node
            # rows incremented in one scatter — instead of the old
            # per-node × per-taint Python walk
            tols = [t for t in pod.tolerations
                    if not t.effect or t.effect == PREFER_NO_SCHEDULE]
            counts = np.zeros(b.n_pad, dtype=np.int64)
            for taint, rows in self._prefer_taint_rows().items():
                if not tolerations_tolerate_taint(tols, taint):
                    np.add.at(counts, rows, 1)
            f.taint_counts = counts
        selectors = get_selectors(pod, self.services, self.replicasets)
        if selectors:
            # selector-spread counting (selector_spreading.go:66): one
            # vectorized selector-match over the columnar pod table plus a
            # segment-sum by holder node, replacing the per-existing-pod
            # Python that made the spread lane the encode-side cliff
            t = self._table()
            nsid = t.ns_vocab.get(pod.namespace)
            if nsid is None:
                m = np.zeros(len(t.pods), dtype=bool)
            else:
                m = (t.ns_id == nsid) & ~t.deleted
            for s in selectors:
                if not m.any():
                    break
                m &= selector_match_mask(s, t)
            counts = np.zeros(b.n_pad, dtype=np.int64)
            rows = t.holder_row[m]
            rows = rows[rows >= 0]
            if rows.size:
                counts += np.bincount(rows, minlength=b.n_pad)
            f.spread_counts = counts
        has_pref_terms = a is not None and (
            (a.pod_affinity is not None and a.pod_affinity.preferred)
            or (a.pod_anti_affinity is not None and a.pod_anti_affinity.preferred))
        if self._any_affinity_pods or has_pref_terms:
            f.interpod_counts, f.interpod_tracked = self._interpod_pref_counts(pod)
        if self._any_images:
            sums = np.zeros(b.n_pad, dtype=np.int64)
            img_rows = self._image_rows()
            for c in pod.containers:
                ent = img_rows.get(normalized_image_name(c.image))
                if ent is not None:
                    np.add.at(sums, ent[0], ent[1])
            f.image_sums = sums
        if self._any_prefer_avoid:
            scores = np.full(b.n_pad, 10, dtype=np.int64)
            owner = pod.owner_ref
            if owner is not None and owner[0] in ("ReplicationController", "ReplicaSet"):
                for i, ni in self._nodes():
                    if ni.node is not None and owner[2] in ni.node.prefer_avoid_pod_uids:
                        scores[i] = 0
            f.prefer_avoid = scores

    def _prefer_taint_rows(self) -> dict:
        """{unique PreferNoSchedule taint -> np node rows}, built once per
        snapshot (taints are per-node state, not per-pod)."""
        got = self._taint_rows
        if got is None:
            d: dict = {}
            for i, ni in self._nodes():
                for taint in ni.taints:
                    if taint.effect == PREFER_NO_SCHEDULE:
                        d.setdefault(taint, []).append(i)
            got = self._taint_rows = {
                t: np.asarray(r, dtype=np.int64) for t, r in d.items()}
        return got

    def _image_rows(self) -> dict:
        """{normalized image name -> (node rows, int64 contributions)} with
        the reference's exact per-(node, image) truncation
        (image_locality.go:42: int(size_bytes * num_nodes/total))."""
        got = self._image_locality_rows
        if got is None:
            rows: dict = {}
            for i, ni in self._nodes():
                for name, state in ni.image_states.items():
                    rows.setdefault(name, ([], []))
                    rows[name][0].append(i)
                    rows[name][1].append(
                        int(state.size_bytes
                            * (state.num_nodes / self.total_num_nodes)))
            got = self._image_locality_rows = {
                name: (np.asarray(r, dtype=np.int64),
                       np.asarray(c, dtype=np.int64))
                for name, (r, c) in rows.items()}
        return got

    def _topo_values(self, key: str):
        """Dictionary-encode node label values for one topology key:
        (ids[N] int32, vocab value->id), id -1 where the label is absent.
        Built once per encoder (= per burst/cycle snapshot)."""
        got = self._topo_cache.get(key)
        if got is None:
            b = self.batch
            ids = np.full(b.n_pad, -1, np.int32)
            vocab: dict[str, int] = {}
            for i, ni in self._nodes():
                n = ni.node
                if n is None:
                    continue
                v = n.labels.get(key)
                if v is not None:
                    ids[i] = vocab.setdefault(v, len(vocab))
            got = self._topo_cache[key] = (ids, vocab)
        return got

    def _interpod_pref_counts(self, pod: Pod):
        """Mirror of the oracle's interpod_affinity_priority counting
        (priorities.py; reference interpod_affinity.go:116,215), emitted as
        dense arrays via the SURVEY §2.3 segment-sum formulation: each
        matching (term, existing-pod) event adds its weight to a
        (topologyKey, value) bucket — the existing pod's node fixes the
        value — and the per-node counts are one bucket gather per distinct
        key. The reference instead walks every node per event inside
        processTerm (:215); the old mirror of that walk was the
        O(events x nodes) host bottleneck of the affinity lanes."""
        b = self.batch
        t = self._table()
        a = pod.affinity
        has_aff = a is not None and a.pod_affinity is not None
        has_anti = a is not None and a.pod_anti_affinity is not None
        trk = np.zeros(b.n_pad, dtype=bool)
        if has_aff or has_anti:
            trk[: b.n_real] = True
        else:
            rows = t.holder_row[t.has_affinity]
            trk[rows[rows >= 0]] = True
        acc: dict[str, np.ndarray] = {}

        def node_of(p: Pod):
            ni = self.node_infos.get(p.node_name)
            return ni.node if ni else None

        def bucket_add_mask(term, mask, weight):
            """All of one term's (existing-pod) events at once: each
            matching pod adds `weight` to the (topologyKey, value) bucket
            its node's label value fixes."""
            key = term.topology_key
            if not key or not mask.any():
                return
            ids, vocab = self._topo_values(key)
            rows = t.name_row[mask]
            rows = rows[rows >= 0]          # fixed node unknown
            if not rows.size:
                return
            vids = ids[rows]
            vids = vids[vids >= 0]          # fixed node lacks the label
            if not vids.size:
                return
            buckets = acc.get(key)
            if buckets is None:
                buckets = acc[key] = np.zeros(len(vocab), np.int64)
            buckets += np.bincount(vids, minlength=len(vocab)) * weight

        def process_term(term, defining, to_check, fixed_node, weight):
            key = term.topology_key
            if fixed_node is None or not key:
                return   # nodes_same_topology is False for empty keys
            if not pod_matches_term_props(to_check, defining, term):
                return
            v = fixed_node.labels.get(key)
            if v is None:
                return   # the fixed node lacks the label: no node matches
            ids, vocab = self._topo_values(key)
            vid = vocab.get(v)
            if vid is None:
                return
            buckets = acc.get(key)
            if buckets is None:
                buckets = acc[key] = np.zeros(len(vocab), np.int64)
            buckets[vid] += weight

        # the incoming pod's preferred terms, vectorized over the
        # existing-pod axis (reference interpod_affinity.go:215 processTerm
        # walked every node per matching pod; the old mirror walked every
        # pod in Python): one mask per term. The reference only processes
        # pods held by nodes with objects — holder_has_obj gates that.
        on_node = t.holder_has_obj
        if has_aff:
            for wt in a.pod_affinity.preferred:
                bucket_add_mask(
                    wt.term,
                    on_node & pod_matches_term_props_mask(pod, wt.term, t),
                    wt.weight)
        if has_anti:
            for wt in a.pod_anti_affinity.preferred:
                bucket_add_mask(
                    wt.term,
                    on_node & pod_matches_term_props_mask(pod, wt.term, t),
                    -wt.weight)
        # existing pods' own terms check the single incoming pod (O(terms)
        # each): only affinity-carrying pods can contribute, so walk exactly
        # those rows instead of every pod
        for r in np.nonzero(t.has_affinity & on_node)[0].tolist():
            existing = t.pods[r]
            existing_node = node_of(existing)
            ea = existing.affinity
            if ea.pod_affinity is not None:
                if self.hard_weight > 0:
                    for term in ea.pod_affinity.required:
                        process_term(term, existing, pod, existing_node,
                                     self.hard_weight)
                for wt in ea.pod_affinity.preferred:
                    process_term(wt.term, existing, pod, existing_node,
                                 wt.weight)
            if ea.pod_anti_affinity is not None:
                for wt in ea.pod_anti_affinity.preferred:
                    process_term(wt.term, existing, pod, existing_node,
                                 -wt.weight)

        arr = np.zeros(b.n_pad, dtype=np.int64)
        for key, buckets in acc.items():
            ids, _vocab = self._topo_cache[key]
            mask = ids >= 0
            arr[mask] += buckets[ids[mask]]
        arr[~trk] = 0
        return arr, trk
