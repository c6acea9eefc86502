"""Node-axis sharding of the port: a single-controller mesh over a list of
torch devices, per-shard slices of the node matrix and the pod inputs,
the all-gather, and the sharded programs the scheduler runs: the serial
cycle, the uniform K-batch burst, the generic scan, the fused drain
window, the victim scan of one preemptor and the pressure wave.

Counterpart of `kubernetes_tpu/parallel/sharding.py`. There GSPMD splits
one jitted program over a `jax.sharding.Mesh` and inserts the
collectives; here the split is written out. One process drives every
device (the JAX mesh is single-controller too):

- shard s owns rows [s * n_pad / D, (s + 1) * n_pad / D) of the node
  matrix, on `mesh.devices[s]`; devices may repeat (`["cuda:0"] * 4` runs
  four shards on one card, `["cpu"] * 4` is what the CPU tests use);
- every shard-local kernel runs ONE launch a device over every shard it
  holds: K9a for the cycle and K14a for a victim scan (one call each,
  outside a window: call r writes half r & 1 of its buffers, r from the
  mesh's one round counter, `Mesh.next_round`), K9c for a uniform pass,
  K10a / K11a / K13a for a step of the scan / fused window / pressure
  wave. Each shard's record (K14a reduces its rows' victim scan to one
  candidate record; K13a appends it) is written straight into row s of
  that device's gathered buffer;
- `gather_in_place` copies only the rows whose shard lives on another
  device (`gather_plan`), none on one card, each copy ordered after its
  producer by a CUDA event (`all_gather`, every row to every device, is
  the reference the tests hold the in-place records against);
- K9a, K10a / K11a / K13a and K14a exchange their records on the device
  (`Mesh.exchange` "peer"): each also writes its shards' records into
  every other card's buffer over NVLink, in half i & 1 of a two-half
  buffer at step (or call) i, then publishes a stamp the selects wait
  for (`mesh_stamps`), so a step is one bound launch a card for the
  local and one for the select, no event and no copy; a host whose cards
  lack peer access takes "copy", the host's `gather_in_place` between
  them;
- a replicated select (K9b, K9d, K10b, K11b, K13b, K14b) runs on every
  distinct device over the gathered records, so every device reaches the
  same decision. The scans keep their step state (step index, li / lni,
  the fold the shards owe, the gang checkpoint) on each device, so the
  host enqueues every step with the same arguments and reads nothing
  until the window's one fetch.

A field whose node axis does not split (an inert `[1]` pod field, a
scalar) is replicated, as JAX's `_put_by_keys` does. Decisions, packed
blocks and folded rows equal the single-device kernels bit for bit
(tests/test_torch_sharding.py; chip_smoke.py on the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import kernels as K

# node-matrix fields split along the node axis (axis 0)
_SHARDED_1D = (
    "valid", "alloc_cpu", "alloc_mem", "alloc_eph", "allowed_pods",
    "req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem", "pod_count",
    "zone_id",
)
_SHARDED_2D = ("alloc_scalar", "req_scalar")
# per-pod [N] fields split the same way (the JAX list plus the volume
# masks: the shard-local filter reads every per-node field of its rows)
_POD_SHARDED = (
    "sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
    "interpod_code", "node_aff_counts", "taint_counts", "spread_counts",
    "interpod_counts", "interpod_tracked", "image_sums", "prefer_avoid",
    "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok",
)
#: uniform passes enqueued between two host reads of the pass counter
PASS_GROUP = 4


def exchange_kind(devices, can_access=None) -> str:
    """How a mesh step's records cross between the distinct devices of
    `devices`: "peer" (each local step writes its records into every
    device's buffer and publishes stamps the selects wait for) when every
    ordered pair of distinct cards has peer access (`can_access(a, b)`,
    default `torch.cuda.can_device_access_peer`), or when there is one
    distinct device; else "copy" (the host copies the other devices'
    records in after each local step). More distinct devices than a local
    step's peer table holds (`K.MAX_PEERS` + 1) take "copy" too."""
    devs = list(dict.fromkeys(torch.device(d) for d in devices))
    if len(devs) == 1:
        return "peer"
    if len(devs) > K.MAX_PEERS + 1:
        return "copy"
    if can_access is None:
        def can_access(a, b):
            return torch.cuda.can_device_access_peer(a.index, b.index)
    ok = all(can_access(a, b) for a in devs for b in devs if a != b)
    return "peer" if ok else "copy"


def exchange_plan(devices) -> list:
    """Where each shard's local step writes its record, shard s's on
    `devices[s]`: (s, [its own device, then every other distinct device
    in first-shard order]), the peers the order of the `peer_rec<k>` /
    `peer_stamps<k>` slots of its launch. No CUDA needed: the devices are
    labels."""
    devs = [torch.device(d) for d in devices]
    distinct = list(dict.fromkeys(devs))
    return [(s, [d] + [x for x in distinct if x != d])
            for s, d in enumerate(devs)]


class Mesh:
    """An ordered list of torch devices the node axis is split over.
    `exchange` ("peer" or "copy", `exchange_kind`) is decided here, once,
    from what the host's cards can do, before any launch; `exchange=`
    names it instead (a host whose cards have peer access may still take
    "copy"). The mesh's stamps (`mesh_stamps`) count up over its life:
    each window reserves its own run of values."""

    def __init__(self, devices, exchange=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices are of one type: {devs}")
        self.devices = tuple(devs)
        if exchange is None:
            exchange = exchange_kind(devs)
        if exchange not in ("peer", "copy"):
            raise ValueError(f"exchange {exchange!r} is not peer or copy")
        if exchange == "peer" and exchange_kind(devs, lambda a, b: True) \
                != "peer":
            raise ValueError(f"{len(self.distinct)} devices exceed a local "
                             f"step's peer table")
        self.exchange = exchange
        self._stamps = None
        self._stamp_next = 0
        # the sharded victim scan's buffers by slot count, the sharded
        # cycle's by n_pad, and the round both take their halves from
        self._preempt: dict = {}
        self._cycle: dict = {}
        self._round = 0
        # the static weight rows on every distinct device, by weights
        self._wrows: dict = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in first-shard order: where the
        replicated buffers and selects live."""
        return tuple(dict.fromkeys(self.devices))

    def rows(self, n_pad: int) -> int:
        """Rows per shard. The node axis must split evenly into shards of
        at least two rows (n_pad is a power of two >= 8, so any mesh of
        1, 2 or 4 devices does)."""
        n_pad = int(n_pad)
        if n_pad % self.size or n_pad // self.size < 2:
            raise ValueError(f"n_pad {n_pad} does not split into "
                             f"{self.size} shards of >= 2 rows")
        return n_pad // self.size

    def reserve_stamps(self, n: int) -> int:
        """The base of the next `n` stamp values (a window's steps and its
        last fold): every later window's stamps lie above them."""
        base = self._stamp_next
        self._stamp_next += int(n)
        return base

    def next_round(self) -> int:
        """The round of the next call outside a window (a sharded cycle,
        K9a / K9b, or a sharded victim scan, K14a / K14b): one counter
        for both, so consecutive calls of either kind on the mesh write
        and read alternate halves of their buffers."""
        r = self._round
        self._round += 1
        return r

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.exchange})"


def mesh_stamps(mesh: Mesh) -> dict:
    """{device: [2, D] int64 stamps} of a "peer" mesh, made at its first
    window: zeroed on every distinct device, peer access enabled for
    every ordered pair of its cards (`mesh_enable_peers`, built with
    K10a's library), then every device synchronized, so no card's first
    local step can write into a buffer another card has yet to zero. A
    failed enable raises."""
    if mesh._stamps is None:
        stamps = {d: torch.zeros((2, mesh.size), dtype=K.I64, device=d)
                  for d in mesh.distinct}
        cards = [d.index for d in mesh.distinct if d.type == "cuda"]
        if len(cards) > 1:
            K.enable_peers(cards)
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        mesh._stamps = stamps
    return mesh._stamps


def _order_window_start(mesh: Mesh) -> None:
    """On several cards, one event a card orders a window's start: every
    card's stream waits until every other card has enqueued what came
    before (its last window's selects, which still read records, and this
    window's buffers, zeroed on its own stream) before any of this
    window's local steps writes into it."""
    cards = [d for d in mesh.distinct if d.type == "cuda"]
    if len(cards) < 2:
        return
    events = {}
    for d in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events[d] = ev
    for d in cards:
        stream = torch.cuda.current_stream(d)
        for src, ev in events.items():
            if src != d:
                stream.wait_event(ev)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over `devices`, else over every visible CUDA device; the
    first `n_devices` of them when given."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device for a mesh; pass devices=")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def _to(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device, copy=True).contiguous()


def shard_node_arrays(mesh: Mesh, nodes: dict) -> list:
    """One dict per shard of the node matrix (numpy or tensors): each
    sharded field's rows of that shard on its device; a field whose node
    axis does not split replicates."""
    n_pad = int(np.shape(nodes["valid"])[0])
    rows = mesh.rows(n_pad)
    out = []
    for s, dev in enumerate(mesh.devices):
        lo = s * rows
        shard = {}
        for k, v in nodes.items():
            split = k in _SHARDED_1D + _SHARDED_2D \
                and np.ndim(v) >= 1 and np.shape(v)[0] == n_pad
            shard[k] = _to(v[lo: lo + rows] if split else v, dev)
        out.append(shard)
    return out


def _split_pod(mesh: Mesh, pod: dict, axis: int) -> list:
    out = [dict() for _ in mesh.devices]
    for k, v in pod.items():
        need = axis + 1 if axis >= 0 else -axis
        width = np.shape(v)[axis] if np.ndim(v) >= need else 1
        split = k in _POD_SHARDED and np.ndim(v) >= 1 and width > 1 \
            and width % mesh.size == 0
        rows = width // mesh.size if split else 0
        for s, dev in enumerate(mesh.devices):
            if split:
                sl = [slice(None)] * np.ndim(v)
                sl[axis] = slice(s * rows, (s + 1) * rows)
                out[s][k] = _to(v[tuple(sl)], dev)
            elif isinstance(v, torch.Tensor):
                out[s][k] = v.to(dev)
            else:
                out[s][k] = v
    return out


def shard_pod_arrays(mesh: Mesh, pod: dict) -> list:
    """One dict per shard of a pod's inputs: a per-node field splits
    along its node axis; inert [1] fields and scalars replicate (host
    values stay on the host)."""
    return _split_pod(mesh, pod, -1)


def shard_pod_batch(mesh: Mesh, pods: dict) -> list:
    """A stacked [B, ...] pod batch per shard: per-node [B, N] fields
    split along axis 1, per-pod values replicate."""
    return _split_pod(mesh, pods, 1)


def _as_shards(mesh: Mesh, nodes) -> list:
    if isinstance(nodes, dict):
        return shard_node_arrays(mesh, nodes)
    shards = list(nodes)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    for sh, dev in zip(shards, mesh.devices):
        K._require_on("shard", dev, *sh.values())
    return shards


def gather_plan(devices, in_place: bool = False) -> list:
    """The copies of one all-gather of shard records, shard s's on
    `devices[s]`: (s, destination device) for every shard and every
    distinct device (in first-shard order), except, `in_place`, each
    shard's own device, where its local step wrote the record straight
    into row s. No CUDA needed: the devices are labels."""
    devs = [torch.device(d) for d in devices]
    return [(s, d) for d in dict.fromkeys(devs)
            for s, src in enumerate(devs) if not (in_place and src == d)]


def _copy_records(mesh: Mesh, parts: list, bufs: dict, copies) -> int:
    """Enqueue `copies` ((s, destination device) pairs) of shard s's 1-D
    uint8 record `parts[s]` into row s of `bufs[destination]`. On CUDA a
    copy to another card waits on an event recorded after the record's
    producer on its device's current stream (no device-wide sync); a copy
    on the record's own card follows its producer on the same stream.
    Returns the copies enqueued."""
    events = []
    for p in parts:
        ev = None
        if p.is_cuda and len(mesh.distinct) > 1:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
        events.append(ev)
    n = 0
    for s, d in copies:
        p = parts[s]
        with K._on(d):
            if events[s] is not None and p.device != d:
                torch.cuda.current_stream(d).wait_event(events[s])
            bufs[d][s].copy_(p, non_blocking=True)
        n += 1
    return n


def all_gather(mesh: Mesh, parts: list, out: dict | None = None):
    """Copy shard s's 1-D uint8 record `parts[s]` (on `mesh.devices[s]`)
    into row s of a [D, bytes] buffer on every distinct device, each copy
    ordered after its producer (`_copy_records`). `out` reuses buffers by
    device. Returns ({device: buffer}, bytes copied)."""
    width = int(parts[0].numel())
    bufs = {d: out[d] if out is not None else torch.empty(
        (mesh.size, width), dtype=torch.uint8, device=d)
        for d in mesh.distinct}
    n = _copy_records(mesh, parts, bufs, gather_plan(mesh.devices))
    return bufs, n * width


def gather_in_place(mesh: Mesh, parts: list, bufs: dict) -> int:
    """The all-gather after K10a / K11a, whose `parts[s]` already is row s
    of its own device's buffer in `bufs`: only the other devices' copies
    are made (`gather_plan(in_place=True)`, none on one card). After them
    each destination records an event that the sources' streams wait on,
    so a source's next local step rewrites row s only after every peer
    copy of it. Returns the copies enqueued."""
    copies = gather_plan(mesh.devices, in_place=True)
    n = _copy_records(mesh, parts, bufs, copies)
    if n and parts[0].is_cuda:
        for d in dict.fromkeys(d for _s, d in copies):
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(d))
            for src in dict.fromkeys(mesh.devices[s] for s, dd in copies
                                     if dd == d):
                torch.cuda.current_stream(src).wait_event(done)
    return n


def _replicas(mesh: Mesh, v, dtype=None) -> dict:
    """`v` (host array or tensor, or None) on every distinct device."""
    if v is None:
        return {d: None for d in mesh.distinct}
    return {d: K._t(v, d, dtype).contiguous() for d in mesh.distinct}


def _weight_rows(mesh: Mesh, weights, wtab, pid) -> dict:
    """The [K] weight row on every distinct device: the `wtab` row of
    profile `pid` (made once per call), else the static weights in axis
    order, uploaded once a mesh and weights (the kernels only read it;
    the kernels and plain versions read either alike)."""
    if wtab is None:
        key = tuple(int(weights.get(n, 0)) for n in K.PRIORITY_AXIS)
        rows = mesh._wrows.get(key)
        if rows is None:
            rows = mesh._wrows[key] = {d: K._weight_row(weights, None, d)
                                       for d in mesh.distinct}
        return rows
    wtabs = _replicas(mesh, wtab, K.I64)
    return {d: K._weight_row(weights, K._row_at(wtabs[d], pid), d)
            for d in mesh.distinct}


def cycle_sides(mesh: Mesh, n_pad: int) -> dict:
    """{device: K.CycleSide} of the mesh's sharded cycle at `n_pad` slots,
    made at its first cycle: on every distinct device the records' two
    halves [2, D, K.full_record_bytes(rows)] (every plane's room, so the
    buffer never regrows and its peers' pointers never change), zeroed,
    one ticket a shard, and under "peer" the mesh's stamps (`mesh_stamps`,
    with peer access enabled) and the other devices' (halves, stamps) by
    `exchange_plan`. The cards are synchronized once after the zeroing,
    so no card's first K9a can write into a buffer another card has yet
    to zero."""
    sides = mesh._cycle.get(int(n_pad))
    if sides is None:
        stride = K.full_record_bytes(mesh.rows(n_pad))
        halves = {d: torch.zeros((2, mesh.size, stride), dtype=torch.uint8,
                                 device=d) for d in mesh.distinct}
        stamps = mesh_stamps(mesh) if mesh.exchange == "peer" \
            else {d: None for d in mesh.distinct}
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        peers = {mesh.devices[s]: dests[1:]
                 for s, dests in exchange_plan(mesh.devices)}
        sides = mesh._cycle[int(n_pad)] = {
            d: K.CycleSide(halves[d], stamps[d], tuple(
                (halves[x], stamps[x]) for x in peers[d])
                if mesh.exchange == "peer" else (),
                torch.zeros(mesh.size, dtype=K.I64, device=d))
            for d in mesh.distinct}
    return sides


def sharded_cycle(mesh: Mesh, nodes, pod: dict, last_index, last_node_index,
                  num_to_find, n_real, z_pad, weights=None, wtab=None,
                  perm=None, inv_perm=None, pos=None, ghost=None) -> dict:
    """`sharded_cycle_fn` (sharding.py:115): one scheduling cycle with the
    node axis split over the mesh. K9a, ONE launch a distinct device over
    every shard it holds (filter, row-local scores, each shard's record
    written in place into row s of the cycle's half of the device's
    buffer and, under "peer", of every other card's, then its stamp);
    under "copy" the host copies other devices' rows in
    (`gather_in_place`); then K9b on every distinct device (walk,
    kept-set normalizations, select) from the records in place, after
    their stamps. The pod's per-node fields and `ghost` ({cpu, mem, eph,
    cnt} whole [n_pad] vectors, or None: the nominated load each shard's
    filter adds to its rows) go to each device once, whole. The cycle takes the mesh's next round
    (`Mesh.next_round`, shared with the sharded victim scan) and, under
    "peer", one stamp value. Returns the JAX output dict; its per-node
    tensors are whole [n_pad] vectors on the first device (on one card,
    the ones K9a wrote). Books `gather.cycle` (bytes in every device's
    buffer) and `copies.cycle` (record copies enqueued: none under
    "peer")."""
    weights = weights or K.DEFAULT_WEIGHTS
    shards = _as_shards(mesh, nodes)
    n_pad = sum(int(sh["valid"].shape[0]) for sh in shards)
    rows = mesh.rows(n_pad)
    sides = cycle_sides(mesh, n_pad)
    wrow = _weight_rows(mesh, weights, wtab, pod.get("profile_id", 0))
    stamp = K.stamp_value(mesh.reserve_stamps(1), 0) \
        if mesh.exchange == "peer" else 0
    call = K.CycleCall(pod=pod, planes=K.cycle_record_planes(pod, weights),
                       weights=weights, wrows=wrow,
                       ghost=ghost, n_pad=n_pad,
                       rows=rows, D=mesh.size, n_real=int(n_real),
                       round=mesh.next_round(), stamp=stamp)
    groups = device_groups(mesh, [K.CycleShard(s, s * rows, sh)
                                  for s, sh in enumerate(shards)])
    outs = {d: K.shard_cycle_local(group, sides[d], call)
            for d, group in groups}
    copies = 0
    if mesh.exchange == "copy":
        copies = gather_in_place(
            mesh, [sides[dev].records(call)[s]
                   for s, dev in enumerate(mesh.devices)],
            {d: sides[d].records(call) for d in mesh.distinct})
    obs.inc("gather.cycle", len(mesh.distinct) * mesh.size
            * call.record_bytes)
    obs.inc("copies.cycle", copies)
    perms, invs, poss = (_replicas(mesh, perm, K.I32),
                         _replicas(mesh, inv_perm, K.I32),
                         _replicas(mesh, pos, K.I32))
    sel = {d: K.shard_cycle_select(
        sides[d].records(call), call.planes, rows, n_real, pod, last_index,
        last_node_index, num_to_find, weights, z_pad, wrow=wrow[d],
        perm=perms[d], inv_perm=invs[d], pos=poss[d],
        stamps=sides[d].stamps, round=call.round, stamp=call.stamp)
        for d in mesh.distinct}
    d0 = mesh.devices[0]
    out, total, kept = sel[d0]
    per_row = list(outs[d0])
    for s, dev in enumerate(mesh.devices):
        if dev != d0:
            # another card's shard: its rows into the first device's
            for mine, theirs in zip(per_row, outs[dev]):
                mine[s * rows: (s + 1) * rows].copy_(
                    theirs[s * rows: (s + 1) * rows])
    return {"selected": out[0], "found": out[1], "evaluated": out[2],
            "max_score": out[3], "total": total, "kept": kept,
            "feasible": per_row[0], "fail_first": per_row[1],
            "general_bits": per_row[2], "next_last_index": out[4],
            "next_last_node_index": out[5]}


def _pad_cols(rows_list: list, width: int) -> torch.Tensor | None:
    """[len, width] int64 stack of [rows] vectors, zero-padded."""
    if not rows_list:
        return None
    st = torch.stack([r.to(K.I64) for r in rows_list])
    if st.shape[1] < width:
        st = torch.cat([st, torch.zeros((st.shape[0], width - st.shape[1]),
                                        dtype=K.I64, device=st.device)], 1)
    return st.contiguous()


def sharded_uniform(mesh: Mesh, nodes, cls, n_pods, last_node_index, n_real,
                    check_resources, weights=None, rotation=None,
                    extra_ok=None, ban=False, cap=None, wtab=None, pid=0):
    """`sharded_uniform_fn` (sharding.py:151): the uniform K-batch burst
    with its node-axis state split over the mesh. Each pass runs K9c,
    ONE launch a device over its shards (fold the previous pass's
    accepted lanes each owns, sweep its rows, each record written in
    place into row s of the device's gathered buffer), the all-gather of
    the records of shards on other devices (`gather_in_place`: none on
    one card), and K9d on every distinct device (the tie walk and the
    lanes, one thread-block cluster). The first pass binds each device's
    K9c and K9d launches (`Relaunch`), the later passes re-enqueue them.
    The pass loop runs on the host,
    PASS_GROUP passes between reads of the pass counter; passes past the
    end are no-ops on the device. Returns (one dict of folded rows per
    shard, packed[cap+1] int32 and the lni tensor, both on the first
    device). Books `gather.burst_uniform` (bytes in every device's
    buffer), `copies.burst_uniform` (record copies enqueued),
    `passes.burst_uniform` and `syncs.burst_uniform`."""
    weights = weights or K.DEFAULT_WEIGHTS
    shards = _as_shards(mesh, nodes)
    D = mesh.size
    n_pad = sum(int(sh["valid"].shape[0]) for sh in shards)
    rows = mesh.rows(n_pad)
    cap = K.B_CAP if cap is None else int(cap)
    if n_pods > cap:
        raise ValueError(f"uniform burst of {n_pods} exceeds cap={cap}")
    flags = K._uniform_flags(cls, check_resources)
    check_res, has_req = flags[:2]
    clsv = _replicas(mesh, np.asarray(K._uniform_cls_vec(cls, flags),
                                      np.int64))
    wrow = _weight_rows(mesh, weights, wtab, pid)
    perm = oid = {d: None for d in mesh.distinct}
    if rotation is not None:
        perm = _replicas(mesh, rotation[0], K.I32)
        oid = _replicas(mesh, rotation[1], K.I32)
    lni0 = last_node_index if isinstance(last_node_index, torch.Tensor) \
        else torch.tensor(int(np.asarray(last_node_index)), dtype=K.I64)
    state, out, lni_out, owner = {}, {}, {}, {}
    for d in mesh.distinct:
        st = torch.zeros(K.ST_LANES + K.K_BATCH, dtype=K.I64, device=d)
        st[K.ST_LNI] = lni0.to(d).reshape(())
        st[K.ST_LNI0] = st[K.ST_LNI]
        state[d] = st
        out[d] = torch.full((cap + K.K_BATCH,), -1, dtype=K.I32, device=d)
        out[d][cap] = 0
        lni_out[d] = st[K.ST_LNI: K.ST_LNI + 1].clone()
        owner[d] = torch.full((n_pad + 1,), K.K_BATCH, dtype=K.I32,
                              device=d)
    # each shard's record is row s of its device's gathered buffer: K9c
    # writes it in place, the all-gather copies only other devices' rows
    gbuf = {d: torch.zeros((D, K.UniformShard.record_bytes(rows)),
                           dtype=torch.uint8, device=d)
            for d in mesh.distinct}
    ushards = []
    for s, (nd, dev) in enumerate(zip(shards, mesh.devices)):
        lo = s * rows
        width = rows + (1 if s == D - 1 else 0)
        carried, xalloc, salloc, sused = K._uniform_rows(nd, flags)
        R, NS = len(carried), len(salloc)
        extra = None if extra_ok is None \
            else K._t(extra_ok, dev, torch.bool)[lo: lo + rows].contiguous()
        ushards.append(K.UniformShard(
            lo, rows, width, nd, _pad_cols(carried, width),
            _pad_cols(xalloc, width), _pad_cols(salloc, width),
            _pad_cols(sused, width), extra, rec=gbuf[dev][s]))
    hoff = ushards[0].hoff
    recs = [sh.rec for sh in ushards]
    groups = device_groups(mesh, ushards)
    sweeps = []     # each device's bound K9c launch (None on the CPU)

    def sweep():
        if not sweeps:
            sweeps.extend(K.shard_uniform_sweep(
                group, state[d], clsv[d], R, NS, check_res, has_req, ban,
                weights, wrow[d], n_real, n_pods) for d, group in groups)
            return
        for rel, (d, group) in zip(sweeps, groups):
            if rel is None:
                K.shard_uniform_sweep(group, state[d], clsv[d], R, NS,
                                      check_res, has_req, ban, weights,
                                      wrow[d], n_real, n_pods)
            else:
                K._check(rel.fn(), rel.name)

    selects = {}    # each device's bound K9d launch (None on the CPU)

    def select():
        for d in mesh.distinct:
            rel = selects.get(d)
            if rel is None:
                selects[d] = K.shard_uniform_select(
                    gbuf[d], rows, hoff, state[d], out[d], lni_out[d],
                    owner[d], n_pods, cap, ban, perm=perm[d], oid_seq=oid[d])
            else:
                K._check(rel.fn(), rel.name)

    nbytes = syncs = copies = 0
    while n_pods > 0:
        for _ in range(PASS_GROUP):
            sweep()
            copies += gather_in_place(mesh, recs, gbuf)
            nbytes += len(mesh.distinct) * D * recs[0].numel()
            select()
        syncs += 1
        if int(state[mesh.devices[0]][K.ST_DONE]) >= n_pods:
            break
    sweep()     # fold the last pass's lanes
    for rel in sweeps + list(selects.values()):
        if rel is not None:
            rel.book()      # the launches the bound sweeps and selects made
    d0 = mesh.devices[0]
    obs.inc("gather.burst_uniform", nbytes)
    obs.inc("copies.burst_uniform", copies)
    obs.inc("passes.burst_uniform", int(state[d0][K.ST_PASS]))
    obs.inc("syncs.burst_uniform", syncs)
    return ([K._uniform_out_rows(sh.st[:, :rows], nd, flags)
             for sh, nd in zip(ushards, shards)],
            out[d0][: cap + 1], lni_out[d0][0])


def shard_pod_stack(mesh: Mesh, stack: K.PodStack):
    """A window's `K.PodStack` per shard, the counterpart of
    `shard_pod_batch` for the per-spec tables: each `[U, n_pad]` per-node
    field becomes the shard's `[U, rows]` slice on its device, `[U, 1]`
    inert fields and per-spec scalars replicate. Inertness stays the
    window's (a field dense for one spec is dense for all, as
    `PodStack.from_specs` decided). Returns (one table dict per shard,
    {device: row[B] int32}, {device: profile_id[B] int64, or None}), the
    pod rows and profile ids uploaded once per distinct device."""
    tables = shard_pod_batch(mesh, stack.table)
    row = {d: K._upload(stack.row.astype(np.int32), d)
           for d in mesh.distinct}
    prof = {d: None for d in mesh.distinct}
    if stack.profile_id is not None:
        prof = {d: K._upload(stack.profile_id.astype(np.int64), d)
                for d in mesh.distinct}
    return tables, row, prof


def _per_shard(mesh: Mesh, v, rows: int) -> list:
    """A [n_pad] vector as one fresh [rows] slice per shard: `v` whole
    (host array or tensor) or already one piece per shard."""
    if isinstance(v, (list, tuple)):
        return [_to(p, dev).to(K.I64) for p, dev in zip(v, mesh.devices)]
    return [_to(v[s * rows: (s + 1) * rows], dev).to(K.I64)
            for s, dev in enumerate(mesh.devices)]


def _scan_window(mesh: Mesh, nodes, pods, last_index, last_node_index,
                 num_to_find, n_real, z_pad, weights, rotation, rotation_pos,
                 spread0, carry_in, wtab, n_steps=None, segments=None,
                 gang_score=False, pressure=None):
    """The shards, the per-device replicated halves and the plan of one
    sharded scan (`segments` None) or segments window (`segments` =
    (seg_start, gang), `n_steps` = n_pods) or pressure wave (`pressure` =
    {"ghost": per-shard ghost slices, "vic": per-shard victim planes, "P":
    victim slots, "out": the packed [B, 5+P] block on the first device}):
    every tensor a step reads, uploaded once. last_index / last_node_index
    may be device scalars (a previous wave chunk's), copied into the step
    state on the device. Returns (ScanShard list, {device: ScanSide},
    ScanPlan, the number of steps the host enqueues)."""
    shards = _as_shards(mesh, nodes)
    D = mesh.size
    n_pad = sum(int(sh["valid"].shape[0]) for sh in shards)
    rows = mesh.rows(n_pad)
    S = int(shards[0]["alloc_scalar"].shape[1])
    d0 = mesh.devices[0]
    stack = pods if isinstance(pods, K.PodStack) \
        else K.PodStack.from_dense(pods, d0)
    B = len(stack)
    n_real, z_pad = int(n_real), int(z_pad)
    mode, L, n_oid = 0, 0, 0
    perms = invs = oid = {d: None for d in mesh.distinct}
    if rotation_pos is not None:
        if rotation is not None:
            raise ValueError("rotation and rotation_pos are exclusive")
        mode, (p, seq) = 2, rotation_pos
        perms, oid = _replicas(mesh, p, K.I32), _replicas(mesh, seq, K.I32)
    elif rotation is not None:
        mode, (p, inv, seq) = 1, rotation
        perms, invs = _replicas(mesh, p, K.I32), _replicas(mesh, inv, K.I32)
        oid = _replicas(mesh, seq, K.I32)
    if mode:
        L, n_oid = int(np.shape(p)[0]), int(np.shape(seq)[0])
    carry_spread = spread0 is not None or (
        carry_in is not None and carry_in[1] is not None)
    if carry_in is not None:
        mut0, s0 = carry_in
    else:
        mut0, s0 = shards, spread0
    spreads = _per_shard(mesh, s0, rows) if carry_spread else [None] * D
    table = stack.table
    # the window's record planes, from the whole table: the carried
    # spread vector is dense, whatever the table's inert field says
    planes = K.cycle_record_planes(
        dict(table, spread_counts=np.zeros(n_pad, np.int64))
        if carry_spread else table, weights)
    if gang_score and "zone" not in planes:
        planes += ("zone",)     # a placed member's zone feeds gz
    if wtab is not None and stack.profile_id is None:
        stack = K.PodStack(table, stack.row, np.zeros(B, np.int64),
                           skip=stack.skip_flags())
    plan = K.ScanPlan(
        n_pad=n_pad, rows=rows, D=D, S=S, U=int(table["skip"].shape[0]),
        B=B, n_steps=B if n_steps is None else int(n_steps),
        num_to_find=int(num_to_find), n_real=n_real, z_pad=z_pad,
        mode=mode, L=L, n_oid=n_oid,
        P=0 if wtab is None else int(np.shape(wtab)[0]),
        carry_spread=carry_spread, gang_score=bool(gang_score),
        ipa_on=bool(weights["interpod"]) and K.cycle_ipa_on(table),
        planes=planes, weights=weights, pressure=pressure is not None,
        vic_P=0 if pressure is None else int(pressure["P"]))
    nbytes = plan.record_bytes
    tables, row, prof = shard_pod_stack(mesh, stack)
    # the step the first local launch computes: the first live pod of a
    # scan (the select decides the skip pods before it), step 0 of a
    # segments window or a pressure wave (every pod a step)
    every_pod = segments is not None or pressure is not None
    live = ~stack.skip_flags()[stack.row]
    first = 0
    if not every_pod:
        first = int(np.argmax(live)) if live.any() else B
    st0 = np.zeros(K.SS_WORDS, np.int64)
    on_dev = {}
    for slots, v in (((K.SS_LI, K.SS_CHK_LI), last_index),
                     ((K.SS_LNI, K.SS_LNI0, K.SS_CHK_LNI), last_node_index)):
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            on_dev[slots] = v.to(K.I64).reshape(1)
        else:
            st0[list(slots)] = int(np.asarray(K._host(v)))
    st0[[K.SS_FOLD_SEL, K.SS_GHOST_SEL]] = -1
    st0[K.SS_NEXT] = first
    wtabs = _replicas(mesh, wtab, K.I64)
    seg = gng = {d: None for d in mesh.distinct}
    if segments is not None:
        seg = _replicas(mesh, segments[0], torch.bool)
        gng = _replicas(mesh, segments[1], torch.bool)
        if any(int(v.shape[0]) != B for v in seg.values()):
            raise ValueError("seg_start/gang are not [B]")
    # the records' two halves on every distinct device, and, exchanging
    # on the device, the mesh's stamps and each device's peers
    halves = {d: torch.zeros((2, D, nbytes), dtype=torch.uint8, device=d)
              for d in mesh.distinct}
    stamps = mesh_stamps(mesh) if mesh.exchange == "peer" \
        else {d: None for d in mesh.distinct}
    peers = {mesh.devices[s]: dests[1:] if mesh.exchange == "peer" else []
             for s, dests in exchange_plan(mesh.devices)}
    sides = {}
    for d in mesh.distinct:
        tab = tables[mesh.devices.index(d)]
        stats = None
        if pressure is not None:
            packed = pressure["out"] if d == mesh.devices[0] else \
                torch.empty_like(pressure["out"], device=d)
        elif segments is None:
            packed = torch.empty(3 * B, dtype=K.I32, device=d)
            stats = torch.empty((5, B), dtype=K.I64, device=d)
        else:
            packed = torch.full((4 * B,), -1, dtype=K.I32, device=d)
        st = K._upload(st0, d)
        with K._on(d):
            for slots, v in on_dev.items():
                for slot in slots:
                    st[slot: slot + 1].copy_(v.to(d))
        sides[d] = K.ScanSide(
            st=st, row=row[d], prof=prof[d] if wtab
            is not None else None, wtab=wtabs[d],
            w=K._weight_row(weights, None, d), scal=K.scan_scalars(tab),
            ic_b=tab["interpod_counts"].to(K.I64)[:, :1].contiguous(),
            tr_b=tab["interpod_tracked"].to(torch.bool)[:, :1].contiguous(),
            perms=perms[d], inv_perms=invs[d], oid=oid[d], seg_start=seg[d],
            gang=gng[d], gz=torch.zeros(z_pad, dtype=K.I64, device=d)
            if gang_score else None,
            halves=halves[d], packed=packed, stats=stats, stamps=stamps[d],
            peers=tuple((halves[x], stamps[x]) for x in peers[d]))
    scan = []
    for s, (nd, dev) in enumerate(zip(shards, mesh.devices)):
        mine = {k: v for k, v in nd.items() if k not in K._MUTABLE}
        mine.update({k: mut0[s][k].to(dev, K.I64).clone().contiguous()
                     for k in K._MUTABLE})
        chk = None
        if segments is not None:
            chk = {k: mine[k].clone() for k in K._MUTABLE}
            if carry_spread:
                chk["spread"] = spreads[s].clone()
        ghost = vic = None
        if pressure is not None:
            ghost = {k: v.to(dev, K.I64).clone().contiguous()
                     for k, v in pressure["ghost"][s].items()}
            vic = pressure["vic"][s]
        # the local step writes the record in place
        scan.append(K.ScanShard(s, s * rows, mine, spreads[s], tables[s],
                                chk, sides[dev].gathered[s], ghost=ghost,
                                vic=vic))
    if every_pod:
        steps = plan.n_steps
    else:
        steps = max(int(np.count_nonzero(live)), 1) if B else 0
    plan.stamp_base = mesh.reserve_stamps(steps + 1)
    _order_window_start(mesh)
    return scan, sides, plan, steps


def device_groups(mesh: Mesh, scan: list) -> list:
    """[(device, [its shards])] over the distinct devices in first-shard
    order: what one grouped local launch covers."""
    return [(d, [sh for sh, dev in zip(scan, mesh.devices) if dev == d])
            for d in mesh.distinct]


def _run_steps(mesh: Mesh, scan: list, sides: dict, plan, steps: int,
               local, select) -> tuple:
    """Enqueue `steps` steps, then the local kernel once more for the last
    step's fold. No host read. A step is the local kernel on every
    distinct device (K10a, K11a, K13a: `local` takes every shard of one
    device, `device_groups`, formed once here), then the select on every
    distinct device. Step i's records go into half i & 1 of the buffers.
    Under `mesh.exchange` "peer" the locals write every record into every
    device's buffer themselves and publish stamps that the selects wait
    for on the device: a step is 2 host calls a card, no event, no copy.
    On every card step i's locals are enqueued before any select of step
    i, so no select can wait on a local stuck behind it. Under "copy" the
    host copies other devices' records in (`gather_in_place`) between the
    two. On a card the first call of each device's local and select
    returns its bound `Relaunch`, and the later steps enqueue those with
    nothing else; their C launch functions count every launch, booked
    after the window. Returns (bytes in every device's buffer, copies
    enqueued)."""
    nbytes = steps * len(mesh.distinct) * mesh.size * plan.record_bytes
    n_copies = 0
    groups = [(sides[d], shards) for d, shards in device_groups(mesh, scan)]
    foreign = mesh.exchange == "copy" \
        and bool(gather_plan(mesh.devices, in_place=True))
    # each half's own rows and buffers, for the host's copies
    recs = [[sides[dev].halves[h][s] for s, dev in enumerate(mesh.devices)]
            for h in (0, 1)]
    bufs = [{d: sides[d].halves[h] for d in mesh.distinct} for h in (0, 1)]

    def bound(handles, calls):
        # (enqueue, kernel name) of each first call's bound launch; on the
        # CPU, the call again
        return [(c, "") if h is None else (h.fn, h.name)
                for h, c in zip(handles, calls)]

    def again(fns):
        for fn, name in fns:
            rc = fn()
            if rc:
                K._check(rc, name)
    firsts = [local(shards, side, plan) for side, shards in groups]
    locals_ = bound(firsts, [functools.partial(local, shards, side, plan)
                             for side, shards in groups])
    selects, sel_firsts = None, []
    for i in range(steps):
        if i:
            again(locals_)
        if foreign:
            n_copies += gather_in_place(mesh, recs[i & 1], bufs[i & 1])
        if selects is None:
            sel_firsts = [select(sides[d], plan) for d in mesh.distinct]
            selects = bound(sel_firsts, [functools.partial(
                select, sides[d], plan) for d in mesh.distinct])
        else:
            again(selects)
    if steps:
        again(locals_)      # the last step's fold
    for rel in firsts + sel_firsts:
        if rel is not None:
            rel.book()      # the launches `again` made
    return nbytes, n_copies


def sharded_scan(mesh: Mesh, nodes, pods, last_index, last_node_index,
                 num_to_find, n_real, z_pad, weights=None, rotation=None,
                 spread0=None, rotation_pos=None, carry_in=None, wtab=None):
    """`sharded_scan_fn` (sharding.py:233): the generic scan (K5) with the
    node axis split over the mesh. Per live pod: K10a, one launch a
    device over its shards (fold the previous winner a shard owns, filter
    and row-local scores of the pod, each record in place), the
    all-gather of other devices' records, K10b on every distinct device
    (walk, kept-set
    scores, pick; the skip pods around it); then K10a once more for the
    last fold. The signature and returns of `K.schedule_batch`: `pods` a
    `PodStack` or the [B, ...] dict; `carry_in` = (per-shard rows, spread
    slices) of a previous window. Returns (one dict of folded rows per
    shard, li, lni, per-shard spread slices (a zero scalar when not
    carried), outs) with outs["packed"] the [3B] int32 block, all on the
    first device; the host reads nothing until it fetches that block.
    Books `gather.burst_scan` (bytes in every device's buffer),
    `copies.burst_scan` (record copies enqueued) and `steps.burst_scan`."""
    weights = weights or K.DEFAULT_WEIGHTS
    local, select = K.shard_scan_local, K.shard_scan_select
    scan, sides, plan, steps = _scan_window(
        mesh, nodes, pods, last_index, last_node_index, num_to_find, n_real,
        z_pad, weights, rotation, rotation_pos, spread0, carry_in, wtab)
    nbytes, copies = _run_steps(mesh, scan, sides, plan, steps, local,
                                select)
    obs.inc("gather.burst_scan", nbytes)
    obs.inc("copies.burst_scan", copies)
    obs.inc("steps.burst_scan", steps)
    d0 = mesh.devices[0]
    side, B = sides[d0], plan.B
    stats, packed = side.stats, side.packed
    outs = {"selected": stats[0], "found": stats[1], "evaluated": stats[2],
            "max_score": stats[3], "li_after": packed[B: 2 * B],
            "lni_after": stats[4], "packed": packed}
    return (_scan_rows(scan), side.st[K.SS_LI].clone(),
            side.st[K.SS_LNI].clone(), _scan_spread(scan, plan, d0), outs)


def _scan_rows(scan: list) -> list:
    return [{k: sh.nodes[k] for k in K._MUTABLE} for sh in scan]


def _scan_spread(scan: list, plan, d0):
    if plan.carry_spread:
        return [sh.spread for sh in scan]
    return torch.zeros((), dtype=K.I64, device=d0)


def sharded_segments(mesh: Mesh, nodes, pods, seg_start, gang, n_pods,
                     last_index, last_node_index, num_to_find, n_real, z_pad,
                     weights=None, rotation=None, rotation_pos=None,
                     spread0=None, wtab=None, gang_score=False):
    """`sharded_segments_fn` (sharding.py:279): the fused drain window
    (K6) with the node axis split over the mesh, the gang checkpoint per
    shard. Exactly `n_pods` steps of K11a (one launch a device over its
    shards), the all-gather of other devices' records and K11b on every
    distinct device, then K11a once more (the last fold or rewind). The
    signature and returns of
    `K.schedule_batch_segments`: (one dict of folded rows per shard, li,
    lni, per-shard spread slices or a zero scalar, packed[4B]), on the
    first device. Books `gather.burst_segments` (bytes),
    `copies.burst_segments` and `steps.burst_segments`."""
    weights = weights or K.DEFAULT_WEIGHTS
    local, select = K.shard_segments_local, K.shard_segments_select
    stack = pods if isinstance(pods, K.PodStack) \
        else K.PodStack.from_dense(pods, mesh.devices[0])
    if int(n_pods) > len(stack):
        raise ValueError("n_pods exceeds the stacked window")
    scan, sides, plan, steps = _scan_window(
        mesh, nodes, stack, last_index, last_node_index, num_to_find,
        n_real, z_pad, weights, rotation, rotation_pos, spread0, None, wtab,
        n_steps=int(n_pods), segments=(seg_start, gang),
        gang_score=gang_score)
    nbytes, copies = _run_steps(mesh, scan, sides, plan, steps, local,
                                select)
    obs.inc("gather.burst_segments", nbytes)
    obs.inc("copies.burst_segments", copies)
    obs.inc("steps.burst_segments", steps)
    d0 = mesh.devices[0]
    side = sides[d0]
    return (_scan_rows(scan), side.st[K.SS_LI].clone(),
            side.st[K.SS_LNI].clone(), _scan_spread(scan, plan, d0),
            side.packed)


def sharded_batch(mesh: Mesh, nodes, pods, last_index, last_node_index,
                  num_to_find, n_real, z_pad, weights=None):
    """`sharded_batch_fn` (sharding.py:388): a plain wrapper over
    `sharded_scan` with no rotation and no spread, the carried rows taken
    from the node matrix. Returns (per-shard rows, li, lni, outs). No
    kernel of its own."""
    state, li, lni, _spread, outs = sharded_scan(
        mesh, nodes, pods, last_index, last_node_index, num_to_find, n_real,
        z_pad, weights=weights)
    return state, li, lni, outs


def _vic_shards(mesh: Mesh, vic) -> list:
    """Victim planes per shard: `vic` whole (split here) or one dict per
    shard (each on its shard's device)."""
    if isinstance(vic, dict):
        return shard_victim_planes(mesh, vic)
    shards = list(vic)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} victim shards for a mesh of "
                         f"{mesh.size}")
    for sh, dev in zip(shards, mesh.devices):
        K._require_on("victim planes", dev, *sh.values())
    return shards


def shard_victim_planes(mesh: Mesh, planes: dict) -> list:
    """`shard_victim_planes` (sharding.py:374): the resident [N, P] victim
    planes (numpy or tensors, the kernels' keys) with the node axis split
    like the node matrix, one dict per shard on its device, in the
    kernels' dtypes."""
    n_pad = int(np.shape(planes["prio"])[0])
    rows = mesh.rows(n_pad)
    return [K._vic_tensors({k: v[s * rows: (s + 1) * rows]
                            for k, v in planes.items()}, dev)
            for s, dev in enumerate(mesh.devices)]


def preempt_sides(mesh: Mesh, P: int) -> dict:
    """{device: K.PreemptSide} of the mesh's sharded victim scan at P
    victim slots, made at its first call: on every distinct device the
    records' two halves [2, D, cand_record_bytes(P)], zeroed, and under
    "peer" the mesh's stamps (`mesh_stamps`, with peer access enabled) and
    the other devices' (halves, stamps) by `exchange_plan`. The cards are
    synchronized once after the zeroing, so no card's first K14a can
    write into a buffer another card has yet to zero."""
    sides = mesh._preempt.get(int(P))
    if sides is None:
        chunk = K.cand_record_bytes(P)
        halves = {d: torch.zeros((2, mesh.size, chunk), dtype=torch.uint8,
                                 device=d) for d in mesh.distinct}
        stamps = mesh_stamps(mesh) if mesh.exchange == "peer" \
            else {d: None for d in mesh.distinct}
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        peers = {mesh.devices[s]: dests[1:]
                 for s, dests in exchange_plan(mesh.devices)}
        sides = mesh._preempt[int(P)] = {
            d: K.PreemptSide(halves[d], stamps[d], tuple(
                (halves[x], stamps[x]) for x in peers[d])
                if mesh.exchange == "peer" else ())
            for d in mesh.distinct}
    return sides


def preempt_call(mesh: Mesh, nodes, vic, pod: dict, feas_static,
                 order_rank, n_real, check_resources, has_request,
                 max_prio) -> tuple:
    """One preemptor's sharded victim scan, ready to launch: ({device:
    its K.PreemptShard list}, {device: K.PreemptSide}, K.PreemptCall).
    `feas_static` and `order_rank` go to each distinct device once (a
    tensor already there stays), and each shard takes its slice there.
    The call takes the mesh's next round (`Mesh.next_round`, shared with
    the sharded cycle) and, under "peer", one stamp value
    (`Mesh.reserve_stamps`)."""
    shards = _as_shards(mesh, nodes)
    vics = _vic_shards(mesh, vic)
    n_pad = sum(int(sh["valid"].shape[0]) for sh in shards)
    rows = mesh.rows(n_pad)
    P = int(vics[0]["prio"].shape[1])
    sides = preempt_sides(mesh, P)
    feas = _replicas(mesh, feas_static, torch.bool)
    rank = _replicas(mesh, order_rank, K.I64)
    groups = {d: [] for d in mesh.distinct}
    for s, (sh, vc, dev) in enumerate(zip(shards, vics, mesh.devices)):
        lo = s * rows
        groups[dev].append(K.PreemptShard(
            s, lo, sh, vc, feas[dev][lo: lo + rows],
            rank[dev][lo: lo + rows]))
    cr = bool(K._host(check_resources))
    stamp = K.stamp_value(mesh.reserve_stamps(1), 0) \
        if mesh.exchange == "peer" else 0
    call = K.PreemptCall(
        *(int(np.asarray(K._host(pod[k])))
          for k in ("req_cpu", "req_mem", "req_eph")),
        max_prio=int(max_prio), cr=cr,
        hr=bool(K._host(has_request)) and cr, n_real=int(n_real), P=P,
        D=mesh.size, round=mesh.next_round(), stamp=stamp)
    return groups, sides, call


def sharded_preempt(mesh: Mesh, nodes, vic, pod: dict, feas_static,
                    order_rank, n_real, check_resources, has_request,
                    max_prio) -> torch.Tensor:
    """`sharded_preempt_fn` (sharding.py:354): one preemptor's victim scan
    with the node rows, the victim planes, `feas_static` and `order_rank`
    split over the mesh (`preempt_call`). K14a once a distinct device over
    every shard it holds (the victim walk of their rows, each reduced to
    its candidate record, written in place into the device's buffer and,
    under "peer", into every other card's, then its stamp); under "copy"
    the host copies the other devices' records in (`gather_in_place`);
    then K14b on every distinct device (the pick among the D records, in
    place, after their stamps). No host read. Returns the packed [3+P]
    int32 block of `K.preemption_scan` on the first device. Books
    `gather.preempt` (bytes in every device's buffer) and
    `copies.preempt` (record copies enqueued: none under "peer")."""
    groups, sides, call = preempt_call(
        mesh, nodes, vic, pod, feas_static, order_rank, n_real,
        check_resources, has_request, max_prio)
    for d, shards in groups.items():
        K.shard_preempt_local(shards, sides[d], call)
    copies = 0
    if mesh.exchange == "copy":
        copies = gather_in_place(
            mesh, [sides[dev].records(call)[s]
                   for s, dev in enumerate(mesh.devices)],
            {d: sides[d].records(call) for d in mesh.distinct})
    obs.inc("gather.preempt", len(mesh.distinct) * mesh.size
            * K.cand_record_bytes(call.P))
    obs.inc("copies.preempt", copies)
    out = {d: K.shard_preempt_select(sides[d], call) for d in mesh.distinct}
    return out[mesh.devices[0]]


def _row_shards(mesh: Mesh, rows_in, rows: int, keys) -> list:
    """Per-shard dicts of `keys`: `rows_in` a whole dict of [n_pad, ...]
    rows (split here) or one dict per shard."""
    if isinstance(rows_in, dict):
        return [{k: _to(rows_in[k][s * rows: (s + 1) * rows], dev)
                 for k in keys} for s, dev in enumerate(mesh.devices)]
    shards = list(rows_in)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} row shards for a mesh of "
                         f"{mesh.size}")
    return shards


def sharded_pressure(mesh: Mesh, nodes, mut0, ghost0, pods, vic, last_index,
                     last_node_index, num_to_find, n_real, z_pad,
                     weights=None, out=None):
    """`sharded_pressure_fn` (sharding.py:330): the schedule-else-preempt
    wave (K8) with the mutable rows, the nominated-ghost load and the
    victim planes split over the mesh. One step per pod, skip pods
    included: K13a, one launch a device over its shards (fold the
    previous outcome a shard owns, the ghost-aware filter record, the
    victim walk reduced to a candidate record, each in place), the
    all-gather of other devices' records, K13b on every distinct device
    (the cycle's select, the pick over the D candidate records, the
    packed row, the step state); then K13a once more for the last fold.
    On a card the steps after the first re-enqueue the bound launches
    (two host calls a step on one card). The signature and
    returns of `K.pressure_batch`: `mut0` / `ghost0` / `vic` whole dicts or
    one dict per shard, last_index / last_node_index ints or the previous
    chunk's device scalars; returns (one dict of folded rows per shard,
    one ghost dict per shard, li, lni, outs) with li, lni and the packed
    [B, 5+P] block (`out` when given) on the first device. No host read
    until the caller fetches the block. Books `gather.pressure` (bytes),
    `copies.pressure` (record copies enqueued) and `steps.pressure`."""
    weights = weights or K.DEFAULT_WEIGHTS
    shards = _as_shards(mesh, nodes)
    n_pad = sum(int(sh["valid"].shape[0]) for sh in shards)
    rows = mesh.rows(n_pad)
    d0 = mesh.devices[0]
    stack = pods if isinstance(pods, K.PodStack) \
        else K.PodStack.from_dense(pods, d0)
    if "pprio" not in stack.table:
        raise ValueError("sharded_pressure: the pods carry no pprio")
    vics = _vic_shards(mesh, vic)
    P = int(vics[0]["prio"].shape[1])
    B = len(stack)
    width = len(K.PRESSURE_HEAD) + P
    if out is None:
        out = torch.empty((B, width), dtype=K.I32, device=d0)
    if tuple(out.shape) != (B, width) or out.dtype != K.I32 \
            or not out.is_contiguous() or out.device != d0:
        raise ValueError("sharded_pressure: out must be a contiguous "
                         f"[{B}, {width}] int32 tensor on {d0}")
    muts = _row_shards(mesh, mut0, rows, K._MUTABLE)
    ghosts = _row_shards(mesh, ghost0, rows, K.GHOST_FIELDS)
    scan, sides, plan, steps = _scan_window(
        mesh, shards, stack, last_index, last_node_index, num_to_find,
        n_real, z_pad, weights, None, None, None, (muts, None), None,
        n_steps=B, pressure={"ghost": ghosts, "vic": vics, "P": P,
                             "out": out})
    nbytes, copies = _run_steps(mesh, scan, sides, plan, steps,
                                K.shard_pressure_local,
                                K.shard_pressure_select)
    obs.inc("gather.pressure", nbytes)
    obs.inc("copies.pressure", copies)
    obs.inc("steps.pressure", steps)
    side = sides[d0]
    return (_scan_rows(scan), [sh.ghost for sh in scan],
            side.st[K.SS_LI].clone(), side.st[K.SS_LNI].clone(),
            K._pressure_outs(out))
