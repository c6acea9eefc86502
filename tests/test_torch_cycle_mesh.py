"""K9, the sharded serial cycle, as one K9a launch a device over its
shards with the records in place, and K9b's select from them after their
stamps, on the CPU.

A device runs K9a once over every shard it holds: each shard's record
goes straight into row s of the cycle's half of that device's buffer
(cycle r writes half r & 1, r from the mesh's one round counter, shared
with the sharded victim scan), then, under the "peer" exchange, into
every other device's and its stamp; K9b waits for the D stamps and
selects from the records where they lie. The pod's per-node fields and
the nominated ghost go to each device whole, each shard reading them at
its offset. Checked here: the grouped plain K9a against the per-shard
plain K9a plus a full `all_gather`, bit for bit, on `["cpu"] * D` for D
in 1, 2 and 4; the sharded cycle against JAX's `_cycle_core` on
conftest's virtual mesh (`sharded_cycle_fn`'s node sharding, with the
ghost and the rotation walks it does not take as arguments) and the
single-device plain K2, with every record plane dense, the ghost, an
n_real that ends inside a shard, and the perm and pos walks; cycles and
victim scans interleaved on one mesh under both exchanges; a select
without its stamps; and K9a's launch words, caught before a launch and
pinned to the kernel's C enums. `chip_smoke.py` holds the kernels
against these plain versions on the card. The same numpy inputs, made
from seeds, go to both packages. Tolerance: exact equality (every output
is an integer, a bool or a float64 compared bit for bit).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_imports import _enum_slots
from tests.test_torch_kernels import CYCLE_OUT, _cycle_inputs, assert_same
from tests.test_torch_preempt import both, rand_victims, victim_nodes

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
W = dict(PK.DEFAULT_WEIGHTS)
#: the pod fields made dense (every record plane present), and the
#: ranges of their values
DENSE = (("node_aff_counts", 0, 9), ("taint_counts", 0, 5),
         ("spread_counts", 0, 7), ("interpod_counts", -4, 5),
         ("image_sums", 0, 9))


def _world(seed, dense=True, n=37):
    """(jax nodes, port nodes, jax pod, port pod, n_real, n_pad, z_pad)
    of a 37-node world (n_pad 64: n_real ends inside shard 2 of 4 and
    shard 1 of 2) and a pod with taints, selectors and node affinity;
    `dense`: every family the record carries dense, inter-pod on."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(seed, 1, n=n)
    if dense:
        rng = np.random.default_rng(seed)
        for k, lo, hi in DENSE:
            v = rng.integers(lo, hi, n_pad).astype(np.int64)
            if k == "image_sums":
                v = v * 150 * 1024 ** 2
            jpod[k], ppod[k] = v, v.copy()
        tr = rng.random(n_pad) < 0.6
        jpod["interpod_tracked"], ppod["interpod_tracked"] = tr, tr.copy()
    return jn, pn, jpod, ppod, n, n_pad, z_pad


def _ghost(seed, n_pad):
    rng = np.random.default_rng(seed)
    return {"cpu": rng.integers(0, 3, n_pad) * 1000,
            "mem": rng.integers(0, 3, n_pad) * 1024 ** 3,
            "eph": np.zeros(n_pad, np.int64),
            "cnt": rng.integers(0, 3, n_pad)}


def _call(mesh, ppod, n, n_pad, ghost=None):
    """A CycleCall of the mesh's next round and stamp, as sharded_cycle
    makes it, with the static weights."""
    stamp = PK.stamp_value(mesh.reserve_stamps(1), 0) \
        if mesh.exchange == "peer" else 0
    return PK.CycleCall(
        pod=ppod, planes=PK.cycle_record_planes(ppod, W), weights=W,
        wrows={CPU: PK._weight_row(W, None, CPU)}, ghost=ghost, n_pad=n_pad,
        rows=mesh.rows(n_pad), D=mesh.size, n_real=n,
        round=mesh.next_round(), stamp=stamp)


def _group(mesh, pn, n_pad):
    rows = mesh.rows(n_pad)
    return [PK.CycleShard(s, s * rows, sh)
            for s, sh in enumerate(PS.shard_node_arrays(mesh, pn))]


# ---------------------------------------------------------------------------
# the grouped plain K9a
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ghost_on", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_grouped_k9a_equals_per_shard_k9a_and_gather(d, ghost_on):
    """One grouped call over a device's d shards writes, in the call's
    half, the rows the per-shard K9a writes and `all_gather` copies; its
    whole per-row outputs are the per-shard outputs joined; the other
    half stays as it was; the call's stamps are published."""
    _jn, pn, _jp, ppod, n, n_pad, _z = _world(40 + d)
    mesh = PS.Mesh(["cpu"] * d)
    ghost = _ghost(d, n_pad) if ghost_on else None
    mesh.next_round()       # the call takes round 1: half 1
    call = _call(mesh, ppod, n, n_pad, ghost)
    side = PS.cycle_sides(mesh, n_pad)[CPU]
    assert side.halves.shape == (2, d, PK.full_record_bytes(n_pad // d))
    group = _group(mesh, pn, n_pad)
    outs = PK.shard_cycle_group_plain(group, side, call)
    rows = n_pad // d
    pods = PS.shard_pod_arrays(mesh, ppod)
    parts, per = [], []
    for s, sh in enumerate(group):
        g = None if ghost is None else {
            k: torch.as_tensor(v[s * rows: (s + 1) * rows])
            for k, v in ghost.items()}
        f, ff, bits, rec = PK.shard_cycle_local_plain(
            sh.nodes, pods[s], s * rows, n, W, call.planes,
            wrow=call.wrows[CPU], ghost=g)
        parts.append(rec)
        per.append((f, ff, bits))
    gathered, nbytes = PS.all_gather(mesh, parts)
    assert nbytes == d * call.record_bytes
    assert_same(side.records(call)[:, : call.record_bytes], gathered[CPU],
                "records")
    assert not side.records(call)[:, call.record_bytes:].any()
    assert not side.halves[0].any()
    for i, name in enumerate(("feasible", "fail_first", "general_bits")):
        assert_same(outs[i], torch.cat([p[i] for p in per]), name)
    assert (side.stamps[1] == call.stamp).all() and call.stamp == 1
    assert not side.stamps[0].any()


# ---------------------------------------------------------------------------
# the sharded cycle against JAX and the single-device K2
# ---------------------------------------------------------------------------
_JAX = {}


def _jax_cycle(d, z_pad):
    """`_cycle_core` jitted with the node axis pinned to a d-device
    sharding, as `sharded_cycle_fn` pins it, taking the ghost and the
    rotation tables too."""
    key = (d, z_pad)
    if key not in _JAX:
        jmesh = JS.make_mesh(d)

        def fn(nodes, pod, li, lni, ntf, n, perm, inv, pos, ghost):
            return JK._cycle_core(JS._constrain_nodes(jmesh, nodes), pod,
                                  li, lni, ntf, n, W, z_pad, perm=perm,
                                  inv_perm=inv, pos=pos, ghost=ghost)
        _JAX[key] = (jmesh, jax.jit(fn))
    return _JAX[key]


def _walk(mode, n, n_pad, seed):
    if mode == "identity":
        return None, None, None
    rng = np.random.default_rng(seed)
    perm = np.concatenate([rng.permutation(n),
                           np.arange(n, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    return (perm, inv, None) if mode == "perm" else (None, None, inv)


@pytest.mark.parametrize("d,mode,dense,ghost_on", [
    (2, "identity", True, False), (4, "identity", True, True),
    (4, "identity", False, False), (2, "perm", True, True),
    (4, "perm", True, False), (4, "pos", True, True),
    (2, "pos", False, True)])
def test_sharded_cycle_matches_jax(d, mode, dense, ghost_on):
    """Every output of the sharded cycle (K9a on each device's shards, the
    records in place, K9b after their stamps) equals JAX's cycle on the
    virtual mesh and the single-device plain K2: dense na / tt / sc / ic
    / zone / tracked planes or inert ones, the nominated ghost, n_real 37
    of 64 slots, the identity, perm and pos walks."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _world(60 + d, dense)
    planes = PK.cycle_record_planes(ppod, W)
    if dense:
        assert planes == tuple(p for p, _ in PK._REC_PLANES)
    ghost = _ghost(7 + d, n_pad) if ghost_on else None
    perm, inv, pos = _walk(mode, n, n_pad, d)
    jmesh, fn = _jax_cycle(d, z_pad)
    jnodes = JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                          for k, v in jn.items()})
    jpod_s = JS.shard_pod_arrays(jmesh, jpod)

    def j(v):
        return None if v is None else jnp.asarray(v)
    jghost = None if ghost is None else {k: jnp.asarray(v, jnp.int64)
                                         for k, v in ghost.items()}
    mesh = PS.Mesh(["cpu"] * d)
    shards = PS.shard_node_arrays(mesh, pn)

    def t(v):
        return None if v is None else torch.as_tensor(v)
    kw = dict(perm=t(perm), inv_perm=t(inv), pos=t(pos), ghost=ghost)
    for li, lni, ntf in [(0, 0, n), (11, 7, 9 if mode != "pos" else n),
                         (n - 1, 2 ** 33 + 5, n)]:
        want = fn(jnodes, jpod_s, jnp.int64(li), jnp.int64(lni),
                  jnp.int64(ntf), jnp.int64(n), j(perm), j(inv), j(pos),
                  jghost)
        got = PK.schedule_cycle(shards, ppod, li, lni, ntf, n, z_pad,
                                mesh=mesh, **kw)
        single = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad, **kw)
        for k in CYCLE_OUT:
            assert_same(got[k], want[k], k)
            assert_same(got[k], single[k], k)


# ---------------------------------------------------------------------------
# rounds and stamps shared with the sharded victim scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("exchange", ["peer", "copy"])
def test_cycles_and_victim_scans_interleave(exchange):
    """cycle, scan, cycle, scan back to back on one 4-shard mesh: each
    call takes the next round of the one counter (half r & 1 of its own
    buffers) and, under "peer", the next stamp of the mesh's one stamp
    array; each result equals the single-device plain version; no record
    is copied on one device; the cycle's gather books its bytes."""
    mesh = PS.Mesh(["cpu"] * 4, exchange=exchange)
    obs.reset()
    _jn, pn, _jp, ppod, n, n_pad, z_pad = _world(81)
    shards = PS.shard_node_arrays(mesh, pn)
    rng = np.random.default_rng(5)
    vic = rand_victims(rng, 64, 16)
    _vj, vn = both(victim_nodes(rng, vic, 64, 57))
    feas, rank = rng.random(64) < 0.85, rng.permutation(64)
    pod = {"req_cpu": np.int64(900), "req_mem": np.int64(1024 ** 3),
           "req_eph": np.int64(0)}
    record = PK.record_layout(PK.cycle_record_planes(ppod, W),
                              n_pad // 4)[1]
    for r in range(4):
        if r % 2 == 0:
            got = PK.schedule_cycle(shards, ppod, 3 * r, r, n, n, z_pad,
                                    mesh=mesh)
            want = PK.schedule_cycle(pn, ppod, 3 * r, r, n, n, z_pad)
            for k in CYCLE_OUT:
                assert_same(got[k], want[k], k)
            side = PS.cycle_sides(mesh, n_pad)[CPU]
        else:
            got = PK.preemption_scan(
                PS.shard_node_arrays(mesh, vn),
                PS.shard_victim_planes(mesh, vic), pod, feas, rank, 57,
                True, True, 6, mesh=mesh)
            assert_same(got, PK.preemption_scan(vn, vic, pod, feas, rank,
                                                57, True, True, 6), "scan")
            side = PS.preempt_sides(mesh, 16)[CPU]
        assert mesh._round == r + 1
        assert side.halves[r & 1].any()
        if exchange == "peer":
            assert side.stamps is PS.mesh_stamps(mesh)[CPU]
            assert (side.stamps[r & 1] == PK.stamp_value(r, 0)).all()
        else:
            assert side.stamps is None and side.peers == ()
    assert obs.get("copies.cycle") == 0
    assert obs.get("gather.cycle") == 2 * 4 * record
    assert PS.cycle_sides(mesh, n_pad) is PS.cycle_sides(mesh, n_pad)


def test_a_cycle_select_without_its_stamps_raises():
    """A K9b whose cycle's records were never published (no K9a ran for
    it) raises, as the kernel's bounded wait traps, although the half
    holds an older cycle's records and stamps; after its K9a it selects
    as the single-device K2."""
    mesh = PS.Mesh(["cpu"] * 2)
    _jn, pn, _jp, ppod, n, n_pad, z_pad = _world(91)
    side = PS.cycle_sides(mesh, n_pad)[CPU]
    group = _group(mesh, pn, n_pad)
    first = _call(mesh, ppod, n, n_pad)
    PK.shard_cycle_group_plain(group, side, first)
    mesh.next_round()           # a victim scan's round between them
    call = _call(mesh, ppod, n, n_pad)
    assert call.round & 1 == first.round & 1 and call.stamp > first.stamp
    args = (side.records(call), call.planes, call.rows, n, ppod, 5, 2, n,
            W, z_pad)
    kw = dict(wrow=call.wrows[CPU], stamps=side.stamps, round=call.round,
              stamp=call.stamp)
    with pytest.raises(RuntimeError, match="did not publish"):
        PK.shard_cycle_select(*args, **kw)
    PK.shard_cycle_group_plain(group, side, call)
    out, total, kept = PK.shard_cycle_select(*args, **kw)
    want = PK.schedule_cycle(pn, ppod, 5, 2, n, n, z_pad)
    assert_same(total, want["total"], "total")
    assert_same(kept, want["kept"], "kept")
    assert int(out[0]) == int(want["selected"])


# ---------------------------------------------------------------------------
# K9a's launch words
# ---------------------------------------------------------------------------
def _at(ptr, dtype, count):
    """`count` values of `dtype` at host address `ptr`."""
    nbytes = count * np.dtype(dtype).itemsize
    raw = (ctypes.c_char * nbytes).from_address(int(ptr))
    return np.frombuffer(bytes(raw), dtype=dtype)


@pytest.mark.parametrize("d", [2, 4])
def test_k9a_launch_words(monkeypatch, d):
    """The words of one K9a call over a device's d shards: each shard's
    `_SCL_INTS` then `_SCL_PTRS`; its node rows in place; the pod's dense
    per-node fields and the ghost staged whole in one buffer, each shard
    pointing at its own rows; its outputs at its offset of the device's
    whole vectors; its record row s of the buffer's first half; the
    device's stamps and its own ticket; the call's round and stamp. What
    stays from call to call (`_cycle_template`) is made once and reused
    while the node tensors stay."""
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    _jn, pn, _jp, ppod, n, n_pad, _z = _world(100 + d)
    mesh = PS.Mesh(["cpu"] * d)
    ghost = _ghost(3, n_pad)
    call = _call(mesh, ppod, n, n_pad, ghost)
    side = PS.cycle_sides(mesh, n_pad)[CPU]
    group = _group(mesh, pn, n_pad)
    words, keep, outs = PK._shard_cycle_words(group, side, call)
    n_i, n_p = len(PK._SCL_INTS), len(PK._SCL_PTRS)
    assert len(words) == d * (n_i + n_p)
    rows = n_pad // d
    off, nbytes = PK.record_layout(call.planes, rows)
    stride = PK.full_record_bytes(rows)
    for s, sh in enumerate(group):
        w = words[s * (n_i + n_p): (s + 1) * (n_i + n_p)]
        ints = dict(zip(PK._SCL_INTS, w[:n_i]))
        ptrs = dict(zip(PK._SCL_PTRS, w[n_i:]))
        assert (ints["rows"], ints["offset"], ints["index"], ints["D"],
                ints["half"], ints["n_peers"]) == (rows, rows * s, s, d,
                                                   d * stride, 0)
        assert (ints["round"], ints["stamp"], ints["n_real"]) == (
            call.round, call.stamp, n)
        assert all(ints["off_" + p] == off.get(p, -1)
                   for p, _ in PK._REC_PLANES)
        for k in PK._SCL_NODES:
            assert ptrs[k] == sh.nodes[k].data_ptr(), k
        for k, _lo, _hi in DENSE:
            assert_same(_at(ptrs[k], np.int64, rows),
                        ppod[k][s * rows: (s + 1) * rows], k)
        assert_same(_at(ptrs["interpod_tracked"], np.bool_, rows),
                    ppod["interpod_tracked"][s * rows: (s + 1) * rows],
                    "tracked")
        for k in PK.GHOST_FIELDS:
            assert_same(_at(ptrs["ghost_" + k], np.int64, rows),
                        ghost[k][s * rows: (s + 1) * rows], k)
        scal = _at(ptrs["scal"], np.int64, len(PK._CYCLE_SCALARS))
        assert int(scal[0]) == int(ppod["req_cpu"])
        assert ptrs["feasible"] == outs[0].data_ptr() + rows * s
        assert ptrs["general_bits"] == outs[2].data_ptr() + 8 * rows * s
        assert ptrs["rec"] == side.halves[0][s].data_ptr()
        assert ptrs["stamps"] == side.stamps.data_ptr()
        assert ptrs["ticket"] == side.tickets[s].data_ptr()
        assert ptrs["w"] == call.wrows[CPU].data_ptr()
        assert all(ptrs[f"peer_rec{k}"] == 0 for k in range(PK.MAX_PEERS))
        # the inert mask fields have no pointer
        assert ptrs["sel_ok"] == 0 or not PK._inert(ppod["sel_ok"])
    assert side.tickets.dtype == torch.int64 and not side.tickets.any()
    nodes = side._nodes[tuple(range(d))][1]
    PK._shard_cycle_words(group, side, call)
    assert side._nodes[tuple(range(d))][1] is nodes
    group[0].nodes["req_cpu"] = group[0].nodes["req_cpu"].clone()
    PK._shard_cycle_words(group, side, call)
    again = side._nodes[tuple(range(d))][1]
    assert again is not nodes
    assert again[0][PK._SCL_AT["req_cpu"]] \
        == group[0].nodes["req_cpu"].data_ptr()


def test_k9a_launch_slots_match_the_kernel_enums():
    """K9a's scalar and pointer tables name `shard_cycle_local.cu`'s C
    enums one to one: after the shard's rows, pod and outputs its record
    row, the device's stamps and its ticket, the peers' rows and stamps,
    the ghost last; the exchange's scalars last of the ints. Its group of
    LOCAL_GROUP_SHARDS structs fits the 4 KB parameter bank, and its
    launch function takes what the grouped locals' take."""
    src = (_build.CSRC / "shard_cycle_local.cu").read_text()
    tail = ("rec", "stamps", "ticket") + tuple(
        f"peer_rec{k}" for k in range(PK.MAX_PEERS)) + tuple(
        f"peer_stamps{k}" for k in range(PK.MAX_PEERS)) + tuple(
        "ghost_" + k for k in PK.GHOST_FIELDS)
    assert PK._SCL_PTRS[-len(tail):] == tail
    assert _enum_slots(src, "LP_COUNT")[-len(tail):] == [
        "LP_" + k.upper() for k in tail]
    assert _enum_slots(src, "CL_COUNT") == ["CL_" + k.upper()
                                            for k in PK._SCL_INTS]
    assert PK._SCL_INTS[-6:] == ("index", "D", "half", "round", "stamp",
                                 "n_peers")
    assert PK.LOCAL_GROUP_SHARDS * 8 * (len(PK._SCL_INTS)
                                        + len(PK._SCL_PTRS)) <= 4096
    assert _build.SIGNATURES["shard_cycle_local"] \
        == _build.SIGNATURES["shard_scan_local"]
    assert "stamps_publish(" in src and "__grid_constant__" in src
    select = (_build.CSRC / "shard_cycle_select.cu").read_text()
    assert "stamps_wait(" in select
    assert _enum_slots(select, "SP_COUNT")[-1] == "SP_STAMPS"
    assert _enum_slots(select, "CS_COUNT")[-2:] == ["CS_ROUND", "CS_STAMP"]
