"""K14, the sharded victim scan, as one K14a launch a device over its
shards with the records in place, and K14b's pick from them, on the CPU.

A device runs K14a once over every shard it holds: each shard's
candidate record goes straight into row s of the call's half of that
device's buffer (call r writes half r & 1), then, under the "peer"
exchange, into every other device's and its stamp; K14b waits for the D
stamps and picks from the records where they lie. Checked here: the
grouped plain K14a against the per-shard plain K14a plus a full
`all_gather`, bit for bit, on `["cpu"] * D` for D in 1, 2 and 4; the
sharded scan against JAX's `preemption_scan(mesh=make_mesh(D))` (conftest's
virtual 8-device CPU mesh) and the single-device plain K7 on designed
worlds (five-criteria ties across shards, a zero-victim candidate only in
the last shard, no candidate, duplicate ranks, an n_real that is a
multiple of no shard count; P 16 and 128), the same numpy inputs made
from a seed; calls back to back on one mesh under both exchanges; a
select without its stamps; and the launch arrays of the K14a wrapper,
caught before a launch. `chip_smoke.py` holds the kernels against these
plain versions on the card. Tolerance: exact equality (every output is an
integer, a bool or a float64 compared bit for bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_preempt import (assert_same, both, rand_victims,
                                      victim_nodes)

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


GI = 1024 ** 3
CPU = torch.device("cpu")
SHARDS = [1, 2, 4]
# n_real 57: a multiple of no shard count, with real rows in the last of
# four shards of 16
N_PAD, N_REAL = 64, 57
WORLDS = ["five-criteria ties across shards",
          "zero victim in the last shard only", "no candidate",
          "duplicate ranks", "ragged n_real"]


def _world(case, P):
    """(node rows, victim planes, pod, feas_static, order_rank) of a
    designed world (numpy)."""
    rng = np.random.default_rng(900 + WORLDS.index(case) + P)
    vic = rand_victims(rng, N_PAD, P)
    nodes = victim_nodes(rng, vic, N_PAD, N_REAL)
    feas = rng.random(N_PAD) < 0.85
    rank = np.full(N_PAD, 1 << 30, np.int64)
    rank[:N_REAL] = rng.permutation(N_REAL)
    pod = {"req_cpu": np.int64(900), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI)}
    if case in ("five-criteria ties across shards", "duplicate ranks"):
        # every node a copy of a row with a victim below priority 6, full
        # on cpu: the five criteria tie on every shard
        j0 = int(np.argmax((vic["valid"] & (vic["prio"] < 6)).any(1)))
        for k in vic:
            vic[k] = np.ascontiguousarray(np.repeat(vic[k][j0:j0 + 1],
                                                    N_PAD, 0))
        for k in nodes:
            if k != "valid":
                nodes[k] = np.ascontiguousarray(
                    np.repeat(nodes[k][j0:j0 + 1], N_PAD, 0))
        nodes["req_cpu"][:] = nodes["alloc_cpu"][0]
        nodes["allowed_pods"][:] = 110
        pod = {"req_cpu": np.int64(1), "req_mem": np.int64(0),
               "req_eph": np.int64(0)}
        # the lowest ranks on the last shards
        rank[:N_REAL] = np.arange(N_REAL)[::-1]
    if case == "duplicate ranks":
        rank = rng.integers(0, 5, N_PAD).astype(np.int64)
    if case == "zero victim in the last shard only":
        # every node full on cpu but the last real one, which has room and
        # no potential victim
        j = N_REAL - 1
        nodes["req_cpu"] = np.maximum(nodes["req_cpu"], nodes["alloc_cpu"])
        nodes["req_cpu"][j] = 0
        nodes["alloc_cpu"][j] = 64000
        for k in ("req_mem", "req_eph", "pod_count"):
            nodes[k][j] = 0
        nodes["allowed_pods"][j] = 110
        vic["valid"][j] = False
        feas[j] = True
    if case == "no candidate":
        feas[:] = False
    return nodes, vic, pod, feas, rank


def _call(mesh, world, exchange_args=(True, True, 6)):
    nodes, vic, pod, feas, rank = world
    _jn, pn = both(nodes)
    return PS.preempt_call(mesh, PS.shard_node_arrays(mesh, pn),
                           PS.shard_victim_planes(mesh, vic), pod, feas,
                           rank, N_REAL, *exchange_args)


@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("case", WORLDS)
@pytest.mark.parametrize("d", SHARDS)
def test_grouped_k14a_equals_per_shard_k14a_and_gather(d, case, P):
    """One grouped plain K14a over the device's shards writes, into the
    call's half of its buffer, exactly the rows a per-shard plain K14a on
    each shard and a full `all_gather` give; the other half stays as it
    was; each shard's stamp of the call is published."""
    mesh = PS.Mesh(["cpu"] * d)
    world = _world(case, P)
    groups, sides, call = _call(mesh, world)
    side = sides[CPU]
    assert call.round == 0 and call.P == P and call.D == d
    assert [sh.index for sh in groups[CPU]] == list(range(d))
    PK.shard_preempt_local(groups[CPU], side, call)
    recs = [PK.shard_preempt_local_plain(
        sh.nodes, sh.vic, world[2], sh.feas, sh.rank, sh.offset, N_REAL,
        True, True, 6) for sh in groups[CPU]]
    gathered, nbytes = PS.all_gather(mesh, recs)
    assert nbytes == d * PK.cand_record_bytes(P)
    assert torch.equal(side.records(call), gathered[CPU])
    assert side.records(call).data_ptr() == side.halves[0].data_ptr()
    assert not side.halves[1].any()
    assert (side.stamps[0] == call.stamp).all()
    assert call.stamp == PK.stamp_value(0, 0)
    # the pick from the records in place is the pick from the gather
    assert_same(PK.shard_preempt_select(side, call),
                PK.preempt_pick_plain(gathered[CPU], P))


@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("case", WORLDS)
def test_sharded_scan_matches_jax_and_k7(case, P):
    """`preemption_scan(mesh=)` on 1, 2 and 4 CPU shards (one K14a call
    a device, K14b from the records in place) equals JAX's
    `sharded_preempt_fn` on the same mesh size and the single-device plain
    K7, block for block."""
    nodes, vic, pod, feas, rank = _world(case, P)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    single = PK.preemption_scan(pn, vic, pod, feas, rank, N_REAL, True,
                                True, 6)
    for d in SHARDS:
        want = np.asarray(JK.preemption_scan(
            jn, jv, pod, jnp.asarray(feas), jnp.asarray(rank), N_REAL,
            True, True, 6, mesh=JS.make_mesh(d)))
        mesh = PS.Mesh(["cpu"] * d)
        got = PK.preemption_scan(PS.shard_node_arrays(mesh, pn),
                                 PS.shard_victim_planes(mesh, vic), pod,
                                 feas, rank, N_REAL, True, True, 6,
                                 mesh=mesh)
        assert got.dtype == torch.int32 and got.shape == (3 + P,)
        assert_same(got, want, f"{case} D={d}")
        assert_same(got, single, f"{case} D={d} vs K7")
    w = int(want[0])
    if case == "no candidate":
        assert w == -1 and not want[1:].any()
    elif case == "zero victim in the last shard only":
        # the last real row, in the last of four shards
        assert w == N_REAL - 1 and w >= 3 * N_PAD // 4
        assert want[1] == 0 and not want[3:].any()
    elif case == "five-criteria ties across shards":
        c = np.flatnonzero(feas[:N_REAL])
        assert w == c[np.argmin(rank[c])] and w >= N_PAD // 4
        assert want[1] > 0
    elif case == "duplicate ranks":
        c = np.flatnonzero(feas[:N_REAL])
        low = rank[c].min()
        assert (rank[c] == low).sum() > 1
        assert w == c[rank[c] == low][0]
    else:
        assert 0 <= w < N_REAL


@pytest.mark.parametrize("exchange", ["peer", "copy"])
def test_calls_back_to_back_alternate_halves(exchange):
    """Three calls on one 4-shard mesh: call r writes half r & 1 and (under
    "peer") publishes stamp values that count up; every block equals the
    single-device plain K7 of its world; no record is copied on one
    device; `gather.preempt` books the records in every device's buffer."""
    mesh = PS.Mesh(["cpu"] * 4, exchange=exchange)
    obs.reset()
    chunk = PK.cand_record_bytes(16)
    for r, case in enumerate(("ragged n_real", "duplicate ranks",
                              "zero victim in the last shard only")):
        nodes, vic, pod, feas, rank = _world(case, 16)
        _jn, pn = both(nodes)
        got = PK.preemption_scan(PS.shard_node_arrays(mesh, pn),
                                 PS.shard_victim_planes(mesh, vic), pod,
                                 feas, rank, N_REAL, True, True, 6,
                                 mesh=mesh)
        assert_same(got, PK.preemption_scan(pn, vic, pod, feas, rank,
                                            N_REAL, True, True, 6), case)
        side = PS.preempt_sides(mesh, 16)[CPU]
        assert mesh._round == r + 1
        if exchange == "peer":
            assert (side.stamps[r & 1] == PK.stamp_value(r, 0)).all()
        else:
            assert side.stamps is None and side.peers == ()
        assert side.halves[r & 1].any()
    assert obs.get("copies.preempt") == 0
    assert obs.get("gather.preempt") == 3 * 4 * chunk
    assert PS.preempt_sides(mesh, 16) is PS.preempt_sides(mesh, 16)


def test_a_select_without_its_stamps_raises():
    """A K14b whose call's records were never published (no K14a ran for
    it) raises, as the kernel's bounded wait traps, even with the last
    call's stamps in place; after its K14a it picks."""
    mesh = PS.Mesh(["cpu"] * 2)
    world = _world("ragged n_real", 16)
    groups, sides, call = _call(mesh, world)
    with pytest.raises(RuntimeError, match="did not publish"):
        PK.shard_preempt_select(sides[CPU], call)
    PK.shard_preempt_local(groups[CPU], sides[CPU], call)
    first = PK.shard_preempt_select(sides[CPU], call)
    groups, sides, call2 = _call(mesh, world)
    assert call2.round == 1 and call2.stamp > call.stamp
    with pytest.raises(RuntimeError, match="did not publish"):
        PK.shard_preempt_select(sides[CPU], call2)
    PK.shard_preempt_local(groups[CPU], sides[CPU], call2)
    assert_same(PK.shard_preempt_select(sides[CPU], call2), first)


# ---------------------------------------------------------------------------
# the K14a launch, caught before it reaches a card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,shards,sms,per_sm,blocks", [
    # (rows a shard, shards a launch, the card's SMs, blocks an SM holds,
    # blocks a shard)
    (4096, 4, 132, 5, 64),      # mesh-preempt-single: a group a warp
    (4096, 1, 132, 5, 64),
    (65536, 4, 132, 5, 165),    # the card split over the four shards
    (65536, 2, 132, 3, 198),
    (8, 4, 132, 3, 1),
    (262144, 4, 114, 2, 57),    # another card's count
])
def test_preempt_group_grid_pins(rows, shards, sms, per_sm, blocks):
    grid = PK.preempt_group_grid(rows, shards, sms, per_sm)
    assert grid.blocks == blocks and grid.fit == sms * per_sm
    # the launch's block records fit the card's array
    assert grid.blocks * shards <= grid.fit
    assert grid.blocks <= PK.preempt_grid(rows, sms, per_sm).blocks


@pytest.mark.parametrize("d", [4, 6])
def test_k14a_launch_arrays(monkeypatch, d):
    """The words of one K14a call over a device's d shards: each shard's
    `_SPL_INTS` then `_SPL_PTRS`, its record row s of the buffer's first
    half (the kernel adds the call's half), the device's block records
    and tickets (made once a device, the tickets zeroed), its blocks from
    `preempt_group_grid` of the launch it falls in (LOCAL_GROUP_SHARDS
    shards a launch), the call's round and stamp."""
    asked = []

    def occupancy():
        asked.append(1)
        return 132, 3
    monkeypatch.setattr(PK, "_PREEMPT_GROUP_CARD", {})
    monkeypatch.setattr(PK, "_preempt_group_occupancy", occupancy)
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    # 8,192 rows a shard: more 32-node groups than a launch of four shards
    # gives a shard blocks, fewer than a launch of two
    rows = 8192
    n_pad = rows * d
    mesh = PS.Mesh(["cpu"] * d)
    rng = np.random.default_rng(17)
    vic = rand_victims(rng, n_pad, 16)
    _jn, pn = both(victim_nodes(rng, vic, n_pad, n_pad - 3))
    groups, sides, call = PS.preempt_call(
        mesh, PS.shard_node_arrays(mesh, pn),
        PS.shard_victim_planes(mesh, vic),
        {"req_cpu": 900, "req_mem": GI, "req_eph": 0},
        rng.random(n_pad) < 0.9, rng.permutation(n_pad), n_pad - 3, True,
        True, 6)
    side = sides[CPU]
    n_i, n_p = len(PK._SPL_INTS), len(PK._SPL_PTRS)
    for _ in range(2):
        words = PK._shard_preempt_words(groups[CPU], side, call)
        assert len(words) == d * (n_i + n_p)
    assert len(asked) == 1
    _sms, _per, records, tickets = PK._PREEMPT_GROUP_CARD["cpu"]
    assert records.numel() == PK.PREEMPT_RECORD_WORDS * 396
    assert tickets.dtype == torch.int32 and not tickets.any()
    assert tickets.numel() == PK.LOCAL_GROUP_SHARDS
    chunk = PK.cand_record_bytes(16)
    for s in range(d):
        w = words[s * (n_i + n_p): (s + 1) * (n_i + n_p)]
        ints = dict(zip(PK._SPL_INTS, w[:n_i]))
        ptrs = dict(zip(PK._SPL_PTRS, w[n_i:]))
        m = min(PK.LOCAL_GROUP_SHARDS,
                d - s // PK.LOCAL_GROUP_SHARDS * PK.LOCAL_GROUP_SHARDS)
        assert ints["blocks"] == PK.preempt_group_grid(rows, m, 132,
                                                       3).blocks
        assert ints["blocks"] == {4: 99, 2: 128}[m]
        assert (ints["rows"], ints["offset"], ints["index"]) == (
            rows, rows * s, s)
        assert (ints["D"], ints["half"], ints["n_peers"]) == (
            d, d * chunk, 0)
        assert (ints["round"], ints["stamp"], ints["P"]) == (
            call.round, call.stamp, 16)
        assert (ints["n_real"], ints["max_prio"], ints["cr"],
                ints["hr"]) == (n_pad - 3, 6, 1, 1)
        assert ptrs["rec"] == side.halves[0][s].data_ptr()
        assert ptrs["stamps"] == side.stamps.data_ptr()
        assert ptrs["records"] == records.data_ptr()
        assert ptrs["tickets"] == tickets.data_ptr()
        assert ptrs["feas"] == groups[CPU][s].feas.data_ptr()
        assert all(ptrs[f"peer_rec{k}"] == 0 for k in range(PK.MAX_PEERS))


def test_k14a_refuses_more_slots_than_a_record_holds(monkeypatch):
    """A block record carries its best node's flags, PREEMPT_P bits:
    wider victim planes are refused before the card is asked."""
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    mesh = PS.Mesh(["cpu"] * 2)
    P = PK.PREEMPT_P + 2
    rng = np.random.default_rng(3)
    vic = rand_victims(rng, 8, P)
    nodes = victim_nodes(rng, vic, 8, 8)
    _jn, pn = both(nodes)
    groups, sides, call = PS.preempt_call(
        mesh, PS.shard_node_arrays(mesh, pn),
        PS.shard_victim_planes(mesh, vic),
        {"req_cpu": 1, "req_mem": 1, "req_eph": 0}, np.ones(8, bool),
        np.arange(8), 8, True, True, 6)
    with pytest.raises(ValueError, match="victim slots"):
        PK._shard_preempt_words(groups[CPU], sides[CPU], call)
