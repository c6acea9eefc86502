"""K7 (`preempt_scan`) as one grid-wide launch: its geometry, the pick as
a reduction over the launch's blocks, and the plain K7 against JAX.

K7 gives each node one thread, 32 consecutive nodes a warp (their slots
staged through shared memory), and fills the card: its grid is the card's
SM count times the K7 blocks an SM holds (the occupancy query), fewer
only when the nodes run out, and the warps take the groups of 32 nodes
with a grid stride.
Each block reduces its nodes' pick to one record keyed by (order_rank,
row); the last block to draw the ticket combines the records. This file
pins the grid and the record array (caught before a launch, the card's
numbers given by a monkeypatch); holds a plain model of that blockwise
pick, on the kernel's own split of the nodes over warps and blocks,
against JAX's `_pick_one_node` (five-criteria ties across blocks,
duplicate ranks among the candidates, a zero-victim candidate only in
the last block, +inf starts, no candidate); and holds the plain K7
(`preemption_scan_plain`) against JAX's `preemption_scan` on the same
designed worlds. `chip_smoke.py` then holds the kernel against the plain
version on the card. Tolerance: exact equality (every output is an
integer, a bool or a float64 compared bit for bit).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from tests.test_torch_preempt import (assert_same, both, rand_victims,
                                      victim_nodes)

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK

torch.set_num_threads(1)

GI = 1024 ** 3
WARPS = PK.PREEMPT_THREADS // 32


# ---------------------------------------------------------------------------
# the grid and the record array
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,sms,per_sm,blocks", [
    # (node slots, the card's SMs, K7 blocks an SM holds, the grid)
    (1024, 132, 5, 16),         # fewer groups of 32 nodes than warps
    (16384, 132, 5, 256),       # one group a warp
    (262144, 132, 5, 660),      # the card full: the grid does not grow
    (262144, 132, 3, 396),
    (16383, 132, 5, 256),
    (16416, 132, 5, 257),       # a ragged last group
    (8, 132, 3, 1),
    (1, 114, 2, 1),
    (262144, 114, 2, 228),      # another card's count
])
def test_preempt_grid_pins(n_pad, sms, per_sm, blocks):
    grid = PK.preempt_grid(n_pad, sms, per_sm)
    assert (grid.blocks, grid.fit) == (blocks, sms * per_sm)
    assert grid.blocks <= grid.fit
    # 32 nodes a warp: the grid's warps cover the nodes or fill the card
    assert grid.blocks * WARPS * 32 >= min(n_pad, grid.fit * WARPS * 32)
    assert grid.records_bytes == 8 * PK.PREEMPT_RECORD_WORDS * sms * per_sm


def test_preempt_grid_refuses_a_card_that_holds_no_block():
    with pytest.raises(RuntimeError, match="holds no block"):
        PK.preempt_grid(16384, 132, 0)


class _Launched(Exception):
    pass


def _expanded_vic(n_pad, P):
    """[n_pad, P] victim planes of the kernels' dtypes that take no memory
    (one element, expanded)."""
    dt = {"start": torch.float64, "valid": torch.bool,
          "violating": torch.bool}
    return {k: torch.zeros(1, 1, dtype=dt.get(k, torch.int64)).expand(
        n_pad, P) for k in PK.VICTIM_PLANES}


@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("n_pad", [1024, 16384, 262144])
def test_k7_wrapper_launches_its_grid(monkeypatch, n_pad, P):
    """The K7 wrapper asks the card once (SMs, blocks an SM holds), takes
    `preempt_grid` of its node axis, and hands the launch the device's
    record array (PREEMPT_RECORD_WORDS words for each block the card
    holds at once) and its ticket, zeroed: both made once a device, not once a
    call (the device checks waived and the launch caught: nothing reaches
    a card)."""
    asked = []
    launched = []

    def occupancy():
        asked.append(1)
        return 132, 3

    def launch(name, iargs, parr):
        launched.append((name, list(iargs), list(parr)))
        raise _Launched
    monkeypatch.setattr(PK, "_PREEMPT_CARD", {})
    monkeypatch.setattr(PK, "_preempt_occupancy", occupancy)
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(PK, "_vic_tensors", lambda vic, dev: vic)
    monkeypatch.setattr(PK, "_launch", launch)
    nodes = {k: torch.zeros(n_pad, dtype=torch.int64)
             for k in PK._PREEMPT_PTRS[:8]}
    feas = torch.ones(n_pad, dtype=torch.bool)
    rank = torch.arange(n_pad)
    pod = {"req_cpu": 1000, "req_mem": GI, "req_eph": 0}
    for _ in range(2):
        with pytest.raises(_Launched):
            PK._preempt_launch(nodes, _expanded_vic(n_pad, P), pod, feas,
                               rank, n_pad - 3, True, True, 6)
    assert len(asked) == 1
    name, iargs, parr = launched[0]
    assert name == "preempt_scan"
    ints = dict(zip(PK._PREEMPT_INTS, iargs))
    want = PK.preempt_grid(n_pad, 132, 3)
    assert ints["blocks"] == want.blocks
    assert (ints["n_pad"], ints["P"], ints["n_real"]) == (n_pad, P, n_pad - 3)
    assert PK.last_geometry["preempt_scan"] == (want, 396)
    sms, per_sm, records, ticket = PK._PREEMPT_CARD["cpu"]
    assert (sms, per_sm) == (132, 3)
    assert records.numel() * 8 == want.records_bytes == 8 * 11 * 396
    assert ticket.dtype == torch.int32 and int(ticket.sum()) == 0
    ptrs = dict(zip(PK._PREEMPT_PTRS, parr))
    assert ptrs["records"] == records.data_ptr()
    assert ptrs["ticket"] == ticket.data_ptr()
    assert dict(zip(PK._PREEMPT_PTRS, launched[1][2]))["records"] \
        == records.data_ptr()


def test_k7_wrapper_refuses_more_slots_than_a_record_holds(monkeypatch):
    """A record carries its best node's flags, PREEMPT_P bits: wider
    victim planes are refused before the card is asked."""
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(PK, "_vic_tensors", lambda vic, dev: vic)
    nodes = {k: torch.zeros(64, dtype=torch.int64)
             for k in PK._PREEMPT_PTRS[:8]}
    with pytest.raises(ValueError, match="victim slots"):
        PK._preempt_launch(nodes, _expanded_vic(64, PK.PREEMPT_P + 2),
                           {"req_cpu": 1, "req_mem": 1, "req_eph": 0},
                           torch.ones(64, dtype=torch.bool),
                           torch.arange(64), 60, True, True, 6)


def test_k7_source_is_one_launch_without_aggregate_planes():
    """One kernel a call, its record and ticket in place of the aggregate
    planes; the one-block pick and the two kernels are gone."""
    src = (_build.CSRC / "preempt_scan.cu").read_text()
    assert src.count("<<<") == 2   # one kernel, two instantiations
    assert "k7_stage(" in src and "__ldcg(records" in src
    assert "__pipeline_memcpy_async(" in src
    # the winner's flags ride in its block's record: no row walked twice
    assert "victim_node" not in src.split("__global__")[1]
    assert "constexpr int K7_WORDS = PK_WORDS + K7_FLAG_WORDS;" in src
    assert "constexpr int K7_FLAG_WORDS = K7_PMAX / 64;" in src
    assert "constexpr int K7_PMAX = 128;" in src
    assert PK.PREEMPT_RECORD_WORDS == 9 + PK.PREEMPT_P // 64 == 11
    assert "__threadfence();" in src and "atomicAdd(" in src
    assert "constexpr int K7_THREADS = 32 * K7_WARPS;" in src
    assert int(re.search(r"constexpr int K7_WARPS = (\d+);", src).group(1)) \
        * 32 == PK.PREEMPT_THREADS
    for gone in ("victim_kernel", "pick_kernel", "pick_block", "AGG",
                 "store_agg"):
        assert gone not in src, gone
    victim = (_build.CSRC / "victim.cuh").read_text()
    assert "pick_block(" not in victim
    assert ("enum { PK_ZKEY, PK_ZROW, PK_BKEY, PK_BROW, PK_CRIT, "
            "PK_WORDS = PK_CRIT + 5 };") in victim
    for name in ("agg_i64", "agg_f64", "agg_u8"):
        assert name not in PK._PREEMPT_PTRS
    assert list(_build.QUERIES["preempt_scan"]) == ["preempt_scan_occupancy"]


# ---------------------------------------------------------------------------
# the pick as the kernel splits it, against JAX's `_pick_one_node`
# ---------------------------------------------------------------------------
def _crit(agg, j):
    """The five criteria of row j as JAX converts them to float64."""
    return (float(agg["viol_ct"][j]), float(agg["first_prio"][j]),
            float(agg["sum_prio"][j]), float(agg["nv"][j]),
            -float(agg["earliest_high"][j]))


NONE = (None, None)


def _before(a, b):
    """Whether best candidate a = (criteria, (rank, row)) comes before b:
    the criteria with IEEE < and ==, then (rank, row)."""
    if a[1] is None:
        return False
    if b[1] is None:
        return True
    for x, y in zip(a[0], b[0]):
        if x < y:
            return True
        if not x == y:
            return False
    return a[1] < b[1]


def _comb(a, b):
    """Two records (zero, best) combined: the lowest zero-victim (rank,
    row), the best candidate."""
    za, zb = a[0], b[0]
    z = zb if za is None or (zb is not None and zb < za) else za
    return (z, b[1] if _before(b[1], a[1]) else a[1])


def model_pick(feas0, agg, rank, blocks):
    """The kernel's pick: node j is in group j // 32, which is warp (j //
    32) % (blocks x WARPS)'s, its block that warp's; each block folds its
    nodes into a record of the lowest
    zero-victim (rank, row) and the best (criteria, (rank, row)); the
    records combine in reverse block order (any order gives the same)."""
    recs = [(None, NONE)] * blocks
    for j in range(len(feas0)):
        if not feas0[j]:
            continue
        b = _block_of(len(feas0), blocks)[j]
        key = (int(rank[j]), j)
        z = key if agg["nv"][j] == 0 else None
        recs[b] = _comb(recs[b], (z, (_crit(agg, j), key)))
    total = (None, NONE)
    for r in reversed(recs):
        total = _comb(total, r)
    if total[1][1] is None:
        return -1
    return total[0][1] if total[0] is not None else total[1][1][1]


def _block_of(n, blocks):
    """The block of each of n nodes in a grid of `blocks` K7 blocks: 32
    consecutive nodes a warp, the groups dealt to the warps in turn."""
    return ((np.arange(n) // 32) % (blocks * WARPS)) // WARPS


def _pick_world(case, blocks, n=1000, seed=0):
    """(feas0, aggregates, order_rank) of a designed pick over a grid of
    `blocks` blocks."""
    rng = np.random.default_rng(seed)
    feas0 = rng.random(n) < 0.7
    agg = {"nv": rng.integers(1, 4, n), "viol_ct": rng.integers(0, 2, n),
           "first_prio": rng.integers(0, 3, n),
           "sum_prio": rng.integers(0, 3, n) + (1 << 31),
           "earliest_high": rng.integers(1, 4, n).astype(float)}
    rank = rng.permutation(n).astype(np.int64)
    if case == "five-criteria ties":
        # every candidate ties through all five criteria: the rank decides
        for k in agg:
            agg[k][:] = agg[k][0]
    if case == "duplicate ranks":
        for k in agg:
            agg[k][:] = agg[k][0]
        rank = rng.integers(0, 12, n).astype(np.int64)
    if case == "zero victims in the last block only":
        # the last few nodes of the grid's last block that holds nodes
        # (a grid of more blocks leaves some without), ranked behind the
        # rest: the zero-victim rows win all the same
        block = _block_of(n, blocks)
        last = np.flatnonzero(block == block.max())[-6:]
        feas0[last] = True
        agg["nv"][last] = 0
        rank[last] = n + np.arange(len(last))    # ranked behind the rest
    if case == "+inf starts":
        agg["earliest_high"][rng.random(n) < 0.6] = np.inf
        agg["first_prio"][:] = 0
        agg["viol_ct"][:] = 0
        agg["sum_prio"][:] = 1 << 31
        agg["nv"][:] = 1
    if case == "no candidate":
        feas0[:] = False
    agg = {k: v.astype(np.float64 if k == "earliest_high" else np.int64)
           for k, v in agg.items()}
    return feas0, agg, rank


PICK_CASES = ["random", "five-criteria ties", "duplicate ranks",
              "zero victims in the last block only", "+inf starts",
              "no candidate"]


@pytest.mark.parametrize("blocks", [1, 3, 17, 125])
@pytest.mark.parametrize("case", PICK_CASES)
def test_blockwise_pick_matches_jax(case, blocks):
    feas0, agg, rank = _pick_world(case, blocks,
                                   seed=PICK_CASES.index(case))
    want = int(JK._pick_one_node(jnp.asarray(feas0),
                                 {k: jnp.asarray(v) for k, v in agg.items()},
                                 jnp.asarray(rank)))
    assert model_pick(feas0, agg, rank, blocks) == want
    got = PK._pick_one_node_plain(torch.as_tensor(feas0),
                                  {k: torch.as_tensor(v)
                                   for k, v in agg.items()},
                                  torch.as_tensor(rank))
    assert got == want
    if case == "no candidate":
        assert want == -1
    block = _block_of(len(feas0), blocks)
    if case == "zero victims in the last block only":
        assert agg["nv"][want] == 0 and block[want] == block.max()
        assert (agg["nv"][feas0 & (block != block.max())] > 0).all()
    if case in ("duplicate ranks", "five-criteria ties"):
        # the lowest rank, and the lowest row among the nodes that hold it
        cand = np.flatnonzero(feas0)
        low = rank[cand].min()
        assert want == cand[rank[cand] == low][0]
    if case == "duplicate ranks":
        tied = cand[rank[cand] == low]
        assert len(tied) > 1
        if blocks > 1:
            assert len(set(block[tied].tolist())) > 1


# ---------------------------------------------------------------------------
# the plain K7 against JAX's `preemption_scan` on the designed worlds
# ---------------------------------------------------------------------------
SCAN_CASES = ["five-criteria ties", "duplicate ranks",
              "zero victim in the last block only", "+inf starts",
              "no candidate", "ragged n_real"]


def _scan_world(case, P):
    """A preemption world of 520 node slots: rows alike where the pick
    must tie, one roomy node at the end for the zero-victim case."""
    rng = np.random.default_rng(500 + SCAN_CASES.index(case) + P)
    n_pad, n_real = 520, 517
    if case == "ragged n_real":
        n_real = 333
    vic = rand_victims(rng, n_pad, P, starts_inf=case == "+inf starts")
    nodes = victim_nodes(rng, vic, n_pad, n_real)
    # every node full on cpu: a candidate has victims
    nodes["req_cpu"] = np.maximum(nodes["req_cpu"], nodes["alloc_cpu"])
    feas = rng.random(n_pad) < 0.85
    rank = np.full(n_pad, 1 << 30, np.int64)
    cand = rng.permutation(n_pad)[:400]
    rank[cand] = np.arange(400)
    if case in ("five-criteria ties", "duplicate ranks"):
        # every node a copy of row 3: the pick ties through all five
        # criteria and falls to the rank, then the row
        for k in vic:
            vic[k] = np.ascontiguousarray(np.repeat(vic[k][3:4], n_pad, 0))
        for k in nodes:
            if k != "valid":
                nodes[k] = np.ascontiguousarray(
                    np.repeat(nodes[k][3:4], n_pad, 0))
        nodes["req_cpu"][:] = nodes["alloc_cpu"][0]
    if case == "duplicate ranks":
        rank = rng.integers(0, 9, n_pad).astype(np.int64)
    if case == "zero victim in the last block only":
        # one roomy node, in the last block of the kernel's grid here
        j = n_real - 1
        nodes["req_cpu"][j] = 0
        nodes["alloc_cpu"][j] = 64000
        for k in ("req_mem", "req_eph", "pod_count"):
            nodes[k][j] = 0
        nodes["allowed_pods"][j] = 110
        feas[j] = True
    if case == "no candidate":
        feas[:] = False
    pod = {"req_cpu": np.int64(900), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI)}
    return nodes, vic, pod, feas, rank, n_real


@pytest.mark.parametrize("P", [16, 128])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_plain_k7_matches_jax(case, P):
    nodes, vic, pod, feas, rank, n_real = _scan_world(case, P)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    want = np.asarray(JK.preemption_scan(
        jn, jv, pod, jnp.asarray(feas), jnp.asarray(rank), n_real, True,
        True, 6))
    got = PK.preemption_scan_plain(pn, vic, pod, feas, rank, n_real, True,
                                   True, 6)
    assert got.dtype == torch.int32 and got.shape == (3 + P,)
    assert_same(got, want, case)
    w = int(want[0])
    if case == "no candidate":
        assert w == -1 and not want[1:].any()
    else:
        assert 0 <= w < n_real
    if case in ("five-criteria ties", "duplicate ranks"):
        c = np.flatnonzero(feas[:n_real])
        low = rank[c].min()
        assert w == c[rank[c] == low][0]
        if case == "duplicate ranks":
            assert (rank[c] == low).sum() > 1
    if case == "zero victim in the last block only":
        assert w == n_real - 1 and want[1] == 0
    if case == "+inf starts":
        assert want[1] > 0
