"""The cluster geometry of K2 (`schedule_cycle`), and the plain K2 against
JAX where the plan's blocks meet.

K2 runs one pod's cycle on one thread-block cluster: block q owns the node
slice [q * span, (q + 1) * span), only the blocks that own a node take
part, the rows stay in global memory (one pod reads each row once) and the
per-slot scratch lives in shared memory, past 180,224 slots on 16 blocks
in a global workspace (`cycle_plan`). This file pins the planner and the
wrapper's use of it; and holds the plain K2 (`schedule_cycle_plain`)
against JAX's `schedule_cycle` / `_cycle_core` on the same numpy inputs at
an n_pad that is no multiple of the span, with the walk start, the tied
nodes, the walk's cutoff and the winners in different blocks of the plan:
identity, perm and pos walks, with and without a nominated ghost, a weight
table, a skip pod, every output (the six scalars and the five per-node
outputs). Those are the inputs `chip_smoke.py` then holds the kernel
against on the card. Tolerance: exact equality (every output is an
integer or a bool).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from tests.test_torch_cluster_plan import (
    N_PAD, N_REAL, OPEN, S_COUNT, Z_PAD, _nodes, _pod, _rotations, _same)

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK
from tests.torch_threads import one_torch_thread  # noqa: F401


#: the fixed tables of a block at z_pad 4 (K5's, counted by hand from
#: csrc/cluster_cycle.cuh) and the scratch a node slot (score 8, prefix,
#: flags and tie slot 4 each)
FIXED = 3392
PER_SLOT = 20


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,blocks,want", [
    # (n_pad, blocks the planner may take, (blocks, slots a thread,
    # scratch in global memory))
    (16384, 16, (16, 1, False)),
    (16384, 8, (8, 2, False)),
    (32768, 16, (16, 2, False)),
    (32768, 8, (8, 4, False)),
    (180224, 16, (16, 11, False)),
    # twelve slots a thread: 15 blocks cover the axis
    (180225, 16, (15, 12, True)),
    (180225, 8, (8, 23, True)),
    (262144, 16, (16, 16, True)),
    (262144, 8, (8, 32, True)),
    (131072, 8, (8, 16, True)),
])
def test_cycle_plan_pins(n_pad, blocks, want):
    plan = PK.cycle_plan(n_pad, S_COUNT, 4, blocks)
    assert (plan.blocks, plan.nodes_per_thread, plan.global_scratch) == want
    # the rows are never staged: one pod reads each row once
    assert not plan.resident
    assert plan.span * plan.blocks >= n_pad
    per_slot = 0 if plan.global_scratch else PER_SLOT
    assert plan.smem_bytes == FIXED + plan.span * per_slot
    assert plan.smem_bytes <= PK.SMEM_CAP
    # the layout mirror: K5's layout without rows
    assert plan.smem_bytes == PK.cluster_smem_bytes(
        plan.span, S_COUNT, 4, False, False,
        global_scratch=plan.global_scratch)
    assert plan.workspace_bytes == (plan.blocks * plan.span * PER_SLOT
                                    if plan.global_scratch else 0)
    assert plan.geometry()[:] == [plan.blocks, plan.nodes_per_thread, 0,
                                  plan.smem_bytes, int(plan.global_scratch)]


@pytest.mark.parametrize("n_pad,blocks", [(1, 1), (1024, 1), (2100, 3),
                                          (4096, 4), (20000, 10)])
def test_cycle_plan_takes_the_blocks_that_own_nodes(n_pad, blocks):
    plan = PK.cycle_plan(n_pad, S_COUNT, Z_PAD)
    assert plan.blocks == blocks
    assert (plan.blocks - 1) * plan.span < max(n_pad, 1)
    assert PK.cycle_plan(n_pad, S_COUNT, Z_PAD, blocks=8).blocks <= min(
        blocks, 8)


def test_cycle_plan_ignores_scalar_resources_and_raises_past_the_cap():
    # no rows in shared memory: the scalar resources cost no bytes
    assert PK.cycle_plan(16384, 64, 4) == PK.cycle_plan(16384, 0, 4)
    assert PK.cycle_plan(16384, 2, 12).smem_bytes == PK.cycle_plan(
        16384, 2, 4).smem_bytes + 8 * (2 * 2 * 8 + 3 * 8)
    with pytest.raises(ValueError, match="over 232448"):
        PK.cycle_plan(16384, 2, 8192)
    for bad in (0, 17):
        with pytest.raises(ValueError):
            PK.cycle_plan(16384, 2, 4, blocks=bad)


def test_cycle_layout_and_slots_match_the_kernel():
    """K2's launch tables name `CycleArgs`' C enums one to one, its layout
    is K5's without rows, and it launches one cluster through the shared
    helpers with an occupancy query; the one-block `cycle_run` is gone."""
    from tests.test_torch_imports import _enum_slots
    src = (_build.CSRC / "schedule_cycle.cu").read_text()
    short = {"allowed_pods": "ALLOWED", "interpod_code": "IPA_CODE",
             "node_aff_counts": "NA", "taint_counts": "TT",
             "spread_counts": "SC", "interpod_counts": "IC",
             "image_sums": "IMG", "prefer_avoid": "PA",
             "interpod_tracked": "TRACKED"}
    for end, pre, host in (("CYI_COUNT", "CYI_", PK._CYCLE_INTS),
                           ("CYP_COUNT", "CYP_", PK._CYCLE_PTRS)):
        slots = _enum_slots(src, end)
        assert slots == [pre + short.get(h, h.upper()) for h in host]
    assert _enum_slots(src, "CO_COUNT") == [
        "CO_" + k.upper() for k in ("selected", "found", "evaluated",
                                    "max_score", "next_li", "next_lni")]
    assert len(PK._CYCLE_RESULTS) == 6
    # the pod's scalars share the scan tables' leading slots, skip among
    # them (`SC_SKIP`, csrc/cycle.cuh)
    assert "pd.scal[SC_SKIP]" in src
    cycle = (_build.CSRC / "cycle.cuh").read_text()
    assert PK._CYCLE_SCALARS.index("skip") == int(re.search(
        r"SC_SKIP = (\d+)", cycle).group(1))
    assert PK._SCAN_SCALARS[:len(PK._CYCLE_SCALARS)] == PK._CYCLE_SCALARS
    assert re.search(r"cluster_layout\(g\.npt \* NTHREADS, S, z_pad, false, "
                     r"false, false,\s*false, gscr\)", src)
    assert "<<<" not in src and "cluster_launch(" in src
    assert 'extern "C" int schedule_cycle_clusters(' in src
    assert "schedule_cycle" in PK.CLUSTER_KERNELS
    for name in ("cycle.cuh", "cluster_cycle.cuh", "shard_scan.cuh"):
        text = (_build.CSRC / name).read_text()
        assert "cycle_run(" not in text and "select_cycle(" not in text


class _Planned(Exception):
    pass


def _planned(monkeypatch, call):
    """The plans a CUDA wrapper asks `_cluster_geometry` for (at 16 and at
    8 blocks), caught before any launch."""
    seen = {}

    def geometry(name, plan_for):
        seen.update(name=name, plans=(plan_for(16), plan_for(8)))
        raise _Planned
    monkeypatch.setattr(PK, "_cluster_geometry", geometry)
    with pytest.raises(_Planned):
        call()
    return seen


def test_k2_wrapper_plans_with_cycle_plan(monkeypatch):
    """The K2 wrapper takes `cycle_plan` of its node axis, its scalar
    resources and z_pad (the tensors' device checks waived: the plan is
    asked before anything reaches a card)."""
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    _jn, pn = _nodes(1)
    pod = _pod(1500)
    seen = _planned(monkeypatch, lambda: PK._schedule_cycle_launch(
        pn, pod, 7, 3, 20, N_REAL, Z_PAD, dict(PK.DEFAULT_WEIGHTS), None,
        None, None, None, None))
    assert seen["name"] == "schedule_cycle"
    assert seen["plans"] == tuple(PK.cycle_plan(N_PAD, S_COUNT, Z_PAD, b)
                                  for b in (16, 8))


@pytest.mark.parametrize("n_pad,z_pad", [(2100, 4), (16384, 4),
                                         (262144, 8)])
def test_k13b_plans_as_k10b(monkeypatch, n_pad, z_pad):
    """K13b's step takes K10b's `select_plan`, the half-cluster fallback
    with it."""
    import types
    plan = types.SimpleNamespace(n_pad=n_pad, z_pad=z_pad)
    got = {}
    for name in ("shard_pressure_select", "shard_scan_select"):
        side = types.SimpleNamespace(_args={}, device=torch.device("cpu"))
        got[name] = _planned(monkeypatch, lambda: PK._select_cluster_launch(
            name, side, plan))
        assert got[name]["name"] == name
    assert got["shard_pressure_select"]["plans"] \
        == got["shard_scan_select"]["plans"] \
        == tuple(PK.select_plan(n_pad, z_pad, b) for b in (16, 8))
    assert "shard_pressure_select" in PK.SELECT_CLUSTER_KERNELS


# ---------------------------------------------------------------------------
# the plain K2 against JAX where the plan's blocks meet
# ---------------------------------------------------------------------------
CYCLE_OUT = ("selected", "found", "evaluated", "max_score", "total", "kept",
             "feasible", "fail_first", "general_bits", "next_last_index",
             "next_last_node_index")
#: (li, lni, num_to_find) of each walk: from block 1 with a cutoff that
#: falls in block 2, from block 0's end across its boundary, and a full
#: scan that wraps; pos is a full-scan mode
WALKS = {
    "identity": [(1500, 2 ** 33 + 5, 20), (1020, 3, 8), (2080, 11, N_REAL)],
    "perm": [(1500, 7, 20), (1020, 3, 8), (2080, 11, N_REAL)],
    "pos": [(1500, 7, N_REAL), (1020, 2 ** 31 - 5, N_REAL)],
}


def _blocks(rows):
    span = PK.cycle_plan(N_PAD, S_COUNT, Z_PAD).span
    return {int(j) // span for j in rows}


def _cycle_pod(cpu=1500):
    return {k: v for k, v in _pod(cpu).items() if not k.startswith("upd_")}


def _ghost():
    """A nominee's load on five OPEN rows in block 0 and two in block 2:
    the cnt makes the block-0 rows fail their pod count, the cpu leaves
    the block-2 rows feasible with less room."""
    g = {k: np.zeros(N_PAD, np.int64) for k in PK.GHOST_FIELDS}
    g["cnt"][OPEN[1:6]] = 110
    g["cpu"][OPEN[-3:-1]] = 1000
    return g


def _run(pn, jn, pod, walk, li, lni, ntf, ghost=None, **kw):
    jkw, pkw = {}, {}
    if walk != "identity":
        perms, inv, _ = _rotations(2)
        if walk == "perm":
            jkw = {"perm": jnp.asarray(perms[1]),
                   "inv_perm": jnp.asarray(inv[1])}
            pkw = {"perm": torch.as_tensor(perms[1]),
                   "inv_perm": torch.as_tensor(inv[1])}
        else:
            jkw = {"pos": jnp.asarray(inv[1])}
            pkw = {"pos": torch.as_tensor(inv[1])}
    if ghost is not None:
        jkw["ghost"] = {k: jnp.asarray(v) for k, v in ghost.items()}
        pkw["ghost"] = ghost
    weights = kw.get("weights", dict(JK.DEFAULT_WEIGHTS))
    if "wtab" in kw:
        jkw["wtab"] = jnp.asarray(kw["wtab"])
        pkw["wtab"] = torch.as_tensor(kw["wtab"])
    want = JK._cycle_core(jn, {k: jnp.asarray(v) for k, v in pod.items()},
                          li, lni, ntf, N_REAL, weights, Z_PAD, **jkw)
    got = PK.schedule_cycle_plain(pn, pod, li, lni, ntf, N_REAL, Z_PAD,
                                  weights=weights, **pkw)
    for k in CYCLE_OUT:
        _same(got[k], want[k], k)
    return got


def test_designed_world_spans_the_plans_blocks():
    plan = PK.cycle_plan(N_PAD, S_COUNT, Z_PAD)
    assert (plan.blocks, plan.span) == (3, 1024)
    assert _blocks(OPEN) == {0, 1, 2}
    assert _blocks([1500, 1020, 2080]) == {0, 1, 2}


@pytest.mark.parametrize("ghost", [False, True])
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_plain_k2_matches_jax_across_blocks(walk, ghost):
    """The OPEN rows are alike, so their scores tie across blocks 0-2; the
    walk starts in one block, its cutoff falls in another and the k-th
    tie (lni) lands in a third. With the ghost, block 0's open rows fail
    their pod count (the filter reads the ghost, the scores do not)."""
    jn, pn = _nodes(1)
    winners, kept = set(), set()
    for li, lni, ntf in WALKS[walk]:
        got = _run(pn, jn, _cycle_pod(), walk, li, lni, ntf,
                   _ghost() if ghost else None)
        assert int(got["found"]) > 0
        winners.add(int(got["selected"]))
        kept |= set(np.flatnonzero(got["kept"].numpy()).tolist())
        if ghost:
            assert not got["feasible"].numpy()[OPEN[1:6]].any()
    assert len(_blocks(winners)) >= 2
    assert len(_blocks(kept)) >= 2


def test_plain_k2_wtab_and_skip_match_jax():
    """A weight table row by profile id (one past the table clamps), and a
    skip pod: no node feasible, none evaluated, every per-node output as
    JAX's."""
    jn, pn = _nodes(2)
    rng = np.random.default_rng(2)
    wtab = rng.integers(0, 4, (3, len(JK.PRIORITY_AXIS))).astype(np.int64)
    union = {k: int(wtab[:, i].max())
             for i, k in enumerate(JK.PRIORITY_AXIS)}
    for pid in (0, 2, 5):
        pod = dict(_cycle_pod(), profile_id=np.int64(pid))
        _run(pn, jn, pod, "identity", 1500, 9, 20, weights=union, wtab=wtab)
    skip = dict(_cycle_pod(), skip=np.bool_(True))
    got = _run(pn, jn, skip, "identity", 1500, 9, 20, _ghost())
    assert int(got["found"]) == 0 and int(got["evaluated"]) == 0
    assert int(got["selected"]) == -1
    assert not got["feasible"].numpy().any()
