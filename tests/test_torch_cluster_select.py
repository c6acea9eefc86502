"""The cluster geometry of the mesh selects K10b / K11b, and the sharded
scan and fused window at a ragged n_pad, against JAX.

K10b (`shard_scan_select`) and K11b (`shard_segments_select`) run one
step's select across a thread-block cluster: block q owns the node slice
[q * span, (q + 1) * span) and stages its slots of the gathered shard
records in shared memory, or in global memory past what shared memory
holds (`select_plan`). This file pins the planner, and
holds the sharded scan (`sharded_scan`: the plain K10a / K10b with the
all-gather between them) and the sharded fused window (`sharded_segments`:
the plain K11a / K11b) on 2- and 4-shard CPU meshes against JAX's
single-device `schedule_batch` / `schedule_batch_segments` on the same
numpy inputs, at an n_pad that is no multiple of the span and whose shard
boundaries are not the plan's block boundaries, with the walk start, the
winners and the tied nodes in different blocks (identity, perm and pos
walks, the carried spread, a gang rewind). Those are the inputs
`chip_smoke.py` then holds the kernels against on the card.
Tolerance: exact equality (every output is an integer).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from tests.test_torch_cluster_plan import (
    N_PAD, N_REAL, OPEN, SCAN_MODES, Z_PAD, _nodes, _pod, _port_kw,
    _rotations, _same, _stack)

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
#: a select's fixed tables at z_pad 4, counted by hand from the layout of
#: csrc/cluster_cycle.cuh: K5's 3,392 B and the step state's 128
SELECT_FIXED = 3392 + 128
#: a select's bytes a node slot: score 8, prefix / flags / tie slot 12,
#: the staged record's zone 4, five int64 planes 40, tracked and feasible 2
SELECT_PER_SLOT = 66
#: the same with the records staged in global memory: score, prefix,
#: flags and tie slot only
GLOBAL_PER_SLOT = 20


def test_select_plan_one_slot_a_thread_at_16384():
    plan = PK.select_plan(16384, 4)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident) == (16, 1,
                                                                   True)
    assert plan.span == 1024 and plan.span * plan.blocks == 16384
    assert plan.smem_bytes == SELECT_FIXED + 1024 * SELECT_PER_SLOT
    assert plan.smem_bytes == PK.cluster_smem_bytes(1024, 0, 4, False, True,
                                                    records=True)
    assert plan.geometry()[:] == [16, 1, 1, plan.smem_bytes, 0]


def test_select_plan_two_slots_a_thread_at_32768():
    plan = PK.select_plan(32768, 4)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident) == (16, 2,
                                                                   True)
    assert plan.smem_bytes == SELECT_FIXED + 2048 * SELECT_PER_SLOT
    assert plan.smem_bytes <= PK.SMEM_CAP
    # the zone tables grow with z_pad: two int64 of each partial record and
    # three of the cluster's / gang's tables a zone
    assert PK.select_plan(32768, 12).smem_bytes == plan.smem_bytes + 8 * (
        2 * 2 * 8 + 3 * 8)


def test_select_plan_half_cluster_and_ragged_axis():
    half = PK.select_plan(16384, 4, blocks=8)
    assert (half.blocks, half.nodes_per_thread, half.span) == (8, 2, 2048)
    assert half.smem_bytes == PK.select_plan(32768, 4).smem_bytes
    ragged = PK.select_plan(N_PAD, Z_PAD)
    assert (ragged.nodes_per_thread, ragged.span) == (1, 1024)
    # blocks 3-15 own no node; block 2 owns 52 of its 1,024 slots
    assert N_PAD // ragged.span == 2 and N_PAD % ragged.span == 52


def test_select_plan_stages_records_in_global_memory_past_the_cap():
    """Past 49,152 slots at 16 blocks (24,576 at 8) the staged records no
    longer fit beside the scratch: they go to global memory, and a block
    keeps 20 B a slot."""
    staged = PK.select_plan(49152, 4)
    assert (staged.nodes_per_thread, staged.resident) == (3, True)
    assert staged.smem_bytes == SELECT_FIXED + 3072 * SELECT_PER_SLOT
    assert staged.smem_bytes <= PK.SMEM_CAP
    past = PK.select_plan(49153, 4)
    assert (past.blocks, past.nodes_per_thread, past.resident) == (16, 4,
                                                                  False)
    assert past.smem_bytes == SELECT_FIXED + 4096 * GLOBAL_PER_SLOT
    assert past.geometry()[:] == [16, 4, 0, past.smem_bytes, 0]
    half = PK.select_plan(32768, 4, blocks=8)
    assert (half.blocks, half.nodes_per_thread, half.resident) == (8, 4,
                                                                  False)
    assert SELECT_FIXED + 4096 * SELECT_PER_SLOT > PK.SMEM_CAP
    assert PK.select_plan(24576, 4, blocks=8).resident


def test_select_plan_raises_past_the_cap():
    assert PK.select_plan(180224, 4).nodes_per_thread == 11
    assert PK.select_plan(180224, 4).smem_bytes == (SELECT_FIXED + 11264
                                                    * GLOBAL_PER_SLOT)
    assert not PK.select_plan(180224, 4).global_scratch
    # one slot more: the scratch moves to the global workspace, and a
    # block keeps only the fixed part
    far = PK.select_plan(180225, 4)
    assert (far.nodes_per_thread, far.resident, far.global_scratch) == (
        12, False, True)
    assert far.smem_bytes == SELECT_FIXED
    assert far.workspace_bytes == 16 * 12 * 1024 * GLOBAL_PER_SLOT
    with pytest.raises(ValueError, match="over 232448"):
        PK.select_plan(16384, 8192)
    with pytest.raises(ValueError):
        PK.select_plan(16384, 4, blocks=17)
    with pytest.raises(ValueError):
        PK.select_plan(16384, 4, blocks=0)


# ---------------------------------------------------------------------------
# the sharded scan and fused window against JAX where the plan's blocks
# meet
# ---------------------------------------------------------------------------
def _blocks(nodes):
    span = PK.select_plan(N_PAD, Z_PAD).span
    return {int(j) // span for j in nodes if j >= 0}


def _whole(x):
    """Per-shard rows or spread slices as whole vectors."""
    if isinstance(x, list) and isinstance(x[0], dict):
        return {k: torch.cat([r[k] for r in x]) for k in x[0]}
    if isinstance(x, list):
        return torch.cat(x)
    return x


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", sorted(SCAN_MODES))
def test_sharded_scan_across_select_blocks(mode, d):
    """K10a / K10b per live pod on d shards of 2,100 rows (shard boundaries
    at multiples of 1,050 or 525, the select's blocks at 1,024): the walk
    starts in one block, the feasible nodes tie across blocks 0-2 and the
    winners land in several of them; skip pods pad the window."""
    li, lni, ntf, extra = SCAN_MODES[mode]
    jn, pn = _nodes(1)
    pods = [_pod(1500) for _ in range(12)] + [dict(_pod(1500),
                                                   skip=np.bool_(True))] * 4
    kw = {}
    if extra in ("perm", "pos"):
        perms, inv, oid = _rotations(2)
        kw = {"rotation": (perms, inv, oid)} if extra == "perm" \
            else {"rotation_pos": (inv, oid)}
    if extra == "spread":
        kw = {"spread0": (np.arange(N_PAD) % 5).astype(np.int64)}
    stacked = _stack(pods)
    want = JK.schedule_batch(jn, {k: jnp.asarray(v) for k, v in
                                  stacked.items()}, li, lni, ntf, N_REAL,
                             Z_PAD, **kw)
    mesh = PS.Mesh(["cpu"] * d)
    steps = obs.get("steps.burst_scan")
    got = PK.schedule_batch(PS.shard_node_arrays(mesh, pn), stacked, li, lni,
                            ntf, N_REAL, Z_PAD, mesh=mesh, **_port_kw(kw))
    assert obs.get("steps.burst_scan") - steps == 12   # one a live pod
    rows = _whole(got[0])
    for k in want[0]:
        _same(rows[k], want[0][k], k)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    _same(_whole(got[3]), want[3], "spread")
    for k in want[4]:
        _same(got[4][k], want[4][k], k)
    sel = np.asarray(want[4]["selected"])[:12]
    assert (sel >= 0).all()
    assert len(_blocks(sel)) >= 2
    assert len(_blocks(OPEN)) == 3


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("walk", ["axis", "perm", "pos"])
def test_sharded_segments_rewind_across_select_blocks(walk, d):
    """K11a / K11b per pod on d shards: a singleton run, a gang of 3-CPU
    pods that places a member on each of the 35 open nodes (in blocks 0-2
    and on every shard) and rewinds when the next finds none, then a run
    that lands where the gang was."""
    jn, pn = _nodes(3)
    small = _pod(500)
    wide = _pod(3000)
    layout = [(small, 4, False), (wide, 40, True), (small, 6, False)]
    pods, seg, gang = [], [], []
    for spec, length, g in layout:
        for i in range(length):
            pods.append(spec)
            seg.append(i == 0)
            gang.append(g)
    n_pods = len(pods)
    B = n_pods + 2
    pods += [dict(small, skip=np.bool_(True))] * 2
    seg += [True, False]
    gang += [False, False]
    seg, gang = np.array(seg), np.array(gang)
    kw = {}
    if walk != "axis":
        perms, inv, _ = _rotations(4)
        oid = np.random.default_rng(5).integers(0, 4, B).astype(np.int32)
        kw = {"rotation": (perms, inv, oid)} if walk == "perm" \
            else {"rotation_pos": (inv, oid)}
    stacked = _stack(pods)
    args = (seg, gang, n_pods, 2040, 9, N_REAL, N_REAL, Z_PAD)
    want = JK.schedule_batch_segments(
        jn, {k: jnp.asarray(v) for k, v in stacked.items()}, *args, **kw)
    mesh = PS.Mesh(["cpu"] * d)
    got = PK.schedule_batch_segments(PS.shard_node_arrays(mesh, pn), stacked,
                                     *args, mesh=mesh, **_port_kw(kw))
    rows = _whole(got[0])
    for k in want[0]:
        _same(rows[k], want[0][k], k)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    _same(got[4], want[4], "packed")
    sel = np.asarray(want[4])[:B]
    placed = sel[4:44][sel[4:44] >= 0]
    assert len(placed) == len(OPEN) and len(_blocks(placed)) == 3
    assert len({int(j) // (N_PAD // d) for j in placed}) == d
    assert (sel[4 + len(OPEN): 44] < 0).all()
    assert int(np.asarray(want[0]["pod_count"])[OPEN].sum()) == 10
