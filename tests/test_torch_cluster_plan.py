"""The cluster geometry of K5 / K6, and their plain versions at ragged n_pad.

K5 (`schedule_batch`) and K6 (`schedule_batch_segments`) run one pod's
cycle across a thread-block cluster: block q owns the node slice
[q * span, (q + 1) * span), and the node rows stay in the blocks' shared
memory when they fit (`cluster_plan`). This file pins the planner, and
holds the plain versions against JAX's `schedule_batch` /
`schedule_batch_segments` at n_pad values that are not multiples of the
span, with the walk start, the winners and the tied nodes in different
blocks of the plan (identity, perm and pos walks; a gang rewind). Those
are the inputs `chip_smoke.py` then holds the kernels against on the card.
Tolerance: exact equality (every output is an integer).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu_torch.ops import kernels as PK
from tests.torch_threads import one_torch_thread  # noqa: F401


GI, MI = 1024 ** 3, 1024 ** 2


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
def test_plan_resident_one_slot_a_thread_at_16384():
    plan = PK.cluster_plan(16384, 0, 4, False)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident) == (16, 1,
                                                                   True)
    assert plan.span * plan.blocks == 16384
    assert plan.blocks * PK.CLUSTER_THREADS == 16384
    assert plan.smem_bytes <= PK.SMEM_CAP == 232448
    # the layout of csrc/cluster_cycle.cuh, counted by hand: 3,392 B of
    # fixed tables and 105 B a node slot (score 8, prefix / flags / tie
    # slot 12, ten int64 rows 80, zone 4, valid 1)
    assert plan.smem_bytes == 3392 + 1024 * 105
    assert plan.geometry()[:] == [16, 1, 1, plan.smem_bytes, 0]
    assert not plan.global_scratch and plan.workspace_bytes == 0


def test_plan_resident_with_the_carried_spread_and_scalars():
    spread = PK.cluster_plan(16384, 0, 4, True)
    assert spread.resident and spread.smem_bytes <= PK.SMEM_CAP
    assert spread.smem_bytes == PK.cluster_plan(16384, 0, 4,
                                                False).smem_bytes + 8 * 1024
    scal = PK.cluster_plan(16384, 2, 8, True)
    assert scal.resident and scal.smem_bytes <= PK.SMEM_CAP
    assert scal.smem_bytes == PK.cluster_smem_bytes(1024, 2, 8, True, True)


@pytest.mark.parametrize("n_pad,S", [(16384, 64), (65536, 0), (40000, 2)])
def test_plan_global_rows_past_the_cap(n_pad, S):
    plan = PK.cluster_plan(n_pad, S, 4, False)
    assert not plan.resident
    assert PK.cluster_smem_bytes(plan.span, S, 4, False, True) > PK.SMEM_CAP
    assert plan.smem_bytes <= PK.SMEM_CAP
    assert plan.span * plan.blocks >= n_pad
    assert (plan.nodes_per_thread - 1) * PK.CLUSTER_THREADS * 16 < n_pad


def test_plan_half_cluster_and_limits():
    half = PK.cluster_plan(16384, 0, 4, False, blocks=8)
    assert (half.nodes_per_thread, half.span, half.resident) == (2, 2048,
                                                                 True)
    small = PK.cluster_plan(1500, 0, 4, False)
    assert small.nodes_per_thread == 1 and small.resident
    with pytest.raises(ValueError):
        PK.cluster_plan(16384, 0, 4, False, blocks=17)
    # past what shared memory holds beside the rows in global memory, the
    # scratch moves to the global workspace: a block keeps only the fixed
    # part in shared memory
    far = PK.cluster_plan(4_000_000, 0, 4, False)
    assert far.global_scratch and not far.resident
    assert far.smem_bytes == PK.cluster_smem_bytes(0, 0, 4, False, False)
    assert far.smem_bytes == PK.cluster_smem_bytes(
        far.span, 0, 4, False, False, global_scratch=True) == 3392
    assert far.workspace_bytes == far.blocks * far.span * 20
    # only a zone table too large for the fixed part still raises
    with pytest.raises(ValueError, match="over 232448"):
        PK.cluster_plan(16384, 0, 8192, False)


# ---------------------------------------------------------------------------
# the third placement: the per-slot scratch in a global workspace
# ---------------------------------------------------------------------------
#: (planner, n_pad, blocks, S, z_pad, carry_spread, (blocks, slots a
#: thread, resident, shared bytes)) as the planners gave them before the
#: third placement: every plan up to n_pad 131,072 on 16 blocks and 65,536
#: on 8 stays as it was, field for field, with its scratch in shared memory
PLANS_BEFORE = [
    ("cluster", 1024, 16, 0, 4, False, (16, 1, True, 110912)),
    ("cluster", 1024, 16, 2, 4, True, (16, 1, True, 151872)),
    ("cluster", 1024, 16, 1, 8, False, (16, 1, True, 127520)),
    ("pressure", 1024, 16, 1, 4, False, (1, 1, True, 202048)),
    ("pressure", 1024, 16, 2, 8, False, (1, 1, True, 218656)),
    ("select", 1024, 16, 0, 4, False, (16, 1, True, 71104)),
    ("select", 1024, 16, 0, 8, False, (16, 1, True, 71328)),
    ("cluster", 1024, 8, 0, 4, False, (8, 1, True, 110912)),
    ("cluster", 1024, 8, 2, 4, True, (8, 1, True, 151872)),
    ("cluster", 1024, 8, 1, 8, False, (8, 1, True, 127520)),
    ("pressure", 1024, 8, 1, 4, False, (1, 1, True, 202048)),
    ("pressure", 1024, 8, 2, 8, False, (1, 1, True, 218656)),
    ("select", 1024, 8, 0, 4, False, (8, 1, True, 71104)),
    ("select", 1024, 8, 0, 8, False, (8, 1, True, 71328)),
    ("cluster", 16384, 16, 0, 4, False, (16, 1, True, 110912)),
    ("cluster", 16384, 16, 2, 4, True, (16, 1, True, 151872)),
    ("cluster", 16384, 16, 1, 8, False, (16, 1, True, 127520)),
    ("pressure", 16384, 16, 1, 4, False, (16, 1, True, 202048)),
    ("pressure", 16384, 16, 2, 8, False, (16, 1, True, 218656)),
    ("select", 16384, 16, 0, 4, False, (16, 1, True, 71104)),
    ("select", 16384, 16, 0, 8, False, (16, 1, True, 71328)),
    ("cluster", 16384, 8, 0, 4, False, (8, 2, True, 218432)),
    ("cluster", 16384, 8, 2, 4, True, (8, 2, False, 44352)),
    ("cluster", 16384, 8, 1, 8, False, (8, 2, False, 44576)),
    ("pressure", 16384, 8, 1, 4, False, (8, 2, False, 44352)),
    ("pressure", 16384, 8, 2, 8, False, (8, 2, False, 44576)),
    ("select", 16384, 8, 0, 4, False, (8, 2, True, 138688)),
    ("select", 16384, 8, 0, 8, False, (8, 2, True, 138912)),
    ("cluster", 2100, 16, 0, 4, False, (16, 1, True, 110912)),
    ("cluster", 2100, 16, 2, 4, True, (16, 1, True, 151872)),
    ("cluster", 2100, 16, 1, 8, False, (16, 1, True, 127520)),
    ("pressure", 2100, 16, 1, 4, False, (3, 1, True, 202048)),
    ("pressure", 2100, 16, 2, 8, False, (3, 1, True, 218656)),
    ("select", 2100, 16, 0, 4, False, (16, 1, True, 71104)),
    ("select", 2100, 16, 0, 8, False, (16, 1, True, 71328)),
    ("cluster", 2100, 8, 0, 4, False, (8, 1, True, 110912)),
    ("cluster", 2100, 8, 2, 4, True, (8, 1, True, 151872)),
    ("cluster", 2100, 8, 1, 8, False, (8, 1, True, 127520)),
    ("pressure", 2100, 8, 1, 4, False, (3, 1, True, 202048)),
    ("pressure", 2100, 8, 2, 8, False, (3, 1, True, 218656)),
    ("select", 2100, 8, 0, 4, False, (8, 1, True, 71104)),
    ("select", 2100, 8, 0, 8, False, (8, 1, True, 71328)),
    ("cluster", 65536, 16, 0, 4, False, (16, 4, False, 85312)),
    ("cluster", 65536, 16, 2, 4, True, (16, 4, False, 85312)),
    ("cluster", 65536, 16, 1, 8, False, (16, 4, False, 85536)),
    ("pressure", 65536, 16, 1, 4, False, (16, 4, False, 85312)),
    ("pressure", 65536, 16, 2, 8, False, (16, 4, False, 85536)),
    ("select", 65536, 16, 0, 4, False, (16, 4, False, 85440)),
    ("select", 65536, 16, 0, 8, False, (16, 4, False, 85664)),
    ("cluster", 65536, 8, 0, 4, False, (8, 8, False, 167232)),
    ("cluster", 65536, 8, 2, 4, True, (8, 8, False, 167232)),
    ("cluster", 65536, 8, 1, 8, False, (8, 8, False, 167456)),
    ("pressure", 65536, 8, 1, 4, False, (8, 8, False, 167232)),
    ("pressure", 65536, 8, 2, 8, False, (8, 8, False, 167456)),
    ("select", 65536, 8, 0, 4, False, (8, 8, False, 167360)),
    ("select", 65536, 8, 0, 8, False, (8, 8, False, 167584)),
    ("cluster", 131072, 16, 0, 4, False, (16, 8, False, 167232)),
    ("cluster", 131072, 16, 2, 4, True, (16, 8, False, 167232)),
    ("cluster", 131072, 16, 1, 8, False, (16, 8, False, 167456)),
    ("pressure", 131072, 16, 1, 4, False, (16, 8, False, 167232)),
    ("pressure", 131072, 16, 2, 8, False, (16, 8, False, 167456)),
    ("select", 131072, 16, 0, 4, False, (16, 8, False, 167360)),
    ("select", 131072, 16, 0, 8, False, (16, 8, False, 167584)),]


def _plan(kind, n_pad, blocks, S, z_pad, spread):
    if kind == "cluster":
        return PK.cluster_plan(n_pad, S, z_pad, spread, blocks=blocks)
    if kind == "pressure":
        return PK.pressure_plan(n_pad, S, z_pad, blocks=blocks)
    return PK.select_plan(n_pad, z_pad, blocks=blocks)


@pytest.mark.parametrize("kind,n_pad,blocks,S,z_pad,spread,before",
                         PLANS_BEFORE)
def test_plans_up_to_the_old_ceiling_are_unchanged(kind, n_pad, blocks, S,
                                                   z_pad, spread, before):
    plan = _plan(kind, n_pad, blocks, S, z_pad, spread)
    assert plan == PK.ClusterPlan(*before)
    assert not plan.global_scratch and plan.workspace_bytes == 0
    assert plan.geometry()[:] == [before[0], before[1], int(before[2]),
                                  before[3], 0]


@pytest.mark.parametrize("kind,S,z_pad,spread", [
    ("cluster", 0, 4, False), ("cluster", 2, 8, True),
    ("pressure", 1, 4, False), ("select", 0, 4, False)])
@pytest.mark.parametrize("n_pad,blocks", [(262144, 16), (131072, 8)])
def test_plans_past_the_old_ceiling_keep_the_scratch_in_global_memory(
        kind, S, z_pad, spread, n_pad, blocks):
    plan = _plan(kind, n_pad, blocks, S, z_pad, spread)
    # 16 slots a thread, every block owning nodes; rows (records) and
    # scratch both in global memory
    assert (plan.blocks, plan.nodes_per_thread, plan.resident,
            plan.global_scratch) == (blocks, 16, False, True)
    assert plan.span * plan.blocks == n_pad
    fixed = PK.cluster_smem_bytes(0, S, z_pad, spread, False,
                                  records=kind == "select",
                                  pressure=kind == "pressure")
    assert plan.smem_bytes == fixed <= PK.SMEM_CAP
    assert plan.workspace_bytes == blocks * plan.span * 20 == n_pad * 20
    assert plan.geometry()[:] == [blocks, 16, 0, fixed, 1]
    # the second placement would not have fitted
    assert PK.cluster_smem_bytes(plan.span, S, z_pad, spread, False,
                                 records=kind == "select",
                                 pressure=kind == "pressure") > PK.SMEM_CAP


@pytest.mark.parametrize("kind", ["cluster", "pressure", "select"])
def test_every_n_pad_gets_a_plan(kind):
    for n_pad in (1, 1023, 131073, 180224, 180225, 262145, 1_000_000,
                  4_000_000):
        plan = _plan(kind, n_pad, 16, 1, 4, False)
        assert plan.span * plan.blocks >= n_pad
        assert plan.smem_bytes <= PK.SMEM_CAP
        # 11 slots a thread (20 B of scratch each) still fit beside the
        # fixed part; the twelfth does not
        assert plan.global_scratch == (n_pad > 11 * 16 * 1024)
    with pytest.raises(ValueError):
        _plan(kind, 16384, 17, 1, 4, False)


# ---------------------------------------------------------------------------
# the plain K5 / K6 against JAX where the plan's blocks meet
# ---------------------------------------------------------------------------
N_PAD, N_REAL, S_COUNT, Z_PAD = 2100, 2090, 2, 4
#: the only feasible nodes: around the span boundaries 1024 and 2048 of
#: the plan, one in block 0's head, the last real node
OPEN = [5] + list(range(1016, 1032)) + [1500] + list(range(2040, 2056)) \
    + [2089]


def _nodes(seed):
    """bench-shaped nodes, all full (pod_count at allowed) but OPEN, whose
    rows are identical: their scores tie across the plan's blocks."""
    rng = np.random.default_rng(seed)
    n = N_PAD
    pod_count = np.full(n, 110, np.int64)
    pod_count[OPEN] = 0
    host = {
        "valid": np.arange(n) < N_REAL,
        "alloc_cpu": np.full(n, 4000, np.int64),
        "alloc_mem": np.full(n, 32 * GI, np.int64),
        "alloc_eph": np.full(n, 50 * GI, np.int64),
        "allowed_pods": np.full(n, 110, np.int64),
        "req_cpu": np.zeros(n, np.int64), "req_mem": np.zeros(n, np.int64),
        "req_eph": np.zeros(n, np.int64), "nz_cpu": np.zeros(n, np.int64),
        "nz_mem": np.zeros(n, np.int64), "pod_count": pod_count,
        "alloc_scalar": np.full((n, S_COUNT), 8, np.int64),
        "req_scalar": rng.integers(0, 2, (n, S_COUNT)).astype(np.int64),
        "zone_id": (np.arange(n) % 3 + 1).astype(np.int32),
    }
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v.copy()) for k, v in host.items()})


def _pod(cpu, spread=False):
    one = np.ones(1, bool)
    pod = {"req_cpu": np.int64(cpu), "req_mem": np.int64(500 * MI),
           "req_eph": np.int64(0),
           "req_scalar": np.array([1, 0], np.int64),
           "has_request": np.bool_(True), "unknown_scalar": np.bool_(False),
           "skip": np.bool_(False), "check_resources": np.bool_(True),
           "nz_cpu": np.int64(cpu), "nz_mem": np.int64(500 * MI),
           "interpod_code": np.zeros(1, np.int8),
           "node_aff_counts": np.zeros(1, np.int64),
           "taint_counts": np.zeros(1, np.int64),
           "spread_counts": np.zeros(1, np.int64),
           "interpod_counts": np.zeros(1, np.int64),
           "interpod_tracked": np.zeros(1, bool),
           "image_sums": np.zeros(1, np.int64),
           "prefer_avoid": np.full(1, 10, np.int64),
           "upd_cpu": np.int64(cpu), "upd_mem": np.int64(500 * MI),
           "upd_eph": np.int64(0),
           "upd_scalar": np.array([1, 0], np.int64)}
    for k in ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
              "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok"):
        pod[k] = one
    return pod


def _stack(pods):
    return {k: np.stack([p[k] for p in pods]) for k in pods[0]}


def _rotations(seed, orders=3):
    rng = np.random.default_rng(seed)
    perms = [np.arange(N_PAD)]
    for _ in range(orders):
        perms.append(np.concatenate([rng.permutation(N_REAL),
                                     np.arange(N_REAL, N_PAD)]))
    perms = np.stack(perms).astype(np.int32)
    inv = np.empty_like(perms)
    for i in range(len(perms)):
        inv[i, perms[i]] = np.arange(N_PAD, dtype=np.int32)
    oid = rng.integers(0, orders + 1, 16).astype(np.int32)
    return perms, inv, oid


def _port_kw(kw):
    out = {}
    for k, v in kw.items():
        if isinstance(v, tuple):
            out[k] = tuple(torch.as_tensor(np.asarray(x)) for x in v)
        elif isinstance(v, np.ndarray):
            out[k] = torch.as_tensor(v)
        else:
            out[k] = v
    return out


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _blocks(nodes):
    span = PK.cluster_plan(N_PAD, S_COUNT, Z_PAD, False).span
    return {int(j) // span for j in nodes if j >= 0}


SCAN_MODES = {
    # walk start in block 0 next to its end, a partial walk that stops in
    # block 1; ties in blocks 0, 1 and 2
    "identity": (1020, 2 ** 31 - 5, 20, {}),
    # the walk starts near the end of the real nodes and wraps
    "perm": (2080, 7, 30, "perm"),
    "pos": (1700, 3, N_REAL, "pos"),
    "spread": (1030, 11, N_REAL, "spread"),
}


@pytest.mark.parametrize("mode", sorted(SCAN_MODES))
def test_schedule_batch_plain_across_blocks(mode):
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
    got = PK.schedule_batch(pn, stacked, li, lni, ntf, N_REAL, Z_PAD,
                            **_port_kw(kw))
    for k in want[0]:
        _same(got[0][k], want[0][k], k)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    _same(got[3], want[3], "spread")
    for k in want[4]:
        _same(got[4][k], want[4][k], k)
    sel = np.asarray(want[4]["selected"])[:12]
    # three pods fit a node: the winners spread over several blocks, and
    # not only the walk start's
    assert (sel >= 0).all()
    assert len(_blocks(sel)) >= 2
    assert len(_blocks(OPEN)) == 3


@pytest.mark.parametrize("walk", ["axis", "perm", "pos"])
def test_schedule_batch_segments_plain_rewinds_across_blocks(walk):
    """A singleton run, a gang of 3-CPU pods that cannot all fit on the 35
    open nodes (one each) and rewinds after placing members in every
    block, then a run that lands where the gang was."""
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
    want = JK.schedule_batch_segments(
        jn, {k: jnp.asarray(v) for k, v in stacked.items()}, seg, gang,
        n_pods, 2040, 9, N_REAL, N_REAL, Z_PAD, **kw)
    got = PK.schedule_batch_segments(pn, stacked, seg, gang, n_pods, 2040,
                                     9, N_REAL, N_REAL, Z_PAD,
                                     **_port_kw(kw))
    for k in want[0]:
        _same(got[0][k], want[0][k], k)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    _same(got[4], want[4], "packed")
    sel = np.asarray(want[4])[:B]
    placed = sel[4:44][sel[4:44] >= 0]
    assert len(placed) == len(OPEN) and len(_blocks(placed)) == 3
    assert (sel[4 + len(OPEN): 44] < 0).all()
    # the rows after the window hold the two singleton runs only
    assert int(np.asarray(want[0]["pod_count"])[OPEN].sum()) == 10
