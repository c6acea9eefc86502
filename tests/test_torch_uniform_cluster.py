"""The cluster geometry of K3 (`uniform_burst`) and of K9b
(`shard_cycle_select`), and their plain versions against JAX where the
plan's blocks meet.

K3 runs a whole uniform burst on one thread-block cluster: block q owns
the node slice [q * span, (q + 1) * span), only the blocks that own a node
take part, the carried rows stay resident in shared memory for the whole
burst while they fit (else in global memory), and past that the scores,
bytes and tie lists move to a global workspace (`uniform_plan`). K9b runs
the sharded cycle's select on K10b's cluster plan (`select_plan`). This
file pins the planner, the kernel's layout and the wrappers' use of the
planners; and holds the plain K3 (`schedule_batch_uniform_plain`) against
JAX's `schedule_batch_uniform` on the same numpy inputs at an n_pad that
is no multiple of the span, so that the tie runs, the lanes' ranks and the
folds cross the plan's block edges (STAY and ELIM batches, a cut mid-batch,
`ban` with `extra_ok`, rotation with L = 3, F == 0 and a filled cluster),
and the plain K9b against JAX's sharded cycle with the walk start, the
ties and the winners in different blocks of the select's plan (identity,
perm and pos walks, inter-pod on). Those are the inputs `chip_smoke.py`
then holds the kernels against on the card. Tolerance: exact equality
(every output is an integer or a bool).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_cycle_cluster import _planned

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS

torch.set_num_threads(1)

GI, MI = 1024 ** 3, 1024 ** 2
#: a block's fixed tables (csrc/uniform_burst.cu `uniform_layout`, counted
#: by hand): the weight row 128, the warp slots of the reductions 256 and
#: of the scans 128, the block's record 32, its control block 64, block
#: 0's accepted lanes 4,096; then per order the tie offsets of 16 blocks
#: (64) and the block's list length (4)
FIXED = 128 + 256 + 128 + 32 + 64 + 4096
PER_ORDER = 16 * 4 + 4


def _fixed(L):
    return FIXED + PER_ORDER * max(L, 1)


def _slot(R, L, resident, gscr):
    """Bytes a node slot: the carried rows when resident, and unless the
    scratch is global its score (4), ok / banned / feasible bytes (3) and
    a tie-list slot an order (4)."""
    return (8 * R if resident else 0) + (0 if gscr else 7 + 4 * max(L, 1))


# ---------------------------------------------------------------------------
# K3's planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,R,L,blocks,want", [
    # (n_pad, carried rows, orders, blocks the planner may take, (blocks,
    # slots a thread, rows resident, scratch in global memory))
    (16384, 5, 0, 16, (16, 1, True, False)),
    (16384, 5, 0, 8, (8, 2, True, False)),
    (15001, 5, 0, 16, (15, 1, True, False)),
    (15001, 5, 0, 8, (8, 2, True, False)),
    (16384, 7, 4, 16, (16, 1, True, False)),
    # the switch from resident to global rows: four slots a thread hold
    # the rows, five do not
    (65536, 5, 0, 16, (16, 4, True, False)),
    (65537, 5, 0, 16, (13, 5, False, False)),
    (32768, 5, 0, 8, (8, 4, True, False)),
    (32769, 5, 0, 8, (7, 5, False, False)),
    # 262,144 slots: the rows in global memory, the scratch too where the
    # tie lists of four orders (or 32 slots a thread) do not fit
    (262144, 5, 0, 16, (16, 16, False, False)),
    (262144, 5, 4, 16, (16, 16, False, True)),
    (262144, 5, 0, 8, (8, 32, False, True)),
    (131072, 5, 4, 8, (8, 16, False, True)),
])
def test_uniform_plan_pins(n_pad, R, L, blocks, want):
    plan = PK.uniform_plan(n_pad, R, 2, L, blocks)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident,
            plan.global_scratch) == want
    assert plan.span * plan.blocks >= n_pad
    assert (plan.blocks - 1) * plan.span < n_pad
    assert plan.smem_bytes == _fixed(L) + plan.span * _slot(
        R, L, plan.resident, plan.global_scratch)
    assert plan.smem_bytes <= PK.SMEM_CAP
    # the layout mirror, and every earlier placement over the cap
    assert plan.smem_bytes == PK.uniform_smem_bytes(
        plan.span, R, L, plan.resident, plan.global_scratch)
    if not plan.resident:
        assert PK.uniform_smem_bytes(plan.span, R, L, True) > PK.SMEM_CAP
    if plan.global_scratch:
        assert PK.uniform_smem_bytes(plan.span, R, L, False) > PK.SMEM_CAP
    assert plan.workspace_bytes == (
        plan.blocks * plan.span * (7 + 4 * max(L, 1))
        if plan.global_scratch else 0)
    assert plan.geometry()[:] == [plan.blocks, plan.nodes_per_thread,
                                  int(plan.resident), plan.smem_bytes,
                                  int(plan.global_scratch)]


@pytest.mark.parametrize("n_pad,blocks", [(1, 1), (1024, 1), (2100, 3),
                                          (20000, 10)])
def test_uniform_plan_takes_the_blocks_that_own_nodes(n_pad, blocks):
    plan = PK.uniform_plan(n_pad, 5, 0, 0)
    assert plan.blocks == blocks
    assert (plan.blocks - 1) * plan.span < max(n_pad, 1)
    assert PK.uniform_plan(n_pad, 5, 0, 0, blocks=8).blocks <= min(blocks, 8)


def test_uniform_plan_every_n_pad_and_its_limits():
    # the static rows stay in global memory: NS costs no shared memory
    assert PK.uniform_plan(16384, 5, 0, 0) == PK.uniform_plan(16384, 5, 6, 0)
    # any node count gets a plan: only the fixed part is left in shared
    # memory, the rest in the workspace
    far = PK.uniform_plan(4_000_000, 5, 0, 4)
    assert far.global_scratch and not far.resident
    assert far.smem_bytes == _fixed(4) == PK.uniform_smem_bytes(0, 5, 4, False)
    assert far.workspace_bytes == far.blocks * far.span * 23
    # only a fixed part past the cap raises: the tie offsets of too many
    # rotation orders
    big_l = (PK.SMEM_CAP - FIXED) // PER_ORDER + 1
    with pytest.raises(ValueError, match="over 232448"):
        PK.uniform_plan(16384, 5, 0, big_l)
    assert PK.uniform_plan(16384, 5, 0, big_l - 1).global_scratch
    for bad in (0, 17):
        with pytest.raises(ValueError):
            PK.uniform_plan(16384, 5, 0, 0, blocks=bad)


def test_uniform_layout_and_slots_match_the_kernel():
    """K3's launch tables name `UArgs`' C enums one to one, the constants
    of its layout (in `uniform_pass.cuh`, shared with K9d) are the
    planner's, and it launches one cluster through the shared helpers
    with an occupancy query; the one-block loop and its global tie lists
    are gone."""
    from tests.test_torch_imports import _enum_slots
    src = (_build.CSRC / "uniform_burst.cu").read_text()
    for end, pre, host in (("UBI_COUNT", "UBI_", PK._UNIFORM_INTS),
                           ("UBP_COUNT", "UBP_", PK._UNIFORM_PTRS)):
        assert _enum_slots(src, end) == [pre + h.upper() for h in host]
    assert int(re.search(r"constexpr int UR_MAX = (\d+);", src).group(1)) \
        == PK.UNIFORM_ROWS_MAX
    assert '#include "uniform_pass.cuh"' in src
    pass_src = (_build.CSRC / "uniform_pass.cuh").read_text()
    assert "constexpr int UK_MAX = NTHREADS;" in pass_src
    assert PK._UNIFORM_LANES_MAX == PK.CLUSTER_THREADS
    ctl = re.search(r"enum \{ UC_DONE, UC_FOLDS, UC_MAX, UC_F, UC_T, "
                    r"UC_ELIM, UC_N = (\d+) \};", pass_src)
    assert int(ctl.group(1)) == PK._UNIFORM_CTL
    # the pass epilogue is the shared header's, not a copy in the kernel
    for step in ("pass_offsets(cl, P);", "pass_orders(cl, P, perm",
                 "pass_lanes<GS>("):
        assert step in src, step
    assert "auto tie_at" not in src and "first_dup" not in src
    # the layout, line by line (the fixed part, then per slot)
    for line in ("U.ws = o;     o += 16 * 8;",
                 "U.sh64 = o;   o += NWARPS * 8;",
                 "U.rec = o;    o += 4 * 8;",
                 "U.ctl = o;    o += UC_N * 8;",
                 "U.rows = o;   if (resident) o += sp * 8 * (size_t)R;",
                 "U.sh32 = o;   o += NWARPS * 4;",
                 "U.incl = o;   o += (size_t)CLUSTER_MAX * 4 * lm;",
                 "U.cnt = o;    o += 4 * lm;",
                 "U.lanes = o;  o += UK_MAX * 4;",
                 "U.tot = o;    if (!gscr) o += sp * 4;",
                 "U.ties = o;   if (!gscr) o += sp * 4 * lm;",
                 "U.flags = o;  if (!gscr) o += sp * 3;"):
        assert line in pass_src, line
    assert "return (size_t)blocks * (size_t)span * (4 * (L > 0 ? L : 1) " \
           "+ 4 + 3);" in pass_src
    cycle = (_build.CSRC / "cluster_cycle.cuh").read_text()
    assert int(re.search(r"constexpr int CLUSTER_MAX = (\d+);",
                         cycle).group(1)) == PK._CLUSTER_MAX
    assert "<<<" not in src and "cluster_launch(uniform_kernel(g)" in src
    assert 'extern "C" int uniform_burst_clusters(' in src
    assert "uniform_burst" in PK.CLUSTER_KERNELS
    assert "a.ties[" not in src and "my_range(" not in src


def test_k3_wrapper_plans_with_uniform_plan(monkeypatch):
    """The K3 wrapper takes `uniform_plan` of its node axis, its carried
    and static rows and its rotation orders (K1's launch replaced by its
    plain version, the device checks waived: the plan is asked before
    anything reaches a card)."""
    monkeypatch.setattr(PK, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(
        PK, "_local_total_launch",
        lambda w, rc, rm, ac, am, wrow, add_cpu=0, add_mem=0:
        PK.local_total_plain(w, rc, rm, ac, am, wrow=wrow, add_cpu=add_cpu,
                             add_mem=add_mem))
    _jn, pn = _world(np.full(N_PAD, 110, np.int64))
    perm, seq = _rotation(3, 256)
    cls = _cls(eph=True, scalar=(1, 2))
    seen = _planned(monkeypatch, lambda: PK._uniform_launch(
        pn, cls, 100, 0, N_REAL, True, dict(PK.DEFAULT_WEIGHTS),
        (torch.as_tensor(perm), torch.as_tensor(seq)), None, False, 256,
        None, 0))
    assert seen["name"] == "uniform_burst"
    # the five fixed rows, ephemeral storage and one carried scalar; the
    # other scalar is static
    assert seen["plans"] == tuple(PK.uniform_plan(N_PAD, 7, 1, 3, b)
                                  for b in (16, 8))


# ---------------------------------------------------------------------------
# the plain K3 against JAX where the plan's blocks meet
# ---------------------------------------------------------------------------
N_PAD, N_REAL, S_COUNT = 2100, 2090, 2


def _world(allowed, load=None, cpu=4000):
    """bench-shaped nodes over N_PAD slots, `allowed` pods each, `load`
    (cpu, pods) already bound on some."""
    n = N_PAD
    req = np.zeros(n, np.int64)
    pods = np.zeros(n, np.int64)
    if load is not None:
        req, pods = load
    host = {
        "valid": np.arange(n) < N_REAL,
        "alloc_cpu": np.full(n, cpu, np.int64),
        "alloc_mem": np.full(n, 32 * GI, np.int64),
        "alloc_eph": np.full(n, 50 * GI, np.int64),
        "allowed_pods": np.asarray(allowed, np.int64),
        "req_cpu": req.copy(), "req_mem": pods * 500 * MI,
        "req_eph": np.zeros(n, np.int64), "nz_cpu": req.copy(),
        "nz_mem": pods * 500 * MI, "pod_count": pods.copy(),
        "alloc_scalar": np.full((n, S_COUNT), 40, np.int64),
        "req_scalar": np.zeros((n, S_COUNT), np.int64),
        "zone_id": (np.arange(n) % 3 + 1).astype(np.int32),
    }
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.as_tensor(v.copy()) for k, v in host.items()})


def _cls(cpu=100, eph=False, scalar=None):
    """A uniform class of (cpu)m / 500 Mi pods; `eph`: carried ephemeral
    storage; `scalar`: (carried, static) scalar requests."""
    req_s = np.zeros(S_COUNT, np.int64)
    upd_s = np.zeros(S_COUNT, np.int64)
    if scalar is not None:
        req_s[:] = scalar
        upd_s[0] = scalar[0]
    return {"req_cpu": np.int64(cpu), "req_mem": np.int64(500 * MI),
            "req_eph": np.int64(GI if eph else 0), "req_scalar": req_s,
            "nz_cpu": np.int64(cpu), "nz_mem": np.int64(500 * MI),
            "upd_cpu": np.int64(cpu), "upd_mem": np.int64(500 * MI),
            "upd_eph": np.int64(GI if eph else 0), "upd_scalar": upd_s,
            "has_request": True}


def _rotation(L, cap):
    """L orders (the axis order, then permutations of the real nodes),
    scratch-padded, and an order id a cycle: a constant run, then mixed."""
    rng = np.random.default_rng(L)
    pad = np.full(N_PAD + 1 - N_REAL, N_PAD)
    rows = [np.concatenate([np.arange(N_REAL), pad])]
    for _ in range(L - 1):
        rows.append(np.concatenate([rng.permutation(N_REAL), pad]))
    seq = np.zeros(cap + JK.K_BATCH, np.int32)
    seq[1:300] = 2
    seq[300:] = rng.integers(0, L, len(seq) - 300)
    return np.stack(rows).astype(np.int32), seq


def _filled():
    """3 pods of 100m on every 7th node: those drop out of the tie set
    after a fold, so STAY batches are cut about every 7 pods."""
    load = np.zeros(N_PAD, np.int64)
    load[::7] = 3
    return _world(np.full(N_PAD, 110, np.int64), (load * 100, load))


def _case(name):
    """(jax nodes, port nodes, cls, n_pods, lni, kwargs, cap)."""
    full = np.full(N_PAD, 110, np.int64)
    if name == "elim":
        # the empty cluster: every fold lowers its node's score
        return _world(full) + (_cls(), 1500, 600, {}, 2048)
    if name == "stay":
        # 150m already on every node: the next two folds keep each score
        jn, pn = _world(full, (np.full(N_PAD, 150), np.ones(N_PAD, np.int64)))
        return jn, pn, _cls(), 3000, 900, {}, 4096
    if name == "cut":
        return _filled() + (_cls(), 1500, 700, {}, 2048)
    if name == "ban+extra_ok":
        extra = np.random.default_rng(8).random(N_PAD) < 0.8
        return _world(full) + (_cls(), 700, 600,
                               dict(ban=True, extra_ok=extra), 1024)
    if name == "rotate":
        perm, seq = _rotation(3, 1024)
        return _filled() + (_cls(), 1000, 5, dict(rotation=(perm, seq)),
                            1024)
    if name == "F == 0":
        return _world(full) + (_cls(cpu=5000), 600, 4, {}, 1024)
    # the carried rows past the fifth: ephemeral storage and a scalar, two
    # pods a node at most
    return _world(np.full(N_PAD, 2, np.int64)) + (
        _cls(eph=True, scalar=(1, 2)), 1500, 800, {}, 2048)


def _port_kw(kw):
    out = dict(kw)
    if "rotation" in kw:
        out["rotation"] = tuple(torch.as_tensor(v) for v in kw["rotation"])
    if "extra_ok" in kw:
        out["extra_ok"] = torch.as_tensor(kw["extra_ok"])
    return out


def _blocks(rows):
    span = PK.uniform_plan(N_PAD, 5, 0, 0).span
    return {int(j) // span for j in rows if j >= 0}


def test_designed_world_spans_the_plans_blocks():
    plan = PK.uniform_plan(N_PAD, 5, 0, 0)
    assert (plan.blocks, plan.span, plan.resident) == (3, 1024, True)
    assert N_PAD % plan.span != 0


@pytest.mark.parametrize("name", ["elim", "stay", "cut", "ban+extra_ok",
                                  "rotate", "F == 0", "carried rows"])
def test_plain_k3_matches_jax_across_blocks(name):
    """Decisions, the packed block (with the lni advance), lni and every
    folded row of the plain K3 equal JAX's, with the tie ranks, the lanes
    and the folds of each pass in several blocks of the plan."""
    jn, pn, cls, n_pods, lni, kw, cap = _case(name)
    jrows, jpacked, jlni = JK.schedule_batch_uniform(
        jn, dict(cls), n_pods, lni, N_REAL, True, cap=cap, **kw)
    prows, ppacked, plni = PK.schedule_batch_uniform_plain(
        pn, dict(cls), n_pods, lni, N_REAL, True, cap=cap, **_port_kw(kw))
    np.testing.assert_array_equal(np.asarray(ppacked), np.asarray(jpacked))
    assert int(plni) == int(jlni)
    assert set(prows) == set(jrows)
    for k in jrows:
        np.testing.assert_array_equal(np.asarray(prows[k]),
                                      np.asarray(jrows[k]), err_msg=k)
    sel = np.asarray(ppacked)[:n_pods]
    if name == "F == 0":
        assert (sel == -1).all() and int(np.asarray(ppacked)[cap]) == 0
        return
    assert (sel >= 0).any() and len(_blocks(sel)) == 3
    first = sel[:JK.K_BATCH]
    if name in ("elim", "ban+extra_ok"):
        # ELIM batches: the first pass's nodes are distinct
        assert len(set(first.tolist())) == len(first)
    if name == "stay":
        # STAY batches: a pass's nodes repeat once the tie set wraps
        assert len(set(sel.tolist())) < len(sel)
    if name == "cut":
        # a filled node ties before its pod and leaves the tie set after
        # it: the STAY batch is cut at its lane, and the node is not picked
        # again while the others tie
        filled = set(range(0, N_REAL, 7)) & set(first.tolist())
        assert filled and len(set(first.tolist())) == len(first)
    if name == "ban+extra_ok":
        assert kw["extra_ok"][sel[sel >= 0]].all()
        assert len(set(sel[sel >= 0].tolist())) == int((sel >= 0).sum())


# ---------------------------------------------------------------------------
# K9b: the plan, and the plain select against JAX across the plan's blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,z_pad", [(2100, 4), (16384, 4),
                                         (262144, 8)])
def test_k9b_plans_as_k10b(monkeypatch, n_pad, z_pad):
    """K9b's cycle takes K10b's `select_plan` of the gathered records'
    node axis and z_pad, the half-cluster fallback with it."""
    import types
    planes = ("local", "feas")
    d = 4
    rows = n_pad // d
    _off, nbytes = PK.record_layout(planes, rows)
    gathered = torch.zeros((d, nbytes), dtype=torch.uint8)
    pod = {"skip": np.bool_(False), "interpod_counts": np.zeros(1, np.int64),
           "interpod_tracked": np.zeros(1, bool)}
    seen = _planned(monkeypatch, lambda: PK._shard_cycle_select_launch(
        gathered, planes, rows, n_pad - 3, pod, 0, 0, 10,
        dict(PK.DEFAULT_WEIGHTS), z_pad, None, None, None, None))
    assert seen["name"] == "shard_cycle_select"
    assert seen["plans"] == tuple(PK.select_plan(n_pad, z_pad, b)
                                  for b in (16, 8))
    side = types.SimpleNamespace(_args={}, device=torch.device("cpu"))
    k10b = _planned(monkeypatch, lambda: PK._select_cluster_launch(
        "shard_scan_select", side, types.SimpleNamespace(n_pad=n_pad,
                                                         z_pad=z_pad)))
    assert k10b["plans"] == seen["plans"]
    assert "shard_cycle_select" in PK.CLUSTER_KERNELS


def test_k9b_layout_and_one_block_select_gone():
    """K9b launches one cluster through the shared helpers, stages its
    records with `select_stage` and waits on no stamp; the one-block
    `cycle_select`, `unpack_records` and the scratch planes K9b's wrapper
    allocated for them are gone, `RecLayout` stays."""
    src = (_build.CSRC / "shard_cycle_select.cu").read_text()
    assert "<<<" not in src and "cluster_launch(" in src
    assert 'extern "C" int shard_cycle_select_clusters(' in src
    assert "select_stage(" in src and "cluster_cycle<true, GS>(" in src
    assert "stamp_wait" not in src and "SS_ROUND" not in src
    cycle = (_build.CSRC / "cycle.cuh").read_text()
    for gone in ("cycle_select(", "unpack_records(", "FL_KEPTP"):
        assert gone not in cycle, gone
    assert "struct RecLayout {" in cycle
    select = (_build.CSRC / "cluster_select.cuh").read_text()
    assert "stamp_wait(a, round)" in select
    for gone in ("p64", "flags", "zs", "zone", "tracked"):
        assert gone not in PK._SCS_PTRS, gone
    assert PK._SCS_PTRS[-2:] == ("recs", "workspace")


#: the only feasible nodes of the K9b world: around the select plan's span
#: boundaries 1024 and 2048, one in block 0's head, the last real node
OPEN = [5] + list(range(1016, 1032)) + [1500] + list(range(2040, 2056)) \
    + [2089]


def _k9b_world():
    """bench-shaped nodes, all full but OPEN, whose rows are alike: their
    scores tie across the select plan's blocks 0-2."""
    load = np.full(N_PAD, 110, np.int64)
    load[OPEN] = 0
    jn, pn = _world(np.full(N_PAD, 110, np.int64),
                    (np.zeros(N_PAD, np.int64), load))
    return jn, pn


def _k9b_pod(seed):
    """A pod with inter-pod on (dense counts and tracked bits) and every
    other family inert."""
    rng = np.random.default_rng(seed)
    one = np.ones(1, bool)
    pod = {"req_cpu": np.int64(500), "req_mem": np.int64(GI),
           "req_eph": np.int64(0), "req_scalar": np.zeros(S_COUNT, np.int64),
           "has_request": np.bool_(True), "unknown_scalar": np.bool_(False),
           "skip": np.bool_(False), "check_resources": np.bool_(True),
           "nz_cpu": np.int64(500), "nz_mem": np.int64(GI),
           "interpod_code": np.zeros(1, np.int8),
           "node_aff_counts": np.zeros(1, np.int64),
           "taint_counts": np.zeros(1, np.int64),
           "spread_counts": np.zeros(1, np.int64),
           # a few counts: most OPEN nodes tie at the top inter-pod score
           "interpod_counts": rng.choice([0, 3, 3, 3], N_PAD).astype(
               np.int64),
           "interpod_tracked": rng.random(N_PAD) < 0.9,
           "image_sums": np.zeros(1, np.int64),
           "prefer_avoid": np.full(1, 10, np.int64)}
    for k in ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
              "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok"):
        pod[k] = one
    return pod


K9B_OUT = ("selected", "found", "evaluated", "max_score", "total", "kept",
           "next_last_index", "next_last_node_index")
#: (li, lni, num_to_find) of each walk: from block 1 with a cutoff in
#: block 2, from block 0's end across its boundary, a full scan that wraps
K9B_WALKS = {
    "identity": [(1500, 2 ** 33 + 5, 20), (1020, 3, 8), (2080, 11, N_REAL)],
    "perm": [(1500, 7, 20), (1020, 3, 8), (2080, 11, N_REAL)],
    "pos": [(1500, 7, N_REAL), (1020, 2 ** 31 - 5, N_REAL)],
}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("walk", sorted(K9B_WALKS))
def test_plain_k9b_matches_jax_across_blocks(walk, d):
    """The sharded cycle through the plain K9a, the all-gather and the
    plain K9b equals JAX: the identity walk against `sharded_cycle_fn` on
    the virtual mesh, the perm and pos walks (which the sharded program
    does not take) against `_cycle_core`, the program it runs; the walk
    start, the cutoff, the ties and the winners lie in different blocks
    of K9b's `select_plan`."""
    jn, pn = _k9b_world()
    pod = _k9b_pod(7)
    jpod = {k: jnp.asarray(v) for k, v in pod.items()}
    mesh = PS.Mesh(["cpu"] * d)
    shards = PS.shard_node_arrays(mesh, pn)
    span = PK.select_plan(N_PAD, 4).span
    pkw = jkw = {}
    if walk != "identity":
        rng = np.random.default_rng(11)
        perm = np.concatenate([rng.permutation(N_REAL),
                               np.arange(N_REAL, N_PAD)]).astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(N_PAD, dtype=np.int32)
        if walk == "perm":
            jkw = {"perm": jnp.asarray(perm), "inv_perm": jnp.asarray(inv)}
            pkw = {"perm": torch.as_tensor(perm),
                   "inv_perm": torch.as_tensor(inv)}
        else:
            jkw = {"pos": jnp.asarray(inv)}
            pkw = {"pos": torch.as_tensor(inv)}
    winners, kept = set(), set()
    for li, lni, ntf in K9B_WALKS[walk]:
        if walk == "identity":
            jmesh = JS.make_mesh(d)
            want = JS.sharded_cycle_fn(jmesh, z_pad=4)(
                JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                             for k, v in jn.items()}),
                JS.shard_pod_arrays(jmesh, pod), jnp.int64(li),
                jnp.int64(lni), jnp.int64(ntf), jnp.int64(N_REAL))
        else:
            want = JK._cycle_core(jn, jpod, li, lni, ntf, N_REAL,
                                  dict(JK.DEFAULT_WEIGHTS), 4, **jkw)
        got = PK.schedule_cycle(shards, pod, li, lni, ntf, N_REAL, 4,
                                mesh=mesh, **pkw)
        for k in K9B_OUT:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
        assert int(got["found"]) > 0
        winners.add(int(got["selected"]) // span)
        kept |= {j // span for j in np.flatnonzero(got["kept"].numpy())}
    assert len(winners) >= 2 and len(kept) >= 2


# ---------------------------------------------------------------------------
# K9d: K3's cluster pass over the stay bits, planned as K3 at R = 0
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,L,blocks,want", [
    # (n_pad, orders, blocks the planner may take, (blocks, slots a
    # thread, resident, lists and bits in the global workspace))
    (16384, 0, 16, (16, 1, True, False)),
    (16384, 0, 8, (8, 2, True, False)),
    (15001, 0, 16, (15, 1, True, False)),
    (15001, 3, 8, (8, 2, True, False)),
    (16384, 3, 16, (16, 1, True, False)),
    # 262,144 slots: the bits and one list in shared memory; three
    # orders' lists do not fit, and go to the workspace with the bits
    (262144, 0, 16, (16, 16, True, False)),
    (262144, 3, 16, (16, 16, False, True)),
    (131072, 4, 8, (8, 16, False, True)),
    # the switch without rotation: 20 slots a thread fit, 21 do not
    (327680, 0, 16, (16, 20, True, False)),
    (327681, 0, 16, (16, 21, False, True)),
])
def test_k9d_plan_pins(n_pad, L, blocks, want):
    """K9d takes K3's planner with no carried rows: per node slot its
    byte planes and a tie-list slot an order, K3's fixed tables."""
    plan = PK.uniform_plan(n_pad, 0, 0, L, blocks)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident,
            plan.global_scratch) == want
    assert (plan.blocks - 1) * plan.span < n_pad <= plan.blocks * plan.span
    assert plan.smem_bytes == _fixed(L) + plan.span * _slot(
        0, L, plan.resident, plan.global_scratch) <= PK.SMEM_CAP
    if plan.global_scratch:
        assert PK.uniform_smem_bytes(plan.span, 0, L, True) > PK.SMEM_CAP
        assert plan.workspace_bytes == plan.blocks * plan.span * (
            7 + 4 * max(L, 1))
    else:
        assert plan.workspace_bytes == 0


def test_k9d_layout_and_one_block_select_gone():
    """K9d lays out K3's shared memory at R = 0 (`uniform_pass.cuh`),
    checks a plan against it, runs the pass epilogue of the shared header
    on one cluster and leaves alike in every block once the burst is
    done; the one-block kernel and its flat planes and tie lists are
    gone."""
    from tests.test_torch_imports import _enum_slots
    src = (_build.CSRC / "shard_uniform_select.cu").read_text()
    assert '#include "uniform_pass.cuh"' in src
    assert "uniform_layout(span, 0, L, g.resident != 0, GS)" in src
    assert "uniform_layout(g.npt * NTHREADS, 0, (int)a.v[UD_L]," in src
    for step in ("pass_offsets(cl, P);", "pass_orders(cl, P,",
                 "pass_lanes<GS>("):
        assert step in src, step
    # the early return comes before the first cluster barrier
    body = src[src.index("shard_uniform_select_kernel(PassArgs a"):]
    assert body.index("if (done >= a.v[UD_B]) return;") \
        < body.index("cl.sync()")
    # block 0 writes the pass state after the last barrier
    assert body.rindex("cl.sync()") < body.index("state[ST_DONE] = ")
    assert "<<<" not in src and "cluster_launch(pass_kernel(g)" in src
    assert 'extern "C" int shard_uniform_select_clusters(' in src
    for gone in ("DP_FLAT", "DP_TIES", "my_range(", "block_min64("):
        assert gone not in src, gone
    assert _enum_slots(src, "DP_COUNT") == [
        "DP_" + k.upper() for k in PK._SUD_PTRS]
    assert "shard_uniform_select" in PK.CLUSTER_KERNELS
    # K3 and K9d check a plan against the one layout
    k3 = (_build.CSRC / "uniform_burst.cu").read_text()
    assert "uniform_layout(g.npt * NTHREADS, R, L, g.resident != 0," in k3


def _k9d_gathered(n_pad, d=4):
    rows = n_pad // d
    hoff = PK._round8(rows)
    return (torch.zeros((d, PK.UniformShard.record_bytes(rows)),
                        dtype=torch.uint8), rows, hoff)


@pytest.mark.parametrize("n_pad,L", [(2100, 0), (2100, 3), (16384, 0),
                                     (262144, 3)])
def test_k9d_wrapper_plans_with_uniform_plan(monkeypatch, n_pad, L):
    """The K9d wrapper asks `_cluster_geometry` for K3's plan at R = 0 of
    the gathered records' node axis and the rotation's orders (caught
    before a launch)."""
    gathered, rows, hoff = _k9d_gathered(n_pad)
    perm = oid = None
    if L:
        perm = torch.zeros((L, n_pad + 1), dtype=torch.int32)
        oid = torch.zeros(256 + PK.K_BATCH, dtype=torch.int32)
    state = torch.zeros(PK.ST_LANES + PK.K_BATCH, dtype=torch.int64)
    seen = _planned(monkeypatch, lambda: PK._shard_uniform_select_bind(
        gathered, rows, hoff, state,
        torch.zeros(256 + PK.K_BATCH, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int64),
        torch.zeros(n_pad + 1, dtype=torch.int32), 200, 256, False, perm,
        oid))
    assert seen["name"] == "shard_uniform_select"
    assert seen["plans"] == tuple(PK.uniform_plan(n_pad, 0, 0, L, b)
                                  for b in (16, 8))


class _BoundSelect:
    """A stand-in for K9d's `Relaunch` on the CPU: `fn()` runs the plain
    version on the bound arguments, `book()` counts."""

    def __init__(self, args, kw, log):
        self.name = "shard_uniform_select"
        self.args, self.kw, self.log = args, kw, log

    def fn(self):
        self.log["relaunched"] += 1
        PK.shard_uniform_select_plain(*self.args, **self.kw)
        return 0

    def book(self):
        self.log["booked"] += 1
        return 0


def _rotate_dup_case():
    """The STAY world with three orders where order 1 is order 0 moved by
    one position and the cycles alternate orders 0 and 1: lane j + 1
    names lane j's node, so the duplicate cut takes each batch at the
    second lane."""
    jn, pn, cls, _n, lni, _kw, cap = _case("stay")
    rng = np.random.default_rng(21)
    pad = np.full(N_PAD + 1 - N_REAL, N_PAD)
    base = np.arange(N_REAL)
    rows = [np.concatenate([base, pad]),
            np.concatenate([np.roll(base, 1), pad]),
            np.concatenate([rng.permutation(N_REAL), pad])]
    seq = np.zeros(cap + JK.K_BATCH, np.int32)
    seq[: 600] = np.arange(600) % 2
    seq[600:] = rng.integers(0, 3, len(seq) - 600)
    kw = dict(rotation=(np.stack(rows).astype(np.int32), seq))
    return jn, pn, cls, 700, lni, kw, cap


K9D_CASES = ["elim", "stay", "cut", "ban+extra_ok", "rotate",
             "rotate+duplicate lane", "F == 0"]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", K9D_CASES)
def test_plain_k9d_matches_jax_across_blocks(monkeypatch, name, d):
    """The sharded burst on `["cpu"] * d` through the plain K9c and K9d
    equals JAX's `schedule_batch_uniform` (decisions, the packed block,
    lni, every folded row), at an n_pad (2,100) that is no multiple of
    K9d's span (1,024: three blocks), so that tie runs and shard edges
    (every 525 or 1,050 rows) cross the plan's block edges; K9d is bound
    once a burst on each device and re-enqueued on the later passes."""
    jn, pn, cls, n_pods, lni, kw, cap = (
        _rotate_dup_case() if name == "rotate+duplicate lane"
        else _case(name))
    log = {"bound": 0, "relaunched": 0, "booked": 0, "dup": 0}
    real = PK.shard_uniform_select_plain

    def spy(gathered, rows, hoff, state, *args, **kwargs):
        real(gathered, rows, hoff, state, *args, **kwargs)
        v = int(state[PK.ST_VFOLD])
        lanes = state[PK.ST_LANES: PK.ST_LANES + PK.K_BATCH].tolist()
        if 0 < v < PK.K_BATCH and lanes[v] in lanes[:v]:
            log["dup"] += 1

    def bind(gathered, rows, hoff, state, *args, **kwargs):
        log["bound"] += 1
        rel = _BoundSelect((gathered, rows, hoff, state) + args, kwargs,
                           log)
        spy(gathered, rows, hoff, state, *args, **kwargs)
        return rel
    monkeypatch.setattr(PK, "shard_uniform_select_plain", spy)
    monkeypatch.setattr(PK, "shard_uniform_select", bind)
    mesh = PS.Mesh(["cpu"] * d)
    assert N_PAD % PK.uniform_plan(N_PAD, 0, 0, 0).span
    jrows, jpacked, jlni = JK.schedule_batch_uniform(
        jn, dict(cls), n_pods, lni, N_REAL, True, cap=cap, **kw)
    rows, packed, plni = PK.schedule_batch_uniform(
        PS.shard_node_arrays(mesh, pn), dict(cls), n_pods, lni, N_REAL,
        True, cap=cap, mesh=mesh, **_port_kw(kw))
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(jpacked))
    assert int(plni) == int(jlni)
    for k in jrows:
        got = torch.cat([r[k] for r in rows])
        np.testing.assert_array_equal(np.asarray(got), np.asarray(jrows[k]),
                                      err_msg=k)
    # bound once on the one device, re-enqueued every later pass, booked
    assert log["bound"] == 1 and log["booked"] == 1
    assert log["relaunched"] >= (1 if name != "F == 0" else 0)
    sel = np.asarray(packed)[:n_pods]
    if name == "F == 0":
        assert (sel == -1).all()
        return
    assert len(_blocks(sel)) == 3
    if name == "rotate+duplicate lane":
        assert log["dup"] > 0
