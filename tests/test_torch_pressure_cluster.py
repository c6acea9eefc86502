"""The cluster geometry of K8, the blockwise pick it runs, and the premise
of its scan reuse, on the CPU.

K8 (`pressure_batch`) runs a chunk of the pressure wave on one
thread-block cluster: block q owns the node slice [q * span, (q + 1) *
span) and keeps its rows, ghost load and victim-scan aggregates in shared
memory when they fit (`pressure_plan`). Each block reduces its slice to a
candidate record and one cluster round combines the records; while the
pod spec repeats, a block rescans only the node the previous pod folded
or nominated. This file pins the planner; holds the plain K8 against
JAX's `pressure_batch` at a ragged n_pad where the cycle's winner, the
resolvable first failures, a zero-victim instant win and five-criteria
ties fall in different blocks of the plan; holds the blockwise pick (the
plain `shard_candidate` record of each block slice, then the record pick)
against `_pick_one_node` over the whole axis; and proves the reuse
premise on waves with spec runs and with alternating specs. K13b
(`shard_pressure_select`) runs the same cycle per step as one cluster of
K10b's `select_plan` over the gathered shard records: the sharded wave on
2 and 4 CPU shards is held against JAX's `sharded_pressure_fn` on the
same designed world, whose select blocks are the plan's blocks here.
Tolerance: exact equality (every output is an integer or a converted
count).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_preempt import (
    MASKS, _check_pressure, _pod_spec, _stack, both, rand_victims,
    victim_nodes)

from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
def test_pressure_plan_at_16384_is_resident_on_16_blocks():
    plan = PK.pressure_plan(16384, 1, 4)
    assert (plan.blocks, plan.nodes_per_thread, plan.resident) == (16, 1,
                                                                   True)
    # K5's layout (3,392 B of fixed tables, 105 B a slot, 16 B a scalar
    # resource) plus the ghost load (32 B) and the scan's aggregates
    # (41 B) a slot
    assert plan.smem_bytes == 3392 + 1024 * (105 + 16 + 73)
    assert plan.smem_bytes == PK.cluster_smem_bytes(
        1024, 1, 4, False, True, pressure=True)
    assert plan.smem_bytes <= PK.SMEM_CAP
    assert plan.geometry()[:] == [16, 1, 1, plan.smem_bytes, 0]


def test_pressure_plan_half_cluster_keeps_rows_in_global_memory():
    half = PK.pressure_plan(16384, 1, 4, blocks=8)
    assert (half.blocks, half.nodes_per_thread, half.span) == (8, 2, 2048)
    assert not half.resident
    assert PK.cluster_smem_bytes(2048, 1, 4, False, True,
                                 pressure=True) > PK.SMEM_CAP
    assert half.smem_bytes == PK.cluster_smem_bytes(2048, 1, 4, False,
                                                    False, pressure=True)


@pytest.mark.parametrize("n_pad,blocks,npt", [
    (1024, 1, 1),       # preempt-baseline: one block
    (2100, 3, 1),       # ragged: the last block owns 52 slots
    (5000, 5, 1),
    (20000, 10, 2),     # two slots a thread: ten blocks cover it
])
def test_pressure_plan_takes_the_blocks_that_own_nodes(n_pad, blocks, npt):
    plan = PK.pressure_plan(n_pad, 1, 4)
    assert (plan.blocks, plan.nodes_per_thread) == (blocks, npt)
    assert plan.span * plan.blocks >= n_pad
    assert (plan.blocks - 1) * plan.span < n_pad
    # the fallback asks for 8 blocks: the same or fewer
    assert PK.pressure_plan(n_pad, 1, 4, blocks=8).blocks <= min(blocks, 8)


def test_pressure_plan_resident_until_the_cap_then_global():
    assert PK.pressure_plan(16384, 2, 8).resident
    # 64 scalar resources: no longer resident at one slot a thread
    wide = PK.pressure_plan(16384, 64, 4)
    assert not wide.resident and wide.smem_bytes <= PK.SMEM_CAP
    with pytest.raises(ValueError):
        PK.pressure_plan(16384, 1, 4, blocks=17)
    # past the rows' cap the scratch moves to the global workspace too
    far = PK.pressure_plan(4_000_000, 1, 4)
    assert far.global_scratch and not far.resident
    assert far.smem_bytes == PK.cluster_smem_bytes(
        0, 1, 4, False, False, pressure=True) == 3392
    assert far.workspace_bytes == far.blocks * far.span * 20


# ---------------------------------------------------------------------------
# the plain K8 against JAX where the plan's blocks meet
# ---------------------------------------------------------------------------
N_PAD, N_REAL, P, Z_PAD = 2100, 2090, 8, 4
LI, LNI = 1500, 3              # the walk starts in block 1
HIT = 5                        # spec A's only room: block 0
TIES = (1100, 2080)            # spec B's candidates, alike: blocks 1, 2
ZERO, EVICT = 2070, 700        # spec C's candidates: blocks 2, 0


def _designed_world(seed):
    """Full nodes around random victim planes, but: HIT has 2 CPU of room;
    the TIES rows are one row and one set of slots (four victims of 1 CPU
    at priorities 1-4), so spec B's pick ties through all five criteria
    across blocks 1 and 2; ZERO has room, so spec C (which asks a scalar
    resource no node has: its cycle fails everywhere, resolvably) wins it
    with no victim over EVICT, which needs evictions. A ghost load sits on
    some other rows."""
    rng = np.random.default_rng(seed)
    vic = rand_victims(rng, N_PAD, P)
    nodes = victim_nodes(rng, vic, N_PAD, N_REAL, room=[HIT, ZERO])
    nodes["allowed_pods"][[HIT, ZERO, EVICT, *TIES]] = 110
    for j in TIES:
        for k in vic:
            vic[k][j] = 0
        vic["valid"][j, :4] = True
        vic["cpu"][j, :4] = 1000
        vic["prio"][j, :4] = [4, 3, 2, 1]
        vic["start"][j, :4] = [5.0, 6.0, 7.0, 8.0]
        vic["start"][j, 4:] = np.inf
        vic["violating"][j, 0] = True
    for k in nodes:
        if k != "valid":
            nodes[k][TIES[1]] = nodes[k][TIES[0]]
    nodes["alloc_cpu"][list(TIES)] = 4000
    nodes["req_cpu"][list(TIES)] = 4000
    nodes["pod_count"][list(TIES)] = 4
    nodes["req_mem"][list(TIES)] = 0
    nodes["req_eph"][list(TIES)] = 0
    ghost = {k: np.zeros(N_PAD, np.int64) for k in PK.GHOST_FIELDS}
    busy = rng.choice(N_REAL, 40, replace=False)
    busy = busy[~np.isin(busy, [HIT, ZERO, EVICT, *TIES])]
    ghost["cpu"][busy] = 300
    ghost["cnt"][busy] = 1

    def only(rows):
        m = np.zeros(N_PAD, bool)
        m[list(rows)] = True
        return m
    a = _pod_spec(rng, N_PAD, False, 400, 400, 9)
    a["unsched_ok"] = ~only([ZERO])
    b = _pod_spec(rng, N_PAD, False, 1500, 1500, 7)
    b["unsched_ok"] = only(TIES)
    c = _pod_spec(rng, N_PAD, False, 400, 400, 5)
    c["unsched_ok"] = only([ZERO, EVICT])
    c["req_scalar"] = np.ones(1, np.int64)
    d = dict(c, skip=np.bool_(True))
    per_pod = [a] * 3 + [b] * 3 + [c] * 3 + [d] * 2
    for pp in per_pod:
        for k in MASKS:
            if k != "unsched_ok":
                pp[k] = np.ones(N_PAD, bool)
    return nodes, vic, per_pod, ghost


def _blocks(rows):
    span = PK.pressure_plan(N_PAD, 1, Z_PAD).span
    return [int(j) // span for j in rows]


def test_designed_world_spans_the_plans_blocks():
    plan = PK.pressure_plan(N_PAD, 1, Z_PAD)
    assert plan.blocks == 3
    assert _blocks([HIT, LI, *TIES, ZERO, EVICT]) == [0, 1, 1, 2, 2, 0]


def test_plain_pressure_batch_matches_jax_across_blocks():
    """Spec A binds at HIT (block 0) on a walk from block 1; spec B fails
    with resolvable first failures on the TIES rows and nominates the
    lower of two rows tied through all five criteria in blocks 1 and 2,
    then the other once the first carries the nomination's ghost; spec C
    nominates ZERO (block 2) with no victim over EVICT (block 0); two skip
    pods. The plain K8 equals JAX's pressure_batch bit for bit."""
    nodes, vic, per_pod, ghost = _designed_world(11)
    stacked = _stack(per_pod)
    jn, pn = both(nodes)
    jv, pv = both(vic)
    jg, pg = both(ghost)
    want = JK.pressure_batch(
        jn, {k: jn[k] for k in PK._MUTABLE}, jg,
        {k: jnp.asarray(v) for k, v in stacked.items()}, jv, LI, LNI,
        N_REAL, N_REAL, Z_PAD)
    got = PK.pressure_batch_plain(
        pn, {k: pn[k] for k in PK._MUTABLE}, pg,
        {k: torch.as_tensor(v) for k, v in stacked.items()}, pv, LI, LNI,
        N_REAL, N_REAL, Z_PAD)
    _check_pressure(got, want)
    out = got[4]
    win, sel = out["winner"].tolist(), out["selected"].tolist()
    cand = out["any_cand"].tolist()
    assert win[:3] == [-2] * 3 and sel[:3] == [HIT] * 3
    assert win[3:6] == [TIES[0], TIES[1], TIES[0]] and all(cand[3:6])
    assert win[6:9] == [ZERO] * 3 and all(cand[6:9])
    # a zero-victim win carries no victim flag
    assert not out["victims"][6:9].any()
    assert out["victims"][3].sum() > 0
    assert win[9:] == [-1, -1] and not any(cand[9:])


def test_designed_world_spans_the_select_plans_blocks():
    """K13b plans its step as K10b does; at N_PAD the select's blocks are
    K8's, so the designed world's rows fall in the same blocks of it."""
    plan = PK.select_plan(N_PAD, Z_PAD)
    assert plan.span == PK.pressure_plan(N_PAD, 1, Z_PAD).span == 1024
    assert [int(j) // plan.span for j in (HIT, LI, *TIES, ZERO, EVICT)] \
        == [0, 1, 1, 2, 2, 0]


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_pressure_matches_jax_across_select_blocks(d):
    """The designed wave on d shards (shard boundaries at multiples of
    1,050 or 525, the select's blocks at 1,024): K13a on every shard and
    K13b per step equal JAX's `sharded_pressure_fn` bit for bit. The
    walk starts in select block 1, spec A binds in block 0, spec B fails
    resolvably and nominates rows tied through all five criteria in
    blocks 1 and 2 (the second pick reads the first nomination's ghost),
    spec C nominates a zero-victim row in block 2 over one in block 0,
    the ghost load is carried in, and two skip pods close the wave."""
    nodes, vic, per_pod, ghost = _designed_world(11)
    stacked = _stack(per_pod)
    jn, pn = both(nodes)
    jv, _pv = both(vic)
    jg, pg = both(ghost)
    want = JK.pressure_batch(
        jn, {k: jn[k] for k in PK._MUTABLE}, jg,
        {k: jnp.asarray(v) for k, v in stacked.items()}, jv, LI, LNI,
        N_REAL, N_REAL, Z_PAD, mesh=JS.make_mesh(d))
    mesh = PS.Mesh(["cpu"] * d)
    got = PK.pressure_batch(
        PS.shard_node_arrays(mesh, pn), {k: pn[k] for k in PK._MUTABLE}, pg,
        {k: torch.as_tensor(v) for k, v in stacked.items()}, vic, LI, LNI,
        N_REAL, N_REAL, Z_PAD, mesh=mesh)
    mut, gh, li, lni, out = got
    _check_pressure(({k: torch.cat([m[k] for m in mut]) for k in mut[0]},
                     {k: torch.cat([g[k] for g in gh]) for k in gh[0]},
                     li, lni, out), want)
    win = out["winner"].tolist()
    assert win[:3] == [-2] * 3 and win[3:6] == [TIES[0], TIES[1], TIES[0]]
    assert win[6:9] == [ZERO] * 3 and win[9:] == [-1, -1]
    assert all(out["any_cand"].tolist()[3:9])


# ---------------------------------------------------------------------------
# the blockwise pick: a record a block slice, then the record pick
# ---------------------------------------------------------------------------
def _scan(nodes, vic, pod, ghost, n_real):
    """One pod's victim select over every row, as `_pressure_core`: the
    pod's static masks and slot mask, the ghost."""
    n_pad = int(nodes["valid"].shape[0])
    in_range = torch.arange(n_pad) < n_real
    feas = in_range & nodes["valid"]
    for k in PK._PRESSURE_MASKS:
        feas = feas & torch.as_tensor(np.broadcast_to(pod[k], (n_pad,))
                                      .copy())
    feas = feas & torch.as_tensor(
        np.broadcast_to(pod["interpod_code"], (n_pad,)) == 0)
    valid_k = vic["valid"] & (vic["prio"] < int(pod["pprio"]))
    return PK._victim_select_plain(
        nodes, vic, valid_k, pod["req_cpu"], pod["req_mem"], pod["req_eph"],
        ghost, feas, pod["check_resources"], pod["has_request"])


def _blockwise_pick(feas0, victims, agg, span):
    """The plain `shard_candidate` record of every block slice (keyed by
    the global row), combined by the record pick."""
    n = int(feas0.shape[0])
    recs = []
    for lo in range(0, n, span):
        sl = slice(lo, min(lo + span, n))
        recs.append(PK._shard_candidate_plain(
            feas0[sl], victims[sl], {k: v[sl] for k, v in agg.items()},
            torch.arange(sl.start, sl.stop, dtype=torch.int64), lo))
    return PK._pick_records_plain(torch.stack(recs), 0,
                                  int(victims.shape[1]))


@pytest.mark.parametrize("spec", [0, 3, 6])
@pytest.mark.parametrize("span", [1024, 700, 64])
def test_blockwise_pick_equals_the_pick_over_the_axis(spec, span):
    """On the designed world (spec A: a pick over random rows; B: ties
    across blocks; C: a zero-victim win) the blockwise pick names
    `_pick_one_node`'s winner over the whole axis, with its victim count,
    violations and flags, at K8's span and at two others."""
    nodes, vic, per_pod, ghost = _designed_world(11)
    pn = {k: torch.as_tensor(v) for k, v in nodes.items()}
    pv = PK._vic_tensors(vic, "cpu")
    pg = {k: torch.as_tensor(v) for k, v in ghost.items()}
    feas0, victims, agg = _scan(pn, pv, per_pod[spec], pg, N_REAL)
    want = PK._pick_one_node_plain(feas0, agg,
                                   torch.arange(N_PAD, dtype=torch.int64))
    winner, nv, viol, flags, _res = _blockwise_pick(feas0, victims, agg,
                                                    span)
    assert winner == want
    if want >= 0 and int(agg["nv"][want]) > 0:
        assert (nv, viol) == (int(agg["nv"][want]),
                              int(agg["viol_ct"][want]))
        assert torch.equal(flags, victims[want].to(torch.int32))
    if spec == 3:
        assert want == TIES[0]
    if spec == 6:
        assert want == ZERO and int(agg["nv"][ZERO]) == 0


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_blockwise_pick_equals_the_pick_on_random_rows(seed):
    rng = np.random.default_rng(seed)
    n_pad, n_real = 600, 590
    vic = rand_victims(rng, n_pad, P, starts_inf=seed == 5)
    nodes = victim_nodes(rng, vic, n_pad, n_real)
    pn = {k: torch.as_tensor(v) for k, v in nodes.items()}
    pv = PK._vic_tensors(vic, "cpu")
    pod = _pod_spec(rng, n_pad, True, 700, 700, 5)
    feas0, victims, agg = _scan(pn, pv, pod, None, n_real)
    want = PK._pick_one_node_plain(feas0, agg,
                                   torch.arange(n_pad, dtype=torch.int64))
    for span in (128, 250, 600):
        assert _blockwise_pick(feas0, victims, agg, span)[0] == want


# ---------------------------------------------------------------------------
# the reuse premise: a repeated spec changes one node's aggregates
# ---------------------------------------------------------------------------
def _wave_world(seed, order):
    """64-row waves over random planes: 16 pods of specs `order` (one
    spec a run, or alternating), two skip pods at the end."""
    rng = np.random.default_rng(seed)
    n_pad, n_real = 64, 60
    vic = rand_victims(rng, n_pad, P)
    nodes = victim_nodes(rng, vic, n_pad, n_real,
                         room=rng.choice(n_real, 3, replace=False))
    specs = [_pod_spec(rng, n_pad, False, 400, 400, 9),
             _pod_spec(rng, n_pad, True, 900, 700, 7),
             _pod_spec(rng, n_pad, False, 300, 300, 5)]
    per_pod = [specs[s] for s in order] + [dict(specs[2],
                                                skip=np.bool_(True))] * 2
    ghost = {k: np.zeros(n_pad, np.int64) for k in PK.GHOST_FIELDS}
    ghost["cpu"][rng.choice(n_real, 6, replace=False)] = 200
    return nodes, vic, per_pod, ghost, n_real


WAVE_ORDERS = {
    "spec runs": [0] * 6 + [1] * 6 + [2] * 4,
    "alternating specs": [0, 1] * 4 + [1, 2] * 4,
}


@pytest.mark.parametrize("order", sorted(WAVE_ORDERS))
@pytest.mark.parametrize("seed", [21, 22])
def test_repeated_spec_changes_only_the_folded_node(order, seed):
    """Replaying a plain K8 wave pod by pod: each pod's per-node
    aggregates (the victim select on the rows and ghost before its fold)
    equal those of the pod before it wherever that pod had the same spec,
    except at the one node the pod before folded (a bind) or nominated (a
    ghost fold). The wave binds, nominates and fails."""
    nodes, vic, per_pod, ghost, n_real = _wave_world(seed,
                                                     WAVE_ORDERS[order])
    stacked = _stack(per_pod)
    pn = {k: torch.as_tensor(v) for k, v in nodes.items()}
    pv = PK._vic_tensors(vic, "cpu")
    pg = {k: torch.as_tensor(v) for k, v in ghost.items()}
    out = PK.pressure_batch_plain(
        pn, {k: pn[k] for k in PK._MUTABLE}, pg,
        {k: torch.as_tensor(v) for k, v in stacked.items()}, pv, 7, 3,
        n_real, n_real, 4)[4]
    win, sel = out["winner"].tolist(), out["selected"].tolist()
    assert -2 in win and any(w >= 0 for w in win) and -1 in win
    mut = {k: pn[k].clone() for k in PK._MUTABLE}
    gh = {k: v.clone() for k, v in pg.items()}
    prev = None
    reused = 0
    for b, pod in enumerate(per_pod):
        rows = {**pn, **mut}
        feas0, _victims, agg = _scan(rows, pv, pod, gh, n_real)
        now = {"feas0": feas0, **agg}
        if prev is not None and per_pod[b - 1] is pod:
            changed = prev["changed"]
            for k, v in now.items():
                same = v == prev["agg"][k]
                if changed >= 0:
                    same[changed] = True
                assert bool(same.all()), (b, k)
            reused += 1
        changed = -1
        if win[b] == -2:
            changed = sel[b]
            PK._fold_state_plain(mut, {k: torch.as_tensor(pod[k]) for k in (
                "upd_cpu", "upd_mem", "upd_eph", "upd_scalar", "nz_cpu",
                "nz_mem")}, changed)
        elif win[b] >= 0:
            changed = win[b]
            for k in ("cpu", "mem", "eph"):
                gh[k][changed] += int(pod["upd_" + k])
            gh["cnt"][changed] += 1
        prev = {"agg": now, "changed": changed}
    assert reused >= (11 if order == "spec runs" else 1)
