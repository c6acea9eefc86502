"""The grouped shard-local steps of the mesh scan (K10a), the mesh fused
window (K11a) and the mesh pressure wave (K13a), on the CPU.

A device runs one local step over every shard it holds, each shard's
record written straight into row s of that device's gathered buffer; the
all-gather then copies only the rows of shards on other devices. Checked
here: how `_run_steps` groups the shards, the all-gather's plan on device
labels, and the grouped plain K10a / K11a / K13a against the per-shard
plain step followed by a full `all_gather`, bit for bit, at D = 1, 2 and
4 on a ragged n_real, in the step states a window or a wave passes
through. The windows and waves of the JAX comparisons
(tests/test_torch_sharding_scan.py, tests/test_torch_cluster_select.py,
tests/test_torch_sharding_preempt.py) run through the same grouped path.
"""
import ctypes

import numpy as np
import pytest
import torch

from tests.test_torch_kernels import SCAN_B, _scan_inputs, _segments
from tests.test_torch_sharding_preempt import _port_wave, _wave

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


# the segments window: a singleton run, two gangs, a singleton run
SEG_LAYOUT = [(3, False), (6, True), (5, True), (4, False)]


def _world():
    """37 nodes (n_pad 64: n_real a multiple of no shard count), 24 pods
    padded with skip pods to SCAN_B, pod 5 a skip pod mid-window, the
    spread vector carried."""
    _jn, pn, stacked, spread0, n, n_pad, z_pad = _scan_inputs(83,
                                                               spread=True)
    skip = stacked["skip"].copy()
    skip[5] = True
    return pn, dict(stacked, skip=skip), spread0, n, n_pad, z_pad


WORLD = _world()


def _window(d, segments):
    """A fresh window's shards, per-device halves and plan on
    `["cpu"] * d`."""
    pn, stacked, spread0, n, _n_pad, z_pad = WORLD
    mesh = PS.Mesh(["cpu"] * d)
    kw = {}
    if segments:
        seg, gang, n_pods = _segments(SCAN_B, SEG_LAYOUT)
        kw = dict(n_steps=n_pods, segments=(seg, gang))
    scan, sides, plan, _steps = PS._scan_window(
        mesh, PS.shard_node_arrays(mesh, pn), stacked, 3, 5, n, n, z_pad,
        PK.DEFAULT_WEIGHTS, None, None, torch.as_tensor(spread0), None,
        None, **kw)
    return mesh, scan, sides, plan


# step states: (name, segments, {slot: value}, whether the step writes
# records); "first" / "last" stand for the first row of the last shard and
# the last row of the first shard
STATES = [
    ("fold on a shard's first row", False,
     {PK.SS_NEXT: 2, PK.SS_FOLD_SEL: "first", PK.SS_FOLD_ROW: 1}, True),
    ("fold on a shard's last row", False,
     {PK.SS_NEXT: 7, PK.SS_FOLD_SEL: "last", PK.SS_FOLD_ROW: 4}, True),
    ("skip pod, fold", False,
     {PK.SS_NEXT: 5, PK.SS_FOLD_SEL: "last", PK.SS_FOLD_ROW: 2}, False),
    ("past the window: fold only", False,
     {PK.SS_NEXT: SCAN_B, PK.SS_FOLD_SEL: "first", PK.SS_FOLD_ROW: 0},
     False),
    ("segment start: checkpoint after the fold", True,
     {PK.SS_NEXT: 3, PK.SS_FOLD_SEL: "first", PK.SS_FOLD_ROW: 2}, True),
    # the step after a gang member failed: every shard rewinds, and the
    # next member, behind the failure, computes nothing
    ("gang rewind across shards", True,
     {PK.SS_NEXT: 6, PK.SS_REWIND: 1, PK.SS_FAILED: 1}, False),
    ("rewind onto a segment start", True,
     {PK.SS_NEXT: 9, PK.SS_REWIND: 1, PK.SS_FAILED: 1}, True),
    ("member behind its gang's failure", True,
     {PK.SS_NEXT: 11, PK.SS_FAILED: 1, PK.SS_FOLD_SEL: "last",
      PK.SS_FOLD_ROW: 10}, False),
    ("gang member, no failure", True,
     {PK.SS_NEXT: 12, PK.SS_FOLD_SEL: "last", PK.SS_FOLD_ROW: 11}, True),
]


def _set_state(mesh, scan, sides, state):
    rows = scan[0].rows
    where = {"first": (mesh.size - 1) * rows, "last": rows - 1}
    for side in sides.values():
        for slot, v in state.items():
            side.st[slot] = where.get(v, v)
    # the checkpoint differs from the live rows, row by row, so a restore
    # shows
    for sh in scan:
        for v in (sh.chk or {}).values():
            v += (1 + torch.arange(sh.rows, dtype=v.dtype)).reshape(
                (-1,) + (1,) * (v.dim() - 1))


def _snapshot(scan, sides):
    out = {"gathered": [s.gathered.clone() for s in sides.values()]}
    for sh in scan:
        for k in PK._MUTABLE:
            out[f"{sh.index}/{k}"] = sh.nodes[k].clone()
        out[f"{sh.index}/spread"] = sh.spread.clone()
        for k, v in (sh.chk or {}).items():
            out[f"{sh.index}/chk/{k}"] = v.clone()
    return out


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("name,segments,state,writes", STATES,
                         ids=[s[0] for s in STATES])
def test_grouped_local_equals_per_shard_step_and_gather(d, name, segments,
                                                        state, writes):
    """The grouped plain K10a / K11a over a device's shards, records in
    place, against the per-shard plain step into each shard's own buffer
    followed by a full all_gather: every record, folded row, spread slice
    and checkpoint equal."""
    results = []
    for grouped in (True, False):
        mesh, scan, sides, plan = _window(d, segments)
        _set_state(mesh, scan, sides, state)
        if grouped:
            local = PK.shard_segments_local_plain if segments \
                else PK.shard_scan_local_plain
            for dev, shards in PS.device_groups(mesh, scan):
                local(shards, sides[dev], plan)
        else:
            own = [torch.zeros(plan.record_bytes, dtype=torch.uint8)
                   for _ in scan]
            for sh, rec in zip(scan, own):
                PK._scan_local_plain(sh, sides[sh.device], plan, segments,
                                     rec)
            PS.all_gather(mesh, own, {dv: sides[dv].gathered
                                      for dv in mesh.distinct})
        results.append(_snapshot(scan, sides))
    got, want = results
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], list):
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a, b), (name, d, k)
        else:
            assert torch.equal(got[k], want[k]), (name, d, k)
    assert bool(got["gathered"][0].any()) == writes, name


def test_grouped_local_rewind_restores_the_checkpoint():
    """A rewind takes every shard's live rows back to its checkpoint."""
    mesh, scan, sides, plan = _window(4, True)
    _set_state(mesh, scan, sides, dict(STATES[5][2]))
    PK.shard_segments_local_plain(scan, sides[mesh.devices[0]], plan)
    for sh in scan:
        for k in PK._MUTABLE:
            assert torch.equal(sh.nodes[k], sh.chk[k]), (sh.index, k)
        assert torch.equal(sh.spread, sh.chk["spread"])


@pytest.mark.parametrize("segments", [False, True])
def test_run_steps_calls_the_grouped_local_once_a_step(monkeypatch,
                                                       segments):
    """On `Mesh(["cpu"] * 4)` a window calls the grouped local once a
    step plus once more (the last fold), each time with all four shards
    in shard order; no record is copied."""
    name = "shard_segments_local" if segments else "shard_scan_local"
    real = getattr(PK, name)
    calls = []

    def spy(shards, side, plan):
        calls.append([sh.index for sh in shards])
        return real(shards, side, plan)
    monkeypatch.setattr(PK, name, spy)
    pn, stacked, _spread0, n, _n_pad, z_pad = WORLD
    mesh = PS.Mesh(["cpu"] * 4)
    op = "burst_segments" if segments else "burst_scan"
    before = {k: obs.get(f"{k}.{op}") for k in ("steps", "copies",
                                                 "gather")}
    shards = PS.shard_node_arrays(mesh, pn)
    if segments:
        seg, gang, n_pods = _segments(SCAN_B, SEG_LAYOUT)
        PS.sharded_segments(mesh, shards, stacked, seg, gang, n_pods, 0, 0,
                            n, n, z_pad)
    else:
        PS.sharded_scan(mesh, shards, stacked, 0, 0, n, n, z_pad)
    steps = obs.get(f"steps.{op}") - before["steps"]
    assert steps == (n_pods if segments
                     else int((~stacked["skip"]).sum()))
    assert calls == [[0, 1, 2, 3]] * (steps + 1)
    assert obs.get(f"copies.{op}") == before["copies"]
    # the bytes still count every record in the buffer, copied or not
    gathered = obs.get(f"gather.{op}") - before["gather"]
    assert gathered > 0 and gathered % (steps * 4) == 0


def test_sharded_pressure_keeps_one_local_a_shard(monkeypatch):
    """The pressure wave's K13a runs one call a device and step over all
    of the device's shards, in shard order, plus one for the last fold:
    on `["cpu"] * 4` one call of the four shards a step, and no record is
    copied (each shard writes its record in place)."""
    real = PK.shard_pressure_local
    calls = []

    def spy(shards, side, plan):
        calls.append([sh.index for sh in shards])
        return real(shards, side, plan)
    monkeypatch.setattr(PK, "shard_pressure_local", spy)
    nodes, vic, stacked, ghost, n_real = _wave("plain")
    before = {k: obs.get(f"{k}.pressure") for k in ("steps", "copies")}
    _port_wave(nodes, vic, stacked, ghost, n_real, 7, 3, n_real, 4)
    steps = obs.get("steps.pressure") - before["steps"]
    assert steps == len(stacked["skip"])
    assert calls == [[0, 1, 2, 3]] * (steps + 1)
    assert obs.get("copies.pressure") == before["copies"]


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("devices,in_place,want", [
    (_cuda(0, 0, 0, 0), True, []),
    (_cuda(0, 0, 0, 0), False,
     [(s, torch.device("cuda", 0)) for s in range(4)]),
    (_cuda(0, 1, 2, 3), True,
     [(s, torch.device("cuda", d)) for d in range(4) for s in range(4)
      if s != d]),
    (_cuda(0, 0, 1, 1), True,
     [(2, torch.device("cuda", 0)), (3, torch.device("cuda", 0)),
      (0, torch.device("cuda", 1)), (1, torch.device("cuda", 1))]),
], ids=["one card in place", "one card, every row", "four cards in place",
        "two cards of two shards in place"])
def test_gather_plan(devices, in_place, want):
    """The all-gather's copies over device labels (no CUDA needed): in
    place, one card copies nothing, four cards of one shard each copy 12
    rows (3 into each buffer), two cards of two shards 4 (2 into each
    buffer, which writes its own 2 in place)."""
    plan = PS.gather_plan(devices, in_place)
    assert plan == want
    if in_place:
        for d in dict.fromkeys(devices):
            got = sorted([s for s, dd in plan if dd == d]
                         + [s for s, src in enumerate(devices) if src == d])
            assert got == list(range(len(devices)))


def test_gather_in_place_copies_only_foreign_rows():
    """`gather_in_place` on one device enqueues no copy and leaves the
    rows the locals wrote; `all_gather` on the same mesh still copies
    every record and counts its bytes."""
    mesh = PS.Mesh(["cpu"] * 4)
    buf = torch.arange(32, dtype=torch.uint8).reshape(4, 8)
    parts = [buf[s] for s in range(4)]
    assert PS.gather_in_place(mesh, parts, {torch.device("cpu"): buf}) == 0
    assert torch.equal(buf, torch.arange(32, dtype=torch.uint8).reshape(
        4, 8))
    own = [torch.full((8,), s + 1, dtype=torch.uint8) for s in range(4)]
    bufs, nbytes = PS.all_gather(mesh, own, {torch.device("cpu"): buf})
    assert bufs[torch.device("cpu")] is buf and nbytes == 32
    assert torch.equal(buf, torch.stack(own))


def _counting(per_call):
    """A C launch function that makes `per_call` launches a call: it adds
    them to the count it is given, as the kernels' launch functions do."""
    calls = []

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_int))
    def cfn(count):
        calls.append(1)
        count[0] += per_call
        return 0
    return cfn, calls


def test_relaunch_books_what_its_launch_function_counted():
    """`Relaunch.book()` moves the launches its C function counted to
    `launch.<name>` and starts again from 0."""
    cfn, calls = _counting(2)
    rel = PK.Relaunch("test_relaunch", cfn, (), None)
    before = obs.get("launch.test_relaunch")
    for _ in range(3):
        assert rel.fn() == 0
    assert rel.book() == 6 and len(calls) == 3
    assert obs.get("launch.test_relaunch") - before == 6
    assert rel.book() == 0


@pytest.mark.parametrize("segments", [False, True])
def test_run_steps_books_the_launches_made(monkeypatch, segments):
    """`_run_steps` books what the bound launches counted, not the steps:
    a local whose launch function makes two launches a call (as a device
    of more than `LOCAL_GROUP_SHARDS` shards does) books two a call, the
    select one, over the first call and every re-enqueue."""
    lname = "shard_segments_local" if segments else "shard_scan_local"
    sname = "shard_segments_select" if segments else "shard_scan_select"
    fns = {lname: _counting(2), sname: _counting(1)}
    rels = {}

    def fake(name):
        def call(*args):
            rel = rels.get(name)
            if rel is None:
                rel = rels[name] = PK.Relaunch(name, fns[name][0], (), None)
            assert rel.fn() == 0
            rel.book()
            return rel
        return call
    monkeypatch.setattr(PK, lname, fake(lname))
    monkeypatch.setattr(PK, sname, fake(sname))
    pn, stacked, _spread0, n, _n_pad, z_pad = WORLD
    mesh = PS.Mesh(["cpu"] * 4)
    op = "burst_segments" if segments else "burst_scan"
    before = {k: obs.get(k) for k in (f"steps.{op}", "launch." + lname,
                                      "launch." + sname)}
    shards = PS.shard_node_arrays(mesh, pn)
    if segments:
        seg, gang, n_pods = _segments(SCAN_B, SEG_LAYOUT)
        PS.sharded_segments(mesh, shards, stacked, seg, gang, n_pods, 0, 0,
                            n, n, z_pad)
    else:
        PS.sharded_scan(mesh, shards, stacked, 0, 0, n, n, z_pad)
    steps = obs.get(f"steps.{op}") - before[f"steps.{op}"]
    assert steps > 1
    assert len(fns[lname][1]) == steps + 1 and len(fns[sname][1]) == steps
    assert obs.get("launch." + lname) - before["launch." + lname] \
        == 2 * (steps + 1)
    assert obs.get("launch." + sname) - before["launch." + sname] == steps


def test_device_groups_in_first_shard_order():
    """One group on `["cpu"] * 4`, its shards in order, each shard's
    record a view of its row of the device's gathered buffer."""
    mesh, scan, sides, plan = _window(4, False)
    groups = PS.device_groups(mesh, scan)
    assert [(d, [sh.index for sh in g]) for d, g in groups] == [
        (torch.device("cpu"), [0, 1, 2, 3])]
    side = sides[torch.device("cpu")]
    assert tuple(side.gathered.shape) == (4, plan.record_bytes)
    for sh in scan:
        assert sh.rec.data_ptr() == side.gathered[sh.index].data_ptr()


# ---------------------------------------------------------------------------
# K13a: the pressure wave's grouped local step
# ---------------------------------------------------------------------------
def _pressure_window(d, world):
    """A fresh pressure wave's shards, per-device halves and plan on
    `["cpu"] * d`, over the K8 test chunk of tests/test_torch_preempt.py
    (64 nodes, 60 real, 16 pods, P 8; ghost load carried in). `world`:
    "plain"; "skip" (pods 11-15 skip pods); "zero" (no node's cpu in use:
    zero-victim candidates on every shard); "ties" (every node a copy of
    row 7 and its victim slots: the five criteria tie across shards)."""
    nodes, vic, stacked, ghost, n_real = _wave(
        "skip padding" if world == "skip" else "ghost carried in")
    if world == "skip":
        ghost = _wave("ghost carried in")[3]
    pn = {k: torch.as_tensor(v) for k, v in nodes.items()}
    vic = {k: torch.as_tensor(v) for k, v in vic.items()}
    if world == "zero":
        pn = dict(pn, req_cpu=torch.zeros_like(pn["req_cpu"]))
    if world == "ties":
        pn = {k: v if k == "valid" else v[7:8].expand_as(v).contiguous()
              for k, v in pn.items()}
        vic = {k: v[7:8].expand_as(v).contiguous() for k, v in vic.items()}
        ghost = {k: np.zeros_like(v) for k, v in ghost.items()}
    mesh = PS.Mesh(["cpu"] * d)
    rows = mesh.rows(pn["valid"].shape[0])
    P = int(vic["prio"].shape[1])
    B = len(stacked["skip"])
    stack = PK.PodStack.from_dense(
        {k: torch.as_tensor(v) for k, v in stacked.items()}, "cpu")
    scan, sides, plan, _steps = PS._scan_window(
        mesh, PS.shard_node_arrays(mesh, pn), stack, 7, 3, n_real, n_real,
        4, PK.DEFAULT_WEIGHTS, None, None, None,
        (PS._row_shards(mesh, {k: pn[k] for k in PK._MUTABLE}, rows,
                        PK._MUTABLE), None), None, n_steps=B,
        pressure={"ghost": PS._row_shards(
            mesh, {k: torch.as_tensor(v) for k, v in ghost.items()}, rows,
            PK.GHOST_FIELDS), "vic": PS.shard_victim_planes(mesh, vic),
            "P": P, "out": torch.empty((B, len(PK.PRESSURE_HEAD) + P),
                                       dtype=torch.int32)})
    return mesh, scan, sides, plan


# step states of a wave: (name, world, {slot: value}); "first" / "last"
# stand for the first row of the last shard and the last row of the first
PRESSURE_STATES = [
    ("bind folded on a shard's first row", "plain",
     {PK.SS_NEXT: 2, PK.SS_FOLD_SEL: "first", PK.SS_FOLD_ROW: 1}),
    ("bind folded on a shard's last row", "plain",
     {PK.SS_NEXT: 3, PK.SS_FOLD_SEL: "last", PK.SS_FOLD_ROW: 2}),
    ("a nomination's ghost fold", "plain",
     {PK.SS_NEXT: 9, PK.SS_GHOST_SEL: "last", PK.SS_FOLD_ROW: 8}),
    ("skip pod after a ghost fold", "skip",
     {PK.SS_NEXT: 12, PK.SS_GHOST_SEL: "first", PK.SS_FOLD_ROW: 11}),
    ("the fold past the wave", "plain",
     {PK.SS_NEXT: 16, PK.SS_FOLD_SEL: "first", PK.SS_FOLD_ROW: 4}),
    ("zero-victim nodes on every shard", "zero", {PK.SS_NEXT: 10}),
    ("ties across shards", "ties",
     {PK.SS_NEXT: 9, PK.SS_FOLD_SEL: "last", PK.SS_FOLD_ROW: 3}),
]


def _pressure_snapshot(scan, sides):
    out = {"gathered": [s.gathered.clone() for s in sides.values()]}
    for sh in scan:
        for k in PK._MUTABLE:
            out[f"{sh.index}/{k}"] = sh.nodes[k].clone()
        for k, v in sh.ghost.items():
            out[f"{sh.index}/ghost/{k}"] = v.clone()
    return out


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("name,world,state", PRESSURE_STATES,
                         ids=[s[0] for s in PRESSURE_STATES])
def test_grouped_pressure_local_equals_per_shard_step_and_gather(
        d, name, world, state):
    """One call of the grouped plain K13a over a device's shards, records
    in place, against the per-shard K13a into each shard's own buffer
    followed by a full all_gather: every cycle record, candidate record,
    folded row and ghost load equal."""
    results = []
    for grouped in (True, False):
        mesh, scan, sides, plan = _pressure_window(d, world)
        rows = scan[0].rows
        where = {"first": (mesh.size - 1) * rows, "last": rows - 1}
        for side in sides.values():
            for slot, v in state.items():
                side.st[slot] = where.get(v, v)
        if grouped:
            for dev, shards in PS.device_groups(mesh, scan):
                assert PK.shard_pressure_local(shards, sides[dev],
                                               plan) is None
        else:
            own = [torch.zeros(plan.record_bytes, dtype=torch.uint8)
                   for _ in scan]
            for sh, rec in zip(scan, own):
                sh.rec = rec
                PK.shard_pressure_local_plain(sh, sides[sh.device], plan)
            PS.all_gather(mesh, own, {dv: sides[dv].gathered
                                      for dv in mesh.distinct})
        results.append(_pressure_snapshot(scan, sides))
        side0 = sides[mesh.devices[0]]
        cand = PK._pick_records_plain(side0.gathered, plan.cand_off,
                                      plan.vic_P)
    got, want = results
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], list):
            for a, b in zip(got[k], want[k]):
                assert torch.equal(a, b), (name, d, k)
        else:
            assert torch.equal(got[k], want[k]), (name, d, k)
    live = state[PK.SS_NEXT] < 16
    assert bool(got["gathered"][0].any()) == live, name
    if world == "ties":
        # every node alike: the pick falls to the lowest row, shard 0's
        assert cand[0] == 0, cand
    if world == "zero":
        assert cand[0] >= 0 and cand[1] == 0, cand
