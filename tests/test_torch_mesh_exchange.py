"""The mesh step's record exchange on the device, and the grouped K9c, on
the CPU.

A mesh step's local kernel (K10a / K11a / K13a) writes each shard's
record into row s of every distinct device's gathered buffer (its own by
a plain store, the other cards' through peer pointers), into half i & 1
of the buffer at step i, then publishes a stamp, stamp_base + i + 1, that
the step's select (K10b / K11b / K13b) waits for on its own device. The
stamps count up over a mesh's life; each window reserves its values.
Checked here: the exchange plan over device labels (the peer table,
`exchange_kind`, the stamp values of a window and step), the launch slot
tables against the C enums, and the plain sharded scan, fused window and
pressure wave through the parity halves and stamps on 2 and 4 CPU shards,
two windows back to back on one mesh, each equal to JAX's sharded
programs (`schedule_batch(mesh=)` / `schedule_batch_segments(mesh=)` /
`pressure_batch(mesh=)` on conftest's virtual CPU mesh). Then K9c: one
launch a device over its shards, each shard a cluster of SWEEP_BLOCKS
blocks; its grouped plain version (the kernel's block split, records in
place in the gathered buffer) against the per-shard plain version on
every pass of real bursts, and the burst against JAX's
`sharded_uniform_fn`. Tolerance: exact equality (every output is an
integer).
"""
import re

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_kernels import _tensors, assert_same
from tests.test_torch_sharding import _cat, _port_kw, _uniform_case
from tests.test_torch_sharding_preempt import (
    _check_wave, _jax_wave, _wave)
from tests.test_torch_sharding_scan import (
    _check_window, _jnodes, _jpods, _scan_case, _segments_case)

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


# ---------------------------------------------------------------------------
# the exchange plan over device labels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("devices,want", [
    (_cuda(0, 0, 0, 0), [(s, _cuda(0)) for s in range(4)]),
    (_cuda(0, 1, 2, 3), [(s, _cuda(s) + [d for d in _cuda(0, 1, 2, 3)
                                         if d.index != s])
                         for s in range(4)]),
    (_cuda(0, 0, 1, 1), [(0, _cuda(0, 1)), (1, _cuda(0, 1)),
                         (2, _cuda(1, 0)), (3, _cuda(1, 0))]),
], ids=["one card", "four cards", "two cards of two shards"])
def test_exchange_plan(devices, want):
    """Each shard's record goes to its own device first, then to every
    other distinct device in first-shard order (the `peer_rec<k>` slots);
    one card writes no peer."""
    assert PS.exchange_plan(devices) == want


def test_exchange_kind():
    """"peer" on one device, or when every ordered pair of cards reaches
    the other; one missing pair makes the whole mesh "copy", and so does
    a mesh wider than the peer table."""
    yes = lambda a, b: True  # noqa: E731
    assert PS.exchange_kind(["cpu"] * 4) == "peer"
    assert PS.exchange_kind(_cuda(0, 0, 0, 0)) == "peer"
    assert PS.exchange_kind(_cuda(0, 1, 2, 3), yes) == "peer"
    missing = lambda a, b: (a.index, b.index) != (2, 1)  # noqa: E731
    assert PS.exchange_kind(_cuda(0, 1, 2, 3), missing) == "copy"
    wide = _cuda(*range(PK.MAX_PEERS + 2))
    assert PS.exchange_kind(wide, yes) == "copy"
    assert PS.exchange_kind(wide[:-1], yes) == "peer"


def test_mesh_records_its_exchange_and_reserves_stamps():
    """A CPU mesh exchanges on the device (one distinct device: no peer);
    `exchange=` names it instead; each window reserves its steps and its
    last fold, so window w + 1's first stamp lies above window w's last."""
    mesh = PS.Mesh(["cpu"] * 4)
    assert mesh.exchange == "peer" and "peer" in repr(mesh)
    assert PS.Mesh(["cpu"] * 2, exchange="copy").exchange == "copy"
    with pytest.raises(ValueError):
        PS.Mesh(["cpu"], exchange="nvlink")
    b0 = mesh.reserve_stamps(3 + 1)
    b1 = mesh.reserve_stamps(5 + 1)
    assert (b0, b1) == (0, 4)
    assert [PK.stamp_value(b0, i) for i in range(4)] == [1, 2, 3, 4]
    assert PK.stamp_value(b1, 0) == 5 > PK.stamp_value(b0, 3)
    stamps = PS.mesh_stamps(mesh)
    assert set(stamps) == {CPU} and stamps[CPU].shape == (2, 4)
    assert not stamps[CPU].any() and PS.mesh_stamps(mesh) is stamps


# ---------------------------------------------------------------------------
# the slot tables against the kernels' sources
# ---------------------------------------------------------------------------
def _src(name):
    return (_build.CSRC / name).read_text()


def _const(src, name):
    return int(re.search(rf"constexpr \w+ {name} = (\w+);", src).group(1))


def test_exchange_slots_match_the_kernels():
    """The round after the step state, the peer table and the stamps: the
    host's slots name the C enums' (the one-to-one check of every slot is
    tests/test_torch_imports.py's), the peer slots follow the record, a
    launch of four shards still fits the 4 KB parameter limit, and the
    select spins with a system-scope acquire bounded by the global timer
    before it traps."""
    scan = _src("shard_scan.cuh")
    assert "constexpr int SS_ROUND = SS_COUNT;" in scan
    assert "constexpr int SS_WORDS = SS_COUNT + 1;" in scan
    assert PK.SS_ROUND == PK.SS_COUNT and PK.SS_WORDS == PK.SS_COUNT + 1
    assert _const(scan, "MAX_PEERS") == PK.MAX_PEERS
    at = PK._SSL_PTRS.index("rec")
    assert PK._SSL_PTRS[at: at + 3 + 2 * PK.MAX_PEERS] == (
        "rec", "stamps", "ticket") + tuple(
        f"peer_rec{k}" for k in range(PK.MAX_PEERS)) + tuple(
        f"peer_stamps{k}" for k in range(PK.MAX_PEERS))
    assert PK._SSL_INTS[-5:] == ("index", "D", "half", "stamp_base",
                                 "n_peers")
    assert PK._SSS_INTS[-1] == "stamp_base" and PK._SSS_PTRS[-1] == "stamps"
    assert PK.LOCAL_GROUP_SHARDS * 8 * (len(PK._SSL_INTS)
                                        + len(PK._SSL_PTRS)) <= 4096
    for token in ("st.release.sys.global.b64", "ld.acquire.sys.global.b64",
                  "%%globaltimer", "__trap()", "__nanosleep"):
        assert token in scan, token
    select = _src("cluster_select.cuh")
    assert "stamp_wait(a, round)" in select
    assert "select_records(a, round)" in select
    for name in PK.SELECT_CLUSTER_KERNELS:
        assert "st[SS_ROUND]" in _src(f"{name}.cu") or \
            "[SS_ROUND] = " in _src(f"{name}.cu"), name
    for name in ("shard_scan_local.cu", "shard_segments_local.cu"):
        assert "local_publish(a, nblk);" in _src(name), name
    assert "candidate_publish(a);" in _src("shard_pressure_local.cu")
    local = _src("shard_scan_local.cu")
    assert 'extern "C" int mesh_enable_peers(const int* devices, int n)' \
        in local
    assert "cudaErrorPeerAccessAlreadyEnabled" in local
    assert list(_build.QUERIES["shard_scan_local"]) == ["mesh_enable_peers"]


def test_sweep_slots_match_the_kernel():
    """K9c takes a device's shards in one launch: the host packs each
    shard's `_SUS_INTS` then `_SUS_PTRS` (the C struct `SweepArgs`), as
    many shards a launch as `SWEEP_GROUP`, each shard a cluster of
    `SWEEP_BLOCKS` blocks of `SWEEP_THREADS`; the first pass comes from
    the pass state, not an argument; the launch takes (words, shard
    count, device index, stream, launch count) and counts its launches."""
    src = _src("shard_uniform_sweep.cu")
    for name in ("SWEEP_BLOCKS", "SWEEP_THREADS", "SWEEP_GROUP"):
        assert _const(src, name) == getattr(PK, name), name
    assert "constexpr int SW_WORDS = US_COUNT + UP_COUNT;" in src
    assert "static_assert(sizeof(SweepArgs) == 8 * SW_WORDS" in src
    assert "__cluster_dims__(SWEEP_BLOCKS, 1, 1)" in src
    assert "__grid_constant__ SweepGroup" in src
    assert "pass == 0" in src and "init" not in PK._SUS_INTS
    assert "if (e == cudaSuccess) ++*launched;" in src
    assert PK.SWEEP_GROUP * 8 * (len(PK._SUS_INTS)
                                 + len(PK._SUS_PTRS)) <= 4096
    assert _build.SIGNATURES["shard_uniform_sweep"] \
        == _build.SIGNATURES["shard_scan_local"]
    assert re.search(r'extern "C" int shard_uniform_sweep_launch\(const i64\* '
                     r'words, int n,\s*int device, void\* stream,\s*int\* '
                     r'launched\)', src)


# ---------------------------------------------------------------------------
# the plain windows through the halves and stamps, against JAX
# ---------------------------------------------------------------------------
def _stamps_after(mesh, base, steps, last_fold=True):
    """The stamps a window of `steps` steps from `base` leaves: its last
    step's in half (steps - 1) & 1, the last fold's (K10a / K11a: it
    publishes too) in half steps & 1."""
    st = PS.mesh_stamps(mesh)[CPU]
    last = PK.stamp_value(base, steps - 1)
    assert (st[(steps - 1) & 1] == last).all(), st
    fold = PK.stamp_value(base, steps) if last_fold else last - 1
    assert (st[steps & 1] == fold).all(), st


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("exchange", ["peer", "copy"])
def test_scan_windows_back_to_back_match_jax(d, exchange):
    """Two scan windows on one mesh, the second from the first's li / lni
    (a fresh window's half and round start at 0; its stamps lie above the
    first's), each equal to JAX's `schedule_batch(mesh=)` and the
    single-device plain K5. Under "copy" no stamp is read or written."""
    mesh = PS.Mesh(["cpu"] * d, exchange=exchange)
    jmesh = JS.make_mesh(d)
    base = 0
    for case in ("skips", "spread"):
        jn, pn, stacked, n, z_pad, ntf, li, lni, kw = _scan_case(case)
        want = JK.schedule_batch(_jnodes(jmesh, jn), _jpods(stacked), li,
                                 lni, ntf, n, z_pad, mesh=jmesh, **kw)
        before = obs.get("steps.burst_scan")
        got = PK.schedule_batch(PS.shard_node_arrays(mesh, pn), stacked, li,
                                lni, ntf, n, z_pad, mesh=mesh,
                                **_tensors(kw))
        single = PK.schedule_batch_plain(pn, stacked, li, lni, ntf, n, z_pad,
                                         **_tensors(kw))
        _check_window(got, want, single)
        steps = obs.get("steps.burst_scan") - before
        assert steps > 2
        if exchange == "peer":
            _stamps_after(mesh, base, steps)
        base += steps + 1
        assert mesh._stamp_next == base
    if exchange == "copy":
        assert mesh._stamps is None


@pytest.mark.parametrize("d", [2, 4])
def test_segments_windows_back_to_back_match_jax(d):
    """Two fused windows on one mesh (a gang rewound across the shards in
    each, odd and even step counts, so the halves swap between windows),
    each equal to JAX's `schedule_batch_segments(mesh=)`."""
    mesh, jmesh = PS.Mesh(["cpu"] * d), JS.make_mesh(d)
    base = 0
    for case in ("short", "gang_score"):
        jn, pn, stacked, seg, gang, n_pods, n, _n_pad, ntf, kw = \
            _segments_case(case)
        args = (seg, gang, n_pods, 3, 5, ntf, n, 8)
        want = JK.schedule_batch_segments(_jnodes(jmesh, jn),
                                          _jpods(stacked), *args,
                                          mesh=jmesh, **kw)
        got = PK.schedule_batch_segments(PS.shard_node_arrays(mesh, pn),
                                         stacked, *args, mesh=mesh,
                                         **_tensors(kw))
        single = PK.schedule_batch_segments_plain(pn, stacked, *args,
                                                  **_tensors(kw))
        _check_window(got, want, single)
        _stamps_after(mesh, base, n_pods)
        base += n_pods + 1


@pytest.mark.parametrize("d", [2, 4])
def test_pressure_waves_back_to_back_match_jax(d):
    """Two pressure waves on one mesh, the second on the first's rows,
    ghost load, li and lni (chained chunks), each equal to JAX's
    `pressure_batch(mesh=)`; K13a publishes no stamp on the fold past the
    wave (its row blocks return before their ticket)."""
    nodes, vic, stacked, ghost, n_real = _wave("plain")
    mesh = PS.Mesh(["cpu"] * d)
    pn = {k: torch.as_tensor(v) for k, v in nodes.items()}
    pst = {k: torch.as_tensor(v) for k, v in stacked.items()}
    shards = PS.shard_node_arrays(mesh, pn)
    B = len(stacked["skip"])
    want = _jax_wave(nodes, vic, stacked, ghost, n_real, 7, 3, n_real, d)
    got = PK.pressure_batch(shards, {k: pn[k] for k in PK._MUTABLE}, ghost,
                            pst, vic, 7, 3, n_real, n_real, 4, mesh=mesh)
    _check_wave(got, want)
    _stamps_after(mesh, 0, B, last_fold=False)
    want2 = _jax_wave(nodes, vic, stacked, want[1], n_real, want[2],
                      want[3], n_real, d, mut=want[0])
    got2 = PK.pressure_batch(shards, got[0], got[1], pst, vic, got[2],
                             got[3], n_real, n_real, 4, mesh=mesh)
    _check_wave(got2, want2)
    _stamps_after(mesh, B + 1, B, last_fold=False)


def test_a_select_without_its_stamps_raises():
    """A select whose step's records were never published (no local ran)
    raises, as the kernel's bounded wait traps; after its local it runs
    and advances the round to the next half."""
    jn, pn, stacked, n, z_pad, ntf, li, lni, kw = _scan_case("identity")
    mesh = PS.Mesh(["cpu"] * 2)
    scan, sides, plan, _steps = PS._scan_window(
        mesh, PS.shard_node_arrays(mesh, pn), stacked, li, lni, ntf, n,
        z_pad, PK.DEFAULT_WEIGHTS, None, None, None, None, None)
    side = sides[CPU]
    with pytest.raises(RuntimeError, match="did not publish"):
        PK.shard_scan_select_plain(side, plan)
    PK.shard_scan_local_plain(scan, side, plan)
    assert (side.stamps[0] == PK.stamp_value(plan.stamp_base, 0)).all()
    assert not side.halves[1].any() and side.halves[0].any()
    PK.shard_scan_select_plain(side, plan)
    assert int(side.st[PK.SS_ROUND]) == 1
    assert side.records().data_ptr() == side.halves[1].data_ptr()


# ---------------------------------------------------------------------------
# K9c: one launch a device over its shards
# ---------------------------------------------------------------------------
def test_sweep_chunk():
    """SWEEP_BLOCKS contiguous slices of `sweep_chunk` columns cover a
    shard's columns once; a ragged width leaves the last slices short or
    empty."""
    assert PK.sweep_chunk(16) == 2 and PK.sweep_chunk(17) == 3
    for w in (1, 5, 16, 17, 4096, 4097):
        c = PK.sweep_chunk(w)
        cover = [j for b in range(PK.SWEEP_BLOCKS)
                 for j in range(min(b * c, w), min((b + 1) * c, w))]
        assert cover == list(range(w))


def _sweep_fields(sh):
    return [sh.rec, sh.tot, sh.flags, sh.st, sh.folded]


@pytest.mark.parametrize("d,case", [
    (2, "stay"), (4, "stay"), (4, "rotate"), (2, "ban+extra_ok"),
    (4, "wtab+carried")])
def test_grouped_sweep_matches_per_shard_and_jax(monkeypatch, d, case):
    """Every pass of a burst on `["cpu"] * d`: the grouped plain K9c (one
    call over the device's shards, its records in place in the gathered
    buffer, each shard in SWEEP_BLOCKS slices: 16 or 32 rows a shard, a
    ragged last shard with the scratch column) equals the per-shard plain
    version on copies of the same state, the first pass's init read from
    the pass state; and the burst equals JAX's `sharded_uniform_fn` and
    the single-device plain K3."""
    real = PK.shard_uniform_sweep
    seen = {"calls": 0, "init": 0, "slices": set()}

    def spy(shards, state, clsv, R, NS, check_res, has_req, ban, weights,
            wrow, n_real, n_pods):
        init = int(state[PK.ST_PASS]) == 0
        ref = []
        for sh in shards:
            c = PK.UniformShard(sh.offset, sh.rows, sh.width, sh.nodes,
                                sh.st.clone(), sh.xa, sh.sa, sh.su, sh.extra)
            c.tot, c.flags, c.folded = (sh.tot.clone(), sh.flags.clone(),
                                        sh.folded.clone())
            c.rec.copy_(sh.rec)
            PK.shard_uniform_sweep_plain(c, state.clone(), clsv, R, NS,
                                         check_res, has_req, ban, weights,
                                         wrow, n_real, n_pods, init)
            ref.append(c)
        out = real(shards, state, clsv, R, NS, check_res, has_req, ban,
                   weights, wrow, n_real, n_pods)
        for sh, c in zip(shards, ref):
            for a, b in zip(_sweep_fields(sh), _sweep_fields(c)):
                assert torch.equal(a, b), (case, sh.offset)
            seen["slices"].add(-(-sh.width // PK.sweep_chunk(sh.width)))
        assert len({sh.rec.data_ptr() for sh in shards}) == len(shards)
        seen["calls"] += 1
        seen["init"] += init
        return out
    monkeypatch.setattr(PK, "shard_uniform_sweep", spy)
    pn, jn, cls, n_pods, lni, n, kw = _uniform_case(case)
    jmesh, mesh = JS.make_mesh(d), PS.Mesh(["cpu"] * d)
    before = {k: obs.get(f"{k}.burst_uniform") for k in ("copies",
                                                         "passes")}
    jrows, jpacked, jlni = JK.schedule_batch_uniform(
        JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                     for k, v in jn.items()}),
        dict(cls), n_pods, lni, n, True, mesh=jmesh, **kw)
    rows, packed, plni = PK.schedule_batch_uniform(
        PS.shard_node_arrays(mesh, pn), dict(cls), n_pods, lni, n, True,
        mesh=mesh, **_port_kw(kw))
    srows, spacked, _slni = PK.schedule_batch_uniform(
        pn, dict(cls), n_pods, lni, n, True, **_port_kw(kw))
    assert_same(packed, jpacked, "packed")
    assert_same(packed, spacked, "packed vs single-device")
    assert int(plni) == int(jlni)
    full = _cat(rows)
    for k in jrows:
        assert_same(full[k], jrows[k], k)
        assert_same(full[k], srows[k], k)
    passes = obs.get("passes.burst_uniform") - before["passes"]
    # one call a pass plus the last fold, the first one the init; no
    # record copied on one device
    assert seen["init"] == 1 and seen["calls"] >= passes + 1 > 2
    assert obs.get("copies.burst_uniform") == before["copies"]
    # several blocks a shard; a shard of 16 rows fills all eight, the
    # ragged last one (17 columns) fewer
    assert min(seen["slices"]) > 1
    assert max(seen["slices"]) == PK.SWEEP_BLOCKS or d == 2


def test_grouped_sweep_writes_each_record_in_place():
    """On `["cpu"] * 4` each shard's record is row s of the device's
    gathered buffer (a view); a record of another size is refused."""
    pn, _jn, cls, n_pods, lni, n, kw = _uniform_case("stay")
    mesh = PS.Mesh(["cpu"] * 4)
    captured = {}
    real = PK.shard_uniform_sweep

    def spy(shards, *args):
        captured.setdefault("shards", shards)
        return real(shards, *args)
    mp = pytest.MonkeyPatch()
    mp.setattr(PK, "shard_uniform_sweep", spy)
    try:
        PK.schedule_batch_uniform(PS.shard_node_arrays(mesh, pn), dict(cls),
                                  n_pods, lni, n, True, mesh=mesh,
                                  **_port_kw(kw))
    finally:
        mp.undo()
    shards = captured["shards"]
    base = shards[0].rec.data_ptr()
    assert [sh.rec.data_ptr() - base for sh in shards] == [
        s * shards[0].rec.numel() for s in range(4)]
    assert shards[-1].width == shards[-1].rows + 1
    sh = shards[0]
    with pytest.raises(ValueError, match="record"):
        PK.UniformShard(sh.offset, sh.rows, sh.width, sh.nodes, sh.st,
                        sh.xa, sh.sa, sh.su, sh.extra,
                        rec=torch.zeros(3, dtype=torch.uint8))
