"""K4, the dirty-row scatter, as one staged buffer, one copy and one launch
a device, on the CPU.

A K4 call packs, for each shard of a device that owns a dirty row, its
row list (int32, padded to a power-of-two bucket by repeating its first
row) and each field's rows, taken from the host table, into one host
buffer, every segment 16-B aligned (`ScatterLayout`); one copy brings it
to the device, where the kernel finds each field's rows from the bucket
size and writes them through the device's field table (`ScatterTable`,
made once per resident table). `scatter_staged_plain` decodes the buffer
the way the kernel indexes it. Checked here: the layout's offsets; the
staged scatter against JAX's `_scatter_rows` (`tpu_scheduler.py:158`) and
the port's `scatter_rows_plain` for bool / int8 / int32 / int64 / float64
fields, 1-D and 2-D, victim planes at P 16 and 128, duplicate, negative
and out-of-range rows; the scheduler's `_scatter_dirty` on a mesh of 4
(one staged call a device, each shard its own rows) and on one device;
the field table's reuse; its slots against the kernel's C enum.
`chip_smoke.py` holds the kernel against these plain versions on the
card. The same numpy inputs, made from seeds, go to both packages.
Tolerance: exact equality.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.core.tpu_scheduler import _scatter_rows as j_scatter
from tests.test_torch_imports import _enum_slots
from tests.test_torch_kernels import assert_same
from tests.test_torch_preempt import rand_victims

from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 64
#: a table with every element type the resident tables hold, 1-D and 2-D
MIXED = {"b": (np.bool_, ()), "c": (np.int8, ()), "z": (np.int32, ()),
         "q": (np.int64, ()), "s": (np.int64, (3,)), "m": (np.bool_, (5,)),
         "f": (np.float64, (2,))}


def _table(seed, spec, n=N):
    rng = np.random.default_rng(seed)
    out = {}
    for k, (dt, shape) in spec.items():
        v = rng.integers(-50, 50, (n,) + shape)
        out[k] = (v > 0).astype(dt) if dt is np.bool_ else v.astype(dt)
    return out


def _nodes(seed, n=N):
    """The 14 node fields of the resident matrix, random."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, 1000, n).astype(np.int64)
           for k in ("alloc_cpu", "alloc_mem", "alloc_eph", "allowed_pods",
                     "req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem",
                     "pod_count")}
    out["valid"] = rng.random(n) < 0.9
    out["alloc_scalar"] = rng.integers(0, 9, (n, 2)).astype(np.int64)
    out["req_scalar"] = rng.integers(0, 9, (n, 2)).astype(np.int64)
    out["zone_id"] = rng.integers(0, 3, n).astype(np.int32)
    return out


def _victims(seed, P, n=N):
    return {k: np.asarray(v) for k, v in rand_victims(
        np.random.default_rng(seed), n, P).items()}


def _changed(table, seed):
    """The host table after the rows changed: every value moved."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in table.items():
        if v.dtype == np.bool_:
            out[k] = ~v
        elif v.dtype == np.float64:
            out[k] = v + rng.random(v.shape)
        else:
            out[k] = (v + rng.integers(1, 9, v.shape)).astype(v.dtype)
    return out


ROWS = {
    "sorted": lambda rng: np.sort(rng.choice(N, 11, replace=False)),
    "duplicates": lambda rng: np.concatenate(
        [np.sort(rng.choice(N, 9, replace=False)), [5, 5, 40]]),
    "negative": lambda rng: np.concatenate(
        [np.sort(rng.choice(N - 8, 7, replace=False)), [-1, -N]]),
    "out of range": lambda rng: np.concatenate(
        [np.sort(rng.choice(N, 6, replace=False)), [N, N + 7, -N - 3]]),
}


# ---------------------------------------------------------------------------
# the staged layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["node fields", "victim planes P16",
                                  "victim planes P128"])
def test_staged_layout(what):
    """Each part's row list at its base, then each field's rows in field
    order, every segment 16-B aligned; the offsets the kernel sums (row
    list, then the fields before) are the layout's `offsets`; a part's
    segment ends where the next begins."""
    host = _nodes(1) if what == "node fields" else _victims(
        1, int(what[-3:].strip("P")))
    dev = [{k: torch.as_tensor(v.copy()) for k, v in host.items()}]
    table = PK.ScatterTable(dev, tuple(host))
    layout = PK.ScatterLayout.of(table, [(0, 16), (0, 32)])
    end = 0
    for i, (k, bucket, base) in enumerate(layout.parts):
        assert base == end and base % PK.STAGE_ALIGN == 0
        o = base + -(-4 * bucket // 16) * 16
        for f, rb in enumerate(table.row_bytes):
            assert layout.offsets[i][f] == o
            assert o % PK.STAGE_ALIGN == 0
            o += -(-bucket * rb // 16) * 16
        end = o
    assert layout.nbytes == end
    assert table.row_bytes == tuple(
        int(np.prod(v.shape[1:], dtype=np.int64)) * v.itemsize
        for v in host.values())
    assert table.words is None      # no device table on the CPU


# ---------------------------------------------------------------------------
# the staged scatter against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(ROWS))
@pytest.mark.parametrize("spec", ["mixed", "node fields"])
def test_staged_rows_match_jax(spec, case):
    """`scatter_rows` (the rows as given, each field's rows packed into
    the staged buffer, decoded by `scatter_staged_plain`) writes what
    JAX's `_scatter_rows` and `scatter_rows_plain` write: a negative row
    wraps once, a row still out of range is dropped, duplicates carry
    equal values."""
    base = _table(2, MIXED) if spec == "mixed" else _nodes(2)
    new = _changed(base, 3)
    rows = ROWS[case](np.random.default_rng(4)).astype(np.int64)
    upd = {k: v[np.clip(np.where(rows < 0, rows + N, rows), 0, N - 1)]
           for k, v in new.items()}
    want = j_scatter({k: jnp.asarray(v) for k, v in base.items()},
                     jnp.asarray(rows), {k: jnp.asarray(v)
                                         for k, v in upd.items()})
    got = PK.scatter_rows({k: torch.as_tensor(v.copy())
                           for k, v in base.items()}, rows, upd)
    plain = PK.scatter_rows_plain({k: torch.as_tensor(v.copy())
                                   for k, v in base.items()},
                                  torch.as_tensor(rows),
                                  {k: torch.as_tensor(v)
                                   for k, v in upd.items()})
    for k in base:
        assert_same(got[k], want[k], k)
        assert_same(plain[k], want[k], k)


@pytest.mark.parametrize("P", [16, 128])
def test_staged_victim_planes_match_jax(P):
    """The victim planes' dirty rows straight from the host table
    (`scatter_prepare`: each field's rows taken into the staged buffer,
    the list padded to 16 by its first row): JAX's `_scatter_rows` of the
    padded rows, and the decoded buffer holds them."""
    base = _victims(5, P)
    new = _changed(base, 6)
    dirty = np.asarray([3, 9, 10, 40, 63])
    dev = {k: torch.as_tensor(v.copy()) for k, v in base.items()}
    table = PK.scatter_table([dev], tuple(base))
    staged, layout = PK.scatter_prepare(table, [(0, dirty, 0)],
                                        [new[k] for k in base])
    rows, fields = layout.views(staged, 0)
    pad = np.concatenate([dirty, np.full(11, dirty[0])])
    assert_same(rows, pad, "row list")
    for k, v in zip(base, fields):
        assert_same(v, new[k][pad], k)
    PK.scatter_staged([dev], staged, layout)
    want = j_scatter({k: jnp.asarray(v) for k, v in base.items()},
                     jnp.asarray(pad), {k: jnp.asarray(new[k][pad])
                                        for k in base})
    for k in base:
        assert_same(dev[k], want[k], k)


class _Src(types.SimpleNamespace):
    """A host table: its fields as attributes."""


@pytest.mark.parametrize("what", ["node fields", "victim planes"])
def test_scatter_dirty_on_a_mesh_of_four(monkeypatch, what):
    """`_scatter_dirty` on a 4-shard mesh of one device: ONE staged call
    (one copy, one launch on a card) covering every shard that owns a
    dirty row, each with its own rows local to it; every shard's rows
    equal JAX's `_scatter_rows` of the whole matrix, sliced."""
    host = _nodes(7) if what == "node fields" else _victims(7, 16)
    fields = [(k, k) for k in host]
    new = _changed(host, 8)
    dirty = [60, 3, 17, 3, 50, 18]     # no row on shard 2, one repeated
    mesh = PS.Mesh(["cpu"] * 4)
    sched = TorchScheduler(device="cpu", mesh=mesh)
    dev = PS.shard_node_arrays(mesh, host) if what == "node fields" \
        else PS.shard_victim_planes(mesh, host)
    calls = []
    real = PK.scatter_staged

    def spy(shards, staged, layout):
        calls.append(layout)
        return real(shards, staged, layout)
    monkeypatch.setattr(PK, "scatter_staged", spy)
    sched._scatter_dirty(dev, dirty, N, _Src(**new), fields)
    assert len(calls) == 1
    assert [(k, b) for k, b, _base in calls[0].parts] == [
        (0, 16), (1, 16), (3, 16)]
    rows, _f = calls[0].views(np.zeros(calls[0].nbytes, np.uint8), 0)
    pad = np.unique(dirty)
    want = j_scatter({k: jnp.asarray(v) for k, v in host.items()},
                     jnp.asarray(pad), {k: jnp.asarray(new[k][pad])
                                        for k in host})
    for s, shard in enumerate(dev):
        for k in host:
            assert_same(shard[k], np.asarray(want[k])[s * 16: (s + 1) * 16],
                        f"shard {s} {k}")
    # the table is made once per resident table and reused
    key = (tuple(host), "cpu")
    table = sched._k4_tables[key]
    sched._scatter_dirty(dev, [1], N, _Src(**new), fields)
    assert sched._k4_tables[key] is table


def test_scatter_dirty_on_one_device():
    """The single-device scheduler: the deduplicated rows padded to a
    power-of-two bucket of at least 16 by the first row, as JAX's
    scatter of the padded list."""
    host = _nodes(9)
    new = _changed(host, 10)
    dirty = list(range(0, 60, 3)) + [6, 9]      # 20 rows: bucket 32
    sched = TorchScheduler(device="cpu")
    dev = {k: torch.as_tensor(v.copy()) for k, v in host.items()}
    sched._scatter_dirty(dev, dirty, N, _Src(**new),
                         [(k, k) for k in host])
    pad = np.unique(dirty)
    pad = np.concatenate([pad, np.full(32 - len(pad), pad[0])])
    want = j_scatter({k: jnp.asarray(v) for k, v in host.items()},
                     jnp.asarray(pad), {k: jnp.asarray(new[k][pad])
                                        for k in host})
    for k in host:
        assert_same(dev[k], want[k], k)


def test_scatter_table_follows_the_resident_tensors():
    """A field table describes the tensors it was made from: the same
    dicts reuse it; a field replaced (a whole upload, a window's folded
    rows adopted) or another field set makes a new one."""
    host = _nodes(11)
    dev = {k: torch.as_tensor(v.copy()) for k, v in host.items()}
    keys = tuple(host)
    table = PK.scatter_table([dev], keys)
    assert PK.scatter_table([dev], keys, table) is table
    assert PK.scatter_table([dict(dev)], keys, table) is table
    dev["req_cpu"] = dev["req_cpu"].clone()
    assert PK.scatter_table([dev], keys, table) is not table
    assert PK.scatter_table([dev], keys[:3], table) is not table
    with pytest.raises(ValueError, match="shards"):
        PK.ScatterTable([dev] * (PK.SCATTER_MAX_SHARDS + 1), keys)


def test_scatter_slots_match_the_kernel():
    """The field table's words and the call's shard slots against
    `scatter_rows.cu`: four words a field (destination, rows, row bytes,
    copy unit), SCATTER_MAX_SHARDS shards a launch, 16-B segments; the
    launch takes the call's words, the table, the staged buffer and the
    stream."""
    src = (_build.CSRC / "scatter_rows.cu").read_text()
    assert _enum_slots(src, "FT_WORDS") == ["FT_DST", "FT_ROWS",
                                            "FT_ROW_BYTES", "FT_UNIT"]
    assert PK._FT_WORDS == 4 and PK.STAGE_ALIGN == 16
    assert f"SCATTER_MAX_SHARDS = {PK.SCATTER_MAX_SHARDS};" in src
    assert f"SCATTER_THREADS = {PK._SCATTER_THREADS};" in src
    assert "(n + 15) & ~(i64)15" in src
    assert len(_build.SIGNATURES["scatter_rows"]) == 4
    assert "__grid_constant__ ScatterCall" in src
