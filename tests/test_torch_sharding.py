"""Node-axis sharding of the port (`kubernetes_tpu_torch.parallel`) against
the JAX package's sharded programs, on the CPU.

The port's mesh is a list of torch devices; `["cpu"] * D` splits the node
axis into D shards here, as conftest's virtual 8-device CPU mesh does for
JAX. The same numpy inputs go through `S.sharded_cycle_fn(make_mesh(D))`
and `K.schedule_batch_uniform(mesh=make_mesh(D))` in JAX, through the
port's sharded programs (K9a-d's plain versions, an all-gather between
them) and through the port's single-device plain K2/K3; a mesh
TorchScheduler runs beside `TPUScheduler(mesh=make_mesh(4))` and the serial
oracle. Every comparison is exact. The jitted JAX programs are shared
across cases (GSPMD compiles on the virtual mesh are the slow part).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu.parallel import sharding as JS
from tests.test_torch_encoders import to_port, uniform_pods
from tests.test_torch_kernels import (
    CYCLE_OUT, _cycle_inputs, _uniform_inputs, assert_same)
from tests.test_torch_scheduler import Trio, burst_nodes

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.carry import state_from_jax
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops import kernels as PK
from kubernetes_tpu_torch.parallel import sharding as PS
from tests.torch_threads import one_torch_thread  # noqa: F401


NODE_FIELDS = TorchScheduler._NODE_FIELDS


@pytest.fixture(scope="module")
def jax_cycle_fns():
    """sharded_cycle_fn jits by (D, z_pad, weights, wtab), built once."""
    cache = {}

    def get(d, z_pad, weights=None, use_wtab=False):
        key = (d, z_pad, tuple(sorted((weights or {}).items())), use_wtab)
        if key not in cache:
            cache[key] = JS.sharded_cycle_fn(JS.make_mesh(d), z_pad=z_pad,
                                             weights=weights,
                                             use_wtab=use_wtab)
        return cache[key]
    return get


def _i64(v):
    return jnp.asarray(v, jnp.int64)


# ---------------------------------------------------------------------------
# the sharded cycle: K9a + all-gather + K9b
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,kind", [(1, 0), (2, 1), (4, 2), (4, 0)])
def test_sharded_cycle_matches_jax(jax_cycle_fns, d, kind):
    """37 nodes (n_pad 64, n_real a multiple of no D) with bound pods,
    taints, labels and images; pod kinds with inert or dense families."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(5 + kind, kind)
    jmesh = JS.make_mesh(d)
    mesh = PS.Mesh(["cpu"] * d)
    fn = jax_cycle_fns(d, z_pad)
    jnodes = JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                          for k, v in jn.items()})
    jpod_s = JS.shard_pod_arrays(jmesh, jpod)
    shards = PS.shard_node_arrays(mesh, pn)
    for li, lni, ntf in [(0, 0, n), (11, 7, 9), (n - 1, 2 ** 33 + 5, 4)]:
        want = fn(jnodes, jpod_s, _i64(li), _i64(lni), _i64(ntf), _i64(n))
        got = PK.schedule_cycle(shards, ppod, li, lni, ntf, n, z_pad,
                                mesh=mesh)
        single = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad)
        for k in CYCLE_OUT:
            assert_same(got[k], want[k], k)
            assert_same(got[k], single[k], k)


def test_sharded_cycle_wtab_matches_jax(jax_cycle_fns):
    """A weight table: the pod's profile row gathered on every device."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(8, 1)
    rng = np.random.default_rng(3)
    wtab = rng.integers(0, 5, (3, len(JK.PRIORITY_AXIS))).astype(np.int64)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(JK.PRIORITY_AXIS)}
    jmesh, mesh = JS.make_mesh(2), PS.Mesh(["cpu"] * 2)
    fn = jax_cycle_fns(2, z_pad, union, True)
    jp = JS.shard_pod_arrays(jmesh, dict(jpod, profile_id=np.int64(2)))
    want = fn(JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                           for k, v in jn.items()}),
              jp, _i64(3), _i64(5), _i64(n), _i64(n), jnp.asarray(wtab))
    got = PK.schedule_cycle(PS.shard_node_arrays(mesh, pn),
                            dict(ppod, profile_id=np.int64(2)), 3, 5, n, n,
                            z_pad, weights=union, wtab=wtab, mesh=mesh)
    for k in CYCLE_OUT:
        assert_same(got[k], want[k], k)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("mode", ["perm", "pos"])
def test_sharded_cycle_rotation_modes(d, mode):
    """The perm and pos walks (the burst scans' modes) through K9b equal
    the single-device plain K2."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(9, 1)
    rng = np.random.default_rng(d)
    perm = np.concatenate([rng.permutation(n),
                           np.arange(n, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    kw = dict(pos=torch.as_tensor(inv)) if mode == "pos" else dict(
        perm=torch.as_tensor(perm), inv_perm=torch.as_tensor(inv))
    mesh = PS.Mesh(["cpu"] * d)
    shards = PS.shard_node_arrays(mesh, pn)
    for li, lni, ntf in [(0, 0, n), (6, 4, n if mode == "pos" else 10)]:
        got = PK.schedule_cycle(shards, ppod, li, lni, ntf, n, z_pad,
                                mesh=mesh, **kw)
        want = PK.schedule_cycle(pn, ppod, li, lni, ntf, n, z_pad, **kw)
        for k in CYCLE_OUT:
            assert_same(got[k], want[k], k)


# ---------------------------------------------------------------------------
# the sharded uniform burst: K9c + all-gather + K9d per pass
# ---------------------------------------------------------------------------
def _rotation(n, n_pad, seed, cap):
    rng = np.random.default_rng(seed)
    rows = [np.concatenate([np.arange(n), np.full(n_pad + 1 - n, n_pad)])]
    for _ in range(3):
        rows.append(np.concatenate([rng.permutation(n),
                                    np.full(n_pad + 1 - n, n_pad)]))
    seq = np.zeros(cap + JK.K_BATCH, np.int32)
    seq[1:60] = 2                  # a constant-order run (full ELIM batches)
    seq[60:] = rng.integers(0, 4, len(seq) - 60)
    return np.stack(rows).astype(np.int32), seq


def _uniform_case(case):
    """(port nodes, jax nodes, cls, n_pods, lni, n, kwargs) of one case."""
    if case == "saturated":
        jn, pn, cls, n, n_pad = _uniform_inputs(6, 3, cpu=1000, pods_cap=8)
        return pn, jn, cls, 70, 3, n, dict(cap=128)
    if case == "wtab+carried":
        jn, pn, cls, n, n_pad = _uniform_inputs(30, 3)
        eph = np.full(n_pad, 10 * 1024 ** 3, np.int64)
        jn["alloc_eph"], pn["alloc_eph"] = jnp.asarray(eph), \
            torch.as_tensor(eph)
        cls = dict(cls, req_eph=1024 ** 3, upd_eph=1024 ** 3)
        rng = np.random.default_rng(2)
        wtab = rng.integers(0, 5, (2, len(JK.PRIORITY_AXIS))).astype(
            np.int64)
        union = {k: int(wtab[:, i].max())
                 for i, k in enumerate(JK.PRIORITY_AXIS)}
        return pn, jn, cls, 250, 1, n, dict(cap=256, weights=union,
                                            wtab=wtab, pid=1)
    jn, pn, cls, n, n_pad = _uniform_inputs(41, 3)
    if case == "stay":
        return pn, jn, cls, 300, 7, n, dict(cap=512)
    if case == "rotate":
        return pn, jn, cls, 200, 5, n, dict(
            cap=256, rotation=_rotation(n, n_pad, 4, 256))
    extra = np.random.default_rng(8).random(n_pad) < 0.8
    return pn, jn, cls, 60, 2, n, dict(cap=64, extra_ok=extra, ban=True)


def _port_kw(kw):
    out = dict(kw)
    if kw.get("rotation") is not None:
        out["rotation"] = tuple(torch.as_tensor(v) for v in kw["rotation"])
    if kw.get("extra_ok") is not None:
        out["extra_ok"] = torch.as_tensor(kw["extra_ok"])
    return out


def _cat(rows):
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("d,case", [
    (4, "stay"), (2, "rotate"), (4, "rotate"), (2, "ban+extra_ok"),
    (4, "wtab+carried"), (1, "saturated")])
def test_sharded_uniform_matches_jax(d, case):
    """41 nodes (n_pad 64) in STAY and ELIM batches, rotated per-cycle
    orders, ban with a static mask, a weight table with carried
    ephemeral rows, a saturated tail (the F == 0 lane-0 clamp)."""
    pn, jn, cls, n_pods, lni, n, kw = _uniform_case(case)
    jmesh, mesh = JS.make_mesh(d), PS.Mesh(["cpu"] * d)
    jrows, jpacked, jlni = JK.schedule_batch_uniform(
        JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                     for k, v in jn.items()}),
        dict(cls), n_pods, lni, n, True, mesh=jmesh, **kw)
    rows, packed, plni = PK.schedule_batch_uniform(
        PS.shard_node_arrays(mesh, pn), dict(cls), n_pods, lni, n, True,
        mesh=mesh, **_port_kw(kw))
    srows, spacked, slni = PK.schedule_batch_uniform(
        pn, dict(cls), n_pods, lni, n, True, **_port_kw(kw))
    assert_same(packed, jpacked, "packed")
    assert_same(packed, spacked, "packed vs single-device")
    assert int(plni) == int(jlni) == int(slni)
    full = _cat(rows)
    assert set(full) == set(jrows) == set(srows)
    for k in jrows:
        assert_same(full[k], jrows[k], k)
        assert_same(full[k], srows[k], k)
    assert len(rows) == d and all(r["req_cpu"].shape[0] == full["req_cpu"]
                                  .shape[0] // d for r in rows)


# ---------------------------------------------------------------------------
# layout: the port's shards against JAX's per-device shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [2, 4])
def test_shard_layout_matches_jax(d):
    """Each shard holds the rows JAX puts on that device; inert [1] pod
    fields and scalars replicate; a [B, N] pod batch splits on axis 1;
    the uniform state's scratch column rides the last shard."""
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(6, 2)
    jmesh, mesh = JS.make_mesh(d), PS.Mesh(["cpu"] * d)
    jshards = JS.shard_node_arrays(jmesh, {k: np.asarray(v)
                                           for k, v in jn.items()})
    shards = PS.shard_node_arrays(mesh, pn)
    rows = n_pad // d
    for k in NODE_FIELDS:
        pieces = sorted(jshards[k].addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        for s, piece in enumerate(pieces):
            assert_same(shards[s][k], np.asarray(piece.data), k)
            assert shards[s][k].shape[0] == rows
    jpod_s = JS.shard_pod_arrays(jmesh, jpod)
    pods = PS.shard_pod_arrays(mesh, ppod)
    for k, v in ppod.items():
        jv = jpod_s[k]
        if np.ndim(v) and np.shape(v)[-1] == n_pad and k in PS._POD_SHARDED:
            for s in range(d):
                assert_same(pods[s][k], np.asarray(v)[s * rows:
                                                      (s + 1) * rows], k)
        else:
            # replicated: every device of JAX holds the whole value
            assert jv.sharding.is_fully_replicated, k
            for s in range(d):
                assert np.array_equal(np.asarray(pods[s][k]), np.asarray(v))
    batch = {"sel_ok": np.ones((3, n_pad), bool),
             "req_cpu": np.arange(3, dtype=np.int64)}
    pb = PS.shard_pod_batch(mesh, batch)
    assert pb[0]["sel_ok"].shape == (3, rows)
    assert np.array_equal(np.asarray(pb[d - 1]["req_cpu"]), batch["req_cpu"])
    # the uniform burst's per-shard state: the scratch column n_pad is the
    # last shard's extra column, never folded
    jn2, pn2, cls, n2, n_pad2 = _uniform_inputs(17, 3)
    before = obs.get("passes.burst_uniform")
    rows_out, _p, _l = PK.schedule_batch_uniform(
        PS.shard_node_arrays(mesh, pn2), dict(cls), 40, 0, n2, True,
        mesh=mesh, cap=64)
    assert obs.get("passes.burst_uniform") > before
    assert [r["req_cpu"].shape[0] for r in rows_out] == [n_pad2 // d] * d


def test_mesh_requires_even_split_and_own_device():
    """A node axis that does not split evenly is refused; a shard launch
    given a tensor of another device raises before it runs."""
    with pytest.raises(ValueError):
        PS.Mesh(["cpu"] * 3).rows(16)
    with pytest.raises(ValueError):
        PS.Mesh(["cpu"] * 8).rows(8)
    jn, pn, jpod, ppod, n, n_pad, z_pad = _cycle_inputs(5, 0)
    mesh = PS.Mesh(["cpu"] * 2)
    shards = PS.shard_node_arrays(mesh, pn)
    shards[1]["req_cpu"] = torch.empty(n_pad // 2, dtype=torch.int64,
                                       device="meta")
    with pytest.raises(ValueError, match="meta"):
        PK.schedule_cycle(shards, ppod, 0, 0, n, n, z_pad, mesh=mesh)


def test_all_gather_copies_every_record():
    mesh = PS.Mesh(["cpu"] * 4)
    parts = [torch.arange(8, dtype=torch.uint8) + 10 * s for s in range(4)]
    bufs, nbytes = PS.all_gather(mesh, parts)
    assert list(bufs) == [torch.device("cpu")]
    assert nbytes == 4 * 8
    for s in range(4):
        assert torch.equal(bufs[torch.device("cpu")][s], parts[s])


# ---------------------------------------------------------------------------
# TorchScheduler(mesh=...) against TPUScheduler(mesh=...) and the oracle
# ---------------------------------------------------------------------------
class MeshTrio(Trio):
    """A Trio whose JAX scheduler and port both shard over d devices."""

    def __init__(self, nodes, d):
        super().__init__(nodes)
        self.jax = TPUScheduler(node_tree=self.w.j_tree,
                                mesh=JS.make_mesh(d))
        self.port = TorchScheduler(node_tree=self.w.p_tree, device="cpu",
                                   mesh=PS.Mesh(["cpu"] * d))

    def warm(self, seed):
        """Bound pods on random nodes, as tests/test_sharding.py
        `_cluster` places them (the oracle's world too)."""
        rng = np.random.RandomState(seed)
        names = self.w.names()
        for j in range(len(names) * 2):
            host = names[int(rng.randint(0, len(names)))]
            pod = uniform_pods(1, cpu=int(rng.choice([100, 500, 1000])),
                               mem_mi=1024 * int(rng.choice([1, 2, 4])),
                               prefix=f"warm{j}-")[0]
            self.w.assume(pod, host)
            placed = copy.deepcopy(pod)
            placed.node_name = host
            self.o_infos[host].add_pod(placed)

    def check_state(self):
        assert self.port.last_index == self.jax.last_index
        assert self.port.last_node_index == self.jax.last_node_index
        jd, pd = self.jax._dev_nodes, self.port._dev_nodes
        assert (jd is None) == (pd is None)
        if jd is not None:
            assert len(pd) == self.port.mesh.size
            whole = _cat(pd)
            for k in NODE_FIELDS:
                np.testing.assert_array_equal(whole[k].numpy(),
                                              np.asarray(jd[k]), err_msg=k)


@pytest.mark.parametrize("n_nodes", [17, 24])
def test_mesh_scheduler_matches_jax_and_oracle(n_nodes):
    """17 nodes: uneven zones (rotated per-cycle orders) and n_real % 4 !=
    0; 24: even zones, the identity walk. A burst, serial cycles (one a
    FitError), and a second burst after the dirty-row scatters."""
    t = MeshTrio(burst_nodes(n_nodes), 4)
    t.warm(n_nodes)
    refusals = obs.family("refusal")
    pods = uniform_pods(60)
    hosts = t.burst(pods)
    assert hosts == [t.oracle_one(p) for p in pods]
    phases = t.port.last_burst_phases
    assert phases["gather_bytes"] > 0 and phases["passes"] >= 1
    for j, cpu in enumerate((300, 5000, 700)):
        pod = uniform_pods(1, cpu=cpu, prefix=f"s{j}-")[0]
        assert t.serial(pod) == (None if cpu > 4000 else t.oracle_one(pod))
    scatters = obs.get("dispatch.scatter")
    more = uniform_pods(40, prefix="q")
    assert t.burst(more) == [t.oracle_one(p) for p in more]
    assert obs.get("dispatch.scatter") > scatters
    dbg = t.port.debug_state()
    assert dbg["mesh"] is True and dbg["devices"] == 4
    assert dbg["mirror"]["shards"] == 4
    assert obs.family("refusal") == refusals


def test_mesh_carry_from_jax():
    """A burst run on JAX, carried into a mesh port scheduler (the folded
    rows re-sharded), finishes like an all-JAX run."""
    nodes = burst_nodes(31)
    pods = uniform_pods(300)
    ref = Trio(nodes)
    ref.burst(pods[:120])
    ref_tail = ref.burst(pods[120:])
    t = Trio(nodes)
    names = t.w.names()
    jh = t.jax.schedule_burst(pods[:120], t.w.j_infos, names)
    jg = [t.w.assume(p, h, "jax")[0] for p, h in zip(pods[:120], jh)]
    t.jax.note_burst_assumed_many(pods[:120], jh, jg)
    for p, h in zip(pods[:120], jh):
        t.w.assume(p, h, "port")
    t.w.advance(len(jh) - 1)
    state = state_from_jax({k: np.asarray(v)
                            for k, v in t.jax._dev_nodes.items()},
                           t.jax.last_index, t.jax.last_node_index,
                           device="cpu")
    port = TorchScheduler(node_tree=t.w.p_tree, device="cpu",
                          mesh=PS.Mesh(["cpu"] * 4))
    port.load_state(state, t.w.p_infos, names)
    assert isinstance(port._dev_nodes, list) and len(port._dev_nodes) == 4
    tail = port.schedule_burst([to_port(p) for p in pods[120:]],
                               t.w.p_infos, t.w.names())
    assert tail == ref_tail
    assert port.last_node_index == ref.jax.last_node_index
    whole = _cat(port._dev_nodes)
    for k in NODE_FIELDS:
        np.testing.assert_array_equal(whole[k].numpy(),
                                      np.asarray(ref.jax._dev_nodes[k]))


@pytest.mark.parametrize("entry", ["preempt", "pressure", "prewarm"])
def test_mesh_mode_refuses_unsharded_paths(entry):
    """Device preemption is sharded (K13, K14): in mesh mode each entry
    point runs its sharded program on a 2-shard mesh instead of raising
    NotImplementedError, counts no refusal, and equals the single-device
    port. (On the CPU the sharded programs run the kernels' plain
    versions: their gather and step counters show they ran.)"""
    from tests.test_torch_preempt import (
        _norm, _pressure_world, _world_basic, port_infos)
    from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
    mesh = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu",
                          mesh=PS.Mesh(["cpu"] * 2))
    single = TorchScheduler(percentage_of_nodes_to_score=100, device="cpu")
    obs.reset()
    if entry == "preempt":
        infos, names, inc, pdbs = _world_basic()
        got = [s.preempt(to_port(inc), port_infos(infos), names,
                         FitError(to_port(inc), len(names), {
                             n: ["InsufficientResource:cpu"]
                             for n in names}), to_port(pdbs))
               for s in (mesh, single)]
        assert got[0].node is not None
        assert got[0].node.name == got[1].node.name
        assert sorted(v.name for v in got[0].victims) == \
            sorted(v.name for v in got[1].victims)
        assert obs.get("gather.preempt") > 0
    elif entry == "pressure":
        pods, infos, names, pdbs = _pressure_world("mixed bind and preempt")
        got = [s.preempt_pressure_burst([to_port(p) for p in pods],
                                        port_infos(infos), names,
                                        to_port(pdbs))
               for s in (mesh, single)]
        assert _norm(got[0]) == _norm(got[1])
        assert obs.get("steps.pressure") == 8     # one 8-pod bucket
        assert isinstance(mesh._dev_nodes, list)
        assert (mesh.last_index, mesh.last_node_index) == \
            (single.last_index, single.last_node_index)
    else:
        infos, names, _inc, _pdbs = _world_basic()
        mesh.prewarm_preempt(port_infos(infos), names, [])
        assert obs.get("dispatch.vic_upload") == 1
        vt = mesh.encoder._vt
        assert len(mesh._dev_vic) == 2
        for k, f in mesh._VIC_FIELDS:
            whole = torch.cat([d[k] for d in mesh._dev_vic])
            np.testing.assert_array_equal(whole.numpy(), getattr(vt, f))
    assert obs.family("refusal") == {}


def test_mesh_auto_without_cards_stays_single_device():
    """mesh="auto" builds a mesh only over several CUDA devices."""
    port = TorchScheduler(device="cpu", mesh="auto")
    assert port.mesh is None and port.debug_state()["devices"] == 1
