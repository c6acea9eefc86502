"""The algorithm surface the scheduler shell reads, on the port's
TorchScheduler(device="cpu") against the JAX package's TPUScheduler.

The shell (`kubernetes_tpu/scheduler.py`) reads more from its algorithm
than the decisions: the wave-commit contract of `schedule_burst` (a
`commit(lo, hosts)` callback fed `wave_size` windows of the one fetched
block, `commit_marker` at each window, `launch_cap`, an abort that
discards the rest), the mid-burst node-death scan (`stale_scan` and its
StaleNodeRefusal), the crash-restart reset (`recover_device`), the serial
cycle's `serial_path`, the phase metrics (`metrics.observe_phase`), the
volume listers and binder, the class signatures, and the ProfileSet and
factory helpers. Each world is built from a seed in both packages and
driven the same way on both; every comparison is exact.
"""
import dataclasses
import random

import numpy as np
import pytest

from kubernetes_tpu import factory as JF
from kubernetes_tpu.api import types as JT
from kubernetes_tpu.core import StaleNodeRefusal as JStale
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops.node_state import PodEncoder as JPodEncoder
from kubernetes_tpu.oracle import volumes as JV
from kubernetes_tpu.profiles import ProfileSet as JProfileSet
from tests.test_tpu_parity import make_pod
from tests.test_torch_encoders import to_port, uniform_pods
from tests.test_torch_scheduler import Trio, burst_nodes
from tests.test_torch_sharding import MeshTrio

from kubernetes_tpu_torch import factory as PF
from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.core import StaleNodeRefusal as PStale
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.ops.node_state import PodEncoder as PPodEncoder
from kubernetes_tpu_torch.oracle import volumes as PV
from kubernetes_tpu_torch.profiles import ProfileSet as PProfileSet
from tests.torch_threads import one_torch_thread  # noqa: F401

GI = 1024 ** 3

#: every name of the shell's algorithm surface (ROADMAP A5.1)
SURFACE = ("supports_fused_segments", "supports_wave_commit", "wave_size",
           "launch_cap", "commit_marker", "stale_scan", "recover_device",
           "metrics", "serial_path", "volume_listers", "volume_binder",
           "_class_signature", "class_signatures")
#: the class attributes among them, whose values must be JAX's
CLASS_VALUES = ("supports_fused_segments", "supports_wave_commit",
                "wave_size", "launch_cap")


@pytest.mark.parametrize("name", SURFACE)
def test_surface_name(name):
    port = TorchScheduler(device="cpu")
    jax = TPUScheduler()
    assert hasattr(port, name) and hasattr(jax, name)
    if name in CLASS_VALUES:
        assert getattr(TorchScheduler, name) == getattr(TPUScheduler, name)
    elif not callable(getattr(jax, name)):
        # the instance state the shell sets or reads starts equal
        assert getattr(port, name) == getattr(jax, name)


def test_class_signatures_match_jax():
    """The class signature the shell's burst classifier keys on is the
    JAX package's, field for field (the port's objects in place of the
    JAX package's), static on the class and batched."""
    rng = random.Random(5)
    pods = [make_pod(rng, j, selectors=True, tolerations=True,
                     node_affinity=True, pod_affinity=j % 2 == 0)
            for j in range(12)]
    want = [to_port(TPUScheduler._class_signature(p)) for p in pods]
    ported = [to_port(p) for p in pods]
    assert [TorchScheduler._class_signature(p) for p in ported] == want
    assert TorchScheduler.class_signatures(ported) == want


# ---------------------------------------------------------------------------
# wave commit
# ---------------------------------------------------------------------------
WAVE, CAP = 16, 32


def _trio(d):
    t = Trio(burst_nodes(31)) if d == 1 else MeshTrio(burst_nodes(32), d)
    for s in (t.jax, t.port):
        s.wave_size, s.launch_cap = WAVE, CAP
    return t


def _window(kind):
    """A uniform burst (spec-identical pods: K3, four 32-pod launches
    under the launch cap) or a scan burst (two specs: K5)."""
    if kind == "uniform":
        return uniform_pods(100)
    return [uniform_pods(1, cpu=100 + 150 * (j % 2), prefix=f"m{j}-")[0]
            for j in range(100)]


class Sink:
    """A commit callback: records every (lo, hosts) window with the
    scheduler's commit_marker at the call, and answers False at the
    window numbered `fail_at` (0-based; None: never)."""

    def __init__(self, sched, fail_at=None):
        self.sched, self.fail_at = sched, fail_at
        self.calls = []

    def __call__(self, lo, hosts):
        self.calls.append((lo, list(hosts), dict(self.sched.commit_marker)))
        return self.fail_at is None or len(self.calls) - 1 != self.fail_at


def _assume(t, pods, hosts):
    """The shell's assume loop over a delivered prefix, in both packages;
    the tree advances by the prefix's cycles."""
    kf = hosts.index(None) if None in hosts else len(hosts)
    jg, pg = [], []
    for pod, host in zip(pods[:kf], hosts[:kf]):
        a, b = t.w.assume(pod, host)
        jg.append(a)
        pg.append(b)
    t.jax.note_burst_assumed_many(pods[:kf], hosts[:kf], jg)
    t.port.note_burst_assumed_many([to_port(p) for p in pods[:kf]],
                                   hosts[:kf], pg)
    if kf:
        t.w.advance(kf - 1)
    return kf


def _committed_burst(t, pods, fail_at):
    names = t.w.names()
    js, ps = Sink(t.jax, fail_at), Sink(t.port, fail_at)
    jh = t.jax.schedule_burst(pods, t.w.j_infos, names, commit=js)
    ph = t.port.schedule_burst([to_port(p) for p in pods], t.w.p_infos,
                               names, commit=ps)
    assert ph == jh
    assert ps.calls == js.calls
    assert t.port.commit_marker == t.jax.commit_marker
    t.check_state()
    return jh, js.calls


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("kind", ["uniform", "scan"])
@pytest.mark.parametrize("fail_at", [None, 2])
def test_burst_commit_windows_match_jax(kind, d, fail_at):
    """schedule_burst(commit=) on one device and on a 2-shard mesh at
    wave_size 16 and launch_cap 32: the windows handed to the callback,
    each window's commit_marker, the returned list and the walk counters
    equal TPUScheduler's; a False at the third window stops both at the
    same prefix with the resident folds dropped; a plain burst after the
    shell's assume loop still matches."""
    t = _trio(d)
    pods = _window(kind)
    hosts, calls = _committed_burst(t, pods, fail_at)
    n_win = len(calls)
    assert [lo for lo, _h, _m in calls] == [WAVE * i for i in range(n_win)]
    assert all(len(h) == WAVE for _lo, h, _m in calls[:-1])
    if fail_at is None:
        assert None not in hosts and n_win == -(-len(pods) // WAVE)
    else:
        # the aborted window is part of the delivered prefix
        assert n_win == fail_at + 1
        assert hosts[:WAVE * n_win] == [h for _lo, w, _m in calls
                                        for h in w]
        assert hosts[WAVE * n_win:] == [None] * (len(pods) - WAVE * n_win)
        assert t.port._dev_nodes is None
    if kind == "scan":
        # every window edge carries exact walk counters
        assert all(m["li1"] is not None and m["lni1"] is not None
                   for _lo, _h, m in calls)
    else:
        # a window edge inside a 32-pod launch has no exact lni
        assert calls[0][2]["lni1"] is None and calls[1][2]["lni1"] is not None
    _assume(t, pods, hosts)
    t.burst(uniform_pods(20, prefix="q"))


@pytest.mark.parametrize("kind", ["uniform", "scan"])
def test_stale_scan_refuses_like_jax(kind):
    """A stale_scan that reports a decided node (on its second call for
    the uniform burst, so the first 32-pod launch commits first): both
    raise StaleNodeRefusal with the same dead set and count, after the
    same windows, with the same walk counters and the folds dropped."""
    t = _trio(1)
    pods = _window(kind)
    names = t.w.names()
    dead = {names[3], names[7]}

    def scan_of(seen):
        def scan(decided, all_names):
            seen.append((list(decided), list(all_names)))
            if kind == "uniform" and len(seen) == 1:
                return set()
            return dead & set(decided)
        return scan
    jseen, pseen = [], []
    t.jax.stale_scan, t.port.stale_scan = scan_of(jseen), scan_of(pseen)
    js, ps = Sink(t.jax), Sink(t.port)
    with pytest.raises(JStale) as je:
        t.jax.schedule_burst(pods, t.w.j_infos, names, commit=js)
    with pytest.raises(PStale) as pe:
        t.port.schedule_burst([to_port(p) for p in pods], t.w.p_infos,
                              names, commit=ps)
    assert (pe.value.dead, pe.value.n_stale) == (je.value.dead,
                                                  je.value.n_stale)
    assert pe.value.dead == dead and pe.value.n_stale >= 2
    assert pseen == jseen and ps.calls == js.calls
    assert len(ps.calls) == (2 if kind == "uniform" else 0)
    assert t.port._dev_nodes is None
    t.check_state()


@pytest.mark.parametrize("kind", ["uniform", "scan"])
def test_recover_device_then_burst(kind):
    """After an aborted commit the shell reconciles its cache to the
    committed windows and calls recover_device(li, lni) from the last
    commit_marker: both drop their resident state and take the counters;
    the next burst matches."""
    t = _trio(1)
    pods = _window(kind)
    hosts, calls = _committed_burst(t, pods, 1)
    _assume(t, pods, hosts)
    marker = calls[-1][2]
    for s in (t.jax, t.port):
        s.recover_device(li=marker["li1"], lni=marker["lni1"])
    assert t.port._dev_nodes is None and t.port._dev_vic is None
    assert t.port.commit_marker is None
    t.check_state()
    t.burst(_window(kind)[:40])
    t.serial(uniform_pods(1, cpu=300, prefix="after")[0])


# ---------------------------------------------------------------------------
# serial_path
# ---------------------------------------------------------------------------
class NoNominees:
    """The shell's nominated-pod map with nothing nominated (the JAX
    package's host twin reads it)."""

    def has_any(self):
        return False

    def pods_for_node(self, name):
        return []


@pytest.mark.parametrize("path", ["device", "host", "adaptive"])
def test_serial_path_cycles_match_jax(path):
    """8 serial cycles (one a FitError) with serial_path set on both: the
    results, FitError reasons and walk counters are TPUScheduler's; the
    port counts each twin cycle under its route's reason."""
    t = Trio(burst_nodes(13, cpu=2000))
    t.jax = TPUScheduler(node_tree=t.w.j_tree, nominated=NoNominees(),
                         serial_path=path)
    t.port = TorchScheduler(node_tree=t.w.p_tree, device="cpu",
                            nominated=NoNominees(), serial_path=path)
    rng = random.Random(11)
    before = obs.family("twin")
    for j in range(8):
        pod = make_pod(rng, j, selectors=j % 3 == 0) if j != 5 else \
            uniform_pods(1, cpu=3000, prefix="big")[0]
        t.serial(pod)
    twin = {k: v - before.get(k, 0) for k, v in obs.family("twin").items()
            if v != before.get(k, 0)}
    if path == "device":
        assert twin == {} and t.port._lat_ora is None
        assert t.port._lat_dev is not None
    elif path == "host":
        assert twin == {"serial-path-host": 8} and t.port._lat_dev is None
    else:
        # the twin first, then whichever is faster on this host
        assert twin.get("adaptive-twin-faster", 0) >= 1
        assert t.port._lat_ora is not None
    assert t.port._serial_cycles == t.jax._serial_cycles == 8
    assert t.port.debug_state()["serial_path"] == path


@pytest.mark.parametrize("ora,dev,cycles", [
    (None, None, 1), (0.001, None, 2), (0.05, None, 3), (0.05, 0.01, 4),
    (0.05, 0.09, 5), (0.05, 0.01, 1024), (0.05, 0.09, 2048),
    (0.03, 0.03, 2048)])
def test_adaptive_pick_matches_jax(ora, dev, cycles):
    """The adaptive route's choice from the same running latencies and
    cycle count: the twin first, no device probe under 30 ms, then the
    faster, the slower probed every 1,024 cycles."""
    port, jax = TorchScheduler(device="cpu"), TPUScheduler()
    for s in (port, jax):
        s._lat_ora, s._lat_dev, s._serial_cycles = ora, dev, cycles
    assert port._serial_pick_host_twin() == jax._serial_pick_host_twin()


def test_serial_path_is_checked():
    with pytest.raises(ValueError, match="serial_path"):
        TorchScheduler(device="cpu", serial_path="gpu")


# ---------------------------------------------------------------------------
# volumes
# ---------------------------------------------------------------------------
def _volume_world():
    """tests/test_volumes.py's shapes: four nodes in two zones, a PV a
    zone and claims on them, an EBS volume already mounted on n1, a claim
    bound to a PV in a zone no node has."""
    nodes = [JT.Node(name=f"n{i}", labels={
        JT.LABEL_ZONE_FAILURE_DOMAIN: f"zone-{i % 2}",
        JT.LABEL_ZONE_REGION: "r1", JT.LABEL_HOSTNAME: f"n{i}"},
        allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(4)]
    pvs = [JT.PersistentVolume(
        name=f"pv{k}", capacity=10 * GI, storage_class="std",
        labels={JT.LABEL_ZONE_FAILURE_DOMAIN: f"zone-{k % 2}"})
        for k in range(3)]
    pvs.append(JT.PersistentVolume(name="pv-far", labels={
        JT.LABEL_ZONE_FAILURE_DOMAIN: "zone-9"}))
    pvcs = [JT.PersistentVolumeClaim(name=f"c{k}", request=GI,
                                     storage_class="std") for k in range(3)]
    pvcs.append(JT.PersistentVolumeClaim(name="far", volume_name="pv-far"))
    pvcs.append(JT.PersistentVolumeClaim(name="big", request=50 * GI,
                                         storage_class="std"))
    return nodes, pvcs, pvs


def _vpod(name, vols, cpu=100):
    return JT.Pod(name=name, volumes=tuple(vols), containers=(
        JT.Container.make(name="c", requests={"cpu": cpu}),))


VOLUME_PODS = {
    "unbound claim": [JT.VolumeSource(name="v", pvc="c0")],
    "two claims": [JT.VolumeSource(name="v", pvc="c1"),
                   JT.VolumeSource(name="w", pvc="c2")],
    "disk conflict": [JT.VolumeSource(name="v", plugin=JT.PLUGIN_EBS,
                                      volume_id="vol-x")],
    "bound far away": [JT.VolumeSource(name="v", pvc="far")],
    "no fitting PV": [JT.VolumeSource(name="v", pvc="big")],
}


def _volume_trio(path):
    nodes, pvcs, pvs = _volume_world()
    t = Trio(nodes)
    jl = JV.VolumeListers(pvcs_fn=lambda: list(pvcs),
                          pvs_fn=lambda: list(pvs))
    ppvcs, ppvs = to_port(pvcs), to_port(pvs)
    pl = PV.VolumeListers(pvcs_fn=lambda: list(ppvcs),
                          pvs_fn=lambda: list(ppvs))
    t.jax = TPUScheduler(node_tree=t.w.j_tree, volume_listers=jl,
                         nominated=NoNominees(), serial_path=path)
    t.port = TorchScheduler(node_tree=t.w.p_tree, device="cpu",
                            volume_listers=pl, nominated=NoNominees(),
                            serial_path=path)
    t.w.assume(_vpod("mounted", VOLUME_PODS["disk conflict"]), "n1")
    return t, jl, pl


@pytest.mark.parametrize("case", sorted(VOLUME_PODS))
def test_volume_masks_match_jax(case):
    """The encoder's four volume masks and the per-node reasons of a pod
    with volumes equal the JAX package's encoder's."""
    t, jl, pl = _volume_trio("device")
    names = t.w.names()
    jb = t.jax.encoder.encode(t.w.j_infos, names)
    pb = t.port.encoder.encode(t.w.p_infos, names)
    pod = _vpod("p", VOLUME_PODS[case])
    jf = JPodEncoder(t.w.j_infos, jb, volume_listers=jl).encode(pod)
    pf = PPodEncoder(t.w.p_infos, pb, volume_listers=pl).encode(
        to_port(pod))
    for k in ("disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok"):
        np.testing.assert_array_equal(getattr(pf, k), getattr(jf, k),
                                      err_msg=k)
    assert pf.volbind_reasons == jf.volbind_reasons
    # without listers no mask is made, as in JAX
    bare = PPodEncoder(t.w.p_infos, pb).encode(to_port(pod))
    assert bare.volbind_ok is None and bare.volbind_reasons is None


@pytest.mark.parametrize("path", ["device", "host"])
def test_schedule_with_volumes_matches_jax(path):
    """schedule() of pods with volumes, on K2's plain version with the
    masks (path "device") and on the host twin with the volume
    predicates (path "host"): results and FitError reasons equal
    TPUScheduler's."""
    t, _jl, _pl = _volume_trio(path)
    fits = 0
    for j, case in enumerate(sorted(VOLUME_PODS) * 2):
        host = t.serial(_vpod(f"p{j}", VOLUME_PODS[case]))
        fits += host is not None
    assert 0 < fits < 2 * len(VOLUME_PODS)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
class Phases:
    """A recording SchedulerMetrics stub."""

    def __init__(self):
        self.seen = []

    def observe_phase(self, phase, seconds):
        assert seconds >= 0
        self.seen.append(phase)


@pytest.mark.parametrize("kind", ["uniform", "scan", "fused"])
def test_metrics_phases_match_jax(kind):
    """metrics.observe_phase gets the phase names TPUScheduler gives, in
    its order: a uniform burst of four launches under launch_cap 32, a
    scan burst and a fused window."""
    t = _trio(1)
    jm, pm = Phases(), Phases()
    t.jax.metrics, t.port.metrics = jm, pm
    if kind == "fused":
        t.fused([(uniform_pods(8, prefix="g"), True),
                 (uniform_pods(5, prefix="s"), False)])
    else:
        t.burst(_window(kind))
    assert pm.seen == jm.seen
    assert pm.seen[0] == "encode" and "kernel" in pm.seen
    if kind == "uniform":
        assert pm.seen.count("kernel") == pm.seen.count("fetch") == 4


# ---------------------------------------------------------------------------
# ProfileSet and factory
# ---------------------------------------------------------------------------
PROFILES = {"profiles": [
    {"schedulerName": "default-scheduler"},
    {"schedulerName": "t", "priorities": {"MostRequestedPriority": 2}},
    {"schedulerName": "r",
     "priorities": [{"name": "LeastRequestedPriority", "weight": 4}],
     "rankAwareGang": True, "gangWeight": 5},
]}


class Recorder:
    def __init__(self):
        self.events = []

    def pod_event(self, pod, kind, reason, message):
        self.events.append((pod.name, kind, reason, message))


def _profile_pair(tmp_path, how):
    import json
    if how == "json":
        return (JProfileSet.from_json(json.dumps(PROFILES)),
                PProfileSet.from_json(json.dumps(PROFILES)))
    path = tmp_path / "profiles.json"
    path.write_text(json.dumps(PROFILES))
    return JProfileSet.from_file(str(path)), PProfileSet.from_file(str(path))


def _rows(ps):
    return [dataclasses.astuple(p) for p in ps]


@pytest.mark.parametrize("method", [
    "from_json", "from_file", "set_row", "snapshot", "default",
    "profile_for", "gang_weight_for", "report_unknown", "note_scheduled",
    "debug_state"])
def test_profile_set_method_matches_jax(tmp_path, method):
    js, ps = _profile_pair(tmp_path,
                           "file" if method == "from_file" else "json")
    assert _rows(ps) == _rows(js)
    assert ps.weight_table().tolist() == js.weight_table().tolist()
    if method == "set_row":
        for args, kw in ((("t", {"MostRequestedPriority": 7}), {}),
                         ((2, {}), {"gang_weight": 9}),
                         (("default-scheduler", {}), {})):
            assert dataclasses.astuple(ps.set_row(*args, **kw)) == \
                dataclasses.astuple(js.set_row(*args, **kw))
        for bad in (("t", {"NoSuchPriority": 1}), ("nobody", {}), (7, {}),
                    ("t", {"MostRequestedPriority": 0})):
            with pytest.raises(ValueError):
                js.set_row(*bad)
            with pytest.raises(ValueError):
                ps.set_row(*bad)
        assert _rows(ps) == _rows(js) and ps.version == js.version == 3
        assert ps.weight_table().tolist() == js.weight_table().tolist()
    elif method == "snapshot":
        jsnap, psnap = js.snapshot(), ps.snapshot()
        js.set_row("t", {"MostRequestedPriority": 3})
        ps.set_row("t", {"MostRequestedPriority": 3})
        assert _rows(psnap) == _rows(jsnap) != _rows(js)
        assert psnap.version == jsnap.version == 0
    elif method == "default":
        assert dataclasses.astuple(ps.default) == \
            dataclasses.astuple(js.default)
    elif method in ("profile_for", "gang_weight_for"):
        for name in ("default-scheduler", "t", "r", "nobody"):
            a, b = getattr(ps, method)(name), getattr(js, method)(name)
            if method == "profile_for" and a is not None:
                a, b = dataclasses.astuple(a), dataclasses.astuple(b)
            assert a == b
    elif method == "report_unknown":
        before = obs.get("profile.unknown")
        jr, pr = Recorder(), Recorder()
        pods = [JT.Pod(name=f"u{j}", uid=f"uid-{j % 2}",
                       scheduler_name=f"other-{j % 3}") for j in range(5)]
        for pod in pods:
            js.report_unknown(pod, recorder=jr)
            ps.report_unknown(to_port(pod), recorder=pr)
        assert pr.events == jr.events and len(pr.events) == 2
        assert ps.unknown_names == js.unknown_names
        assert obs.get("profile.unknown") - before == 2
    elif method == "note_scheduled":
        before = obs.get("profile.scheduled.t")
        for i, count in ((0, 3), (1, 1), (1, 4)):
            js.note_scheduled(i, count)
            ps.note_scheduled(i, count)
        assert ps.scheduled_counts == js.scheduled_counts == [3, 5, 0]
        assert obs.get("profile.scheduled.t") - before == 5
    elif method == "debug_state":
        js.note_scheduled(2, 2)
        ps.note_scheduled(2, 2)
        js.report_unknown(JT.Pod(name="x", scheduler_name="nope"))
        ps.report_unknown(to_port(JT.Pod(name="x", scheduler_name="nope")))
        assert ps.debug_state() == js.debug_state()


@pytest.mark.parametrize("selection", [
    {"LeastRequestedPriority": 1, "BalancedResourceAllocation": 1},
    {"MostRequestedPriority": 3, "ImageLocalityPriority": 2,
     "NodePreferAvoidPodsPriority": 10000},
    dict(JF.DEFAULT_PRIORITY_WEIGHTS),
    {"LeastRequestedPriority": 1, "EqualPriority": 1}])
def test_tpu_kernel_weights_matches_jax(selection):
    """The kernel weight dict of a priority selection (None where a
    priority has no device implementation) and the key table."""
    assert PF.TPU_WEIGHT_KEYS == JF.TPU_WEIGHT_KEYS
    assert PF.tpu_kernel_weights(selection) == \
        JF.tpu_kernel_weights(selection)
