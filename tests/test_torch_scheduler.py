"""The port's slice as a whole: TorchScheduler(device="cpu") against the
JAX package's TPUScheduler and the oracle.

Each world exists three times (JAX scheduler, port, serial oracle), each
with its own NodeInfos and NodeTree, driven the way the scheduler shell
drives a burst: one enumeration for the burst, the assume loop
(NodeInfo.add_pod + note_burst_assumed_many) over the decided prefix, the
tree fast-forwarded over the burst's cycles; serial cycles take one
enumeration each. Decisions, walk counters and the resident node matrix
must be identical; exact equality everywhere.
"""
import copy
import dataclasses
import random
import zlib

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node, LABEL_HOSTNAME, Service
from kubernetes_tpu.cache.node_info import NodeInfo as JNodeInfo
from kubernetes_tpu.cache.node_tree import NodeTree as JNodeTree
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.oracle import priorities as jprios
from kubernetes_tpu.oracle.generic_scheduler import (
    GenericScheduler, FitError as JFitError, PriorityConfig,
    default_priority_configs)
from kubernetes_tpu.profiles import ProfileSet as JProfileSet
from tests.test_tpu_parity import make_cluster, make_pod
from tests.test_torch_encoders import World, to_port, uniform_pods

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.carry import profile_dicts, state_from_jax
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    FitError as PFitError)
from kubernetes_tpu_torch.profiles import ProfileSet as PProfileSet
from tests.torch_threads import one_torch_thread  # noqa: F401


GI = 1024 ** 3


def burst_nodes(n, zones=3, cpu=4000, pods_cap=110, labels=None):
    """bench.py's node shape: 4 CPU, 32 Gi, 110 pods, zone i % zones;
    `labels(i)` adds labels to node i."""
    return [Node(name=f"n{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"zone-{i % zones}",
        LABEL_HOSTNAME: f"n{i}", **(labels(i) if labels else {})},
        allocatable={"cpu": cpu, "memory": 32 * GI, "pods": pods_cap})
        for i in range(n)]


class Trio:
    """One world for the JAX scheduler, the port and the serial oracle."""

    def __init__(self, nodes, pct=None, services=(), profiles=None):
        self.w = World(nodes)
        kw = {} if pct is None else {"percentage_of_nodes_to_score": pct}
        self.services = list(services)
        self.jax = TPUScheduler(node_tree=self.w.j_tree,
                                services_fn=lambda: self.services, **kw)
        self.port = TorchScheduler(
            node_tree=self.w.p_tree, device="cpu",
            services_fn=lambda: [to_port(x) for x in self.services], **kw)
        self.profiles = None
        if profiles is not None:
            self.profiles = JProfileSet.from_dict({"profiles": profiles})
            self.jax.set_profiles(self.profiles)
            self.port.set_profiles(PProfileSet.from_dict(
                {"profiles": profiles}))
        self.o_infos = {n.name: JNodeInfo(n) for n in nodes}
        self.o_tree = JNodeTree()
        for n in nodes:
            self.o_tree.add_node(n)
        self.oracle = GenericScheduler(**kw)

    def _oracle_configs(self, pod, gang_zones=None):
        if self.profiles is None:
            return default_priority_configs(
                services_fn=lambda: self.services)
        pid = self.profiles.index_of(pod.scheduler_name) or 0
        cfgs = self.profiles.oracle_configs(
            pid, services_fn=lambda: self.services)
        gw = self.profiles.gang_weight_for(pod.scheduler_name)
        if gang_zones is not None and gw:
            cfgs = list(cfgs) + [PriorityConfig(
                "GangLocalityPriority", gw,
                function=lambda _p, nis, nodes: [
                    jprios.gang_locality_map(gang_zones, nis[n.name])
                    for n in nodes])]
        return cfgs

    def oracle_one(self, pod, gang_zones=None):
        names = self.o_tree.list_names()
        try:
            host = self.oracle.schedule(
                pod, self.o_infos, names,
                priority_configs=self._oracle_configs(pod, gang_zones)
            ).suggested_host
        except JFitError:
            return None
        placed = copy.deepcopy(pod)
        placed.node_name = host
        self.o_infos[host].add_pod(placed)
        return host

    def oracle_gang(self, pods):
        """A serial gang trial: all members placed, or none (the world,
        the walk counters and the tree rewound)."""
        from kubernetes_tpu.api.types import get_zone_key
        saved = (copy.deepcopy(self.o_infos), self.o_tree.checkpoint(),
                 self.oracle.last_index, self.oracle.last_node_index)
        zones: dict = {}
        hosts = []
        for p in pods:
            h = self.oracle_one(p, gang_zones=zones)
            if h is None:
                self.o_infos, chk, self.oracle.last_index, \
                    self.oracle.last_node_index = saved
                self.o_tree.restore(chk)
                return None
            z = get_zone_key(self.o_infos[h].node)
            if z:
                zones[z] = zones.get(z, 0) + 1
            hosts.append(h)
        return hosts

    def fused(self, segments):
        """One fused window in both packages plus the shell's commit loop
        (decided gangs and the decided singleton prefix are assumed, the
        tree advances by the consumed enumerations)."""
        jchk, pchk = self.w.j_tree.checkpoint(), self.w.p_tree.checkpoint()
        names = self.w.names()
        jr = self.jax.schedule_burst_fused(segments, self.w.j_infos, names)
        pr = self.port.schedule_burst_fused(
            [([to_port(p) for p in seg], g) for seg, g in segments],
            self.w.p_infos, names)
        if jr is None:
            assert pr is None
            self.w.j_tree.restore(jchk)
            self.w.p_tree.restore(pchk)
            return None
        assert pr["consumed"] == jr["consumed"]
        assert len(pr["segments"]) == len(jr["segments"])
        for a, b in zip(pr["segments"], jr["segments"]):
            assert set(a) == set(b)
            for k in b:
                if k.endswith("_seq"):
                    assert list(map(int, a[k])) == list(map(int, b[k])), k
                else:
                    assert a[k] == b[k], k
        placed_pods, placed_hosts = [], []
        for (seg, _g), rec in zip(segments, jr["segments"]):
            if rec["status"] in ("decided", "failed"):
                placed_pods += seg[:len(rec["hosts"])]
                placed_hosts += rec["hosts"]
        jg, pg = [], []
        for pod, host in zip(placed_pods, placed_hosts):
            a, b = self.w.assume(pod, host)
            jg.append(a)
            pg.append(b)
        self.jax.note_burst_assumed_many(placed_pods, placed_hosts, jg)
        self.port.note_burst_assumed_many(
            [to_port(p) for p in placed_pods], placed_hosts, pg)
        if jr["consumed"] > 0:
            self.w.advance(jr["consumed"] - 1)
        else:
            self.w.j_tree.restore(jchk)
            self.w.p_tree.restore(pchk)
        self.check_state()
        return jr

    def burst(self, pods):
        """One burst in both packages plus the shell's assume loop."""
        names = self.w.names()
        jh = self.jax.schedule_burst(pods, self.w.j_infos, names)
        ph = self.port.schedule_burst([to_port(p) for p in pods],
                                      self.w.p_infos, names)
        assert ph == jh
        if jh is None:
            return None
        kf = jh.index(None) if None in jh else len(jh)
        jg, pg = [], []
        for pod, host in zip(pods[:kf], jh[:kf]):
            a, b = self.w.assume(pod, host)
            jg.append(a)
            pg.append(b)
        self.jax.note_burst_assumed_many(pods[:kf], jh[:kf], jg)
        self.port.note_burst_assumed_many(
            [to_port(p) for p in pods[:kf]], jh[:kf], pg)
        if kf:
            self.w.advance(kf - 1)
        self.check_state()
        return jh

    def serial(self, pod):
        """One serial cycle in both packages; the result is assumed."""
        names = self.w.names()
        try:
            jr = self.jax.schedule(pod, self.w.j_infos, names)
        except JFitError as e:
            with pytest.raises(PFitError) as pe:
                self.port.schedule(to_port(pod), self.w.p_infos, names)
            assert pe.value.failed_predicates == e.failed_predicates
            assert pe.value.num_all_nodes == e.num_all_nodes
            self.check_state()
            return None
        pr = self.port.schedule(to_port(pod), self.w.p_infos, names)
        assert dataclasses.astuple(pr) == dataclasses.astuple(jr)
        self.w.assume(pod, jr.suggested_host)
        self.check_state()
        return jr.suggested_host

    def check_state(self):
        assert self.port.last_index == self.jax.last_index
        assert self.port.last_node_index == self.jax.last_node_index
        jd, pd = self.jax._dev_nodes, self.port._dev_nodes
        assert (jd is None) == (pd is None)
        if jd is not None:
            for k in TorchScheduler._NODE_FIELDS:
                np.testing.assert_array_equal(pd[k].numpy(),
                                              np.asarray(jd[k]), err_msg=k)


@pytest.mark.parametrize("n_nodes,n_pods,cpu", [
    (30, 300, 4000),     # even zones: the identity walk
    (31, 300, 4000),     # uneven zones: rotated per-cycle enumerations
    (7, 80, 1000),       # saturated: unschedulable None tail
])
def test_burst_matches_jax_and_oracle(n_nodes, n_pods, cpu):
    t = Trio(burst_nodes(n_nodes, cpu=cpu))
    pods = uniform_pods(n_pods)
    hosts = t.burst(pods)
    expected = [t.oracle_one(p) for p in pods]
    kf = hosts.index(None) if None in hosts else len(hosts)
    assert hosts[:kf] == expected[:kf]
    assert all(h is None for h in expected[kf:])
    if n_nodes == 7:
        assert kf < n_pods
    # serial cycles (each assume dirties one row), then a second burst
    # that starts from the dirty-row scatter
    rng = random.Random(n_nodes)
    scatters = obs.get("dispatch.scatter")
    for j in range(4):
        t.serial(make_pod(rng, 500 + j))
    if kf == n_pods:
        t.burst(uniform_pods(50, prefix="q"))
        assert obs.get("dispatch.scatter") > scatters


def test_invalidate_node_and_debug_state():
    """A dead node drops the resident matrix in both packages; the next
    burst re-uploads and still matches."""
    t = Trio(burst_nodes(12))
    t.burst(uniform_pods(40))
    t.jax.invalidate_node("n3")
    t.port.invalidate_node("n3")
    assert t.port._dev_nodes is None and "n3" not in \
        t.port.encoder._generations
    t.check_state()
    uploads = obs.get("dispatch.upload")
    t.burst(uniform_pods(30, prefix="r"))
    assert obs.get("dispatch.upload") == uploads + 1
    dbg = t.port.debug_state()
    assert dbg["mirror"] == {"fields": 14, "n_pad": 16}
    assert dbg["last_node_index"] == t.jax.last_node_index
    assert dbg["device"] == "cpu"


def test_schedule_matches_jax():
    rng = random.Random(17)
    t = Trio(make_cluster(rng, 33, zones=3, taint_frac=0.3,
                          labeled_frac=0.5, images=True))
    kinds = [dict(), dict(selectors=True, tolerations=True),
             dict(node_affinity=True, images=True),
             dict(pod_affinity=True, ports=True)]
    for j in range(40):
        t.serial(make_pod(rng, j, **kinds[j % len(kinds)]))


def test_schedule_fit_error_reasons_match():
    t = Trio(burst_nodes(5, cpu=500))
    big = uniform_pods(1, cpu=900, prefix="big")[0]
    assert t.serial(big) is None


def _refusal_window(reason):
    """A window each package refuses whole, for `reason`."""
    rng = random.Random(3)
    if reason == "burst-affinity-mixed":
        # pod affinity terms outside the uniform class (mixed specs)
        return [make_pod(rng, j, pod_affinity=True) for j in range(12)]
    if reason == "burst-spread-mixed":
        # a Service selects pods of two different specs
        return uniform_pods(3, prefix="a") + uniform_pods(3, cpu=200,
                                                          prefix="b")
    if reason == "fused-spread-selectors":
        return [(uniform_pods(4, prefix="g"), True)]
    port_pod = next(p for p in (make_pod(rng, j, ports=True)
                                for j in range(100)) if p.containers[0].ports)
    return [(uniform_pods(2, prefix="s"), False), ([port_pod], True)]


@pytest.mark.parametrize("reason", [
    "burst-affinity-mixed", "burst-spread-mixed", "fused-spread-selectors",
    "fused-pod-features"])
def test_refused_window_is_counted(reason):
    """The refusals the JAX package keeps: both packages return None and
    the port counts the refusal under its reason."""
    svc = [Service(name="s", namespace="default", selector={"app": "burst"})]
    t = Trio(burst_nodes(12), services=svc)
    window = _refusal_window(reason)
    if reason == "burst-affinity-mixed":
        assert any(p.affinity is not None and (
            p.affinity.pod_affinity or p.affinity.pod_anti_affinity)
            for p in window)
    before = obs.get("refusal." + reason)
    names = t.w.names()
    if reason.startswith("fused"):
        got = t.port.schedule_burst_fused(
            [([to_port(p) for p in seg], g) for seg, g in window],
            t.w.p_infos, names)
        want = t.jax.schedule_burst_fused(window, t.w.j_infos, names)
    else:
        got = t.port.schedule_burst([to_port(p) for p in window],
                                    t.w.p_infos, names)
        want = t.jax.schedule_burst(window, t.w.j_infos, names)
    assert got is None and want is None
    assert obs.get("refusal." + reason) == before + 1


def _kinds_pods(rng, n_pods, prefix="m"):
    """Mixed specs without pod affinity or host ports: node selectors,
    tolerations, node affinity (required and preferred), images."""
    kinds = [dict(), dict(selectors=True, tolerations=True),
             dict(node_affinity=True, images=True), dict(images=True)]
    pods = []
    for j in range(n_pods):
        p = make_pod(rng, j, **kinds[j % len(kinds)])
        pods.append(dataclasses.replace(p, name=f"{prefix}{j}"))
    return pods


def _burst_vs_oracle(t, pods):
    """One burst in both packages, held against the oracle the way the
    shell commits it: the decided prefix is the oracle's serial one, and
    what the window left undecided (from the first failure on) reruns
    serially, as the shell reruns it, so the oracle's world stays the
    packages' world."""
    hosts = t.burst(pods)
    assert hosts is not None
    kf = hosts.index(None) if None in hosts else len(hosts)
    assert hosts[:kf] == [t.oracle_one(p) for p in pods[:kf]]
    assert all(h is None for h in hosts[kf:])
    for p in pods[kf:]:
        assert t.serial(p) == t.oracle_one(p)
    return kf


@pytest.mark.parametrize("case", ["mixed-spec", "mixed-uneven",
                                  "mixed-tail", "default-50",
                                  "default-50-uneven", "spread",
                                  "spread-uneven"])
def test_generic_burst_matches_jax_and_oracle(case):
    """Windows the uniform kernel does not take run through the scan (K5)
    in both packages with the same decisions, walk counters and resident
    rows, and those decisions are the oracle's serial ones. `mixed-tail`
    holds a pod no node fits mid-window: the scan decides the prefix
    before it, and the rest reruns serially."""
    rng = random.Random(zlib.crc32(case.encode()) % 1000)
    svc = ()
    pct = None
    if case.startswith("mixed"):
        n = 31 if case == "mixed-uneven" else 30
        nodes = make_cluster(rng, n, zones=3, taint_frac=0.3,
                             labeled_frac=0.5, images=True)
        pods = _kinds_pods(rng, 60)
        if case == "mixed-tail":
            pods[25] = uniform_pods(1, cpu=10 ** 6, prefix="huge")[0]
    elif case.startswith("default-50"):
        n = 150 if case == "default-50" else 151
        nodes = burst_nodes(n)
        pods = uniform_pods(64)
    else:
        n = 30 if case == "spread" else 31
        nodes = burst_nodes(n)
        pods = uniform_pods(70)
        svc = [Service(name="s", namespace="default",
                       selector={"app": "burst"})]
        pct = 100
    t = Trio(nodes, pct=pct, services=svc)
    scans = obs.get("dispatch.burst_scan")
    kf = _burst_vs_oracle(t, pods)
    assert obs.get("dispatch.burst_scan") == scans + 1
    if case == "mixed-tail":
        assert kf == 25
    if case.startswith("default-50"):
        assert t.port.last_index != 0       # a partial walk moved it
    for j in range(2):
        pod = make_pod(rng, 900 + j)
        assert t.serial(pod) == t.oracle_one(pod)
    more = _kinds_pods(rng, 20, prefix="q") if case.startswith("mixed") \
        else uniform_pods(20, prefix="q")
    _burst_vs_oracle(t, more)


PROFILES = [
    {"schedulerName": "default-scheduler"},
    {"schedulerName": "packer", "priorities": {
        "MostRequestedPriority": 1, "BalancedResourceAllocation": 1,
        "NodeAffinityPriority": 1, "TaintTolerationPriority": 1,
        "NodePreferAvoidPodsPriority": 10000}},
]


def test_mixed_profile_burst_matches_jax_and_oracle():
    """Pods of two profiles in one window: the scan scores each pod with
    its own weight-table row."""
    rng = random.Random(23)
    t = Trio(burst_nodes(31), profiles=PROFILES)
    pods = []
    for j, p in enumerate(uniform_pods(40) + uniform_pods(40, cpu=300,
                                                          prefix="b")):
        pods.append(dataclasses.replace(
            p, scheduler_name="packer" if j % 3 == 0
            else "default-scheduler"))
    rng.shuffle(pods)
    hosts = t.burst(pods)
    expected = [t.oracle_one(p) for p in pods]
    assert hosts == expected
    pod = dataclasses.replace(make_pod(rng, 77), scheduler_name="packer")
    assert t.serial(pod) == t.oracle_one(pod)
    dbg = t.port.debug_state()
    assert dbg["profiles"] == ["default-scheduler", "packer"]
    assert dbg["weight_table"] and not dbg["gang_score"]
    assert set(dbg["launches"]) >= {"schedule_batch", "schedule_segments"}


def _gang(n, cpu, prefix, **kw):
    return uniform_pods(n, cpu=cpu, prefix=prefix, **kw)


@pytest.mark.parametrize("case", ["rank-aware", "plain", "default-50"])
def test_fused_window_matches_jax_and_oracle(case):
    """Singleton runs and gangs in one window (K6): a gang that cannot all
    fit (nodeSelector rack=r0 on 5 nodes, 6 members) is rejected and
    rewound mid-window, the rest matches the serial gang trials, and a
    singleton failure ends the decided prefix."""
    n = 31 if case != "default-50" else 151
    nodes = burst_nodes(n, labels=lambda i: {"rack": "r0"}
                        if i % 6 == 1 and i < 30 else {})
    profiles = None
    if case == "rank-aware":
        profiles = [{"schedulerName": "default-scheduler",
                     "rankAwareGang": True, "gangWeight": 3}]
    t = Trio(nodes, profiles=profiles)
    rack = 5
    segments = [
        (_gang(4, 500, "a"), True),
        (uniform_pods(5, prefix="s"), False),
        (_gang(rack + 1, 3000, "r", node_selector={"rack": "r0"})
         [: rack + 1], True),
        (_gang(6, 700, "b"), True),
        (uniform_pods(3, cpu=300, prefix="u"), False),
    ]
    if case == "rank-aware":
        segments.append((uniform_pods(1, cpu=9000, prefix="big"), False))
        segments.append((uniform_pods(2, prefix="late"), False))
    res = t.fused(segments)
    assert res is not None
    statuses = [r["status"] for r in res["segments"]]
    assert statuses[2] == "rejected" and res["segments"][2]["placed"] > 0
    # the oracle's serial trials; what the window left undecided (from
    # the singleton failure on) reruns serially, as the shell reruns it
    leftovers = []
    for (seg, is_gang), rec in zip(segments, res["segments"]):
        if rec["status"] == "rejected":
            assert t.oracle_gang(seg) is None
        elif rec["status"] == "decided":
            exp = t.oracle_gang(seg) if is_gang \
                else [t.oracle_one(p) for p in seg]
            assert rec["hosts"] == exp
        elif rec["status"] == "failed":
            k = len(rec["hosts"])
            assert rec["hosts"] == [t.oracle_one(p) for p in seg[:k]]
            leftovers += seg[k:]
        else:
            leftovers += seg
    for p in leftovers:
        assert t.serial(p) == t.oracle_one(p)
    if case == "rank-aware":
        assert statuses[-2:] == ["failed", "undecided"]
    # a serial cycle continues from the window's walk counters
    pod = uniform_pods(1, prefix="after")[0]
    assert t.serial(pod) == t.oracle_one(pod)


def test_state_from_jax_round_trip():
    """A burst stopped half way on JAX and finished on the port equals an
    all-JAX run: same decisions, walk counters and folded node matrix."""
    nodes = burst_nodes(31)
    pods = uniform_pods(400)
    ref = Trio(nodes)
    ref.burst(pods[:150])
    ref_tail = ref.burst(pods[150:])

    t = Trio(nodes)
    names = t.w.names()
    jh = t.jax.schedule_burst(pods[:150], t.w.j_infos, names)
    jg = [t.w.assume(p, h, "jax")[0] for p, h in zip(pods[:150], jh)]
    t.jax.note_burst_assumed_many(pods[:150], jh, jg)
    for p, h in zip(pods[:150], jh):
        t.w.assume(p, h, "port")
    t.w.advance(len(jh) - 1)
    # carry the JAX scheduler's resident state into a fresh port scheduler
    arrays = {k: np.asarray(v) for k, v in t.jax._dev_nodes.items()}
    state = state_from_jax(arrays, t.jax.last_index, t.jax.last_node_index,
                           device="cpu")
    port = TorchScheduler(node_tree=t.w.p_tree, device="cpu")
    port.load_state(state, t.w.p_infos, names)
    tail = port.schedule_burst([to_port(p) for p in pods[150:]], t.w.p_infos,
                               t.w.names())
    assert tail == ref_tail
    assert port.last_index == ref.jax.last_index
    assert port.last_node_index == ref.jax.last_node_index
    for k, v in ref.jax._dev_nodes.items():
        np.testing.assert_array_equal(port._dev_nodes[k].numpy(),
                                      np.asarray(v), err_msg=k)


def test_state_from_jax_carries_weight_table():
    ptab = np.arange(22, dtype=np.int64).reshape(2, 11)
    nodes = burst_nodes(6)
    w = World(nodes)
    names = w.names()
    b = TPUScheduler().encoder.encode(w.j_infos, names)
    arrays = {k: np.asarray(getattr(b, k)) for k in TorchScheduler._NODE_FIELDS}
    st = state_from_jax(arrays, 3, 9, ptab=ptab, device="cpu")
    assert st["nodes"]["zone_id"].dtype == torch.int32
    assert st["nodes"]["valid"].dtype == torch.bool
    port = TorchScheduler(device="cpu")
    port.load_state(st, w.p_infos, names)
    assert (port.last_index, port.last_node_index) == (3, 9)
    np.testing.assert_array_equal(port._ptab, ptab)
    assert port._union_weights["gang_locality"] == 21
    with pytest.raises(ValueError):
        state_from_jax({"valid": arrays["valid"]}, 0, 0, device="cpu")


PROFILE_SETS = [
    [],
    [{"schedulerName": "default-scheduler"}],
    PROFILES,
    [{"schedulerName": "default-scheduler", "rankAwareGang": True,
      "gangWeight": 4},
     {"schedulerName": "rtcr", "priorities": [
         {"name": "RequestedToCapacityRatioPriority", "weight": 3},
         {"name": "ImageLocalityPriority"}], "rank_aware": True}],
    [{"schedulerName": "solo", "priorities": {"LeastRequestedPriority": 2}}],
]


@pytest.mark.parametrize("i", range(len(PROFILE_SETS)))
def test_profile_set_copy_matches_jax(i):
    """The port's ProfileSet copy equals the JAX package's on the same
    dicts: weight table, union gate, kernel rows, lookups, tensor mode."""
    d = {"profiles": PROFILE_SETS[i]}
    j, p = JProfileSet.from_dict(d), PProfileSet.from_dict(d)
    np.testing.assert_array_equal(p.weight_table(), j.weight_table())
    assert p.union_kernel_weights() == j.union_kernel_weights()
    assert bool(p.tensor_mode()) == bool(j.tensor_mode())
    for k in range(len(j)):
        assert p.kernel_row(k) == j.kernel_row(k)
        name = j.profiles[k].name
        assert p.index_of(name) == j.index_of(name) == k
        assert p.profiles[k].rank_aware == j.profiles[k].rank_aware
    assert p.index_of("nobody") is None and j.index_of("nobody") is None
    assert profile_dicts(p) == profile_dicts(j)


def test_profile_set_copy_validates_like_jax():
    from kubernetes_tpu.profiles import ProfileValidationError as JErr
    from kubernetes_tpu_torch.profiles import ProfileValidationError as PErr
    for bad in ([{"schedulerName": "a"}, {"schedulerName": "a"}],
                [{"schedulerName": "a", "priorities": {"NoSuch": 1}}],
                [{"schedulerName": "a",
                  "priorities": {"LeastRequestedPriority": 0}}],
                [{"schedulerName": "a", "rankAwareGang": True,
                  "gangWeight": 2 ** 31}]):
        with pytest.raises(JErr) as je:
            JProfileSet.from_dict({"profiles": bad})
        with pytest.raises(PErr) as pe:
            PProfileSet.from_dict({"profiles": bad})
        assert str(pe.value) == str(je.value)


def test_state_from_jax_carries_scan_folds_and_profiles():
    """A mixed-profile scan window run on JAX, its folded matrix, walk
    counters and profile set carried into a fresh port scheduler: the next
    window equals the all-JAX run."""
    nodes = burst_nodes(31)
    pods = []
    for j, p in enumerate(uniform_pods(30) + uniform_pods(30, cpu=250,
                                                          prefix="b")):
        pods.append(dataclasses.replace(
            p, scheduler_name="packer" if j % 2 else "default-scheduler"))
    ref = Trio(nodes, profiles=PROFILES)
    ref.burst(pods[:25])
    ref_tail = ref.burst(pods[25:])

    t = Trio(nodes, profiles=PROFILES)
    names = t.w.names()
    jh = t.jax.schedule_burst(pods[:25], t.w.j_infos, names)
    jg = [t.w.assume(p, h, "jax")[0] for p, h in zip(pods[:25], jh)]
    t.jax.note_burst_assumed_many(pods[:25], jh, jg)
    for p, h in zip(pods[:25], jh):
        t.w.assume(p, h, "port")
    t.w.advance(len(jh) - 1)
    arrays = {k: np.asarray(v) for k, v in t.jax._dev_nodes.items()}
    state = state_from_jax(arrays, t.jax.last_index, t.jax.last_node_index,
                           ptab=t.jax._ptab, device="cpu",
                           profiles=profile_dicts(t.jax.profiles))
    port = TorchScheduler(node_tree=t.w.p_tree, device="cpu")
    port.load_state(state, t.w.p_infos, names)
    assert port.debug_state()["profiles"] == ["default-scheduler", "packer"]
    tail = port.schedule_burst([to_port(p) for p in pods[25:]], t.w.p_infos,
                               t.w.names())
    assert tail == ref_tail
    assert port.last_index == ref.jax.last_index
    assert port.last_node_index == ref.jax.last_node_index
    for k, v in ref.jax._dev_nodes.items():
        np.testing.assert_array_equal(port._dev_nodes[k].numpy(),
                                      np.asarray(v), err_msg=k)


def test_gang_checkpoint_rewind_restores_the_matrix():
    """gang_checkpoint/gang_rewind: a trial window rewound at the same
    epoch restores the pinned matrix and counters in both packages; after
    a scatter (new epoch) the matrix drops instead."""
    t = Trio(burst_nodes(12))
    t.burst(uniform_pods(10))
    jc, pc = t.jax.gang_checkpoint(), t.port.gang_checkpoint()
    names = t.w.names()
    t.jax.schedule_burst(uniform_pods(5, prefix="g"), t.w.j_infos, names)
    t.port.schedule_burst([to_port(p) for p in uniform_pods(5, prefix="g")],
                          t.w.p_infos, names)
    t.jax.gang_rewind(jc)
    t.port.gang_rewind(pc)
    t.check_state()
    assert t.port._dev_nodes is pc["dev"]
    pc = t.port.gang_checkpoint()
    t.port._dev_epoch += 1           # an upload or scatter since
    t.port.gang_rewind(pc)
    assert t.port._dev_nodes is None


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TorchScheduler()
