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

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.types import Node, LABEL_HOSTNAME
from kubernetes_tpu.cache.node_info import NodeInfo as JNodeInfo
from kubernetes_tpu.cache.node_tree import NodeTree as JNodeTree
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.oracle.generic_scheduler import (
    GenericScheduler, FitError as JFitError)
from tests.test_tpu_parity import make_cluster, make_pod
from tests.test_torch_encoders import World, to_port, uniform_pods

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.carry import state_from_jax
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    FitError as PFitError)

# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

GI = 1024 ** 3


def burst_nodes(n, zones=3, cpu=4000, pods_cap=110):
    """bench.py's node shape: 4 CPU, 32 Gi, 110 pods, zone i % zones."""
    return [Node(name=f"n{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"zone-{i % zones}",
        LABEL_HOSTNAME: f"n{i}"},
        allocatable={"cpu": cpu, "memory": 32 * GI, "pods": pods_cap})
        for i in range(n)]


class Trio:
    """One world for the JAX scheduler, the port and the serial oracle."""

    def __init__(self, nodes):
        self.w = World(nodes)
        self.jax = TPUScheduler(node_tree=self.w.j_tree)
        self.port = TorchScheduler(node_tree=self.w.p_tree, device="cpu")
        self.o_infos = {n.name: JNodeInfo(n) for n in nodes}
        self.o_tree = JNodeTree()
        for n in nodes:
            self.o_tree.add_node(n)
        self.oracle = GenericScheduler()

    def oracle_one(self, pod):
        names = self.o_tree.list_names()
        try:
            host = self.oracle.schedule(pod, self.o_infos, names).suggested_host
        except JFitError:
            return None
        placed = copy.deepcopy(pod)
        placed.node_name = host
        self.o_infos[host].add_pod(placed)
        return host

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


def test_non_uniform_burst_is_refused_and_counted():
    rng = random.Random(3)
    t = Trio(burst_nodes(12))
    pods = [make_pod(rng, j) for j in range(6)]
    before = obs.get("refusal.burst-mixed-spec")
    names = t.w.names()
    got = t.port.schedule_burst([to_port(p) for p in pods], t.w.p_infos, names)
    assert got is None
    assert obs.get("refusal.burst-mixed-spec") == before + 1


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


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError):
        TorchScheduler()
