"""Encoder parity between the JAX package and the PyTorch port, plus the
shared world builders of the port's tests.

Each package builds its own Node/Pod/NodeInfo objects: worlds are made
from a seed with `tests/test_tpu_parity.py`'s generators (JAX-package
objects), and `to_port` rebuilds every dataclass field for field as the
port's class of the same name. The encoders of both packages then run on
their own objects, and every NodeBatch / PodFeatures field must be equal.
"""
import dataclasses
import random

import numpy as np
import pytest

from kubernetes_tpu.api import types as JT
from kubernetes_tpu.cache.node_info import NodeInfo as JNodeInfo
from kubernetes_tpu.cache.node_tree import NodeTree as JNodeTree
from kubernetes_tpu.ops.node_state import (
    NodeStateEncoder as JNodeStateEncoder, PodEncoder as JPodEncoder)
from tests.test_tpu_parity import make_cluster, make_pod

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.cache.node_info import NodeInfo as PNodeInfo
from kubernetes_tpu_torch.cache.node_tree import NodeTree as PNodeTree
from kubernetes_tpu_torch.ops.node_state import (
    NodeStateEncoder as PNodeStateEncoder, PodEncoder as PPodEncoder)


# ---------------------------------------------------------------------------
# shared world builders
# ---------------------------------------------------------------------------
def to_port(obj):
    """Rebuild a JAX-package api object (dataclasses all the way down) as
    the port's class of the same name, field for field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(PT, type(obj).__name__)
        fields = dataclasses.fields(obj)
        new = cls(**{f.name: to_port(getattr(obj, f.name))
                     for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(new, f.name, to_port(getattr(obj, f.name)))
        return new
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


class World:
    """One cluster in both packages: node infos and a NodeTree each."""

    def __init__(self, nodes):
        self.jnodes = nodes
        self.pnodes = [to_port(n) for n in nodes]
        self.j_infos = {n.name: JNodeInfo(n) for n in self.jnodes}
        self.p_infos = {n.name: PNodeInfo(n) for n in self.pnodes}
        self.j_tree, self.p_tree = JNodeTree(), PNodeTree()
        for jn, pn in zip(self.jnodes, self.pnodes):
            self.j_tree.add_node(jn)
            self.p_tree.add_node(pn)

    def names(self):
        """One enumeration from each tree (they must agree)."""
        a, b = self.j_tree.list_names(), self.p_tree.list_names()
        assert a == b
        return a

    def advance(self, count: int) -> None:
        self.j_tree.advance_enumerations(count)
        self.p_tree.advance_enumerations(count)

    def assume(self, jpod, host: str, pod_side: str = "both"):
        """Bind one pod on `host` in the chosen package's cache; returns
        the new generation(s)."""
        gens = []
        if pod_side in ("both", "jax"):
            jp = dataclasses.replace(jpod, node_name=host)
            self.j_infos[host].add_pod(jp)
            gens.append(self.j_infos[host].generation)
        if pod_side in ("both", "port"):
            pp = dataclasses.replace(to_port(jpod), node_name=host)
            self.p_infos[host].add_pod(pp)
            gens.append(self.p_infos[host].generation)
        return gens


def make_world(seed, n, zones=3, **kw):
    rng = random.Random(seed)
    return World(make_cluster(rng, n, zones=zones, **kw))


def uniform_pods(n_pods, cpu=100, mem_mi=500, prefix="p", **kw):
    """`n_pods` spec-identical pods (the bench.py burst shape)."""
    return [JT.Pod(name=f"{prefix}{j}", labels={"app": "burst"},
                   containers=(JT.Container.make(
                       name="c", requests={"cpu": cpu,
                                           "memory": mem_mi * 1024 ** 2}),),
                   **kw)
            for j in range(n_pods)]


# ---------------------------------------------------------------------------
# encoder parity
# ---------------------------------------------------------------------------
_BATCH_FIELDS = ("names", "n_real", "n_pad", "scalar_names", "zone_names",
                 "valid", "alloc_cpu", "alloc_mem", "alloc_eph",
                 "allowed_pods", "req_cpu", "req_mem", "req_eph", "nz_cpu",
                 "nz_mem", "pod_count", "alloc_scalar", "req_scalar",
                 "zone_id", "dirty_rows")


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None, what
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _check_batches(jb, pb):
    for f in _BATCH_FIELDS:
        _same(getattr(jb, f), getattr(pb, f), f)


def _check_features(jf, pf):
    for f in dataclasses.fields(jf):
        a, b = getattr(jf, f.name), getattr(pf, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        else:
            _same(a, b, f.name)


WORLDS = [
    dict(n=24, zones=3, taint_frac=0.3, labeled_frac=0.5),
    dict(n=40, zones=0, labeled_frac=0.3, images=True),
    dict(n=31, zones=4, taint_frac=0.2, labeled_frac=0.4, images=True),
]
POD_KW = [
    dict(selectors=True, tolerations=True),
    dict(node_affinity=True, images=True),
    dict(pod_affinity=True, ports=True, selectors=True, tolerations=True,
         node_affinity=True),
]


@pytest.mark.parametrize("wi", range(len(WORLDS)))
@pytest.mark.parametrize("pi", range(len(POD_KW)))
def test_encoders_match(wi, pi):
    rng = random.Random(1000 * wi + pi)
    w = World(make_cluster(rng, **WORLDS[wi]))
    jenc, penc = JNodeStateEncoder(), PNodeStateEncoder()
    names = w.names()
    pods = [make_pod(rng, j, **POD_KW[pi]) for j in range(12)]
    services = [JT.Service(name="svc", namespace="default",
                           selector={"app": "web"})]
    for step, pod in enumerate(pods):
        jb = jenc.encode(w.j_infos, names)
        pb = penc.encode(w.p_infos, names)
        _check_batches(jb, pb)
        je = JPodEncoder(w.j_infos, jb, services, [], state_encoder=jenc)
        pe = PPodEncoder(w.p_infos, pb, [to_port(s) for s in services], [],
                         state_encoder=penc)
        _check_features(je.encode(pod), pe.encode(to_port(pod)))
        # bind the pod somewhere so later steps see existing pods
        host = names[rng.randrange(len(names))]
        w.assume(pod, host)
        if step % 4 == 3:
            names = w.names()


def test_to_port_rebuilds_port_classes():
    rng = random.Random(7)
    pod = make_pod(rng, 0, selectors=True, tolerations=True,
                   node_affinity=True, pod_affinity=True, ports=True)
    pp = to_port(pod)
    assert type(pp) is PT.Pod and pp.uid == pod.uid
    assert type(pp.containers[0]) is PT.Container
    assert dataclasses.astuple(pp) == dataclasses.astuple(pod)
