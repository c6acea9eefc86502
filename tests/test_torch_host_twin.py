"""The serial cycle's host twin: `TorchScheduler.schedule` against
`TPUScheduler.schedule` where the reference decides on its twin.

The reference sends a `schedule` call to its host twin (the oracle's
GenericScheduler with the profile's priority configs) when it carries
`extra_configs` (the gang serial referee's GangLocalityPriority) and when
nominated pods exist. The port sends the first kind to its copy of the
twin, and a nominated cycle there only when the device ghost cannot
express it (the pod or a counted nominee has volumes, pod-affinity
terms, host ports or scalar requests); a cycle with resource-only
nominees stays on K2 (K9a / K9b on a mesh) with the ghost load. On the
same world, made from a seed, each cycle's ScheduleResult (host,
evaluated, feasible count, host priorities, failed reasons) or
FitError's failed map must be equal, and so must last_index and
last_node_index after it, on one device and on a 2-shard mesh of the
CPU. Tolerance: exact equality.
"""
import copy
import dataclasses
import random

import pytest
import torch

from kubernetes_tpu.api.types import (
    Affinity, Container, ContainerPort, LabelSelector, PodAffinityTerm,
    PodAntiAffinity, VolumeSource, LABEL_HOSTNAME, get_zone_key)
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.oracle import priorities as jprios
from kubernetes_tpu.oracle.generic_scheduler import (
    PriorityConfig as JPriorityConfig)
from kubernetes_tpu.profiles import ProfileSet as JProfileSet
from tests.test_preemption import mkpod, snapshot
from tests.test_torch_encoders import to_port
from tests.test_torch_preempt import port_infos
from tests.test_torch_scheduler import PROFILES, burst_nodes
from tests.test_torch_sharding_preempt import _nom_map, _nominee, _result

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.api.types import get_zone_key as p_get_zone_key
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.oracle import priorities as pprios
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    PriorityConfig as PPriorityConfig)
from kubernetes_tpu_torch.parallel import sharding as PS
from kubernetes_tpu_torch.profiles import ProfileSet as PProfileSet
from tests.torch_threads import one_torch_thread  # noqa: F401


#: 200 nodes: the default 50 % looks for 100 feasible ones, so a walk
#: covers part of the axis and last_index moves
N_NODES = 200
MESHES = [None, 2]
GATES = ["pod volumes", "pod affinity", "nominee ports", "nominee scalar"]


class Pair:
    """One world for TPUScheduler and TorchScheduler (device="cpu", on
    one device or a mesh of `shards` CPU shards), with the same nominees;
    `cycle` holds one schedule call of each against the other and binds
    the pod where both placed it."""

    def __init__(self, nominees=(), shards=None, profiles=None,
                 name_weights=None, seed=0):
        rng = random.Random(seed)
        nodes = burst_nodes(N_NODES)
        self.infos = snapshot(nodes, {
            n.name: [mkpod(f"{n.name}-b{k}", cpu=rng.choice([300, 800,
                                                            1500]),
                           priority=rng.randint(0, 9))
                     for k in range(rng.randint(0, 2))] for n in nodes})
        self.pinfos = port_infos(self.infos)
        self.names = [n.name for n in nodes]
        self.jax = TPUScheduler(nominated=_nom_map(list(nominees)))
        self.port = TorchScheduler(
            nominated=_nom_map([to_port(p) for p in nominees]), device="cpu",
            mesh=None if shards is None else PS.Mesh(["cpu"] * shards))
        if profiles is not None:
            self.jax.set_profiles(JProfileSet.from_dict(
                {"profiles": profiles}))
            self.port.set_profiles(PProfileSet.from_dict(
                {"profiles": profiles}))
        if name_weights is not None:
            self.jax.priority_name_weights = dict(name_weights)
            self.port.priority_name_weights = dict(name_weights)

    def cycle(self, pod, extra=None, pextra=None):
        """Both schedulers' result for `pod` (equal, counters too)."""
        want = _result(lambda: self.jax.schedule(
            pod, self.infos, self.names, extra_configs=extra))
        got = _result(lambda: self.port.schedule(
            to_port(pod), self.pinfos, self.names, extra_configs=pextra))
        assert got == want
        assert (self.port.last_index, self.port.last_node_index) == \
            (self.jax.last_index, self.jax.last_node_index)
        if want[0] != "fit-error":
            placed = copy.deepcopy(pod)
            placed.node_name = want[0]
            self.infos[want[0]].add_pod(placed)
            self.pinfos[want[0]].add_pod(to_port(placed))
        return want


def _gated(gate, pod, nom):
    """Give the pod or the nominee the feature that keeps it out of the
    device ghost."""
    if gate == "pod volumes":
        pod.volumes = (VolumeSource(name="v", pvc="c"),)
    if gate == "pod affinity":
        pod.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(
            required=(PodAffinityTerm(label_selector=LabelSelector(
                match_labels=(("a", "b"),)), topology_key=LABEL_HOSTNAME),)))
    if gate == "nominee ports":
        nom.containers = (Container.make(name="c", requests={"cpu": 3000},
                                         ports=(ContainerPort(
                                             host_port=80,
                                             container_port=80),)),)
    if gate == "nominee scalar":
        nom.containers = (Container.make(name="c", requests={
            "cpu": 3000, "example.com/gpu": 1}),)


@pytest.mark.parametrize("shards", MESHES)
@pytest.mark.parametrize("gate", GATES)
def test_gated_nominated_cycle_goes_to_the_twin(gate, shards):
    """A nominated cycle the device ghost cannot express is decided on the
    host twin, equal to TPUScheduler's; the next cycle, whose only counted
    nominee is resource-only, runs on the device with the ghost and walks
    on from the twin's last_index."""
    # a 3-CPU nominee of priority 7 on every tenth node (the gated one on
    # n3), a resource-only one of priority 9 on every sixth
    noms = [_nominee(f"nom{i}", 3000, 7, f"n{i}") for i in range(3, 120, 10)]
    noms += [_nominee(f"big{i}", 2500, 9, f"n{i}")
             for i in range(0, 120, 6)]
    pod = mkpod("in", cpu=1200, priority=5)
    _gated(gate, pod, noms[0])
    t = Pair(noms, shards=shards)
    obs.reset()
    t.cycle(pod)
    assert obs.family("twin") == {"nominated-ghosts": 1}
    assert obs.get("dispatch.cycle") == 0
    li = t.port.last_index
    assert li != 0                      # the twin's partial walk moved it
    # priority 8: only the resource-only nominees of priority 9 count
    for j in range(3):
        t.cycle(mkpod(f"next{j}", cpu=1200, priority=8))
    assert obs.family("twin") == {"nominated-ghosts": 1}
    assert obs.get("dispatch.cycle") == 3
    assert obs.get("dispatch.cycle_ghost") == 3


@pytest.mark.parametrize("shards", MESHES)
def test_gang_locality_extra_configs_go_to_the_twin(shards):
    """`extra_configs` (the rank-aware gang serial referee's
    GangLocalityPriority, bound to the trial's live zone counts) is
    decided on the host twin, each package with its own PriorityConfig and
    gang_locality_map, member by member with the counts updated after
    every bind."""
    t = Pair(shards=shards, seed=1)
    zones_j, zones_p = {}, {}
    extra = [JPriorityConfig("GangLocalityPriority", 3, function=lambda _p,
                             nis, nodes: [jprios.gang_locality_map(
                                 zones_j, nis[n.name]) for n in nodes])]
    pextra = [PPriorityConfig("GangLocalityPriority", 3, function=lambda _p,
                              nis, nodes: [pprios.gang_locality_map(
                                  zones_p, nis[n.name]) for n in nodes])]
    obs.reset()
    hosts = []
    for j in range(6):
        want = t.cycle(mkpod(f"member{j}", cpu=900), extra, pextra)
        hosts.append(want[0])
        node = t.infos[want[0]].node
        zones_j[get_zone_key(node)] = zones_j.get(get_zone_key(node), 0) + 1
        pnode = t.pinfos[want[0]].node
        zones_p[p_get_zone_key(pnode)] = \
            zones_p.get(p_get_zone_key(pnode), 0) + 1
    assert obs.family("twin") == {"gang-locality-serial": 6}
    assert obs.get("dispatch.cycle") == 0
    assert len({get_zone_key(t.infos[h].node) for h in hosts}) == 1
    # without extra_configs the next cycle is the device's again
    t.cycle(mkpod("after", cpu=900))
    assert obs.get("dispatch.cycle") == 1


@pytest.mark.parametrize("shards", MESHES)
def test_twin_scores_with_the_pods_profile(shards):
    """Two profiles: a gated nominated cycle of a pod of the second
    profile ("packer": MostRequested) scores with that profile's configs
    on both twins, and one of the default profile with the default's."""
    noms = [_nominee(f"nom{i}", 1000, 9, f"n{i}") for i in range(0, 60, 4)]
    _gated("nominee ports", mkpod("x"), noms[0])
    t = Pair(noms, shards=shards, profiles=PROFILES, seed=2)
    obs.reset()
    packer = t.cycle(dataclasses.replace(
        mkpod("packed", cpu=700, priority=5), scheduler_name="packer"))
    default = t.cycle(mkpod("spread", cpu=700, priority=5))
    assert obs.family("twin") == {"nominated-ghosts": 2}
    assert packer[0] != default[0] or packer[3] != default[3]


@pytest.mark.parametrize("shards", MESHES)
def test_twin_scores_with_priority_name_weights(shards):
    """`priority_name_weights` (the provider / policy priorities the JAX
    shell sets) gives the twin's configs on both sides."""
    noms = [_nominee(f"nom{i}", 1000, 9, f"n{i}") for i in range(0, 60, 5)]
    _gated("nominee scalar", mkpod("x"), noms[0])
    t = Pair(noms, shards=shards, seed=3, name_weights={
        "MostRequestedPriority": 2, "BalancedResourceAllocation": 1,
        "NodePreferAvoidPodsPriority": 10000})
    obs.reset()
    for j in range(3):
        t.cycle(mkpod(f"w{j}", cpu=800, priority=4))
    assert obs.family("twin") == {"nominated-ghosts": 3}


@pytest.mark.parametrize("shards", MESHES)
def test_twin_fit_error(shards):
    """A pod that fits nowhere raises the twin's FitError, failed map and
    counters equal to the reference's; the next device cycle walks on from
    there."""
    noms = [_nominee("nom", 1000, 9, "n7")]
    _gated("nominee ports", mkpod("x"), noms[0])
    t = Pair(noms, shards=shards, seed=4)
    obs.reset()
    want = t.cycle(mkpod("huge", cpu=64000, priority=5))
    assert want[0] == "fit-error" and len(want[2]) == N_NODES
    assert obs.family("twin") == {"nominated-ghosts": 1}
    t.cycle(mkpod("fits", cpu=500, priority=10))
    assert obs.get("dispatch.cycle") == 1
