"""The port's config surface against the JAX package's, on the CPU.

`kubernetes_tpu_torch.apis` (SchedulerConfiguration, Policy), the gate
table (`utils.features`), the factory's providers, custom predicates and
priorities, `resolve_algorithm` and `create_scheduler`, and `metrics.py`,
each held against the JAX package on the same inputs:
- the config's defaults and round trip; every invalid config refused with
  the reference's message;
- Policy parsing and validation; the two providers' contents;
- `resolve_algorithm` on a provider, a Policy file and an inline Policy;
- `create_scheduler(device="cpu")` against JAX's `create_scheduler` on
  `tests/test_config.py`'s `run_cluster` world, with TPUScoring on and
  off, under DefaultProvider, ClusterAutoscalerProvider and two Policies:
  the same binding map and the same route (the device's algorithm, or the
  oracle's);
- labelsPresence and serviceAffinity predicates; a priority with no kernel
  weight (the host route in both); a Policy's extenders, bind-only and
  decision ones, built from `extender_endpoints` (the host route in both,
  the same bindings and extender calls);
- `render_metrics` after the same burst: the same family names.

`create_scheduler` sets process-global gates and registers predicates and
priorities in both packages; the autouse fixture restores all of them.
"""
import dataclasses
import json

import pytest

from kubernetes_tpu import factory as jfactory
from kubernetes_tpu.api import types as JT
from kubernetes_tpu.apis import config as jconfig
from kubernetes_tpu.apis import policy as jpolicy
from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
from kubernetes_tpu.oracle.generic_scheduler import (
    GenericScheduler as JGeneric, PriorityConfig as JPriorityConfig)
from kubernetes_tpu.store import store as JS
from kubernetes_tpu.utils import features as jfeatures
from tests.torch_threads import one_torch_thread  # noqa: F401

from kubernetes_tpu_torch import factory as pfactory
from kubernetes_tpu_torch import profiles as pprofiles
from kubernetes_tpu_torch.apis import config as pconfig
from kubernetes_tpu_torch.apis import policy as ppolicy
from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    GenericScheduler as PGeneric, PriorityConfig as PPriorityConfig)
from kubernetes_tpu_torch.store import store as PS
from kubernetes_tpu_torch.utils import features as pfeatures

GI = 1024 ** 3
ZONE = "failure-domain.beta.kubernetes.io/zone"


@pytest.fixture(autouse=True)
def restore_registries():
    """Gates, custom predicates and custom priorities of both packages
    back to what they were before the test."""
    saved = [(m, dict(m._EXTRA_PREDICATES), dict(m._EXTRA_PRIORITIES))
             for m in (jfactory, pfactory)]
    yield
    for m, preds, prios in saved:
        m._EXTRA_PREDICATES.clear()
        m._EXTRA_PREDICATES.update(preds)
        m._EXTRA_PRIORITIES.clear()
        m._EXTRA_PRIORITIES.update(prios)
    jfeatures.reset()
    pfeatures.reset()


# -- configuration ------------------------------------------------------------
def test_config_defaults_and_round_trip_equal_the_reference():
    pc, jc = pconfig.SchedulerConfiguration(), jconfig.SchedulerConfiguration()
    pconfig.validate(pc)
    assert pc.to_dict() == jc.to_dict()
    assert pc.feature_gates == {"TPUScoring": True}
    d = json.loads(json.dumps(pc.to_dict()))
    assert pconfig.SchedulerConfiguration.from_dict(d).to_dict() == \
        jconfig.SchedulerConfiguration.from_dict(d).to_dict()
    # a config file of the reference's shape reads the same in both
    raw = {"scheduler_name": "s2", "percentage_of_nodes_to_score": 70,
           "algorithm_source": {"provider": "ClusterAutoscalerProvider"},
           "leader_election": {"leader_elect": True, "retry_period": 0.5},
           "feature_gates": {"TPUScoring": False, "Other": True}}
    assert pconfig.SchedulerConfiguration.from_dict(raw).to_dict() == \
        jconfig.SchedulerConfiguration.from_dict(raw).to_dict()


def _set(attr, value):
    return lambda c, m: setattr(c, attr, value)


def _src(**kw):
    return lambda c, m: setattr(c, "algorithm_source",
                                m.AlgorithmSource(**kw))


@pytest.mark.parametrize("mutate", [
    # tests/test_config.py:51's four
    _set("percentage_of_nodes_to_score", 101),
    _set("hard_pod_affinity_symmetric_weight", -1),
    _set("scheduler_name", ""),
    _set("bind_timeout_seconds", 0),
    # and the source and profile rules of the same validate()
    _src(provider=None),
    _src(provider=None, policy_file="p.json", policy_inline={}),
    _src(provider="ClusterAutoscalerProvider", policy_inline={"a": 1}),
    lambda c, m: (setattr(c, "profiles", [{"schedulerName": "a"}]),
                  setattr(c, "algorithm_source", m.AlgorithmSource(
                      provider=None, policy_inline={"a": 1}))),
    _set("profiles", [{"schedulerName": "a"}, {"schedulerName": "a"}]),
    _set("profiles", [{"schedulerName": "a",
                       "priorities": {"LeastRequestedPriority": 0}}]),
], ids=["percentage", "hard_pod", "scheduler_name", "bind_timeout",
        "no_source", "file_and_inline", "provider_and_policy",
        "profiles_and_policy", "duplicate_profile", "profile_weight"])
def test_invalid_configs_refused_with_the_reference_message(mutate):
    msgs = []
    for m in (pconfig, jconfig):
        cfg = m.SchedulerConfiguration()
        mutate(cfg, m)
        with pytest.raises(m.ValidationError) as ei:
            m.validate(cfg)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_config_from_file(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"percentage_of_nodes_to_score": 100,
                                "disable_preemption": True}))
    p = pconfig.SchedulerConfiguration.from_file(str(path))
    assert p.to_dict() == \
        jconfig.SchedulerConfiguration.from_file(str(path)).to_dict()
    assert p.disable_preemption and p.percentage_of_nodes_to_score == 100


# -- Policy -------------------------------------------------------------------
POLICY = {
    "predicates": [{"name": "GeneralPredicates"},
                   {"name": "PodToleratesNodeTaints"},
                   {"name": "ZoneOnly", "argument": {
                       "labelsPresence": {"labels": [ZONE],
                                          "presence": True}}}],
    "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                   {"name": "BalancedResourceAllocation", "weight": 1}],
    "extenders": [{"urlPrefix": "http://e", "filterVerb": "filter",
                   "bindVerb": "bind", "nodeCacheCapable": True,
                   "managedResources": [{"name": "example.com/gpu"}]}],
    "hardPodAffinitySymmetricWeight": 10,
}


def test_policy_parse_equals_the_reference():
    p = ppolicy.Policy.from_json(json.dumps(POLICY))
    j = jpolicy.Policy.from_json(json.dumps(POLICY))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    ppolicy.validate_policy(p)
    assert p.extenders[0].managed_resources == ("example.com/gpu",)
    assert (ppolicy.MAX_PRIORITY, ppolicy.MAX_WEIGHT) == \
        (jpolicy.MAX_PRIORITY, jpolicy.MAX_WEIGHT)


@pytest.mark.parametrize("doc", [
    {"priorities": [{"name": "x", "weight": 0}]},
    {"priorities": [{"name": "x", "weight": 1 << 40}]},
    {"priorities": [{"name": "x", "weight": -2},
                    {"name": "y", "weight": jpolicy.MAX_WEIGHT}]},
    {"extenders": [{"url_prefix": "a", "weight": 0}]},
    {"extenders": [{"url_prefix": "a", "bind_verb": "b"},
                   {"url_prefix": "c", "bind_verb": "d"}]},
], ids=["zero", "huge", "two", "extender_weight", "two_binders"])
def test_invalid_policies_refused_with_the_reference_message(doc):
    msgs = []
    for m in (ppolicy, jpolicy):
        with pytest.raises(m.PolicyValidationError) as ei:
            m.validate_policy(m.Policy.from_dict(doc))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_one_weight_bound_for_profiles_policy_and_search():
    from kubernetes_tpu_torch.tuner import search
    assert pprofiles.MAX_WEIGHT is ppolicy.MAX_WEIGHT
    assert search.MAX_WEIGHT is ppolicy.MAX_WEIGHT
    from kubernetes_tpu import profiles as jprofiles
    for row in ({"LeastRequestedPriority": 0},
                {"LeastRequestedPriority": jpolicy.MAX_WEIGHT,
                 "MostRequestedPriority": -1}):
        msgs = []
        for m in (pprofiles, jprofiles):
            with pytest.raises(m.ProfileValidationError) as ei:
                m.ProfileSet([m.SchedulingProfile("p", tuple(
                    sorted(row.items())))]).validate()
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


# -- gates and providers ------------------------------------------------------
def test_feature_gates_equal_the_reference():
    assert pfeatures.DEFAULT_FEATURE_GATES == jfeatures.DEFAULT_FEATURE_GATES
    assert not pfeatures.enabled("TPUScoring")
    pfeatures.set_gates({"TPUScoring": 1, "NewGate": True})
    assert pfeatures.enabled("TPUScoring") and pfeatures.enabled("NewGate")
    assert not jfeatures.enabled("TPUScoring")     # two tables
    pfeatures.reset()
    assert not pfeatures.enabled("NewGate")
    assert pfeatures.enabled("TaintNodesByCondition")


@pytest.mark.parametrize("name", ["DefaultProvider",
                                  "ClusterAutoscalerProvider"])
def test_providers_equal_the_reference(name):
    p = pfactory.get_algorithm_provider(name)
    j = jfactory.get_algorithm_provider(name)
    assert p.predicate_names == j.predicate_names
    assert p.priority_weights == j.priority_weights
    w = dict(p.priority_weights)
    if name == "DefaultProvider":
        assert w["LeastRequestedPriority"] == 1
        assert w["NodePreferAvoidPodsPriority"] == 10000
    else:
        assert "LeastRequestedPriority" not in w
        assert w["MostRequestedPriority"] == 1


def test_unknown_provider_and_support_tables():
    with pytest.raises(KeyError):
        pfactory.get_algorithm_provider("NopeProvider")
    assert pfactory.TPU_SUPPORTED_PREDICATES == \
        jfactory.TPU_SUPPORTED_PREDICATES
    assert pfactory.TPU_WEIGHT_KEYS == jfactory.TPU_WEIGHT_KEYS
    for names in (["GeneralPredicates"], ["GeneralPredicates", "ZoneOnly"],
                  list(pfactory.DEFAULT_PREDICATE_NAMES)):
        assert pfactory.tpu_supports_predicates(names) == \
            jfactory.tpu_supports_predicates(names)


@pytest.mark.parametrize("source", ["provider", "file", "inline"])
def test_resolve_algorithm_equals_the_reference(source, tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(POLICY))
    out = []
    for m in (pconfig, jconfig):
        cfg = m.SchedulerConfiguration()
        if source == "provider":
            cfg.algorithm_source = m.AlgorithmSource(
                provider="ClusterAutoscalerProvider")
        elif source == "file":
            cfg.algorithm_source = m.AlgorithmSource(
                provider=None, policy_file=str(path))
        else:
            cfg.algorithm_source = m.AlgorithmSource(
                provider=None, policy_inline={"priorities": [
                    {"name": "MostRequestedPriority", "weight": 3}]})
        fac = pfactory if m is pconfig else jfactory
        preds, weights, policy = fac.resolve_algorithm(cfg)
        out.append((preds, weights, dataclasses.asdict(policy)))
    assert out[0] == out[1]
    if source == "inline":
        # no predicates named: the DefaultProvider's
        assert out[0][0] == list(pfactory.DEFAULT_PREDICATE_NAMES)
        assert out[0][1] == {"MostRequestedPriority": 3}


# -- create_scheduler -----------------------------------------------------------
def mknode(name, cpu=4000, labels=None):
    return JT.Node(name=name, labels=dict(labels or {}),
                   allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def mkpod(name, cpu=400, labels=None):
    # tests/test_config.py's pod: cpu and memory at the same fraction of
    # allocatable, so Least/MostRequested decide pack-vs-spread alone
    return JT.Pod(name=name, labels=dict(labels or {}), containers=(
        JT.Container.make(name="c", requests={"cpu": cpu,
                                              "memory": int(3.2 * GI)}),))


def run_cluster(port, cfg, nodes, pods, services=()):
    """tests/test_config.py's run_cluster in either package: the scheduler
    `create_scheduler` builds, serial cycles until the queue is empty.
    Returns (scheduler, {pod: node})."""
    from tests.test_torch_encoders import to_port
    S = PS if port else JS
    conv = to_port if port else (lambda o: o)
    store = S.Store()
    for n in nodes:
        store.create(S.NODES, conv(n))
    for svc in services:
        store.create(S.SERVICES, conv(svc))
    sched = (pfactory.create_scheduler(store, cfg, device="cpu") if port
             else jfactory.create_scheduler(store, cfg))
    sched.sync()
    for p in pods:
        store.create(S.PODS, conv(p))
    sched.pump()
    while sched.schedule_one(timeout=0.0):
        pass
    sched.pump()
    return sched, {p.name: store.get(S.PODS, p.key).node_name for p in pods}


def route(sched):
    a = sched.algorithm
    if isinstance(a, (TorchScheduler, TPUScheduler)):
        return "device"
    assert isinstance(a, (PGeneric, JGeneric)), type(a)
    return "oracle"


def both(make_cfg, nodes, pods, services=()):
    """The same config (built per package by `make_cfg(module)`) in both
    packages: the route and binding map of each."""
    out = []
    for port in (True, False):
        cfg = make_cfg(pconfig if port else jconfig)
        sched, hosts = run_cluster(port, cfg, nodes, pods, services)
        out.append((route(sched), hosts))
    return out


def provider_cfg(provider, gate):
    def make(m):
        cfg = m.SchedulerConfiguration(
            percentage_of_nodes_to_score=100,
            algorithm_source=m.AlgorithmSource(provider=provider))
        cfg.feature_gates["TPUScoring"] = gate
        return cfg
    return make


def policy_cfg(policy, gate):
    def make(m):
        cfg = m.SchedulerConfiguration(
            percentage_of_nodes_to_score=100,
            algorithm_source=m.AlgorithmSource(
                provider=None, policy_inline=json.loads(json.dumps(policy))))
        cfg.feature_gates["TPUScoring"] = gate
        return cfg
    return make


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("provider", ["DefaultProvider",
                                      "ClusterAutoscalerProvider"])
def test_create_scheduler_provider_route_and_bindings(provider, gate):
    nodes = [mknode(f"n{i}") for i in range(4)]
    pods = [mkpod(f"p{j}") for j in range(12)]
    (pr, ph), (jr, jh) = both(provider_cfg(provider, gate), nodes, pods)
    assert pr == jr == ("device" if gate else "oracle")
    assert ph == jh and all(ph.values())
    counts = {h: list(ph.values()).count(h) for h in set(ph.values())}
    if provider == "DefaultProvider":
        assert len(counts) == 4                  # LeastRequested spreads
    else:
        assert max(counts.values()) >= 6         # MostRequested packs


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("policy", [
    {"predicates": [{"name": "GeneralPredicates"}],
     "priorities": [{"name": "MostRequestedPriority", "weight": 1}]},
    {"predicates": [{"name": "GeneralPredicates"},
                    {"name": "PodToleratesNodeTaints"}],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 2},
                    {"name": "BalancedResourceAllocation", "weight": 1},
                    {"name": "TaintTolerationPriority", "weight": 3}]},
], ids=["pack", "mixed"])
def test_create_scheduler_policy_route_and_bindings(policy, gate):
    nodes = [mknode(f"n{i}") for i in range(6)]
    pods = [mkpod(f"p{j}") for j in range(24)]
    (pr, ph), (jr, jh) = both(policy_cfg(policy, gate), nodes, pods)
    assert pr == jr == ("device" if gate else "oracle")
    assert ph == jh and all(ph.values())


def test_create_scheduler_builds_the_configured_shell():
    store = PS.Store()
    cfg = pconfig.SchedulerConfiguration(
        scheduler_name="s2", percentage_of_nodes_to_score=70,
        disable_preemption=True)
    cfg.algorithm_source = pconfig.AlgorithmSource(
        provider=None, policy_inline={
            "priorities": [{"name": "LeastRequestedPriority",
                            "weight": 2}],
            "hardPodAffinitySymmetricWeight": 7})
    sched = pfactory.create_scheduler(store, cfg, device="cpu")
    a = sched.algorithm
    assert isinstance(a, TorchScheduler) and a.device.type == "cpu"
    assert a.mesh is None
    assert sched.name == "s2" and sched.disable_preemption
    assert a.percentage_of_nodes_to_score == 70
    assert a.hard_pod_affinity_weight == 7
    assert a.priority_name_weights == {"LeastRequestedPriority": 2}
    assert a.weights["least_requested"] == 2
    assert pfeatures.enabled("TPUScoring")


def test_labels_presence_and_service_affinity_predicates():
    """A Policy with a labelsPresence and a serviceAffinity predicate (named
    as the evaluation order names them): custom predicates the kernels do
    not evaluate, so both packages take the host route, and place the same
    pods on the same nodes."""
    policy = {
        "predicates": [
            {"name": "GeneralPredicates"},
            {"name": "CheckNodeLabelPresence", "argument": {
                "labelsPresence": {"labels": ["rack"], "presence": True}}},
            {"name": "CheckServiceAffinity", "argument": {"serviceAffinity": {
                "labels": [ZONE]}}}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}
    nodes = [mknode(f"n{i}", labels={ZONE: f"z{i % 2}",
                                     **({"rack": "r"} if i != 3 else {})})
             for i in range(6)]
    svc = JT.Service(name="web", selector={"app": "web"})
    pods = [mkpod(f"w{j}", cpu=300, labels={"app": "web"})
            for j in range(8)] + [mkpod(f"o{j}", cpu=300) for j in range(4)]
    (pr, ph), (jr, jh) = both(policy_cfg(policy, True), nodes, pods, [svc])
    assert pr == jr == "oracle"
    assert ph == jh and all(ph.values())
    assert "n3" not in ph.values()               # no rack label
    zones = {int(ph[f"w{j}"][1:]) % 2 for j in range(8)}
    assert len(zones) == 1                       # the service's zone


def test_priority_without_kernel_weight_routes_to_the_host():
    def factory_for(cls):
        return lambda w, s, r, h: cls("CustomPriority", w,
                                      map_fn=lambda pod, ni: 5)
    pfactory.register_priority("CustomPriority",
                               factory_for(PPriorityConfig))
    jfactory.register_priority("CustomPriority",
                               factory_for(JPriorityConfig))
    policy = {"priorities": [{"name": "CustomPriority", "weight": 1}]}
    nodes = [mknode(f"n{i}") for i in range(3)]
    pods = [mkpod(f"p{j}") for j in range(6)]
    (pr, ph), (jr, jh) = both(policy_cfg(policy, True), nodes, pods)
    assert pr == jr == "oracle"
    assert ph == jh and all(ph.values())
    assert pfactory.tpu_kernel_weights({"CustomPriority": 1}) is None


EXTENDER_POLICIES = {
    "bind-only": [{"urlPrefix": "inproc://b", "bindVerb": "bind"}],
    "filter+prioritize": [{"urlPrefix": "inproc://d", "filterVerb": "filter",
                           "prioritizeVerb": "prioritize", "weight": 2}],
    "both": [{"urlPrefix": "inproc://d", "filterVerb": "filter",
              "prioritizeVerb": "prioritize", "weight": 2},
             {"urlPrefix": "inproc://b", "bindVerb": "bind"}],
}


@pytest.mark.parametrize("kind", sorted(EXTENDER_POLICIES))
def test_policy_with_extenders_builds_them_equal_to_the_reference(kind):
    """A Policy's extenders, built by `create_scheduler` from
    `extender_endpoints` in both packages: any extender (a bind-only one
    included) takes the host route in both, with the same bindings and
    the same extender calls."""
    nodes = [mknode(f"n{i}", cpu=2000 + 1000 * (i % 3)) for i in range(6)]
    pods = [mkpod(f"p{j}", cpu=[200, 400, 800][j % 3]) for j in range(12)]
    out = []
    for port in (True, False):
        from tests.test_torch_encoders import to_port
        S = PS if port else JS
        conv = to_port if port else (lambda o: o)
        calls = []
        store = S.Store()

        def bind_ep(payload, store=store, calls=calls):
            calls.append(("bind", payload["pod"], payload["node"]))
            store.bind_pod(payload["pod"], payload["node"])
            return {}

        def filter_ep(payload, calls=calls):
            calls.append(("filter", payload["pod"]))
            return {"nodeNames": [n for n in payload["nodes"]
                                  if n != "n1"]}

        def prioritize_ep(payload, calls=calls):
            calls.append(("prioritize", payload["pod"]))
            return {"hostPriorityList": [
                {"host": n, "score": int(n[1:]) % 2 * 10}
                for n in payload["nodes"]]}
        endpoints = {"inproc://b": {"bind": bind_ep},
                     "inproc://d": {"filter": filter_ep,
                                    "prioritize": prioritize_ep}}
        m = pconfig if port else jconfig
        cfg = m.SchedulerConfiguration(
            percentage_of_nodes_to_score=100,
            algorithm_source=m.AlgorithmSource(
                provider=None,
                policy_inline={"extenders": EXTENDER_POLICIES[kind]}))
        for n in nodes:
            store.create(S.NODES, conv(n))
        sched = (pfactory.create_scheduler(store, cfg,
                                           extender_endpoints=endpoints,
                                           device="cpu") if port
                 else jfactory.create_scheduler(
                     store, cfg, extender_endpoints=endpoints))
        assert len(sched.extenders) == len(EXTENDER_POLICIES[kind])
        sched.sync()
        for p in pods:
            store.create(S.PODS, conv(p))
        sched.pump()
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        out.append((route(sched), {p.name: store.get(S.PODS, p.key).node_name
                                   for p in pods}, calls))
    (pr, ph, pc), (jr, jh, jc) = out
    assert pr == jr == "oracle"
    assert ph == jh and all(ph.values())
    assert pc == jc and pc
    if "filter" in kind or kind == "both":
        assert "n1" not in ph.values()


def test_render_metrics_family_names_equal_the_reference():
    from kubernetes_tpu import metrics as jmetrics
    from kubernetes_tpu_torch import metrics as pmetrics
    nodes = [mknode(f"n{i}") for i in range(4)]
    names = []
    for port in (True, False):
        from tests.test_torch_encoders import to_port
        S = PS if port else JS
        conv = to_port if port else (lambda o: o)
        store = S.Store()
        for n in nodes:
            store.create(S.NODES, conv(n))
        m = pconfig if port else jconfig
        cfg = m.SchedulerConfiguration(percentage_of_nodes_to_score=100)
        sched = (pfactory.create_scheduler(store, cfg, device="cpu") if port
                 else jfactory.create_scheduler(store, cfg))
        sched.sync()
        for j in range(10):
            store.create(S.PODS, conv(mkpod(f"p{j}", cpu=100)))
        sched.pump()
        while sched.schedule_burst(max_pods=16):
            pass
        sched.pump()
        text = (pmetrics if port else jmetrics).render_metrics(sched)
        fams = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE")})
        names.append(fams)
        assert sched.metrics.schedule_attempts["scheduled"] == 10
        assert "scheduler_schedule_attempts_total" in fams
        (pmetrics if port else jmetrics).reset_metrics(sched)
        assert sched.metrics.schedule_attempts["scheduled"] == 0
    assert names[0] == names[1]
