"""The port's REST apiserver, admission chain, authentication and
authorization against the JAX package's, on the CPU.

`kubernetes_tpu_torch.apiserver` (server, admission, auth) and
`kubernetes_tpu_torch.api.serde`:
- `tests/test_apiserver.py`'s TestSerde, TestRESTSurface, the admission
  classes, TestWatchResume and TestServiceAccountAdmission, and
  `tests/test_auth.py` but TestNodeIpam and the clusterrole-aggregation
  controller (both need `controllers/`, which the port does not carry
  yet), each on the port's server and client;
- parity with the JAX package: every kind's serde dict equal to JAX's for
  the same object, JAX's dict decoded by the port's serde into the same
  object, the kind registry and the cluster-scoped kinds equal;
  `wire_line` bytes equal (key order, resourceVersion, the trailing
  newline); the same REST script against both servers answering the same
  status codes and bodies, and both watch streams the same events.
Every server listens on 127.0.0.1 port 0 and is stopped by its fixture or
its `with` block; every urllib call carries a timeout (`urlopen` below),
and a command's or scheduler's informers are stopped before its server.
"""
import json
import threading
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu_torch.api.types import (
    Pod, Node, Container, PriorityClass, Affinity, PodAntiAffinity,
    PodAffinityTerm, LabelSelector, Taint, Toleration, LABEL_HOSTNAME,
    NO_SCHEDULE,
)
from kubernetes_tpu_torch.api import serde
from kubernetes_tpu_torch.apiserver.auth import (
    Attributes, NodeAuthorizer, PolicyRule, RBACAuthorizer, Role,
    RoleBinding, TokenAuthenticator, UserInfo, default_roles, union,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.store.remote import RemoteStore, APIStatusError
from kubernetes_tpu_torch.store.store import Store, PODS, NODES
from tests.torch_threads import one_torch_thread  # noqa: F401

GI = 1024 ** 3


def urlopen(*args, **kw):
    """urllib's urlopen with a timeout on every call."""
    kw.setdefault("timeout", 30)
    return urllib.request.urlopen(*args, **kw)


# -- tests/test_apiserver.py on the port ----------------------------------------
@pytest.fixture()
def server():
    store = Store()
    with APIServer(store) as srv:
        yield store, srv.url


def req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    with urlopen(r) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


class TestSerde:
    def test_pod_round_trip_with_nested_spec(self):
        pod = Pod(name="p", labels={"a": "b"},
                  node_selector={"zone": "z1"},
                  affinity=Affinity(pod_anti_affinity=PodAntiAffinity(
                      required=(PodAffinityTerm(
                          label_selector=LabelSelector(
                              match_labels=(("a", "b"),)),
                          topology_key=LABEL_HOSTNAME),))),
                  tolerations=(Toleration(key="k", value="v",
                                          effect=NO_SCHEDULE,
                                          toleration_seconds=5.0),),
                  containers=(Container.make(
                      name="c", requests={"cpu": 100, "memory": GI}),))
        d = serde.to_dict(pod)
        back = serde.from_dict(PODS, json.loads(json.dumps(d)))
        assert back == pod

    def test_node_round_trip(self):
        node = Node(name="n", labels={"z": "1"},
                    taints=(Taint(key="k", effect=NO_SCHEDULE),),
                    allocatable={"cpu": 4000, "memory": GI, "pods": 110})
        back = serde.from_dict(NODES, json.loads(json.dumps(
            serde.to_dict(node))))
        assert back == node

    def test_quoted_forward_ref_fields_rebuild(self):
        """tuple[\"PodCondition\", ...] style annotations: the nested quoted
        name survives get_type_hints as a bare string inside the builtin
        generic — decode must still rebuild the dataclass, not hand back
        raw dicts (regression: PodScheduled conditions arrived as dicts
        over the remote transport)."""
        from kubernetes_tpu_torch.api.types import (PodCondition, POD_SCHEDULED,
                                              CONDITION_FALSE)
        pod = Pod(name="p")
        pod.conditions = (PodCondition(type=POD_SCHEDULED,
                                       status=CONDITION_FALSE,
                                       reason="Unschedulable", message="m"),)
        back = serde.from_dict(PODS, json.loads(json.dumps(
            serde.to_dict(pod))))
        assert isinstance(back.conditions[0], PodCondition)
        assert back.conditions[0].reason == "Unschedulable"
        assert back == pod


class TestRESTSurface:
    def test_crud_and_binding(self, server):
        store, url = server
        with urlopen(f"{url}/healthz") as resp:
            assert resp.status == 200 and resp.read() == b"ok"
        st, created = req(f"{url}/api/v1/nodes", "POST", serde.to_dict(Node(
            name="n0", allocatable={"cpu": 4000, "memory": GI, "pods": 10})))
        assert st == 201 and created["resource_version"] > 0
        st, created = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p0", containers=(Container.make(
                name="c", requests={"cpu": 100}),))))
        assert st == 201
        st, _ = req(f"{url}/api/v1/pods/default/p0/binding", "POST",
                    {"node": "n0"})
        assert st == 201
        st, got = req(f"{url}/api/v1/pods/default/p0")
        assert got["node_name"] == "n0"
        st, lst = req(f"{url}/api/v1/pods")
        assert len(lst["items"]) == 1 and lst["resourceVersion"] > 0
        st, _ = req(f"{url}/api/v1/pods/default/p0", "DELETE")
        assert st == 200
        with pytest.raises(urllib.error.HTTPError) as e:
            req(f"{url}/api/v1/pods/default/p0")
        assert e.value.code == 404

    def test_update_conflict(self, server):
        store, url = server
        _, created = req(f"{url}/api/v1/nodes", "POST",
                         serde.to_dict(Node(name="n0")))
        stale = dict(created)
        created["unschedulable"] = True
        st, _ = req(f"{url}/api/v1/nodes/n0", "PUT", created)
        assert st == 200
        stale["unschedulable"] = False
        with pytest.raises(urllib.error.HTTPError) as e:
            req(f"{url}/api/v1/nodes/n0", "PUT", stale)
        assert e.value.code == 409

    def test_watch_stream(self, server):
        store, url = server
        got = []
        done = threading.Event()

        def watcher():
            with urlopen(
                    f"{url}/api/v1/pods?watch=true") as resp:
                for raw in resp:
                    line = raw.strip()
                    if line:
                        got.append(json.loads(line))
                        if len(got) >= 2:
                            done.set()
                            return

        t = threading.Thread(target=watcher, daemon=True)
        t.start()
        import time
        time.sleep(0.2)
        store.create(PODS, Pod(name="w0"))
        store.delete(PODS, "default/w0")
        assert done.wait(5), f"watch delivered {got}"
        assert [e["type"] for e in got] == ["ADDED", "DELETED"]
        assert got[0]["object"]["name"] == "w0"

    def test_watch_byte_ring_shared_class(self, server):
        """Round 20: two HTTP watchers on the same ?selector ride ONE
        subscription class server-side — the watch route streams
        pre-encoded lines out of the shared byte ring (wire shape
        unchanged from the per-watcher encode path), and the store books
        the second stream's lines as shared-ring hits, not re-encodes."""
        store, url = server
        got1, got2 = [], []
        done1, done2 = threading.Event(), threading.Event()

        def watcher(got, done):
            with urlopen(
                    f"{url}/api/v1/pods?watch=true&selector=app%3Da") as resp:
                for raw in resp:
                    line = raw.strip()
                    if line:
                        got.append(json.loads(line))
                        if len(got) >= 2:
                            done.set()
                            return

        t1 = threading.Thread(target=watcher, args=(got1, done1), daemon=True)
        t2 = threading.Thread(target=watcher, args=(got2, done2), daemon=True)
        t1.start()
        t2.start()
        import time
        time.sleep(0.3)
        store.create(PODS, Pod(name="b0"))
        store.delete(PODS, "default/b0")
        assert done1.wait(5) and done2.wait(5), (got1, got2)
        assert got1 == got2
        assert [e["type"] for e in got1] == ["ADDED", "DELETED"]
        assert got1[0]["object"]["name"] == "b0"
        assert got1[0]["resourceVersion"] > 0
        st = store.watch_plane_state()
        # one classmate's lines were serialize-once cache hits
        assert st["shared_hits"] >= 2, st
        assert st["line_encodes"] >= 2, st

    def test_priority_admission(self, server):
        store, url = server
        req(f"{url}/api/v1/priorityclasses", "POST",
            serde.to_dict(PriorityClass(name="high", value=1000)))
        req(f"{url}/api/v1/priorityclasses", "POST",
            serde.to_dict(PriorityClass(name="base", value=7,
                                        global_default=True)))
        _, p = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p1", priority_class_name="high")))
        assert p["priority"] == 1000
        _, p = req(f"{url}/api/v1/pods", "POST",
                   serde.to_dict(Pod(name="p2")))
        assert p["priority"] == 7 and p["priority_class_name"] == "base"
        with pytest.raises(urllib.error.HTTPError) as e:
            req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
                name="p3", priority_class_name="nope")))
        assert e.value.code == 422


class TestAdmissionDefaults:
    def test_default_toleration_seconds_and_limit_ranger(self, server):
        from kubernetes_tpu_torch.apiserver.admission import (
            TAINT_NOT_READY, TAINT_UNREACHABLE)
        store, url = server
        _, p = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="bare", containers=(Container.make(name="c"),))))
        # DefaultTolerationSeconds: both NoExecute tolerations, 300s
        tols = {t["key"]: t for t in p["tolerations"]}
        assert set(tols) == {TAINT_NOT_READY, TAINT_UNREACHABLE}
        assert all(t["toleration_seconds"] == 300.0 and
                   t["effect"] == "NoExecute" for t in tols.values())
        # LimitRanger: request defaults applied
        reqs = dict(map(tuple, p["containers"][0]["requests"]))
        assert reqs == {"cpu": 100, "memory": 200 * 1024 ** 2}
        # explicit values survive untouched
        _, p = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="explicit",
            tolerations=(Toleration(key=TAINT_NOT_READY, op="Exists",
                                    effect="NoExecute",
                                    toleration_seconds=7.0),),
            containers=(Container.make(name="c",
                                       requests={"cpu": 900,
                                                 "memory": GI}),))))
        tols = {t["key"]: t for t in p["tolerations"]}
        assert tols[TAINT_NOT_READY]["toleration_seconds"] == 7.0
        assert dict(map(tuple, p["containers"][0]["requests"]))["cpu"] == 900


class TestWatchResume:
    def test_resume_from_rv_and_410_gone(self, server):
        store, url = server
        # generate history
        for j in range(5):
            store.create(PODS, Pod(name=f"h{j}"))
        rv = store.resource_version()
        store.create(PODS, Pod(name="after"))
        # resume from rv: only the later event arrives
        got = []
        def watcher():
            with urlopen(
                    f"{url}/api/v1/pods?watch=true&resourceVersion={rv}") as r:
                for raw in r:
                    line = raw.strip()
                    if line:
                        got.append(json.loads(line))
                        return
        t = threading.Thread(target=watcher, daemon=True)
        t.start()
        t.join(5)
        assert got and got[0]["object"]["name"] == "after"
        # a resume point older than the log window is 410 Gone -> re-list
        small = Store(watch_log_size=4)
        with APIServer(small) as srv2:
            for j in range(10):
                small.create(PODS, Pod(name=f"x{j}"))
            with pytest.raises(urllib.error.HTTPError) as e:
                urlopen(
                    f"{srv2.url}/api/v1/pods?watch=true&resourceVersion=1")
            assert e.value.code == 410


class TestAdmissionOnPut:
    """The chain runs on UPDATES (VERDICT r03 weak #6): the create-then-PUT
    escape hatch around LimitRanger/quota is closed."""

    def _put(self, url, kind, obj, user=None):
        data = json.dumps(serde.to_dict(obj)).encode()
        headers = {"Content-Type": "application/json"}
        if user:
            headers["X-Remote-User"] = user
        r = urllib.request.Request(f"{url}/api/v1/{kind}/{obj.key}",
                                   data=data, method="PUT", headers=headers)
        try:
            with urlopen(r) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    def test_oversized_put_rejected_by_quota(self, server):
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        store, url = server
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="q", hard={"cpu": 500}))
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p", containers=(Container.make(
                name="c", requests={"cpu": 400, "memory": GI}),))))
        assert code == 201
        big = serde.from_dict("pods", body)
        big.containers = (Container.make(
            name="c", requests={"cpu": 2000, "memory": GI}),)
        code, body = self._put(url, "pods", big)
        assert code == 422 and "exceeded quota" in body["message"]
        # the rejected delta must not leak into usage
        assert store.get(RESOURCEQUOTAS, "default/q").used["cpu"] == 400
        # a conforming PUT (shrink) lands and replenishes
        small = store.get(PODS, "default/p")
        small.containers = (Container.make(
            name="c", requests={"cpu": 100, "memory": GI}),)
        code, _ = self._put(url, "pods", small)
        assert code == 200
        assert store.get(RESOURCEQUOTAS, "default/q").used["cpu"] == 100

    def test_put_reapplies_limitranger_defaults(self, server):
        store, url = server
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="d", containers=(Container.make(name="c"),))))
        assert code == 201
        stripped = serde.from_dict("pods", body)
        stripped.containers = (Container(name="c", requests=()),)
        code, body = self._put(url, "pods", stripped)
        assert code == 200
        reqs = dict(store.get(PODS, "default/d").containers[0].requests)
        assert reqs.get("cpu") == 100 and "memory" in reqs


class TestNodeRestriction:
    def test_kubelet_identity_limited_to_own_node(self, server):
        store, url = server
        for nm in ("n0", "n1"):
            store.create(NODES, Node(
                name=nm, allocatable={"cpu": 1000, "memory": GI, "pods": 10}))
        helper = TestAdmissionOnPut()
        own = store.get(NODES, "n0")
        own.unschedulable = True
        code, _ = helper._put(url, "nodes", own, user="system:node:n0")
        assert code == 200
        other = store.get(NODES, "n1")
        other.unschedulable = True
        code, body = helper._put(url, "nodes", other, user="system:node:n0")
        assert code == 422 and "not allowed" in body["message"]
        # a node identity may not create pods bound to ANOTHER node
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="mirror", node_name="n1",
            containers=(Container.make(name="c"),))))
        assert code == 201   # no identity: unrestricted
        data = json.dumps(serde.to_dict(Pod(
            name="mirror2", node_name="n1",
            containers=(Container.make(name="c"),)))).encode()
        r = urllib.request.Request(
            f"{url}/api/v1/pods", data=data, method="POST",
            headers={"Content-Type": "application/json",
                     "X-Remote-User": "system:node:n0"})
        try:
            urlopen(r)
            assert False, "cross-node mirror pod must be rejected"
        except urllib.error.HTTPError as e:
            assert e.code == 422


class TestPodTolerationRestriction:
    def test_namespace_whitelist_and_defaults(self, server):
        from kubernetes_tpu_torch.api.types import Namespace, Toleration
        from kubernetes_tpu_torch.store.store import NAMESPACES
        store, url = server
        store.create(NAMESPACES, Namespace(
            name="locked",
            annotations={
                "scheduler.alpha.kubernetes.io/defaultTolerations":
                    '[{"key": "team", "operator": "Equal", "value": "a", '
                    '"effect": "NoSchedule"}]',
                "scheduler.alpha.kubernetes.io/tolerationsWhitelist":
                    '[{"key": "team", "operator": "Equal", "value": "a", '
                    '"effect": "NoSchedule"}]',
            }))
        ok = Pod(name="good", namespace="locked",
                 containers=(Container.make(name="c"),))
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(ok))
        assert code == 201
        stored = store.get(PODS, "locked/good")
        assert any(t.key == "team" and t.value == "a"
                   for t in stored.tolerations), "defaults merged"
        bad = Pod(name="bad", namespace="locked",
                  tolerations=(Toleration(key="other", value="x",
                                          effect="NoSchedule"),),
                  containers=(Container.make(name="c"),))
        data = json.dumps(serde.to_dict(bad)).encode()
        r = urllib.request.Request(f"{url}/api/v1/pods", data=data,
                                   method="POST",
                                   headers={"Content-Type": "application/json"})
        try:
            urlopen(r)
            assert False, "non-whitelisted toleration must be rejected"
        except urllib.error.HTTPError as e:
            assert e.code == 422


class TestAntiAffinityAdmission:
    def test_non_hostname_required_anti_affinity_rejected(self, server):
        store, url = server
        bad = Pod(name="wide", affinity=Affinity(
            pod_anti_affinity=PodAntiAffinity(required=(
                PodAffinityTerm(
                    label_selector=LabelSelector(
                        match_labels=(("app", "x"),)),
                    topology_key="failure-domain.beta.kubernetes.io/zone"),
            ))), containers=(Container.make(name="c"),))
        data = json.dumps(serde.to_dict(bad)).encode()
        r = urllib.request.Request(f"{url}/api/v1/pods", data=data,
                                   method="POST",
                                   headers={"Content-Type": "application/json"})
        try:
            urlopen(r)
            assert False, "zone-wide required anti-affinity must be rejected"
        except urllib.error.HTTPError as e:
            assert e.code == 422
        ok = Pod(name="narrow", affinity=Affinity(
            pod_anti_affinity=PodAntiAffinity(required=(
                PodAffinityTerm(
                    label_selector=LabelSelector(
                        match_labels=(("app", "x"),)),
                    topology_key=LABEL_HOSTNAME),
            ))), containers=(Container.make(name="c"),))
        code, _ = req(f"{url}/api/v1/pods", "POST", serde.to_dict(ok))
        assert code == 201


class TestEventRateLimit:
    def test_event_burst_throttled(self):
        from kubernetes_tpu_torch.apiserver.admission import (
            AdmissionChain, AdmissionError, EventRateLimit)
        from kubernetes_tpu_torch.api.types import EventRecord
        from kubernetes_tpu_torch.store.store import Store, EVENTS
        store = Store()
        fake_now = [0.0]
        chain = AdmissionChain(plugins=[
            EventRateLimit(qps=10, burst=3, clock=lambda: fake_now[0])])
        def mk(i):
            return EventRecord(name=f"e{i}", involved_kind="Pod",
                               involved_key=f"default/p{i}", type="Normal",
                               reason="Scheduled")
        for i in range(3):
            chain.admit(EVENTS, mk(i), store)
        with pytest.raises(AdmissionError):
            chain.admit(EVENTS, mk(3), store)
        fake_now[0] += 0.2    # 2 tokens replenish
        chain.admit(EVENTS, mk(4), store)


class TestAdmissionPutBypassesClosed:
    """The PUT-path bypass vectors from review: old-binding hijack,
    whitelist/anti-affinity injection, over-cap shrink blocking."""

    def test_kubelet_cannot_steal_other_nodes_pod(self, server):
        store, url = server
        store.create(PODS, Pod(name="victim", node_name="n1",
                               containers=(Container.make(name="c"),)))
        helper = TestAdmissionOnPut()
        stolen = store.get(PODS, "default/victim")
        stolen.node_name = "n0"     # rewrite the binding in the body
        code, body = helper._put(url, "pods", stolen, user="system:node:n0")
        assert code == 422 and "not allowed" in body["message"]
        unbound = store.get(PODS, "default/victim")
        unbound.node_name = ""      # unbinding is a modification too
        code, _ = helper._put(url, "pods", unbound, user="system:node:n0")
        assert code == 422

    def test_put_cannot_inject_forbidden_toleration(self, server):
        from kubernetes_tpu_torch.api.types import Namespace, Toleration
        from kubernetes_tpu_torch.store.store import NAMESPACES
        store, url = server
        store.create(NAMESPACES, Namespace(
            name="locked",
            annotations={
                "scheduler.alpha.kubernetes.io/tolerationsWhitelist": "[]"}))
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p", namespace="locked",
            containers=(Container.make(name="c"),))))
        assert code == 201
        helper = TestAdmissionOnPut()
        hacked = store.get(PODS, "locked/p")
        hacked.tolerations = hacked.tolerations + (
            Toleration(key="smuggled", value="x", effect="NoSchedule"),)
        code, body = helper._put(url, "pods", hacked)
        assert code == 422 and "whitelist" in body["message"]
        # re-PUT with only the create-time (cluster-default) tolerations: ok
        same = store.get(PODS, "locked/p")
        same.labels["touch"] = "1"
        code, _ = helper._put(url, "pods", same)
        assert code == 200

    def test_put_cannot_inject_zone_anti_affinity(self, server):
        store, url = server
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p", containers=(Container.make(name="c"),))))
        assert code == 201
        helper = TestAdmissionOnPut()
        hacked = store.get(PODS, "default/p")
        hacked.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(
            required=(PodAffinityTerm(
                label_selector=LabelSelector(match_labels=(("a", "b"),)),
                topology_key="failure-domain.beta.kubernetes.io/zone"),)))
        code, _ = helper._put(url, "pods", hacked)
        assert code == 422

    def test_shrinking_put_allowed_when_over_cap(self, server):
        """An admin lowering hard caps below current usage must not block
        the shrinking updates that recover the namespace."""
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        store, url = server
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="q", hard={"cpu": 1000}))
        code, body = req(f"{url}/api/v1/pods", "POST", serde.to_dict(Pod(
            name="p", containers=(Container.make(
                name="c", requests={"cpu": 600, "memory": GI}),))))
        assert code == 201
        # cap lowered below usage
        def lower(cur):
            cur.hard = {"cpu": 500}
            return cur
        store.guaranteed_update(RESOURCEQUOTAS, "default/q", lower)
        helper = TestAdmissionOnPut()
        shrink = store.get(PODS, "default/p")
        shrink.containers = (Container.make(
            name="c", requests={"cpu": 300, "memory": GI}),)
        code, _ = helper._put(url, "pods", shrink)
        assert code == 200
        assert store.get(RESOURCEQUOTAS, "default/q").used["cpu"] == 300


class TestServiceAccountAdmission:
    """plugin/pkg/admission/serviceaccount: pods default to the namespace's
    'default' account; a named account must exist."""

    def _serve(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        store = Store()
        return store, APIServer(store)

    def test_defaults_to_default_account(self):
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store, srv = self._serve()
        with srv:
            RemoteStore(srv.url).create(PODS, Pod(
                name="p1", containers=(Container.make(
                    name="c", requests={"cpu": 100}),)))
        assert store.get(PODS, "default/p1").service_account_name == "default"

    def test_named_account_must_exist(self):
        from kubernetes_tpu_torch.store.remote import RemoteStore, APIStatusError
        from kubernetes_tpu_torch.store.store import SERVICEACCOUNTS
        from kubernetes_tpu_torch.api.types import ServiceAccount
        import pytest as _pytest
        store, srv = self._serve()
        with srv:
            remote = RemoteStore(srv.url)
            bad = Pod(name="bad", service_account_name="robot",
                      containers=(Container.make(
                          name="c", requests={"cpu": 100}),))
            with _pytest.raises(APIStatusError) as ei:
                remote.create(PODS, bad)
            assert ei.value.code == 422
            store.create(SERVICEACCOUNTS, ServiceAccount(name="robot"))
            remote.create(PODS, bad)
        assert store.get(PODS, "default/bad").service_account_name == "robot"


# -- tests/test_auth.py on the port ---------------------------------------------
def mknode(name):
    return Node(name=name,
                allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})


def mkpod(name, node=""):
    return Pod(name=name, node_name=node,
               containers=(Container.make(name="c", requests={"cpu": 100}),))


# table-driven RBAC cases (rbac.go RuleAllows semantics)
ALICE = UserInfo("alice", ("devs",))
BOB = UserInfo("bob", ())
ADMIN = UserInfo("root", ("system:masters",))
RBAC_CASES = [
    # (user, verb, resource, name, expected)
    (ALICE, "get", "pods", "", True),          # devs: read pods
    (ALICE, "list", "pods", "", True),
    (ALICE, "create", "pods", "", False),      # read-only role
    (ALICE, "delete", "nodes", "n1", False),   # other resource
    (BOB, "get", "pods", "", False),           # unbound user
    (BOB, "update", "nodes", "special", True),  # name-scoped rule
    (BOB, "update", "nodes", "other", False),   # wrong resourceName
    (ADMIN, "delete", "nodes", "n1", True),     # system:masters bypass
]


class TestTokenAuthenticator:
    def test_bearer_parsing(self):
        a = TokenAuthenticator({"s3cret": UserInfo("alice", ("devs",))})
        assert a.authenticate("Bearer s3cret") == UserInfo("alice", ("devs",))
        assert a.authenticate("Bearer wrong") is None
        assert a.authenticate("Basic s3cret") is None
        assert a.authenticate(None) is None


class TestRBACAuthorizer:
    def setup_method(self):
        self.authz = RBACAuthorizer(
            roles=[
                Role("pod-reader", rules=(
                    PolicyRule(verbs=("get", "list", "watch"),
                               resources=("pods",)),)),
                Role("special-node-editor", rules=(
                    PolicyRule(verbs=("update",), resources=("nodes",),
                               resource_names=("special",)),)),
            ],
            bindings=[
                RoleBinding("pod-reader", groups=("devs",)),
                RoleBinding("special-node-editor", users=("bob",)),
            ])

    @pytest.mark.parametrize("user,verb,resource,name,want", RBAC_CASES)
    def test_table(self, user, verb, resource, name, want):
        got = self.authz.authorize(Attributes(user, verb, resource, name))
        assert got is want, (user.name, verb, resource, name)

    def test_wildcards(self):
        authz = RBACAuthorizer(
            roles=[Role("admin", rules=(
                PolicyRule(verbs=("*",), resources=("*",)),))],
            bindings=[RoleBinding("admin", users=("ops",))])
        u = UserInfo("ops", ())
        assert authz.authorize(Attributes(u, "delete", "namespaces", "x"))
        assert not authz.authorize(
            Attributes(UserInfo("other", ()), "get", "pods", ""))

    @pytest.mark.parametrize("verb", ["list", "watch", "create"])
    def test_resource_names_deny_collection_verbs(self, verb):
        """resourceNames narrow a rule to SPECIFIC objects (auth.py
        PolicyRule.allows): collection verbs carry no object name
        (attrs.name == \"\"), so a name-scoped rule can never satisfy
        list/watch — and create (name unknown at authorization time) is
        denied the same way, matching the reference's RuleAllows where
        resourceNames simply never match the empty name. Pinned here
        because the controller-manager's */* grant otherwise hides a
        regression in this rule entirely."""
        authz = RBACAuthorizer(
            roles=[Role("one-node", rules=(
                PolicyRule(verbs=("*",), resources=("nodes",),
                           resource_names=("special",)),))],
            bindings=[RoleBinding("one-node", users=("carol",))])
        carol = UserInfo("carol", ())
        # the named object itself stays reachable through object verbs
        assert authz.authorize(Attributes(carol, "get", "nodes", "special"))
        assert authz.authorize(Attributes(carol, "update", "nodes", "special"))
        # collection verbs (empty name) are denied by the same rule
        assert not authz.authorize(Attributes(carol, verb, "nodes", ""))
        # and an unlisted name stays denied for any verb
        assert not authz.authorize(Attributes(carol, verb, "nodes", "other"))

    def test_resource_names_collection_deny_not_masked_by_union(self):
        """The same pinning through a union with the node authorizer (the
        server's real stack shape): the deny must survive stacking, not
        just the single-authorizer unit."""
        authz = union(RBACAuthorizer(
            roles=[Role("one-node", rules=(
                PolicyRule(verbs=("*",), resources=("nodes",),
                           resource_names=("special",)),))],
            bindings=[RoleBinding("one-node", users=("carol",))]),
            NodeAuthorizer())
        carol = UserInfo("carol", ())
        assert not authz.authorize(Attributes(carol, "list", "nodes", ""))
        assert not authz.authorize(Attributes(carol, "watch", "nodes", ""))
        assert not authz.authorize(Attributes(carol, "create", "nodes", ""))


KUBELET1 = UserInfo("system:node:n1", ("system:nodes",))
IMPOSTOR = UserInfo("system:node:n1", ())   # right name, not in the group
NODE_CASES = [
    (KUBELET1, "get", "pods", "", True),        # informers read
    (KUBELET1, "watch", "nodes", "", True),
    (KUBELET1, "update", "nodes", "n1", True),  # own node status
    (KUBELET1, "update", "nodes", "n2", False),  # someone else's node
    (KUBELET1, "delete", "nodes", "n1", False),  # kubelets never delete nodes
    (KUBELET1, "create", "events", "", True),
    (KUBELET1, "delete", "events", "e1", False),
    (KUBELET1, "update", "leases", "n1", True),  # heartbeat lease
    (KUBELET1, "update", "pods", "default/p", True),  # body checked by
    (IMPOSTOR, "update", "nodes", "n1", False),       # NodeRestriction
    (KUBELET1, "create", "pods", "", False),   # binding = scheduler verb
    # secret-bearing kinds: the graph-based reference scopes these to
    # objects referenced by pods bound to the node; without the graph the
    # collapse is an outright deny — a kubelet credential must not read
    # cluster secrets wholesale (ADVICE r5)
    (KUBELET1, "get", "secrets", "default/s1", False),
    (KUBELET1, "list", "secrets", "", False),
    (KUBELET1, "watch", "secrets", "", False),
    (KUBELET1, "get", "configmaps", "default/cm", False),
    (KUBELET1, "list", "configmaps", "", False),
    (KUBELET1, "watch", "serviceaccounts", "", False),
    (KUBELET1, "create", "secrets", "", False),
    (KUBELET1, "update", "configmaps", "default/cm", False),
    # the pod-group kind is ordinary cluster state: reads stay allowed
    (KUBELET1, "get", "podgroups", "default/g", True),
]


class TestNodeAuthorizer:
    @pytest.mark.parametrize("user,verb,resource,name,want", NODE_CASES)
    def test_table(self, user, verb, resource, name, want):
        got = NodeAuthorizer().authorize(Attributes(user, verb, resource,
                                                    name))
        assert got is want, (user.name, verb, resource, name)

    def test_secret_deny_survives_union_stack(self):
        """The deny must hold through the server's real authorizer shape
        (RBAC ∪ node): the scheduler/controller roles keep their access,
        the kubelet identity stays denied."""
        roles, bindings = default_roles()
        stack = union(RBACAuthorizer(roles=roles, bindings=bindings),
                      NodeAuthorizer())
        for verb in ("get", "list", "watch"):
            assert not stack.authorize(
                Attributes(KUBELET1, verb, "secrets", ""))
            assert not stack.authorize(
                Attributes(KUBELET1, verb, "configmaps", ""))
        sched = UserInfo("system:kube-scheduler")
        assert stack.authorize(Attributes(sched, "list", "secrets", ""))

    def test_served_kubelet_cannot_read_secrets(self):
        """End to end over HTTP: a kubelet token listing secrets /
        configmaps / serviceaccounts gets 403; its ordinary informer
        reads (pods, nodes) still work."""
        from kubernetes_tpu_torch.api.types import Secret
        from kubernetes_tpu_torch.store.store import (CONFIGMAPS, SECRETS,
                                                SERVICEACCOUNTS)
        store = Store()
        store.create(NODES, mknode("n1"))
        store.create(SECRETS, Secret(name="s1", data={"k": "dmFs"}))
        authn = TokenAuthenticator({
            "kubelet-n1": UserInfo("system:node:n1", ("system:nodes",))})
        with APIServer(store, authenticator=authn,
                       authorizer=NodeAuthorizer()) as srv:
            kubelet = RemoteStore(srv.url, token="kubelet-n1")
            assert [n.name for n in kubelet.list(NODES)[0]] == ["n1"]
            for kind in (SECRETS, CONFIGMAPS, SERVICEACCOUNTS):
                with pytest.raises(APIStatusError) as ei:
                    kubelet.list(kind)
                assert ei.value.code == 403, kind
            with pytest.raises(APIStatusError) as ei:
                kubelet.get(SECRETS, "default/s1")
            assert ei.value.code == 403


class TestServedAuth:
    """The apiserver enforcing the stack end-to-end over HTTP."""

    def _serve(self, store):
        roles, bindings = default_roles()
        authn = TokenAuthenticator({
            "sched-token": UserInfo("system:kube-scheduler"),
            "kubelet-n1": UserInfo("system:node:n1", ("system:nodes",)),
            "viewer": UserInfo("eve"),
        })
        authz = union(
            RBACAuthorizer(roles=roles, bindings=bindings),
            NodeAuthorizer())
        return APIServer(store, authenticator=authn, authorizer=authz)

    def test_unauthenticated_writes_rejected(self):
        store = Store()
        with self._serve(store) as srv:
            anon = RemoteStore(srv.url)
            with pytest.raises(APIStatusError) as ei:
                anon.create(NODES, mknode("n1"))
            assert ei.value.code == 401
            with pytest.raises(APIStatusError) as ei:
                anon.list(PODS)
            assert ei.value.code == 401
            assert store.list(NODES)[0] == []   # nothing landed

    def test_wrong_token_is_anonymous(self):
        store = Store()
        with self._serve(store) as srv:
            bad = RemoteStore(srv.url, token="guessed")
            with pytest.raises(APIStatusError) as ei:
                bad.create(NODES, mknode("n1"))
            assert ei.value.code == 401

    def test_scheduler_identity_can_do_its_job(self):
        store = Store()
        store.create(NODES, mknode("n1"))
        store.create(PODS, mkpod("p1"))
        with self._serve(store) as srv:
            sched = RemoteStore(srv.url, token="sched-token")
            pods, _ = sched.list(PODS)          # read: allowed
            assert len(pods) == 1
            sched.bind_pod("default/p1", "n1")  # the scheduler's write verb
            assert store.get(PODS, "default/p1").node_name == "n1"
            with pytest.raises(APIStatusError) as ei:
                sched.delete(NODES, "n1")       # outside its role
            assert ei.value.code == 403

    def test_authenticated_but_unauthorized_forbidden(self):
        store = Store()
        store.create(NODES, mknode("n1"))
        with self._serve(store) as srv:
            eve = RemoteStore(srv.url, token="viewer")
            with pytest.raises(APIStatusError) as ei:
                eve.create(PODS, mkpod("p1"))
            assert ei.value.code == 403

    def test_node_restriction_on_verified_identity(self):
        """The VERDICT r4 hole: NodeRestriction keyed off a spoofable
        header. With auth enabled the header is ignored; the verified
        kubelet identity is enforced — n1's kubelet cannot touch n2."""
        store = Store()
        store.create(NODES, mknode("n1"))
        store.create(NODES, mknode("n2"))
        with self._serve(store) as srv:
            kubelet = RemoteStore(srv.url, token="kubelet-n1")
            n1 = kubelet.get(NODES, "n1")
            n1.unschedulable = True
            kubelet.update(NODES, n1, expect_rv=n1.resource_version)  # own: ok
            n2 = kubelet.get(NODES, "n2")
            n2.unschedulable = True
            with pytest.raises(APIStatusError) as ei:
                kubelet.update(NODES, n2, expect_rv=n2.resource_version)
            assert ei.value.code == 403   # node authorizer: not its node

    def test_kubelet_cannot_bind_or_steal_pods(self):
        """The binding subresource is the scheduler's verb: a node
        identity is denied at authorization (and, belt-and-braces, by
        NodeRestriction's binding admission)."""
        store = Store()
        store.create(NODES, mknode("n1"))
        store.create(PODS, mkpod("victim"))
        with self._serve(store) as srv:
            kubelet = RemoteStore(srv.url, token="kubelet-n1")
            with pytest.raises(APIStatusError) as ei:
                kubelet.bind_pod("default/victim", "n1")
            assert ei.value.code == 403
            assert store.get(PODS, "default/victim").node_name == ""
        # even WITHOUT an authorizer, binding admission rejects node
        # identities (the authn-only posture)
        from kubernetes_tpu_torch.apiserver.auth import TokenAuthenticator
        authn = TokenAuthenticator({
            "kubelet-n1": UserInfo("system:node:n1", ("system:nodes",))})
        with APIServer(store, authenticator=authn) as srv:
            kubelet = RemoteStore(srv.url, token="kubelet-n1")
            with pytest.raises(APIStatusError) as ei:
                kubelet.bind_pod("default/victim", "n1")
            assert ei.value.code == 422
            assert store.get(PODS, "default/victim").node_name == ""

    def test_kubelet_delete_restricted_to_own_pods(self):
        """Deletes run admission: n1's kubelet can evict its own pod but
        not one bound to n2, and cannot delete another node object."""
        store = Store()
        store.create(NODES, mknode("n1"))
        store.create(NODES, mknode("n2"))
        store.create(PODS, mkpod("mine", node="n1"))
        store.create(PODS, mkpod("theirs", node="n2"))
        store.create(PODS, mkpod("pending"))   # unbound: the scheduler's
        with self._serve(store) as srv:
            kubelet = RemoteStore(srv.url, token="kubelet-n1")
            kubelet.delete(PODS, "default/mine")        # own pod: allowed
            with pytest.raises(APIStatusError) as ei:
                kubelet.delete(PODS, "default/theirs")
            assert ei.value.code == 422
            with pytest.raises(APIStatusError) as ei:
                kubelet.delete(PODS, "default/pending")  # unbound: denied
            assert ei.value.code == 422
            with pytest.raises(APIStatusError):
                kubelet.delete(NODES, "n2")
        assert store.get(PODS, "default/theirs").node_name == "n2"
        with pytest.raises(Exception):
            store.get(PODS, "default/mine")   # gone

    def test_spoofed_header_no_longer_grants_identity(self):
        """With an authenticator configured, X-Remote-User is dead: an
        anonymous caller asserting a kubelet identity is rejected at
        authn, and an authenticated non-node user keeps ITS identity for
        admission regardless of the header."""
        import json
        import urllib.request
        store = Store()
        store.create(NODES, mknode("n2"))
        store.create(PODS, mkpod("p1", node="n2"))
        with self._serve(store) as srv:
            from kubernetes_tpu_torch.api import serde
            pod = store.get(PODS, "default/p1")
            pod.labels = {"touched": "yes"}
            body = serde.to_dict(pod)
            body["resource_version"] = 0
            req = urllib.request.Request(
                f"{srv.url}/api/v1/pods/default/p1",
                data=json.dumps(body).encode(), method="PUT",
                headers={"Content-Type": "application/json",
                         # spoof: claim to be n2's kubelet
                         "X-Remote-User": "system:node:n2"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urlopen(req)
            assert ei.value.code == 401   # anonymous, despite the header

    def test_scheduler_attaches_with_token(self):
        """cmd/scheduler.py --server --token: the whole scheduling loop
        under the bootstrapped RBAC identity."""
        from kubernetes_tpu_torch.cmd import scheduler as cmd_sched
        store = Store(watch_log_size=65536)
        store.create(NODES, mknode("n1"))
        for j in range(4):
            store.create(PODS, mkpod(f"p{j}"))
        state = {}
        with self._serve(store) as srv:
            try:
                rc = cmd_sched.main(["--server", srv.url, "--token",
                                     "sched-token", "--once",
                                     "--percentage-of-nodes-to-score", "100",
                                     "--device", "cpu"], state=state)
            finally:
                state["scheduler"].informers.stop_all()
            assert rc == 0
        assert all(p.node_name for p in store.list(PODS)[0])


class TestStoreBackedRBAC:
    """RBAC policy as API objects: clusterroles / clusterrolebindings in
    the store drive authorization live, and the aggregation controller
    unions labeled roles (clusterroleaggregation_controller.go)."""

    def test_policy_objects_grant_access(self):
        from kubernetes_tpu_torch.apiserver.auth import (Role, RoleBinding,
                                                   PolicyRule)
        from kubernetes_tpu_torch.store.store import (CLUSTERROLES,
                                                CLUSTERROLEBINDINGS)
        store = Store()
        authn = TokenAuthenticator({"t": UserInfo("dev", ("devs",))})
        authz = RBACAuthorizer(store=store)
        with APIServer(store, authenticator=authn,
                       authorizer=authz) as srv:
            dev = RemoteStore(srv.url, token="t")
            with pytest.raises(APIStatusError) as ei:
                dev.list(PODS)
            assert ei.value.code == 403
            # grant through the API-objects themselves (admin writes
            # directly; a bootstrapped admin token would do it over HTTP)
            store.create(CLUSTERROLES, Role(name="reader", rules=(
                PolicyRule(verbs=("get", "list", "watch"),
                           resources=("pods",)),)))
            store.create(CLUSTERROLEBINDINGS, RoleBinding(
                role="reader", groups=("devs",)))
            assert dev.list(PODS)[0] == []     # live effect, no restart
            with pytest.raises(APIStatusError):
                dev.create(PODS, mkpod("p"))   # still read-only

    def test_policy_round_trips_serde(self):
        from kubernetes_tpu_torch.api import serde
        from kubernetes_tpu_torch.apiserver.auth import Role, PolicyRule
        r = Role(name="agg", rules=(
            PolicyRule(verbs=("get",), resources=("pods",),
                       resource_names=("x",)),),
            labels={"team": "a"}, aggregation_labels={"rbac/agg": "true"})
        back = serde.from_dict("clusterroles", serde.to_dict(r))
        assert back.rules == r.rules
        assert isinstance(back.rules[0], PolicyRule)
        assert back.aggregation_labels == {"rbac/agg": "true"}



# -- parity with the JAX package --------------------------------------------------
from kubernetes_tpu.api import serde as jserde  # noqa: E402
from kubernetes_tpu.api import types as JT  # noqa: E402
from kubernetes_tpu.apiserver import server as jserver  # noqa: E402
from kubernetes_tpu.store import store as JS  # noqa: E402
from kubernetes_tpu_torch.apiserver import server as pserver  # noqa: E402


def to_port_obj(obj):
    """A JAX-package dataclass rebuilt as the port's class of the same
    module path and name, field for field (api types, RBAC kinds,
    PodGroup alike)."""
    import dataclasses
    import importlib
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        mod = importlib.import_module(cls.__module__.replace(
            "kubernetes_tpu", "kubernetes_tpu_torch", 1))
        fields = dataclasses.fields(obj)
        new = getattr(mod, cls.__name__)(**{
            f.name: to_port_obj(getattr(obj, f.name))
            for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(new, f.name,
                                   to_port_obj(getattr(obj, f.name)))
        return new
    if isinstance(obj, tuple):
        return tuple(to_port_obj(x) for x in obj)
    if isinstance(obj, list):
        return [to_port_obj(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port_obj(v) for k, v in obj.items()}
    return obj


def sample(kind):
    """A JAX-package object of `kind`: richly filled for pods, nodes, the
    RBAC kinds and PodGroups, else named (and namespaced) defaults."""
    cls = jserde.KIND_TYPES[kind]
    if kind == JS.PODS:
        return JT.Pod(
            name="p", namespace="ns1", uid="ns1/p/fixed", labels={"a": "b"},
            priority=7,
            node_selector={"zone": "z1"}, node_name="n1",
            affinity=JT.Affinity(pod_anti_affinity=JT.PodAntiAffinity(
                required=(JT.PodAffinityTerm(
                    label_selector=JT.LabelSelector(
                        match_labels=(("a", "b"),)),
                    topology_key=JT.LABEL_HOSTNAME),))),
            tolerations=(JT.Toleration(key="k", value="v",
                                       effect=JT.NO_SCHEDULE,
                                       toleration_seconds=5.0),),
            conditions=(JT.PodCondition(type=JT.POD_SCHEDULED,
                                        status=JT.CONDITION_FALSE,
                                        reason="Unschedulable",
                                        message="m"),),
            containers=(JT.Container.make(
                name="c", requests={"cpu": 100, "memory": GI,
                                    "example.com/gpu": 1}),))
    if kind == JS.NODES:
        return JT.Node(name="n", labels={"z": "1"}, unschedulable=True,
                       taints=(JT.Taint(key="k", effect=JT.NO_SCHEDULE),),
                       allocatable={"cpu": 4000, "memory": GI, "pods": 110})
    if kind == JS.CLUSTERROLES:
        from kubernetes_tpu.apiserver.auth import PolicyRule, Role as JRole
        return JRole(name="agg", rules=(PolicyRule(
            verbs=("get",), resources=("pods",), resource_names=("x",)),),
            labels={"team": "a"}, aggregation_labels={"rbac/agg": "true"})
    if kind == JS.CLUSTERROLEBINDINGS:
        return cls(role="agg", users=("alice",), groups=("devs",))
    if kind == JS.EVENTS:
        return cls(name="e1", involved_kind="Pod", involved_key="ns1/p",
                   type="Normal", reason="Scheduled", message="m", count=2,
                   namespace="ns1", component="default-scheduler")
    if kind == JS.PODGROUPS:
        return cls(name="g", namespace="ns1", min_member=3)
    names = {f.name for f in __import__("dataclasses").fields(cls)}
    kw = {"name": f"{kind}-1"}
    if "namespace" in names:
        kw["namespace"] = "ns1"
    return cls(**kw)


def test_kind_registry_equals_the_reference():
    assert sorted(serde.KIND_TYPES) == sorted(jserde.KIND_TYPES)
    assert {k: c.__name__ for k, c in serde.KIND_TYPES.items()} == \
        {k: c.__name__ for k, c in jserde.KIND_TYPES.items()}
    assert serde.CLUSTER_SCOPED_KINDS == jserde.CLUSTER_SCOPED_KINDS


@pytest.mark.parametrize("kind", sorted(jserde.KIND_TYPES))
def test_serde_dict_equals_the_reference(kind):
    """The same object built in both packages serialises to equal dicts
    with the same key order; JAX's dict decodes to the port's object, and
    the port's dict to JAX's."""
    jobj = sample(kind)
    pobj = to_port_obj(jobj)
    jd, pd = jserde.to_dict(jobj), serde.to_dict(pobj)
    assert pd == jd
    assert json.dumps(pd) == json.dumps(jd)
    assert serde.from_dict(kind, json.loads(json.dumps(jd))) == pobj
    assert jserde.from_dict(kind, json.loads(json.dumps(pd))) == jobj


@pytest.mark.parametrize("etype", ["ADDED", "MODIFIED", "DELETED"])
@pytest.mark.parametrize("kind", [JS.PODS, JS.NODES, JS.CLUSTERROLES,
                                  JS.PODGROUPS, JS.EVENTS])
def test_wire_line_bytes_equal_the_reference(kind, etype):
    jobj = sample(kind)
    for rv in (1, 2 ** 40 + 3):
        line = pserver.wire_line(etype, to_port_obj(jobj), rv)
        assert line == jserver.wire_line(etype, jobj, rv)
        assert line.endswith(b"\n") and line.count(b"\n") == 1


def rest_script(url):
    """One REST session: creates, a binding, reads, a stale PUT, a delete,
    a 404, a priority-class admission, a list, then a watch from rv 0.
    Returns every (status, body) and the watch's events."""
    out = []

    def call(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(url + path, data=data, method=method,
                                   headers={"Content-Type":
                                            "application/json"})
        try:
            with urlopen(r) as resp:
                out.append((resp.status, json.loads(resp.read() or b"{}")))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.loads(e.read() or b"{}")))
        return out[-1][1]
    node = jserde.to_dict(JT.Node(name="n0", allocatable={
        "cpu": 4000, "memory": GI, "pods": 10}))
    created = call("/api/v1/nodes", "POST", node)
    call("/api/v1/priorityclasses", "POST", jserde.to_dict(
        JT.PriorityClass(name="high", value=1000)))
    for j, pc in enumerate(("high", "", "nope")):
        call("/api/v1/pods", "POST", jserde.to_dict(JT.Pod(
            name=f"p{j}", uid=f"default/p{j}/fixed",
            priority_class_name=pc, containers=(
                JT.Container.make(name="c", requests={"cpu": 100}),))))
    rv0 = call("/api/v1/pods")["resourceVersion"]
    call("/api/v1/pods/default/p0/binding", "POST", {"node": "n0"})
    call("/api/v1/pods/default/p0/binding", "POST", {"node": "n9"})
    call("/api/v1/pods/default/p0")
    stale = dict(created)
    created["unschedulable"] = True
    call("/api/v1/nodes/n0", "PUT", created)
    call("/api/v1/nodes/n0", "PUT", stale)
    call("/api/v1/pods/default/p1", "DELETE")
    call("/api/v1/pods/default/p1")
    call("/api/v1/pods")
    call("/api/v1/nodes")
    call("/api/v1/nosuchkind")
    events = []
    with urlopen(f"{url}/api/v1/pods?watch=true&resourceVersion={rv0}") as r:
        for raw in r:
            if raw.strip():
                events.append(json.loads(raw))
                if len(events) == 2:
                    break
    return out, events


def test_rest_script_answers_equal_the_reference():
    """The same REST session against the port's server and JAX's, each
    over its own empty store: every status code and body equal, and the
    resumed watch's events equal."""
    with APIServer(Store()) as srv:
        port = rest_script(srv.url)
    with jserver.APIServer(JS.Store()) as srv:
        ref = rest_script(srv.url)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    codes = [c for c, _b in port[0]]
    assert 404 in codes and 409 in codes and 422 in codes


def test_watch_stream_bytes_equal_the_reference():
    """A watch stream's raw lines from both servers over the same writes
    are byte-equal (the serialize-once ring's encoder is `wire_line`)."""
    lines = {}
    for pkg, Server, conv in (("port", APIServer, to_port_obj),
                              ("jax", jserver.APIServer, lambda o: o)):
        store = Store() if pkg == "port" else JS.Store()
        kinds = (PODS, NODES) if pkg == "port" else (JS.PODS, JS.NODES)
        got = []
        with Server(store) as srv:
            store.create(kinds[1], conv(sample(JS.NODES)))
            rv = store.resource_version()
            store.create(kinds[0], conv(sample(JS.PODS)))
            store.delete(kinds[0], "ns1/p")
            with urlopen(f"{srv.url}/api/v1/pods?watch=true"
                         f"&resourceVersion={rv}") as r:
                for raw in r:
                    if raw.strip():
                        got.append(raw)
                        if len(got) == 2:
                            break
        lines[pkg] = got
    assert lines["port"] == lines["jax"]
    assert [json.loads(x)["type"] for x in lines["port"]] == \
        ["ADDED", "DELETED"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_per_watcher_mode_equals_the_reference(seed, monkeypatch):
    """The store's degenerate class-per-watcher mode
    (`shared_watch_classes=False`, `set_shared_classes` on the commit
    core) and the shared-class mode, each on the port's store, against the
    JAX package's twin core in both modes: the op programs of
    `tests/test_commit_core.py` (creates, updates, deletes, binds, waves,
    fences, evictions, selector watches drained as Events and as wire
    bytes, detaches; the reference's core demotion left out, the port has
    none) give every result, raise, Event stream, byte stream, bucket and
    resourceVersion equal in all four runs."""
    from kubernetes_tpu_torch import chaos as pchaos
    from kubernetes_tpu_torch.store import store as PS
    from tests import test_commit_core as TC
    prog = [op for op in TC._random_program(seed) if op[0] != "demote"]
    runs = {}
    for shared in (True, False):
        h = TC._Recorderless("twin", seed, shared=shared)
        for op in prog:
            h.op(*op)
        runs[("jax", shared)] = (h.log, h.snapshot_pods(),
                                 h.store.resource_version())
    with monkeypatch.context() as mp:
        for name in ("NotFoundError", "AlreadyExistsError", "ConflictError",
                     "ExpiredError", "FencedError"):
            if hasattr(TC, name):
                mp.setattr(TC, name, getattr(PS, name))
        mp.setattr(TC, "InjectedFault", pchaos.InjectedFault)

        def port_store(commit_core=None, **kw):
            assert commit_core == "twin"
            return PS.Store(**kw)
        mp.setattr(TC, "Store", port_store)
        for shared in (True, False):
            h = TC._Recorderless("twin", seed, shared=shared)
            assert isinstance(h.store, PS.Store)
            assert h.store.shared_watch_classes is shared
            for op in prog:
                h.op(*op)
            runs[("port", shared)] = (h.log, h.snapshot_pods(),
                                      h.store.resource_version())
            stats = h.store.watch_plane_state()
            assert stats["shared_classes"] is shared
            if not shared:
                assert stats["classes"] == []
    assert runs[("port", True)] == runs[("jax", True)]
    assert runs[("port", False)] == runs[("jax", False)]
    assert runs[("port", True)] == runs[("port", False)]
