"""The port's webhook admission against the JAX package's, on the CPU.

`kubernetes_tpu_torch.apiserver.webhook`: `tests/test_webhook.py` on the
port's apiserver and remote client (mutating and validating
registrations over callable and HTTP transports, two-phase ordering,
failurePolicy, the quota ordering, the hardening cases), and the
AdmissionReview each package sends for the same writes, held equal.
Every server listens on 127.0.0.1 port 0 and is stopped by its `with`
block or its `finally`.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kubernetes_tpu_torch.api.types import Container, Pod
from kubernetes_tpu_torch.apiserver.admission import AdmissionChain
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.apiserver.webhook import (
    WebhookAdmission, WebhookConfig, FAIL, IGNORE,
)
from kubernetes_tpu_torch.store.remote import RemoteStore, APIStatusError
from kubernetes_tpu_torch.store.store import Store, PODS
from tests.torch_threads import one_torch_thread  # noqa: F401


def mkpod(name, labels=None):
    return Pod(name=name, labels=labels or {},
               containers=(Container.make(name="c", requests={"cpu": 100}),))


def chain_with(wh: WebhookAdmission) -> AdmissionChain:
    chain = AdmissionChain()
    # registration inserts BEFORE ResourceQuotaAdmission so a webhook
    # denial can never follow (and leak) a committed quota charge
    chain.register_webhooks(wh)
    return chain


class TestCallableWebhooks:
    def test_mutating_patches_then_validating_sees_patch(self):
        wh = WebhookAdmission()

        def inject(review):
            obj = review["object"]
            obj["labels"] = {**obj.get("labels", {}), "injected": "yes"}
            return {"allowed": True, "patchedObject": obj}

        seen = {}

        def check(review):
            seen["labels"] = dict(review["object"].get("labels", {}))
            return {"allowed": True}
        wh.register_mutating(WebhookConfig(
            name="injector", kinds=("pods",), endpoint=inject))
        wh.register_validating(WebhookConfig(
            name="checker", kinds=("pods",), endpoint=check))
        store = Store()
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("p1", labels={"app": "web"}))
        created = store.get(PODS, "default/p1")
        assert created.labels == {"app": "web", "injected": "yes"}
        # the validating phase ran AFTER the mutation (two-phase order)
        assert seen["labels"]["injected"] == "yes"

    def test_validating_denies(self):
        wh = WebhookAdmission()
        wh.register_validating(WebhookConfig(
            name="no-latest", kinds=("pods",),
            endpoint=lambda r: {"allowed": "forbidden" not in
                                r["object"].get("labels", {}),
                                "message": "forbidden label"}))
        store = Store()
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("ok"))
            with pytest.raises(APIStatusError) as ei:
                remote.create(PODS, mkpod("bad",
                                          labels={"forbidden": "x"}))
            assert ei.value.code == 422
            assert "no-latest" in ei.value.message
        assert len(store.list(PODS)[0]) == 1

    def test_update_operation_and_kind_matching(self):
        wh = WebhookAdmission()
        calls = []
        wh.register_validating(WebhookConfig(
            name="audit", kinds=("pods",), operations=("UPDATE",),
            endpoint=lambda r: (calls.append(
                (r["operation"], r["oldObject"] is not None)),
                {"allowed": True})[1]))
        store = Store()
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("p1"))    # CREATE: not matched
            assert calls == []
            cur = remote.get(PODS, "default/p1")
            cur.labels = {"v": "2"}
            remote.update(PODS, cur, expect_rv=cur.resource_version)
            assert calls == [("UPDATE", True)]   # oldObject delivered

    def test_failure_policy(self):
        store = Store()
        down = "http://127.0.0.1:1/webhook"   # nothing listens there
        for policy, ok in ((IGNORE, True), (FAIL, False)):
            wh = WebhookAdmission()
            wh.register_validating(WebhookConfig(
                name="down", kinds=("pods",), url=down,
                failure_policy=policy, timeout=0.2))
            with APIServer(store, admission=chain_with(wh)) as srv:
                remote = RemoteStore(srv.url)
                if ok:
                    remote.create(PODS, mkpod(f"pod-{policy}"))
                else:
                    with pytest.raises(APIStatusError) as ei:
                        remote.create(PODS, mkpod(f"pod-{policy}"))
                    assert ei.value.code == 422


class TestWebhookQuotaOrdering:
    def test_denial_does_not_leak_quota(self):
        """A webhook denial must run BEFORE the quota charge commits —
        otherwise every denied write leaks usage (admission.py's
        quota-runs-last invariant)."""
        from kubernetes_tpu_torch.api.types import ResourceQuota
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        wh = WebhookAdmission()
        wh.register_validating(WebhookConfig(
            name="deny-marked", kinds=("pods",),
            endpoint=lambda r: {"allowed": "deny" not in
                                r["object"].get("labels", {})}))
        store = Store()
        store.create(RESOURCEQUOTAS, ResourceQuota(
            name="q", hard={"pods": 10}))
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            for i in range(3):
                with pytest.raises(APIStatusError):
                    remote.create(PODS, mkpod(f"d{i}",
                                              labels={"deny": "x"}))
            remote.create(PODS, mkpod("ok"))
        q = store.get(RESOURCEQUOTAS, "default/q")
        assert dict(q.used).get("pods", 0) == 1   # only the landed pod


class TestHTTPWebhook:
    def test_http_transport_round_trip(self):
        """A real HTTP webhook server: the AdmissionReview payload goes
        over the wire, the patch comes back, failure-policy untouched."""
        class Hook(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                review = json.loads(self.rfile.read(n))
                obj = review["object"]
                obj["priority"] = 7
                body = json.dumps({"allowed": True,
                                   "patchedObject": obj}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}/"
            wh = WebhookAdmission()
            wh.register_mutating(WebhookConfig(
                name="prio-setter", kinds=("pods",), url=url))
            store = Store()
            with APIServer(store, admission=chain_with(wh)) as srv:
                RemoteStore(srv.url).create(PODS, mkpod("p1"))
            assert store.get(PODS, "default/p1").priority == 7
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestWebhookHardening:
    def test_patch_cannot_move_or_reversion_object(self):
        """Identity metadata is re-pinned from the pre-patch object: a
        webhook that zeroes resource_version must not disable the PUT's
        CAS, and one that renames must not write under another key."""
        wh = WebhookAdmission()

        def hostile(review):
            obj = dict(review["object"])
            obj["name"] = "hijacked"
            obj["resource_version"] = 0
            obj["labels"] = {"patched": "yes"}
            return {"allowed": True, "patchedObject": obj}
        wh.register_mutating(WebhookConfig(
            name="hostile", kinds=("pods",), endpoint=hostile))
        store = Store()
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("p1"))
            cur = remote.get(PODS, "default/p1")
            cur.labels = {"v": "2"}
            remote.update(PODS, cur, expect_rv=cur.resource_version)
        pods = store.list(PODS)[0]
        assert [p.name for p in pods] == ["p1"]      # no hijacked key
        assert store.get(PODS, "default/p1").labels["patched"] == "yes"

    def test_delete_operation_dispatches(self):
        wh = WebhookAdmission()
        wh.register_validating(WebhookConfig(
            name="no-delete", kinds=("pods",), operations=("DELETE",),
            endpoint=lambda r: {"allowed": "keep" not in
                                r["object"].get("labels", {}),
                                "message": "protected"}))
        store = Store()
        with APIServer(store, admission=chain_with(wh)) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("guarded", labels={"keep": "1"}))
            remote.create(PODS, mkpod("plain"))
            with pytest.raises(APIStatusError) as ei:
                remote.delete(PODS, "default/guarded")
            assert ei.value.code == 422
            remote.delete(PODS, "default/plain")
        assert [p.name for p in store.list(PODS)[0]] == ["guarded"]


class TestServiceAccountOnPut:
    def test_put_cannot_smuggle_missing_account(self):
        store = Store()
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            remote.create(PODS, mkpod("p1"))
            cur = remote.get(PODS, "default/p1")
            cur.service_account_name = "ghost"
            with pytest.raises(APIStatusError) as ei:
                remote.update(PODS, cur, expect_rv=cur.resource_version)
            assert ei.value.code == 422
        assert store.get(PODS, "default/p1").service_account_name == "default"


# -- parity with the JAX package --------------------------------------------------
def reviews_of(pkg):
    """The AdmissionReviews `pkg`'s webhooks receive over a create, an
    update and a delete through its own apiserver and client, and the
    stored pod's labels after the mutating patch."""
    if pkg == "port":
        import kubernetes_tpu_torch as root
    else:
        import kubernetes_tpu as root
    import importlib
    T = importlib.import_module(root.__name__ + ".api.types")
    A = importlib.import_module(root.__name__ + ".apiserver.admission")
    W = importlib.import_module(root.__name__ + ".apiserver.webhook")
    srv_mod = importlib.import_module(root.__name__ + ".apiserver.server")
    R = importlib.import_module(root.__name__ + ".store.remote")
    S = importlib.import_module(root.__name__ + ".store.store")
    seen = []

    def mutate(review):
        seen.append(("mutate", json.loads(json.dumps(review))))
        obj = dict(review["object"])
        obj["labels"] = {**obj.get("labels", {}), "m": "1"}
        return {"allowed": True, "patchedObject": obj}

    def validate(review):
        seen.append(("validate", json.loads(json.dumps(review))))
        return {"allowed": True}
    wh = W.WebhookAdmission()
    wh.register_mutating(W.WebhookConfig(name="m", kinds=("pods",),
                                         endpoint=mutate))
    wh.register_validating(W.WebhookConfig(
        name="v", kinds=("pods",), operations=("CREATE", "UPDATE", "DELETE"),
        endpoint=validate))
    chain = A.AdmissionChain()
    chain.register_webhooks(wh)
    store = S.Store()
    with srv_mod.APIServer(store, admission=chain) as srv:
        remote = R.RemoteStore(srv.url)
        remote.create(S.PODS, T.Pod(
            name="p1", uid="default/p1/fixed", labels={"app": "web"},
            containers=(T.Container.make(name="c",
                                         requests={"cpu": 100}),)))
        cur = remote.get(S.PODS, "default/p1")
        cur.labels = {**cur.labels, "v": "2"}
        remote.update(S.PODS, cur, expect_rv=cur.resource_version)
        labels = dict(store.get(S.PODS, "default/p1").labels)
        remote.delete(S.PODS, "default/p1")
    return seen, labels


def test_admission_reviews_equal_the_reference():
    port, ref = reviews_of("port"), reviews_of("jax")
    assert port == ref
    assert [k for k, _r in port[0]].count("validate") == 3
