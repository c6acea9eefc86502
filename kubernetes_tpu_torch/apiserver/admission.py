"""Admission chain — plugin/pkg/admission analog: the port's copy of the
reference's `apiserver/admission.py` with the port's imports.

Mutating/validating plugins run on every apiserver write before the store
commit (the reference chains 20+ plugins in the generic apiserver's
handler stack). Implemented plugins:

- PriorityAdmission (plugin/pkg/admission/priority): resolves
  pod.priority_class_name to the PriorityClass value (or the cluster's
  global default when unset), writing pod.priority — the field preemption
  orders by. Unknown class names are rejected.
- TaintNodesByCondition-style defaulting is NOT admission here (the
  node-lifecycle controller owns taints).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from kubernetes_tpu_torch.api.types import Pod, get_resource_request
from kubernetes_tpu_torch.store.store import Store, PODS, PRIORITYCLASSES

# The node-lifecycle taint keys and the quota usage of a pod, copied from
# the reference's controllers (`controllers/nodelifecycle.py`,
# `controllers/resourcequota.py`), which the port does not carry yet.
TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"


def pod_usage(pod: Pod) -> dict[str, int]:
    req = get_resource_request(pod)
    return {"cpu": req.milli_cpu, "memory": req.memory, "pods": 1}


class AdmissionError(Exception):
    """Write rejected (HTTP 422 at the REST boundary)."""


class PriorityAdmission:
    """plugin/pkg/admission/priority: Admit on pod create."""

    kind = PODS

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        classes, _rv = store.list(PRIORITYCLASSES)
        if obj.priority_class_name:
            for pc in classes:
                if pc.name == obj.priority_class_name:
                    obj.priority = pc.value
                    return obj
            raise AdmissionError(
                f"no PriorityClass with name {obj.priority_class_name} was found")
        for pc in classes:
            if pc.global_default:
                obj.priority = pc.value
                obj.priority_class_name = pc.name
                return obj
        return obj   # resolved priority 0 (the reference's default)


class DefaultTolerationSeconds:
    """plugin/pkg/admission/defaulttolerationseconds: pods that don't pin
    their own not-ready/unreachable NoExecute tolerations get the cluster
    defaults (300s), bounding how long they linger on a failed node before
    the taint manager evicts them."""

    DEFAULT_SECONDS = 300.0

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        from kubernetes_tpu_torch.api.types import Toleration, TOLERATION_OP_EXISTS
        have = {t.key for t in obj.tolerations
                if t.effect in ("", "NoExecute")}
        extra = []
        for key in (TAINT_NOT_READY, TAINT_UNREACHABLE):
            if key not in have:
                extra.append(Toleration(
                    key=key, op=TOLERATION_OP_EXISTS, effect="NoExecute",
                    toleration_seconds=self.DEFAULT_SECONDS))
        if extra:
            obj.tolerations = obj.tolerations + tuple(extra)
        return obj


class LimitRanger:
    """plugin/pkg/admission/limitranger (defaulting half): containers with
    no cpu/memory request get the configured defaults, so every pod the
    scheduler sees has concrete resource demands."""

    def __init__(self, default_cpu: int = 100, default_mem: int = 200 * 1024 ** 2):
        self.default_cpu = default_cpu
        self.default_mem = default_mem

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        from kubernetes_tpu_torch.api.types import Container
        changed = False
        out = []
        for c in obj.containers:
            req = dict(c.requests)
            if "cpu" not in req or "memory" not in req:
                req.setdefault("cpu", self.default_cpu)
                req.setdefault("memory", self.default_mem)
                c = Container(name=c.name, image=c.image,
                              requests=tuple(sorted(req.items())),
                              limits=c.limits, ports=c.ports)
                changed = True
            out.append(c)
        if changed:
            obj.containers = tuple(out)
        return obj

    def admit_update(self, kind: str, old: Any, new: Any, store: Store) -> Any:
        # the reference LimitRanger runs on updates too: a PUT must not
        # strip the defaults a create received
        return self.admit(kind, new, store)


def _subtract_usage(cur, amounts: dict) -> Any:
    """Clamp-at-zero usage decrement over a quota's hard-capped resources —
    the single mutate every quota refund path shares."""
    used = dict(cur.used)
    for name in cur.hard:
        if amounts.get(name):
            used[name] = max(0, used.get(name, 0) - amounts[name])
    cur.used = used
    return cur


class ResourceQuotaAdmission:
    """plugin/pkg/admission/resourcequota: reject pod creation that would
    push any namespace quota past its hard caps, COMMITTING the new usage
    synchronously via CAS on admit (the reference's checkQuotas CASes quota
    status through the evaluator before the pod write lands,
    plugin/pkg/admission/resourcequota/controller.go). A rapid burst of
    creates therefore cannot overshoot: each admit observes the previous
    admit's committed usage. The controller reconciles drift (pod deletes,
    terminal phases) from live state afterwards."""

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS, NotFoundError
        quotas, _rv = store.list(RESOURCEQUOTAS)
        matching = [q for q in quotas
                    if q.namespace == obj.namespace and q.hard]
        if not matching:
            return obj
        usage = pod_usage(obj)

        def charge(cur):
            over = [
                f"{name}: used {cur.used.get(name, 0)} + requested "
                f"{usage.get(name, 0)} > hard {cap}"
                for name, cap in cur.hard.items()
                if cur.used.get(name, 0) + usage.get(name, 0) > cap]
            if over:
                raise AdmissionError(
                    f"exceeded quota {cur.key}: " + "; ".join(over))
            used = dict(cur.used)
            for name in cur.hard:
                if usage.get(name):
                    used[name] = used.get(name, 0) + usage[name]
            cur.used = used
            return cur

        charged: list[str] = []
        try:
            for q in matching:
                store.guaranteed_update(RESOURCEQUOTAS, q.key, charge)
                charged.append(q.key)
        except AdmissionError:
            # a later quota rejected after earlier ones were charged: put
            # the earlier charges back before surfacing the rejection
            self._refund_keys(store, charged, usage)
            raise
        return obj

    def _refund_keys(self, store: Store, keys, usage) -> None:
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS, NotFoundError
        for key in keys:
            try:
                store.guaranteed_update(
                    RESOURCEQUOTAS, key,
                    lambda cur: _subtract_usage(cur, usage))
            except NotFoundError:
                pass

    def refund(self, kind: str, obj: Any, store: Store) -> None:
        """Undo admit()'s usage commit when the admitted write itself fails
        (AlreadyExists/Conflict): without this, every failed create leaks a
        permanent charge against the namespace quotas."""
        if kind != PODS:
            return
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS
        quotas, _rv = store.list(RESOURCEQUOTAS)
        keys = [q.key for q in quotas
                if q.namespace == obj.namespace and q.hard]
        if keys:
            self._refund_keys(store, keys, pod_usage(obj))

    def admit_update(self, kind: str, old: Any, new: Any, store: Store) -> Any:
        """The classic escape hatch this closes: create a conforming pod,
        PUT it oversized. Charges/refunds the usage DELTA via the same CAS
        (negative deltas replenish immediately; the controller reconciles
        any drift)."""
        if kind != PODS:
            return new
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS, NotFoundError
        quotas, _rv = store.list(RESOURCEQUOTAS)
        matching = [q for q in quotas
                    if q.namespace == new.namespace and q.hard]
        if not matching:
            return new
        old_u, new_u = pod_usage(old), pod_usage(new)
        delta = {k: new_u.get(k, 0) - old_u.get(k, 0)
                 for k in set(old_u) | set(new_u)}
        if not any(delta.values()):
            return new

        def apply(cur):
            # only GROWING resources are checked (the reference rejects only
            # usage increases past hard): an already-over-cap namespace —
            # e.g. after an admin lowered the cap — must not block shrinking
            # or unrelated updates
            over = [
                f"{name}: used {cur.used.get(name, 0)} + delta "
                f"{delta.get(name, 0)} > hard {cap}"
                for name, cap in cur.hard.items()
                if delta.get(name, 0) > 0
                and cur.used.get(name, 0) + delta.get(name, 0) > cap]
            if over:
                raise AdmissionError(
                    f"exceeded quota {cur.key}: " + "; ".join(over))
            used = dict(cur.used)
            for name in cur.hard:
                if delta.get(name):
                    used[name] = max(0, used.get(name, 0) + delta[name])
            cur.used = used
            return cur

        charged: list[str] = []
        try:
            for q in matching:
                store.guaranteed_update(RESOURCEQUOTAS, q.key, apply)
                charged.append(q.key)
        except AdmissionError:
            for key in charged:
                try:
                    store.guaranteed_update(
                        RESOURCEQUOTAS, key,
                        lambda cur: _subtract_usage(cur, delta))
                except NotFoundError:
                    pass
            raise
        return new

    def refund_update(self, kind: str, old: Any, new: Any,
                      store: Store) -> None:
        """Inverse of admit_update's delta charge, for a PUT that failed to
        land (Conflict/NotFound)."""
        if kind != PODS:
            return
        from kubernetes_tpu_torch.store.store import RESOURCEQUOTAS, NotFoundError
        old_u, new_u = pod_usage(old), pod_usage(new)
        delta = {k: new_u.get(k, 0) - old_u.get(k, 0)
                 for k in set(old_u) | set(new_u)}
        if not any(delta.values()):
            return
        quotas, _rv = store.list(RESOURCEQUOTAS)
        for q in quotas:
            if q.namespace != new.namespace or not q.hard:
                continue
            try:
                store.guaranteed_update(
                    RESOURCEQUOTAS, q.key,
                    lambda cur: _subtract_usage(cur, delta))
            except NotFoundError:
                pass


class NodeRestriction:
    """plugin/pkg/admission/noderestriction/admission.go:46: a kubelet
    identity (`system:node:<name>`) may only update ITS OWN Node object and
    pods bound to its node. Identity arrives as the REST layer's
    `X-Remote-User` header (the reference's header authn front end); writes
    with no user (in-process controllers, admins) are unrestricted."""

    PREFIX = "system:node:"

    def _node_of(self, user: Optional[str]) -> Optional[str]:
        if user and user.startswith(self.PREFIX):
            return user[len(self.PREFIX):]
        return None

    def admit(self, kind: str, obj: Any, store: Store,
              user: Optional[str] = None) -> Any:
        from kubernetes_tpu_torch.store.store import NODES
        node = self._node_of(user)
        if node is None:
            return obj
        if kind == NODES and obj.name != node:
            raise AdmissionError(
                f"node {node!r} is not allowed to modify node {obj.name!r}")
        if kind == PODS and getattr(obj, "node_name", "") not in ("", node):
            raise AdmissionError(
                f"node {node!r} is not allowed to modify pods bound to "
                f"node {obj.node_name!r}")
        return obj

    def admit_update(self, kind: str, old: Any, new: Any, store: Store,
                     user: Optional[str] = None) -> Any:
        node = self._node_of(user)
        if node is not None and kind == PODS \
                and getattr(old, "node_name", "") not in ("", node):
            # the OLD binding counts too: a kubelet may not unbind/steal a
            # pod bound to another node by rewriting node_name in the body
            raise AdmissionError(
                f"node {node!r} is not allowed to modify pods bound to "
                f"node {old.node_name!r}")
        return self.admit(kind, new, store, user=user)

    def admit_binding(self, pod: Any, node_name: str, store: Store,
                      user: Optional[str] = None) -> None:
        # binding is the scheduler's verb: a node identity may not bind
        # (or steal) pods at all (admission.go:46 posture; kubelets report
        # status, they do not place workloads)
        node = self._node_of(user)
        if node is not None:
            raise AdmissionError(
                f"node {node!r} is not allowed to create pod bindings")

    def admit_delete(self, kind: str, obj: Any, store: Store,
                     user: Optional[str] = None) -> None:
        from kubernetes_tpu_torch.store.store import NODES
        node = self._node_of(user)
        if node is None:
            return
        if kind == PODS and getattr(obj, "node_name", "") != node:
            # ONLY pods bound to this node — an unbound pod is the
            # scheduler's, not any kubelet's, so a stolen node credential
            # can't drain the pending queue
            raise AdmissionError(
                f"node {node!r} is not allowed to delete pods bound to "
                f"node {obj.node_name or '<none>'!r}")
        if kind == NODES and obj.name != node:
            raise AdmissionError(
                f"node {node!r} is not allowed to delete node {obj.name!r}")


class PodTolerationRestriction:
    """plugin/pkg/admission/podtolerationrestriction: merge the namespace's
    default tolerations into the pod and reject tolerations outside the
    namespace whitelist (both from namespace annotations, as JSON lists of
    {key, operator, value, effect})."""

    DEFAULT_KEY = "scheduler.alpha.kubernetes.io/defaultTolerations"
    WHITELIST_KEY = "scheduler.alpha.kubernetes.io/tolerationsWhitelist"

    @staticmethod
    def _parse(raw: str):
        import json as _json
        from kubernetes_tpu_torch.api.types import Toleration
        out = []
        for d in _json.loads(raw):
            out.append(Toleration(
                key=d.get("key", ""), op=d.get("operator", "Equal"),
                value=d.get("value", ""), effect=d.get("effect", "")))
        return out

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        from kubernetes_tpu_torch.store.store import NAMESPACES, NotFoundError
        try:
            ns = store.get(NAMESPACES, obj.namespace)
        except NotFoundError:
            return obj
        if self.DEFAULT_KEY in ns.annotations:
            defaults = self._parse(ns.annotations[self.DEFAULT_KEY])
            have = set(obj.tolerations)
            extra = tuple(t for t in defaults if t not in have)
            if extra:
                obj.tolerations = obj.tolerations + extra
        if self.WHITELIST_KEY in ns.annotations:
            allowed = set(self._parse(ns.annotations[self.WHITELIST_KEY]))
            bad = [t for t in obj.tolerations if t not in allowed]
            if bad:
                raise AdmissionError(
                    f"pod tolerations (possibly merged) conflict with "
                    f"namespace whitelist of {obj.namespace}")
        return obj

    def admit_update(self, kind: str, old: Any, new: Any, store: Store) -> Any:
        # the reference registers for Create AND Update — a PUT must not
        # smuggle in tolerations the namespace forbids. The cluster NoExecute
        # defaults (DefaultTolerationSeconds) were added on create and sit in
        # `new` already; whitelist them implicitly by judging only the diff
        # against old's accepted set when a whitelist exists.
        if kind != PODS:
            return new
        from kubernetes_tpu_torch.store.store import NAMESPACES, NotFoundError
        try:
            ns = store.get(NAMESPACES, new.namespace)
        except NotFoundError:
            return new
        if self.WHITELIST_KEY in ns.annotations:
            allowed = set(self._parse(ns.annotations[self.WHITELIST_KEY]))
            allowed |= set(old.tolerations)
            bad = [t for t in new.tolerations if t not in allowed]
            if bad:
                raise AdmissionError(
                    f"pod tolerations conflict with namespace whitelist "
                    f"of {new.namespace}")
        return new


class AntiAffinityAdmission:
    """plugin/pkg/admission/antiaffinity (LimitPodHardAntiAffinityTopology):
    required pod anti-affinity with a topology key other than the hostname
    label is rejected — cluster-wide anti-affinity is an abuse vector."""

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        if kind != PODS:
            return obj
        from kubernetes_tpu_torch.api.types import LABEL_HOSTNAME
        a = getattr(obj, "affinity", None)
        paa = a.pod_anti_affinity if a is not None else None
        for term in (paa.required if paa else ()):
            if term.topology_key != LABEL_HOSTNAME:
                raise AdmissionError(
                    "affinity.podAntiAffinity.requiredDuringScheduling... "
                    f"topologyKey {term.topology_key!r} is not allowed "
                    f"(only {LABEL_HOSTNAME})")
        return obj

    def admit_update(self, kind: str, old: Any, new: Any, store: Store) -> Any:
        return self.admit(kind, new, store)


class ServiceAccountAdmission:
    """plugin/pkg/admission/serviceaccount/admission.go: default every pod
    to the namespace's 'default' ServiceAccount and reject pods naming an
    account that doesn't exist (the reference also mounts token volumes —
    no volume dataplane exists in this model, so the identity half is the
    faithful subset)."""

    def admit(self, kind: str, obj: Any, store: Store,
              user: Optional[str] = None) -> Any:
        from kubernetes_tpu_torch.store.store import SERVICEACCOUNTS, NotFoundError
        if kind != PODS:
            return obj
        if not obj.service_account_name:
            obj.service_account_name = "default"
        try:
            store.get(SERVICEACCOUNTS,
                      f"{obj.namespace}/{obj.service_account_name}")
        except NotFoundError:
            # the reference retries for a short window to ride out the SA
            # controller's default creation; our controller creates
            # 'default' on namespace sight, so only a truly missing named
            # account rejects (and a missing 'default' in a namespace the
            # controller never saw admits — matching the reference's
            # bootstrapping tolerance for the default account)
            if obj.service_account_name != "default":
                raise AdmissionError(
                    f"service account {obj.namespace}/"
                    f"{obj.service_account_name} does not exist")
        return obj

    def admit_update(self, kind: str, old: Any, new: Any, store: Store,
                     user: Optional[str] = None) -> Any:
        # a PUT must not smuggle in a nonexistent account (the chain runs
        # admission on every write verb)
        return self.admit(kind, new, store, user=user)


class EventRateLimit:
    """plugin/pkg/admission/eventratelimit: a token bucket over event
    creates (server scope) so an event storm cannot swamp the store."""

    def __init__(self, qps: float = 50.0, burst: int = 100, clock=None):
        import threading
        import time as _time
        self.qps = qps
        self.burst = burst
        self._tokens = float(burst)
        self._last = None
        self._now = clock or _time.monotonic
        # the chain runs inside ThreadingHTTPServer request threads; the
        # read-modify-write of the bucket must not race
        self._lock = threading.Lock()

    def admit(self, kind: str, obj: Any, store: Store) -> Any:
        from kubernetes_tpu_torch.store.store import EVENTS
        if kind != EVENTS:
            return obj
        with self._lock:
            now = self._now()
            if self._last is not None:
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens < 1.0:
                raise AdmissionError(
                    "event rate limited (server bucket empty)")
            self._tokens -= 1.0
        return obj


class AdmissionChain:
    def __init__(self, plugins: Optional[list] = None):
        # ResourceQuotaAdmission runs LAST: its admit commits quota usage,
        # and only a failure of the store write itself (handled by the
        # caller via refund()) — not a later plugin's rejection — may
        # follow a successful charge
        # PodTolerationRestriction precedes DefaultTolerationSeconds (as in
        # the reference's recommended order) so namespace whitelists judge
        # the POD'S tolerations, not the cluster-injected NoExecute defaults
        self.plugins = plugins if plugins is not None else [
            NodeRestriction(), PriorityAdmission(),
            ServiceAccountAdmission(), PodTolerationRestriction(),
            AntiAffinityAdmission(), EventRateLimit(),
            DefaultTolerationSeconds(), LimitRanger(),
            ResourceQuotaAdmission()]

    def admit(self, kind: str, obj: Any, store: Store,
              user: Optional[str] = None) -> Any:
        for p in self.plugins:
            if user is not None and isinstance(p, NodeRestriction):
                obj = p.admit(kind, obj, store, user=user)
            else:
                obj = p.admit(kind, obj, store)
        return obj

    def register_webhooks(self, webhook_admission) -> None:
        """Insert a WebhookAdmission BEFORE ResourceQuotaAdmission: quota
        must stay last (its admit commits usage, and only a store-write
        failure — refunded by the caller — may follow a successful
        charge; a webhook denial after the charge would leak it). The
        reference's recommended order also runs the admission webhooks
        before ResourceQuota."""
        for i, p in enumerate(self.plugins):
            if isinstance(p, ResourceQuotaAdmission):
                self.plugins.insert(i, webhook_admission)
                return
        self.plugins.append(webhook_admission)

    def admit_binding(self, pod: Any, node_name: str, store: Store,
                      user: Optional[str] = None) -> None:
        """Admission for the pods/binding subresource (the scheduler's
        write verb, factory.go:710): plugins exposing admit_binding judge
        (current pod, target node, identity) — NodeRestriction uses it to
        keep node identities from binding/stealing pods."""
        for p in self.plugins:
            ab = getattr(p, "admit_binding", None)
            if ab is not None:
                ab(pod, node_name, store, user=user)

    def admit_delete(self, kind: str, obj: Any, store: Store,
                     user: Optional[str] = None) -> None:
        """Admission for deletes: plugins exposing admit_delete judge the
        object about to go away (NodeRestriction: a kubelet may evict only
        pods bound to its own node, delete only its own Node)."""
        for p in self.plugins:
            ad = getattr(p, "admit_delete", None)
            if ad is not None:
                ad(kind, obj, store, user=user)

    def admit_update(self, kind: str, old: Any, new: Any, store: Store,
                     user: Optional[str] = None) -> Any:
        """The UPDATE half of the chain (the reference runs admission on
        every write verb): plugins exposing admit_update participate; pure
        create-defaulting plugins are skipped."""
        for p in self.plugins:
            au = getattr(p, "admit_update", None)
            if au is None:
                continue
            if isinstance(p, NodeRestriction):
                new = au(kind, old, new, store, user=user)
            else:
                new = au(kind, old, new, store)
        return new

    def refund(self, kind: str, obj: Any, store: Store) -> None:
        """Roll back side-effecting admissions (quota usage commits) after
        the admitted write failed to land (AlreadyExists/Conflict). Callers
        that admit-then-create MUST call this on create failure."""
        for p in self.plugins:
            r = getattr(p, "refund", None)
            if r is not None:
                r(kind, obj, store)

    def refund_update(self, kind: str, old: Any, new: Any,
                      store: Store) -> None:
        """Roll back admit_update side effects (quota delta charges) after
        the admitted PUT failed to land (Conflict/NotFound)."""
        for p in self.plugins:
            r = getattr(p, "refund_update", None)
            if r is not None:
                r(kind, old, new, store)
