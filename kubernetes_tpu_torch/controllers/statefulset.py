"""StatefulSet controller — pkg/controller/statefulset/stateful_set.go.

Stable ordinal identities: pods are named `{set}-0` .. `{set}-{N-1}` and
reconciled IN ORDER. OrderedReady (the default) creates ordinal i only when
every lower ordinal exists and is Running, and scales down from the highest
ordinal one at a time; Parallel creates/deletes without waiting
(reference: pkg/apis/apps/types.go PodManagementPolicyType).

The port's copy of the reference's `controllers/statefulset.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Pod, StatefulSet
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, STATEFULSETS, AlreadyExistsError, NotFoundError,
)


class StatefulSetController(DirtyKeyController):
    KIND = STATEFULSETS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        from kubernetes_tpu_torch.apiserver.admission import AdmissionChain
        self.admission = AdmissionChain()
        self.recorder = EventRecorder(store, component="controllermanager")

    def _register_extra_handlers(self) -> None:
        pods = self.informers.informer(PODS)
        pods.add_event_handler(on_add=self._pod_changed,
                               on_update=lambda o, n: self._pod_changed(n),
                               on_delete=self._pod_changed)

    def _pod_changed(self, pod: Pod) -> None:
        if pod.owner_ref is not None and pod.owner_ref[0] == "StatefulSet":
            self._dirty.add(f"{pod.namespace}/{pod.owner_ref[1]}")

    # -- syncStatefulSet -----------------------------------------------------
    def _ordinal_pods(self, sts: StatefulSet) -> dict[int, Pod]:
        pods, _rv = self.store.list(PODS)
        out: dict[int, Pod] = {}
        prefix = f"{sts.name}-"
        for p in pods:
            if p.namespace != sts.namespace or p.deleted:
                continue
            if p.owner_ref is None \
                    or p.owner_ref[:2] != ("StatefulSet", sts.name):
                continue
            tail = p.name[len(prefix):] if p.name.startswith(prefix) else ""
            if tail.isdigit():
                out[int(tail)] = p
        return out

    def reconcile(self, sts: StatefulSet) -> None:
        have = self._ordinal_pods(sts)
        ordered = sts.pod_management_policy != "Parallel"
        from kubernetes_tpu_torch.apiserver.admission import AdmissionError
        from kubernetes_tpu_torch.api.types import PodTemplate
        tmpl = sts.template or PodTemplate()
        # scale up: ordinals 0..replicas-1, each gated on its predecessor
        # being Running under OrderedReady
        for i in range(sts.replicas):
            if i in have:
                if ordered and have[i].phase != "Running":
                    break   # wait for this ordinal before touching later ones
                continue
            pod = tmpl.make_pod(
                f"{sts.name}-{i}", sts.namespace,
                owner_ref=("StatefulSet", sts.name, f"sts-{sts.name}"),
                extra_labels={"statefulset.kubernetes.io/pod-name":
                              f"{sts.name}-{i}"})
            admitted = None
            try:
                pod = admitted = self.admission.admit(PODS, pod, self.store)
                self.store.create(PODS, pod)
                self.recorder.event(
                    "StatefulSet", sts.key, NORMAL, "SuccessfulCreate",
                    f"create Pod {pod.name} in StatefulSet {sts.name} "
                    "successful")
            except AlreadyExistsError:
                self.admission.refund(PODS, admitted, self.store)
            except AdmissionError as e:
                self.recorder.event(
                    "StatefulSet", sts.key, "Warning", "FailedCreate",
                    f"Error creating: {e}")
                break
            if ordered:
                break   # one ordinal per pass; wait for it to come up
        # scale down: highest ordinal first, one at a time under OrderedReady
        over = sorted((i for i in have if i >= sts.replicas), reverse=True)
        for i in over:
            try:
                self.store.delete(PODS, have[i].key)
                self.recorder.event(
                    "StatefulSet", sts.key, NORMAL, "SuccessfulDelete",
                    f"delete Pod {have[i].name} in StatefulSet {sts.name} "
                    "successful")
            except NotFoundError:
                pass
            if ordered:
                break
        self._update_status(sts)

    def _update_status(self, sts: StatefulSet) -> None:
        have = self._ordinal_pods(sts)
        current = len(have)
        ready = sum(1 for p in have.values() if p.phase == "Running")

        def mutate(cur):
            if cur.current_replicas == current and cur.ready_replicas == ready:
                return None
            cur.current_replicas = current
            cur.ready_replicas = ready
            return cur
        try:
            self.store.guaranteed_update(STATEFULSETS, sts.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
