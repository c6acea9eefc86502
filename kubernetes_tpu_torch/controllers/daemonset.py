"""DaemonSet controller — pkg/controller/daemon/daemon_controller.go:81.

One pod per eligible node. In this reference snapshot the DS controller
schedules its own pods — it sets nodeName directly instead of leaving pods
Pending for the scheduler (ScheduleDaemonSetPods was still feature-gated
off by default) — mirrored here: eligibility is the template's node
selector plus NoSchedule/NoExecute taint toleration against the node
(daemon_controller.go nodeShouldRunDaemonPod), and placement bypasses the
scheduling queue entirely.

The port's copy of the reference's `controllers/daemonset.py` with the
port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import (
    DaemonSet, Node, Pod, find_intolerable_taint, NO_SCHEDULE, NO_EXECUTE,
)
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, NODES, DAEMONSETS, AlreadyExistsError, NotFoundError,
)


class DaemonSetController(DirtyKeyController):
    KIND = DAEMONSETS

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
        nodes = self.informers.informer(NODES)
        # eligibility reads labels + taints only; other node churn
        # (heartbeats, conditions) must not trigger full reconciles
        nodes.add_event_handler(
            on_add=self._node_changed,
            on_update=lambda o, n: ((o.labels != n.labels
                                     or o.taints != n.taints)
                                    and self._node_changed(n)),
            on_delete=self._node_changed)

    def _pod_changed(self, pod: Pod) -> None:
        if pod.owner_ref is not None and pod.owner_ref[0] == "DaemonSet":
            self._dirty.add(f"{pod.namespace}/{pod.owner_ref[1]}")

    def _node_changed(self, _node: Node) -> None:
        for d in self.informers.informer(DAEMONSETS).list():
            self._dirty.add(d.key)

    # -- nodeShouldRunDaemonPod ----------------------------------------------
    def _eligible(self, ds: DaemonSet, node: Node) -> bool:
        tmpl = ds.template
        if tmpl is not None and tmpl.node_selector:
            if any(node.labels.get(k) != v
                   for k, v in tmpl.node_selector.items()):
                return False
        tols = tmpl.tolerations if tmpl is not None else ()
        bad = find_intolerable_taint(
            node.taints, tols,
            lambda t: t.effect in (NO_SCHEDULE, NO_EXECUTE))
        return bad is None

    def reconcile(self, ds: DaemonSet) -> None:
        nodes, _rv = self.store.list(NODES)
        pods, _rv = self.store.list(PODS)
        mine = [p for p in pods
                if p.namespace == ds.namespace and not p.deleted
                and p.owner_ref is not None
                and p.owner_ref[:2] == ("DaemonSet", ds.name)]
        by_node: dict[str, list[Pod]] = {}
        for p in mine:
            by_node.setdefault(p.node_name, []).append(p)
        eligible = {n.name for n in nodes if self._eligible(ds, n)}

        from kubernetes_tpu_torch.apiserver.admission import AdmissionError
        for name in sorted(eligible):
            have = by_node.get(name, [])
            if not have:
                # the DS controller schedules: nodeName set at create
                from kubernetes_tpu_torch.api.types import PodTemplate
                tmpl = ds.template or PodTemplate()
                pod = tmpl.make_pod(
                    f"{ds.name}-{name}", ds.namespace,
                    owner_ref=("DaemonSet", ds.name, f"ds-{ds.name}"),
                    node_name=name)
                admitted = None
                try:
                    pod = admitted = self.admission.admit(PODS, pod, self.store)
                    self.store.create(PODS, pod)
                except AlreadyExistsError:
                    self.admission.refund(PODS, admitted, self.store)
                except AdmissionError as e:
                    self.recorder.event(
                        "DaemonSet", ds.key, "Warning", "FailedCreate",
                        f"Error creating: {e}")
                    break
            elif len(have) > 1:
                # duplicate daemons on one node: keep the oldest
                for p in sorted(have, key=lambda p: p.creation_timestamp)[1:]:
                    try:
                        self.store.delete(PODS, p.key)
                    except NotFoundError:
                        pass
        # pods on nodes that are gone or no longer eligible are evicted
        for name, have in by_node.items():
            if name not in eligible:
                for p in have:
                    try:
                        self.store.delete(PODS, p.key)
                        self.recorder.event(
                            "DaemonSet", ds.key, NORMAL, "SuccessfulDelete",
                            f"Deleted pod {p.name} (node ineligible)")
                    except NotFoundError:
                        pass
        self._update_status(ds, len(eligible))

    def _update_status(self, ds: DaemonSet, desired: int) -> None:
        pods, _rv = self.store.list(PODS)
        mine = [p for p in pods
                if p.namespace == ds.namespace and not p.deleted
                and p.owner_ref is not None
                and p.owner_ref[:2] == ("DaemonSet", ds.name)]
        current = len({p.node_name for p in mine if p.node_name})
        ready = sum(1 for p in mine if p.phase == "Running")

        def mutate(cur):
            if (cur.desired_number_scheduled == desired
                    and cur.current_number_scheduled == current
                    and cur.number_ready == ready):
                return None
            cur.desired_number_scheduled = desired
            cur.current_number_scheduled = current
            cur.number_ready = ready
            return cur
        try:
            self.store.guaranteed_update(DAEMONSETS, ds.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
