"""ClusterRole aggregation controller —
pkg/controller/clusterroleaggregation/clusterroleaggregation_controller.go.

A ClusterRole with an aggregationRule owns no rules of its own: this loop
unions the rules of every ClusterRole whose labels match the rule's
selectors and writes them into the aggregated role (admin/edit/view are
built this way in the reference). Any role change re-evaluates every
aggregating role.

The port's copy of the reference's
`controllers/clusterrole_aggregation.py` with the port's imports.
"""
from __future__ import annotations

from kubernetes_tpu_torch.apiserver.auth import Role
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.store import Store, CLUSTERROLES, NotFoundError


def _matches(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class ClusterRoleAggregationController(DirtyKeyController):
    KIND = CLUSTERROLES

    def _register_extra_handlers(self) -> None:
        # ANY role event (including deletes and label REMOVALS, which the
        # new-labels-only match would miss) re-evaluates every aggregating
        # role — revocation must propagate, not just grants
        mark_aggregating = lambda *_: self._dirty.update(
            r.key for r in self.informers.informer(CLUSTERROLES).list()
            if r.aggregation_labels)
        self.informers.informer(CLUSTERROLES).add_event_handler(
            on_add=mark_aggregating,
            on_update=lambda o, n: mark_aggregating(),
            on_delete=mark_aggregating)

    def reconcile(self, role: Role) -> None:
        if not role.aggregation_labels:
            return   # sources are handled via the event fan-out above
        union: list = []
        seen = set()
        for other in sorted(self.informers.informer(CLUSTERROLES).list(),
                            key=lambda r: r.name):
            if other.name == role.name or other.aggregation_labels:
                continue
            if not _matches(role.aggregation_labels, other.labels):
                continue
            for rule in other.rules:
                if rule not in seen:
                    seen.add(rule)
                    union.append(rule)
        want = tuple(union)
        if want == role.rules:
            return

        def mutate(cur):
            if cur.rules == want:
                return None
            cur.rules = want
            return cur
        try:
            self.store.guaranteed_update(CLUSTERROLES, role.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
