"""Host priority helpers the encoder reaches, copied from the oracle
(reference: pkg/scheduler/algorithm/priorities)."""
from __future__ import annotations

from kubernetes_tpu_torch.api.types import Pod, ReplicaSet, Service


def get_selectors(pod: Pod, services: list[Service],
                  replicasets: list[ReplicaSet]) -> list:
    """Selectors of services / RC / RS / STS that select this pod
    (reference: selector_spreading.go getSelectors)."""
    selectors = []
    for svc in services:
        if svc.namespace != pod.namespace or not svc.selector:
            continue
        if all(pod.labels.get(k) == v for k, v in svc.selector.items()):
            selectors.append(dict(svc.selector))
    for rs in replicasets:
        if rs.namespace != pod.namespace or rs.selector is None:
            continue
        if rs.selector.matches(pod.labels):
            selectors.append(rs.selector)
    return selectors
