"""Controller manager — the kube-controller-manager shell.

Mirror of cmd/kube-controller-manager/app/controllermanager.go:372
(NewControllerInitializers + StartControllers): owns controller instances
over one store, syncs their informers, and drives reconciliation. The
reference runs 31 loops; this hosts the ones implemented so far and is the
registration point for the rest.

The port's copy of the reference's `controllers/manager.py` with the
port's imports.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.store.store import Store
from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.podgc import PodGCController
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.replicaset import ReplicaSetController
from kubernetes_tpu_torch.controllers.resourcequota import ResourceQuotaController
from kubernetes_tpu_torch.controllers.deployment import DeploymentController
from kubernetes_tpu_torch.controllers.job import JobController
from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
from kubernetes_tpu_torch.controllers.statefulset import StatefulSetController
from kubernetes_tpu_torch.controllers.namespace import (
    NamespaceController, ServiceAccountController,
)
from kubernetes_tpu_torch.controllers.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.controllers.hpa import HorizontalPodAutoscalerController
from kubernetes_tpu_torch.controllers.cronjob import CronJobController
from kubernetes_tpu_torch.controllers.podgroup import PodGroupController
from kubernetes_tpu_torch.controllers.ttl import TTLController
from kubernetes_tpu_torch.controllers.pvbinder import PersistentVolumeBinder
from kubernetes_tpu_torch.controllers.nodeipam import NodeIpamController
from kubernetes_tpu_torch.controllers.clusterrole_aggregation import (
    ClusterRoleAggregationController,
)

# name -> constructor(store) (NewControllerInitializers analog,
# controllermanager.go:372-412). Ordering matters for single-threaded
# pump() convergence: deployment before replicaset (rollout scales feed the
# RS reconcile in the same pass), garbagecollector last (owners deleted by
# earlier loops cascade in the same pump).
CONTROLLER_INITIALIZERS: dict[str, Callable[[Store], object]] = {
    "disruption": DisruptionController,
    "podgroup": PodGroupController,
    "nodelifecycle": NodeLifecycleController,
    "podgc": PodGCController,
    "ttl": TTLController,
    "nodeipam": NodeIpamController,
    "clusterrole-aggregation": ClusterRoleAggregationController,
    "persistentvolume-binder": PersistentVolumeBinder,
    "horizontalpodautoscaling": HorizontalPodAutoscalerController,
    "cronjob": CronJobController,
    "deployment": DeploymentController,
    "replicaset": ReplicaSetController,
    "job": JobController,
    "daemonset": DaemonSetController,
    "statefulset": StatefulSetController,
    "endpoint": EndpointsController,
    "resourcequota": ResourceQuotaController,
    "namespace": NamespaceController,
    "serviceaccount": ServiceAccountController,
    "garbagecollector": GarbageCollector,
}


class ControllerManager:
    def __init__(self, store: Store,
                 enabled: Optional[list[str]] = None):
        names = list(CONTROLLER_INITIALIZERS) if enabled is None else enabled
        self.controllers = {
            name: CONTROLLER_INITIALIZERS[name](store) for name in names}
        self._stop = threading.Event()

    def sync(self) -> None:
        for c in self.controllers.values():
            c.sync()

    def pump(self) -> int:
        return sum(c.pump() for c in self.controllers.values())

    def run(self, interval: float = 0.05,
            stop_after: Optional[Callable[[], bool]] = None) -> None:
        """Reconcile loop; call from a thread."""
        while not self._stop.is_set():
            self.pump()
            if stop_after is not None and stop_after():
                return
            self._stop.wait(interval)

    def stop(self) -> None:
        self._stop.set()
