"""Cluster bootstrap — the kubeadm analog.

`kubeadm init` assembles a control plane from static manifests
(cmd/kubeadm); this assembles the in-process equivalent over one store and
runs it: REST apiserver (+admission), the device scheduler loop, the
controller manager (disruption / node-lifecycle / podgc / replicaset), and
a fleet of hollow kubelets heartbeating leases, node readiness, and pod
lifecycle (the kubemark cluster of test/kubemark/). The result is a
cluster-in-a-process that kubectl can drive end to end:

    python -m kubernetes_tpu_torch.cmd.cluster --nodes 100 --api-port 8001
    python -m kubernetes_tpu_torch.cmd.kubectl -s http://127.0.0.1:8001 \
        create -f rs.json
    python -m kubernetes_tpu_torch.cmd.kubectl -s http://127.0.0.1:8001 \
        get pods

Also usable in-process (tests, harnesses) via `Cluster`.

The port's copy of the reference's `cmd/cluster.py` with the port's
imports. The reference's `use_tpu` is `use_device` plus `device` here:
the scheduler decides on a TorchScheduler on `device` (`cuda` unless the
caller asks for `cpu`, the kernels' plain versions), or on the port's
copy of the oracle when `use_device` is false (`--no-device`).
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.controllers.manager import ControllerManager
from kubernetes_tpu_torch.models.hollow import (
    NodeStrategy, make_hollow_nodes, HollowKubelet,
)
from kubernetes_tpu_torch.store.store import Store, NODES, PODS
from kubernetes_tpu_torch.scheduler import Scheduler


class Cluster:
    """All control-plane components over one store."""

    def __init__(self, n_nodes: int = 10, zones: int = 3,
                 api_port: int = 0, use_device: bool = True,
                 device: str = "cuda", kubelet_interval: float = 1.0):
        self.store = Store(watch_log_size=max(1 << 16, 8 * n_nodes))
        for node in make_hollow_nodes(NodeStrategy(count=n_nodes,
                                                   zones=zones)):
            self.store.create(NODES, node)
        self.api = APIServer(self.store, port=api_port) if api_port >= 0 \
            else None
        self.scheduler = Scheduler(self.store, use_device=use_device,
                                   device=device,
                                   percentage_of_nodes_to_score=100)
        self.controllers = ControllerManager(self.store)
        self.kubelets = [HollowKubelet(self.store, node.name)
                         for node in self.store.list(NODES)[0]]
        # one virtual proxier per node (kube-proxy at kubemark fidelity:
        # HollowProxy) — endpoints propagate into per-node forwarding tables
        from kubernetes_tpu_torch.proxy.proxier import VirtualProxier
        self.proxies = [VirtualProxier(self.store, node.name)
                        for node in self.store.list(NODES)[0]]
        self.kubelet_interval = kubelet_interval
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Cluster":
        if self.api is not None:
            self.api.start()
        self.scheduler.sync()
        self.controllers.sync()
        for p in self.proxies:
            p.sync()
        self.kubelet_tick()

        def sched_loop():
            while not self._stop.is_set():
                self.scheduler.pump()
                if not self.scheduler.schedule_burst(max_pods=1024):
                    self._stop.wait(0.02)

        def controller_loop():
            while not self._stop.is_set():
                self.controllers.pump()
                self._stop.wait(0.05)

        def kubelet_loop():
            while not self._stop.is_set():
                self.kubelet_tick()
                self._stop.wait(self.kubelet_interval)

        def proxy_loop():
            while not self._stop.is_set():
                for p in self.proxies:
                    p.pump()
                self._stop.wait(0.05)

        for fn in (sched_loop, controller_loop, kubelet_loop, proxy_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def kubelet_tick(self) -> None:
        # one list serves the whole fleet (see HollowKubelet.heartbeat)
        pods, _rv = self.store.list(PODS)
        by_node: dict[str, list] = {}
        for p in pods:
            if p.node_name:
                by_node.setdefault(p.node_name, []).append(p)
        for k in self.kubelets:
            k.heartbeat(pods=by_node.get(k.node_name, ()))

    def stop(self) -> None:
        self._stop.set()
        self.scheduler.stop()
        for t in self._threads:
            t.join(2.0)
        if self.api is not None:
            self.api.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- conveniences --------------------------------------------------------
    @property
    def url(self) -> Optional[str]:
        return self.api.url if self.api is not None else None

    def wait_for(self, predicate, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(0.05)
        return False


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="kubeadm-torch",
                                 description="cluster-in-a-process bootstrap")
    ap.add_argument("--nodes", type=int, default=10)
    ap.add_argument("--zones", type=int, default=3)
    ap.add_argument("--api-port", type=int, default=8001)
    ap.add_argument("--device", default="cuda",
                    help="where the scheduler decides: cuda (the kernels) "
                         "or cpu (their plain versions)")
    ap.add_argument("--no-device", action="store_true",
                    help="decide on the oracle copies instead")
    args = ap.parse_args(argv)
    cluster = Cluster(n_nodes=args.nodes, zones=args.zones,
                      api_port=args.api_port, use_device=not args.no_device,
                      device=args.device)
    cluster.start()
    print(f"control plane up: {cluster.url} "
          f"({args.nodes} hollow nodes, scheduler + controllers + kubelets)")
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        cluster.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
