"""kube-proxy analog — a per-node virtual service dataplane.

The reference's iptables proxier (pkg/proxy/iptables/proxier.go) runs on
every node, watches Services + Endpoints, and on each sync REBUILDS the
kernel rule set: one service chain per service, one endpoint chain per
backend, traffic spread across backends. kubemark's HollowProxy runs the
same loop against a fake iptables.

This VirtualProxier is that loop at kubemark fidelity: informer-driven
full resyncs (syncProxyRules rebuilds everything each pass, exactly like
the reference) materializing a per-node FORWARDING TABLE
{service key -> tuple of (pod_key, node_name) backends}, plus `route()`,
the userspace-proxy-style round-robin backend pick standing in for the
iptables statistic-random chain. The pruned model has no pod IPs; the
(pod_key, node) pair is the routable identity, matching the Endpoints
encoding (api/types.py Endpoints).

The port's copy of the reference's `proxy/proxier.py` with the port's
imports.
"""
from __future__ import annotations

import threading
from typing import Optional

from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.store.store import Store, SERVICES, ENDPOINTS


class VirtualProxier:
    def __init__(self, store: Store, node_name: str):
        self.store = store
        self.node_name = node_name
        self.informers = InformerFactory(store)
        self._lock = threading.Lock()
        self._rules: dict[str, tuple[tuple[str, str], ...]] = {}
        self._rr: dict[str, int] = {}          # per-service round-robin cursor
        self.sync_count = 0
        self._pending = True
        # any Service/Endpoints event schedules a full resync — the
        # reference coalesces bursts the same way (async runner); rules are
        # rebuilt from the informer caches, never patched incrementally
        mark = lambda *_: setattr(self, "_pending", True)
        for kind in (SERVICES, ENDPOINTS):
            self.informers.informer(kind).add_event_handler(
                on_add=mark, on_update=mark, on_delete=mark)

    # -- lifecycle -----------------------------------------------------------
    def sync(self) -> None:
        self.informers.sync_all()
        self._sync_rules()

    def pump(self) -> int:
        n = self.informers.pump_all()
        if self._pending:
            self._sync_rules()
        return n

    def _sync_rules(self) -> None:
        """syncProxyRules: rebuild the whole table from the caches."""
        eps = {e.key: e for e in self.informers.informer(ENDPOINTS).list()}
        rules: dict[str, tuple[tuple[str, str], ...]] = {}
        for svc in self.informers.informer(SERVICES).list():
            e = eps.get(svc.key)
            rules[svc.key] = tuple(e.addresses) if e is not None else ()
        with self._lock:
            self._rules = rules
            self._rr = {k: v for k, v in self._rr.items() if k in rules}
        self.sync_count += 1
        self._pending = False

    # -- the dataplane surface ----------------------------------------------
    def backends(self, service_key: str) -> tuple[tuple[str, str], ...]:
        with self._lock:
            return self._rules.get(service_key, ())

    def rules(self) -> dict[str, tuple[tuple[str, str], ...]]:
        with self._lock:
            return dict(self._rules)

    def route(self, service_key: str) -> Optional[tuple[str, str]]:
        """One virtual connection: pick the next backend round-robin (the
        deterministic stand-in for the iptables statistic-random chain;
        the userspace proxier's LoadBalancerRR works exactly so). None =
        no endpoints (the reference REJECTs such traffic)."""
        with self._lock:
            backends = self._rules.get(service_key, ())
            if not backends:
                return None
            i = self._rr.get(service_key, 0)
            self._rr[service_key] = i + 1
            return backends[i % len(backends)]
