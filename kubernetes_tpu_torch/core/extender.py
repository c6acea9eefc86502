"""Scheduler extender — the out-of-process filter/score/bind webhook: the
port's copy of the reference's `core/extender.py` with the port's
imports.

Mirrors pkg/scheduler/core/extender.go (HTTPExtender :86, Filter :258,
Prioritize :318, Bind :360, ProcessPreemption :135) over this framework's
transport: an in-process callable endpoint (the common test/bench form) or
a real HTTP JSON endpoint, selected by the config's url_prefix.
"""
from __future__ import annotations

import json
import urllib.request
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Pod, Node
from kubernetes_tpu_torch.apis.policy import ExtenderConfig


class ExtenderError(Exception):
    pass


class SchedulerExtender:
    """One configured extender. For callable transport, pass `endpoints`:
    {"filter": fn(args_dict)->result_dict, "prioritize": ..., "bind": ...,
    "preempt": ...} — the same JSON-shaped dicts the HTTP form sends."""

    def __init__(self, config: ExtenderConfig,
                 endpoints: Optional[dict[str, Callable]] = None):
        self.config = config
        self.endpoints = endpoints or {}

    @property
    def weight(self) -> int:
        return self.config.weight

    def is_interested(self, pod: Pod) -> bool:
        """extender.go IsInterested: an extender with managed_resources only
        handles pods requesting at least one of them; otherwise all pods."""
        managed = self.config.managed_resources
        if not managed:
            return True
        for c in list(pod.containers) + list(pod.init_containers):
            for name, _q in c.requests:
                if name in managed:
                    return True
        return False

    @property
    def is_ignorable(self) -> bool:
        """Ignorable extenders don't fail scheduling when unreachable
        (extender.go IsIgnorable)."""
        return self.config.ignorable

    def _call(self, verb: str, payload: dict) -> dict:
        if verb in self.endpoints:
            return self.endpoints[verb](payload)
        url = f"{self.config.url_prefix.rstrip('/')}/{verb}"
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read())

    # -- Filter (extender.go:258) --------------------------------------------
    def filter(self, pod: Pod, nodes: list[Node]
               ) -> tuple[list[Node], dict[str, list[str]]]:
        if not self.config.filter_verb or not self.is_interested(pod):
            return nodes, {}
        payload = {
            "pod": pod.key,
            "nodes": [n.name for n in nodes],
        }
        try:
            result = self._call(self.config.filter_verb, payload)
        except Exception as e:
            if self.is_ignorable:
                return nodes, {}
            raise ExtenderError(f"extender filter failed: {e}") from e
        if result.get("error"):
            raise ExtenderError(result["error"])
        keep = set(result.get("nodeNames", [n.name for n in nodes]))
        failed = {name: [reason] for name, reason in
                  (result.get("failedNodes") or {}).items()}
        return [n for n in nodes if n.name in keep], failed

    # -- Prioritize (extender.go:318) ------------------------------------------
    def prioritize(self, pod: Pod, nodes: list[Node]
                   ) -> tuple[dict[str, int], int]:
        """Returns ({host: score}, weight); scores are the extender's own
        0-10 range, weighted by the caller."""
        if not self.config.prioritize_verb or not self.is_interested(pod):
            return {n.name: 0 for n in nodes}, 0
        payload = {"pod": pod.key, "nodes": [n.name for n in nodes]}
        try:
            result = self._call(self.config.prioritize_verb, payload)
        except Exception as e:
            if self.is_ignorable:
                return {n.name: 0 for n in nodes}, 0
            raise ExtenderError(f"extender prioritize failed: {e}") from e
        scores = {h["host"]: int(h["score"]) for h in result.get("hostPriorityList", [])}
        return scores, self.config.weight

    # -- Bind (extender.go:360) -------------------------------------------------
    @property
    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)

    def bind(self, pod: Pod, node_name: str) -> None:
        result = self._call(self.config.bind_verb,
                            {"pod": pod.key, "node": node_name})
        if result.get("error"):
            raise ExtenderError(result["error"])

    # -- ProcessPreemption (extender.go:135) -------------------------------------
    def process_preemption(self, pod: Pod,
                           nodes_to_victims: dict[str, list[Pod]]
                           ) -> dict[str, list[Pod]]:
        """Lets the extender veto/trim preemption candidates. Payload carries
        victim pod keys per node; the response echoes the surviving map."""
        if not self.config.preempt_verb:
            return nodes_to_victims
        payload = {
            "pod": pod.key,
            "nodeNameToVictims": {n: [p.key for p in v]
                                  for n, v in nodes_to_victims.items()},
        }
        try:
            result = self._call(self.config.preempt_verb, payload)
        except Exception as e:
            if self.is_ignorable:
                return nodes_to_victims
            raise ExtenderError(f"extender preempt failed: {e}") from e
        surviving = result.get("nodeNameToVictims")
        if surviving is None:
            return nodes_to_victims
        out = {}
        for name, victim_keys in surviving.items():
            if name not in nodes_to_victims:
                continue
            keep = set(victim_keys)
            out[name] = [p for p in nodes_to_victims[name] if p.key in keep]
        return out
