"""Webhook admission — the dynamic admission extension point: the port's
copy of the reference's `apiserver/webhook.py` with the port's imports.

Mirror of the reference's mutating/validating admission webhooks
(staging/src/k8s.io/apiserver/pkg/admission/plugin/webhook/{mutating,
validating}): registrations name a kind set + operations, the chain calls
each matching webhook with an AdmissionReview-shaped payload, mutating
webhooks return a patched object, validating webhooks allow/deny, and an
unreachable webhook follows its failurePolicy (Ignore = admit anyway,
Fail = reject the write). Transport is the extender pattern
(core/extender.py): an in-process callable or a real HTTP JSON endpoint.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from kubernetes_tpu_torch.api import serde
from kubernetes_tpu_torch.apiserver.admission import AdmissionError

FAIL = "Fail"          # failurePolicy values (webhook types.go)
IGNORE = "Ignore"


@dataclass
class WebhookConfig:
    """One registration (Mutating/ValidatingWebhookConfiguration entry)."""
    name: str
    kinds: tuple[str, ...] = ("*",)         # store kinds ("pods", ...)
    operations: tuple[str, ...] = ("CREATE", "UPDATE")
    failure_policy: str = FAIL
    url: str = ""                            # HTTP endpoint; or...
    endpoint: Optional[Callable[[dict], dict]] = None   # in-process callable
    timeout: float = 10.0

    def matches(self, kind: str, operation: str) -> bool:
        return (("*" in self.kinds or kind in self.kinds)
                and operation in self.operations)


class Webhook:
    def __init__(self, config: WebhookConfig, mutating: bool):
        self.config = config
        self.mutating = mutating

    def _call(self, payload: dict) -> dict:
        if self.config.endpoint is not None:
            return self.config.endpoint(payload)
        req = urllib.request.Request(
            self.config.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req,
                                    timeout=self.config.timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def review(self, kind: str, operation: str, obj: Any,
               old: Any = None) -> Any:
        """One AdmissionReview round trip. Returns the (possibly patched)
        object; raises AdmissionError on deny or on transport failure with
        failurePolicy Fail."""
        payload = {
            "kind": kind,
            "operation": operation,
            "object": serde.to_dict(obj),
            "oldObject": serde.to_dict(old) if old is not None else None,
        }
        try:
            resp = self._call(payload)
        except (urllib.error.URLError, OSError, ValueError) as e:
            if self.config.failure_policy == IGNORE:
                return obj   # unreachable + Ignore: admit unchanged
            raise AdmissionError(
                f"webhook {self.config.name!r} failed: {e}")
        if not resp.get("allowed", False):
            raise AdmissionError(
                f"admission webhook {self.config.name!r} denied the "
                f"request: {resp.get('message', '')}")
        if self.mutating and resp.get("patchedObject") is not None:
            patched = serde.from_dict(kind, resp["patchedObject"])
            # a patch may not move or re-version the object: identity
            # metadata is re-pinned from the pre-patch object (the
            # reference rejects webhook mutations of immutable metadata;
            # a zeroed resource_version would silently disable the PUT's
            # optimistic-concurrency check)
            for attr in ("name", "namespace", "uid", "resource_version"):
                if hasattr(patched, attr) and hasattr(obj, attr):
                    setattr(patched, attr, getattr(obj, attr))
            return patched
        return obj


@dataclass
class WebhookAdmission:
    """The chain plugin hosting every registered webhook: mutating first
    (their patches feed the next), then validating against the final
    object — the reference's two-phase order."""
    mutating: list[Webhook] = field(default_factory=list)
    validating: list[Webhook] = field(default_factory=list)

    def register_mutating(self, config: WebhookConfig) -> None:
        self.mutating.append(Webhook(config, mutating=True))

    def register_validating(self, config: WebhookConfig) -> None:
        self.validating.append(Webhook(config, mutating=False))

    def _run(self, kind: str, operation: str, obj: Any,
             old: Any = None) -> Any:
        for w in self.mutating:
            if w.config.matches(kind, operation):
                obj = w.review(kind, operation, obj, old)
        for w in self.validating:
            if w.config.matches(kind, operation):
                w.review(kind, operation, obj, old)
        return obj

    # -- AdmissionChain plugin surface --------------------------------------
    def admit(self, kind: str, obj: Any, store,
              user: Optional[str] = None) -> Any:
        return self._run(kind, "CREATE", obj)

    def admit_update(self, kind: str, old: Any, new: Any, store,
                     user: Optional[str] = None) -> Any:
        return self._run(kind, "UPDATE", new, old)

    def admit_delete(self, kind: str, obj: Any, store,
                     user: Optional[str] = None) -> None:
        # DELETE reviews are validating-only (nothing to patch: the object
        # is going away); a mutating registration matching DELETE is
        # treated as validating, like the reference's DELETE reviews
        for w in self.mutating + self.validating:
            if w.config.matches(kind, "DELETE"):
                w.review(kind, "DELETE", obj)
