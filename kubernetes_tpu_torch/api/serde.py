"""JSON serialization for the API types — the runtime.Scheme analog: the
port's copy of the reference's `api/serde.py` with the port's imports.

The reference's apimachinery gives every object a serialize/deserialize
round trip (runtime.Scheme + codecs); this provides the same contract for
the pruned dataclasses: `to_dict(obj)` -> plain JSON-able dict,
`from_dict(kind, d)` -> object, driven generically off dataclass type
hints (nested dataclasses, tuples of dataclasses, tuple-of-pairs maps,
Optionals). Used by the REST apiserver and kubectl.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, get_args, get_origin, get_type_hints

from kubernetes_tpu_torch.api import types as T
from kubernetes_tpu_torch.store import store as store_mod

# store kind -> object class (the scheme's kind registry)
KIND_TYPES = {
    store_mod.PODS: T.Pod,
    store_mod.NODES: T.Node,
    store_mod.SERVICES: T.Service,
    store_mod.REPLICASETS: T.ReplicaSet,
    store_mod.PDBS: T.PodDisruptionBudget,
    store_mod.PVS: T.PersistentVolume,
    store_mod.PVCS: T.PersistentVolumeClaim,
    store_mod.EVENTS: T.EventRecord,
    "priorityclasses": T.PriorityClass,
    store_mod.ENDPOINTS: T.Endpoints,
    store_mod.RESOURCEQUOTAS: T.ResourceQuota,
    store_mod.DEPLOYMENTS: T.Deployment,
    store_mod.JOBS: T.Job,
    store_mod.DAEMONSETS: T.DaemonSet,
    store_mod.STATEFULSETS: T.StatefulSet,
    store_mod.NAMESPACES: T.Namespace,
    store_mod.CONFIGMAPS: T.ConfigMap,
    store_mod.SECRETS: T.Secret,
    store_mod.SERVICEACCOUNTS: T.ServiceAccount,
    store_mod.HPAS: T.HorizontalPodAutoscaler,
    store_mod.PODMETRICS: T.PodMetrics,
    store_mod.CRONJOBS: T.CronJob,
}

# coordination.k8s.io/Lease — one kind serves the leader-election
# resourcelock AND the node-heartbeat NodeLease, so leader election and
# the node-lifecycle health monitor work over the remote transport too
KIND_TYPES[store_mod.LEASES] = T.Lease

# rbac.authorization.k8s.io policy objects: the store-backed authorizer
# and the clusterrole-aggregation controller read these
from kubernetes_tpu_torch.apiserver.auth import (  # noqa: E402
    Role as _Role, RoleBinding as _RoleBinding)
KIND_TYPES[store_mod.CLUSTERROLES] = _Role
KIND_TYPES[store_mod.CLUSTERROLEBINDINGS] = _RoleBinding

# co-scheduling gangs (scheduling.sigs.k8s.io PodGroup analog): served by
# the apiserver + /status subresource, mirrored by RemoteStore
from kubernetes_tpu_torch.coscheduling.types import PodGroup as _PodGroup  # noqa: E402
KIND_TYPES[store_mod.PODGROUPS] = _PodGroup

# kinds whose objects key by bare name (Node.key etc.); everything else
# keys by namespace/name — the single owner of REST path scoping
CLUSTER_SCOPED_KINDS = frozenset(
    kind for kind, cls in KIND_TYPES.items()
    if "namespace" not in {f.name for f in dataclasses.fields(cls)})


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


_HINTS_CACHE: dict[type, dict] = {}


def _hints(cls: type) -> dict:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        # resolve stringified annotations in the class's OWN module (types
        # registered from other modules — Lease, RBAC — name their own
        # neighbors), with api.types as fallback vocabulary
        import sys
        ns = dict(vars(T))
        ns.update(vars(sys.modules.get(cls.__module__, T)))
        h = _HINTS_CACHE[cls] = get_type_hints(cls, ns,
                                               {"Optional": Optional})
    return h


def _build(hint: Any, value: Any) -> Any:
    if value is None:
        return None
    if isinstance(hint, str):
        # a quoted forward reference nested inside a builtin generic (e.g.
        # tuple["PodCondition", ...]) survives get_type_hints as a plain
        # string — types.GenericAlias neither wraps it in ForwardRef nor
        # resolves it; look it up in the api.types vocabulary
        hint = getattr(T, hint, Any)
    origin = get_origin(hint)
    if origin is typing.Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        return _build(args[0], value) if len(args) == 1 else value
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        return from_obj_dict(hint, value)
    if origin is tuple:
        args = get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_build(args[0], v) for v in value)
        if args:
            return tuple(_build(a, v) for a, v in zip(args, value))
        return tuple(value)
    if origin is list:
        (elem,) = get_args(hint) or (Any,)
        return [_build(elem, v) for v in value]
    if origin is dict:
        return dict(value)
    return value


def from_obj_dict(cls: type, d: dict) -> Any:
    """Rebuild a dataclass instance from to_dict output (unknown keys are
    dropped — forward-compatible decode, like unknown-field-tolerant
    deserialization in the reference)."""
    hints = _hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            kw[f.name] = _build(hints.get(f.name, Any), d[f.name])
    return cls(**kw)


def from_dict(kind: str, d: dict) -> Any:
    cls = KIND_TYPES.get(kind)
    if cls is None:
        raise KeyError(f"unknown kind {kind!r}")
    return from_obj_dict(cls, d)
