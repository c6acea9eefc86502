"""Authentication + authorization for the apiserver: the port's copy of
the reference's `apiserver/auth.py` with the port's imports.

The reference stacks authenticators (bearer token file among them,
staging/src/k8s.io/apiserver/pkg/authentication/token/tokenfile) in front
of a union of authorizers — RBAC
(plugin/pkg/auth/authorizer/rbac/rbac.go:1) and the node authorizer
(plugin/pkg/auth/authorizer/node/node_authorizer.go:1) being the two that
matter for the control plane. This module provides that floor:

- `TokenAuthenticator`: bearer token -> UserInfo(name, groups); unknown or
  missing tokens are anonymous (None) and the server rejects writes with
  401 when auth is enabled.
- `RBACAuthorizer`: Roles (verb x resource rules, optional resourceNames)
  bound to users/groups; RuleAllows semantics with "*" wildcards
  (rbac.go VisitRulesFor / RuleAllows).
- `NodeAuthorizer`: identities in the `system:nodes` group named
  `system:node:<name>` may read cluster state, write their OWN Node
  object, status-update/delete pods BOUND to them, and create events —
  the graph-based reference collapsed to the ownership rules the
  kubemark-fidelity kubelet exercises.
- `union()`: allow when ANY authorizer allows (the reference's union
  authorizer) — and NodeRestriction then acts on the VERIFIED identity,
  closing the spoofable `X-Remote-User` hole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

NODES_GROUP = "system:nodes"
NODE_USER_PREFIX = "system:node:"
MASTERS_GROUP = "system:masters"   # cluster-admin bypass, like the reference


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: tuple[str, ...] = ()


@dataclass(frozen=True)
class Attributes:
    """The authorizer.Attributes subset the REST surface produces."""
    user: UserInfo
    verb: str          # get | list | watch | create | update | delete
    resource: str      # the kind path segment ("pods", "nodes", ...)
    name: str = ""     # object name/key ("" for collection ops)


class TokenAuthenticator:
    """Static token map — the token-file authenticator."""

    def __init__(self, tokens: Optional[dict[str, UserInfo]] = None):
        self.tokens = dict(tokens or {})

    def add(self, token: str, user: UserInfo) -> None:
        self.tokens[token] = user

    def authenticate(self, authorization: Optional[str]) -> Optional[UserInfo]:
        """`Authorization: Bearer <token>` -> UserInfo, else None."""
        if not authorization or not authorization.startswith("Bearer "):
            return None
        return self.tokens.get(authorization[len("Bearer "):])


@dataclass(frozen=True)
class PolicyRule:
    """rbac.PolicyRule subset: verbs x resources (+ optional names)."""
    verbs: tuple[str, ...]
    resources: tuple[str, ...]
    resource_names: tuple[str, ...] = ()

    def allows(self, attrs: Attributes) -> bool:
        # RuleAllows (rbac.go): "*" wildcards, resourceNames narrow to
        # specific objects when present
        if "*" not in self.verbs and attrs.verb not in self.verbs:
            return False
        if "*" not in self.resources and attrs.resource not in self.resources:
            return False
        if self.resource_names:
            return attrs.name in self.resource_names
        return True


@dataclass
class Role:
    """rbac.ClusterRole (cluster-scoped, like everything in this flat
    authorization model). `aggregation_labels` is the ClusterRole
    aggregationRule reduced to match-labels: the clusterrole-aggregation
    controller unions the rules of every role whose `labels` match."""
    name: str
    rules: tuple[PolicyRule, ...] = ()
    labels: dict = field(default_factory=dict)
    aggregation_labels: dict = field(default_factory=dict)
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "Role":
        import copy
        out = copy.copy(self)
        out.labels = dict(self.labels)
        out.aggregation_labels = dict(self.aggregation_labels)
        return out


@dataclass
class RoleBinding:
    """rbac.ClusterRoleBinding: role name + user/group subjects.

    `name` defaults to the role name for the common one-binding-per-role
    case; give EXPLICIT distinct names when storing multiple bindings for
    one role, or their store keys collide (the reference requires
    distinct binding names)."""
    role: str
    name: str = ""
    users: tuple[str, ...] = ()
    groups: tuple[str, ...] = ()
    resource_version: int = 0

    def __post_init__(self):
        if not self.name:
            self.name = self.role

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "RoleBinding":
        import copy
        return copy.copy(self)

    def matches(self, user: UserInfo) -> bool:
        return user.name in self.users or any(
            g in self.groups for g in user.groups)


class RBACAuthorizer:
    """VisitRulesFor over bindings -> roles -> rules (rbac.go:1).

    Static form: pass `roles`/`bindings` literals. Store-backed form: pass
    `store` — every authorize() reads the live clusterroles /
    clusterrolebindings objects, so policy edits through the API take
    effect immediately (the reference's RBAC informers with none of the
    staleness window, affordable at this scale)."""

    def __init__(self, roles: Iterable[Role] = (),
                 bindings: Iterable[RoleBinding] = (), store=None):
        self.roles = {r.name: r for r in roles}
        self.bindings = list(bindings)
        self.store = store

    def _policy(self) -> tuple[dict, list]:
        if self.store is None:
            return self.roles, self.bindings
        from kubernetes_tpu_torch.store.store import CLUSTERROLES, \
            CLUSTERROLEBINDINGS
        roles = {r.name: r for r in self.store.list(CLUSTERROLES)[0]}
        roles.update(self.roles)           # bootstrap literals stay valid
        bindings = self.bindings + self.store.list(CLUSTERROLEBINDINGS)[0]
        return roles, bindings

    def authorize(self, attrs: Attributes) -> bool:
        if MASTERS_GROUP in attrs.user.groups:
            return True
        roles, bindings = self._policy()
        for b in bindings:
            if not b.matches(attrs.user):
                continue
            role = roles.get(b.role)
            if role is None:
                continue
            if any(rule.allows(attrs) for rule in role.rules):
                return True
        return False


# kinds a node identity may NOT read wholesale: the graph-based reference
# authorizer scopes secrets/configmaps/serviceaccounts to the objects
# referenced by pods BOUND to that node (node_authorizer.go:151-186,
# "no relationship found" -> deny); this model keeps no reference graph,
# so the collapse is an outright deny — a compromised kubelet credential
# must not be a read-everything credential for cluster secrets. The
# kubemark-fidelity kubelet reads none of these.
NODE_RESTRICTED_READS = frozenset(
    ("secrets", "configmaps", "serviceaccounts"))


class NodeAuthorizer:
    """node_authorizer.go collapsed to ownership rules: a kubelet identity
    may read cluster state (its informers) EXCEPT secret-bearing kinds,
    write only its own Node, touch only pods bound to it, and post
    events."""

    def authorize(self, attrs: Attributes) -> bool:
        u = attrs.user
        if NODES_GROUP not in u.groups or \
                not u.name.startswith(NODE_USER_PREFIX):
            return False
        node_name = u.name[len(NODE_USER_PREFIX):]
        if attrs.resource in NODE_RESTRICTED_READS:
            return False
        if attrs.verb in ("get", "list", "watch"):
            return True
        if attrs.resource == "nodes":
            # create-on-register + self-updates only
            return attrs.name in ("", node_name) and \
                attrs.verb in ("create", "update")
        if attrs.resource == "leases":
            # node heartbeat lease, named after the node
            return attrs.name in ("", node_name)
        if attrs.resource == "events":
            return attrs.verb == "create"
        if attrs.resource == "pods":
            # status updates and eviction of pods on this node; WHICH pods
            # is enforced by NodeRestriction admission against the object.
            # No "create": binding subresources are the scheduler's verb,
            # and the kubemark kubelet runs no mirror pods.
            return attrs.verb in ("update", "delete")
        return False


class UnionAuthorizer:
    def __init__(self, *authorizers):
        self.authorizers = [a for a in authorizers if a is not None]

    def authorize(self, attrs: Attributes) -> bool:
        return any(a.authorize(attrs) for a in self.authorizers)


def union(*authorizers) -> UnionAuthorizer:
    return UnionAuthorizer(*authorizers)


# the control-plane roles a bootstrapped cluster grants
# (bootstrappolicy analog): scheduler and controller-manager identities
def default_roles() -> tuple[list[Role], list[RoleBinding]]:
    roles = [
        Role("system:kube-scheduler", rules=(
            PolicyRule(verbs=("get", "list", "watch"), resources=("*",)),
            PolicyRule(verbs=("create", "update", "delete"),
                       resources=("pods", "events", "leases")),
        )),
        Role("system:kube-controller-manager", rules=(
            PolicyRule(verbs=("*",), resources=("*",)),
        )),
        Role("system:public-info-viewer", rules=(
            PolicyRule(verbs=("get", "list", "watch"), resources=("*",)),
        )),
    ]
    bindings = [
        RoleBinding("system:kube-scheduler",
                    users=("system:kube-scheduler",)),
        RoleBinding("system:kube-controller-manager",
                    users=("system:kube-controller-manager",)),
    ]
    return roles, bindings
