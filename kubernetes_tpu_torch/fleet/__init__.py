"""kubernetes_tpu_torch.fleet — the active-active scheduler fleet.

Copied from the reference (`kubernetes_tpu.fleet`) with the port's
imports. Each instance's scheduler is the port's shell, on the card
unless it was given `device="cpu"`; instances of one process may run on
threads of their own over one card, each with its own TorchScheduler
(resident matrix, launch bindings, pinned fetch ring).

N `Scheduler` instances share ONE store (ROADMAP item 3; the
reference's multi-scheduler `spec.schedulerName` contract). Work is
partitioned two ways:

- BY PROFILE: a pod's `spec.schedulerName` names the scheduler class
  that owns it (per-tenant scheduler classes — PAPERS.md 2008.09213's
  heterogeneous per-tenant policies made deployable);
- WITHIN a profile, BY NAMESPACE-HASH SHARD: the profile's namespaces
  hash into a fixed shard ring, and each shard is claimed through a
  `Lease` (the leader-election kind) via the elector — rendezvous hashing
  over the LIVE instance set (heartbeat leases) picks each shard's
  preferred owner, so claims rebalance when instances join, die, or
  pause.

Three layers make "no double-bind, ever" an invariant rather than a
probability:

1. PARTITIONING keeps two instances from even queueing the same pod
   (informer-delivery filter on profile + claimed shard);
2. FENCING kills the zombie window: every shard claim carries a fencing
   token (the claim Lease's resourceVersion at acquisition — strictly
   greater for every later claimant), every wave/bind write presents its
   tokens, and the store's commit core rejects a superseded token's
   write WHOLE (`FencedError`: no bind, no event, no rv) before anything
   lands. A new claimant advances the
   fence BEFORE replaying its partition, so a paused instance's late
   wave is dead on arrival;
3. rv-CAS BINDS backstop whatever slips past both (claim handoff
   windows, nominated pods): a bind for an already-bound pod is refused
   by the store's already-bound check and the loser re-queues with
   backoff in creation order — the existing binding is never
   overwritten.

Failover is the shell's recovery contract scoped to a shard: a dead
instance's heartbeat goes stale, its shard leases expire, a survivor
acquires each lease, advances the fence, and replays the shard from the
store (bound pods are already adopted through the assigned-pod informer
path; unbound pods re-enter the queue in creation order) — so the
reclaimed partition's post-failover decision stream is bit-identical to
a solo scheduler that observed the same pod subset, which
`FleetManager`'s timeline recorder + `replay_instance` verify
differentially (tests/test_fleet.py, tests/sweep_fleet_seeds.py).
"""
from __future__ import annotations

from kubernetes_tpu_torch import obs

# -- observability (registered BEFORE the submodule imports so the
# scheduler's lazy `from kubernetes_tpu_torch.fleet import BIND_CONFLICTS`
# works even mid-import of this package) ------------------------------------
SHARD_CLAIMS = obs.gauge(
    "fleet_partition_shards",
    "Namespace-hash shards currently claimed, by instance.",
    ("instance",))
BIND_CONFLICTS = obs.counter(
    "fleet_bind_conflicts_total",
    "Cross-instance bind races resolved without a double-bind, by "
    "outcome: requeued (rv-CAS loser — the existing binding stood and "
    "the pod re-queued with backoff in creation order), fenced (a whole "
    "wave/bind rejected because its partition-lease fencing token was "
    "superseded; the pods were dropped to the claim's new holder).",
    ("outcome",))
DOUBLE_BINDS = obs.counter(
    "fleet_double_binds_total",
    "TRIPWIRE, pinned at zero: a pod's nodeName observed changing from "
    "one non-empty value to a different one on the shared store's watch "
    "stream. Partitioning + fencing + rv-CAS binds make this "
    "structurally impossible; any increment is a released invariant and "
    "fails every fleet sweep, test, and bench audit.")
FAILOVERS = obs.counter(
    "fleet_failovers_total",
    "Partition shards reclaimed from an expired holder (the previous "
    "holder's lease ran out — crash, pause, or partition), by the "
    "claiming instance.", ("instance",))
CLAIM_CHANGES = obs.counter(
    "fleet_claim_transitions_total",
    "Shard claim transitions, by kind: gained (acquired a shard and "
    "advanced its fence), lost (released or lost a shard and purged its "
    "pods from the queue).", ("kind",))

from kubernetes_tpu_torch.fleet.partition import (   # noqa: E402
    DEFAULT_SHARDS, ScriptedClaims, ShardClaimSet, heartbeat_lease_name,
    preferred_owner, shard_lease_name, shard_of,
)
from kubernetes_tpu_torch.fleet.instance import (    # noqa: E402
    FleetInstance, FleetScheduler,
)
from kubernetes_tpu_torch.fleet.manager import (     # noqa: E402
    BindAuditor, FleetManager, replay_instance,
)

__all__ = [
    "BIND_CONFLICTS", "BindAuditor", "CLAIM_CHANGES", "DEFAULT_SHARDS",
    "DOUBLE_BINDS", "FAILOVERS", "FleetInstance", "FleetManager",
    "FleetScheduler", "SHARD_CLAIMS", "ScriptedClaims", "ShardClaimSet",
    "heartbeat_lease_name", "preferred_owner", "replay_instance",
    "shard_lease_name", "shard_of",
]
