"""One fleet member: a partition-filtered Scheduler + its shard claims.

Copied from the reference (`kubernetes_tpu.fleet.instance`) with the
port's imports. What differs: the reference's `use_tpu=` is
`use_device=` plus `device=`, and the device path is the default, as in
the port's Scheduler; an instance on its own thread keeps its own
TorchScheduler, and an error of its step is not caught here.

`FleetScheduler` narrows the reference's multi-scheduler responsibility
check (`spec.schedulerName == name`) with the live namespace-hash claim
set, so the informer-delivery filter keeps unowned pods out of the queue
entirely. `FleetInstance` wires the claims into the scheduler's fence
provider (every wave/bind write carries the claim tokens), runs the
serve-style step loop, and implements the two ownership transitions:

- GAIN (claim acquired, fence already advanced by the claim protocol):
  replay the shard from the authoritative store — the shell's recovery
  contract scoped to one shard. Bound pods are already adopted through
  the assigned-pod informer path (the cache watches ALL bound pods,
  cluster-wide — capacity math needs every binding, whoever made it);
  unbound owned pods re-enter the queue in creation order (the store
  lists in insertion order), exactly the arrival order a never-failed
  owner's informer would have fed its queue.
- LOSE (claim released, expired, or superseded): purge the shard's pods
  from the queue and row cache — the new owner replays them; holding
  them would only manufacture rv-CAS conflicts.

The `fleet.lease-loss` chaos seam fires here: the instance PAUSES claim
maintenance for a few steps while continuing to schedule — the zombie
window. Its leases expire, a peer claims + advances the fence, and the
store rejects the zombie's next wave whole (FencedError), which the
scheduler answers by dropping the wave's pods to the new owner.
"""
from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch import chaos
from kubernetes_tpu_torch.fleet import (
    CLAIM_CHANGES, FAILOVERS, SHARD_CLAIMS,
)
from kubernetes_tpu_torch.fleet.partition import (
    DEFAULT_SHARDS, ShardClaimSet, shard_of,
)
from kubernetes_tpu_torch.scheduler import DEFAULT_SCHEDULER_NAME, Scheduler
from kubernetes_tpu_torch.serve.loop import ServeLoop
from kubernetes_tpu_torch.store.store import PODS

#: steps of claim maintenance skipped when the lease-loss seam fires —
#: long enough (with the harness stepping the clock) for the leases to
#: expire and a peer to claim + fence, i.e. a real zombie window
LEASE_LOSS_PAUSE_STEPS = 3


class FleetScheduler(Scheduler):
    """Scheduler whose responsibility = profile AND live shard claims.

    `_partition_filter` defaults to owning everything (a solo
    FleetScheduler is just a Scheduler); FleetInstance swaps in the
    claim check. The filter is consulted at informer delivery time
    through `_responsible_for`, so claim changes take effect at the next
    pump without re-registering handlers.

    With a round-19 ProfileSet attached, responsibility stays pinned to
    the instance's CLAIMED profile (self.name) — the set only supplies
    scoring: the claimed profile's weight-tensor row scores every owned
    pod, so fleet tenants get real per-tenant scheduler classes while
    partitioning semantics are untouched."""

    _partition_filter = staticmethod(lambda pod: True)

    def _responsible_for(self, pod) -> bool:
        return pod.scheduler_name == self.name \
            and self._partition_filter(pod)


class FleetInstance:
    """One active-active fleet member (see module docstring)."""

    def __init__(self, store, identity: str, peers: list,
                 profile: str = DEFAULT_SCHEDULER_NAME,
                 n_shards: int = DEFAULT_SHARDS,
                 use_device: bool = True,
                 device=None,
                 clock=None,
                 window: int = 8, depth: int = 2,
                 lease_duration: float = 6.0,
                 renew_deadline: float = 4.0,
                 claims=None,
                 profiles=None,
                 **sched_kw):
        self.identity = identity
        self.profile = profile
        self.n_shards = int(n_shards)
        if profiles is not None and profiles.index_of(profile) is None:
            raise ValueError(
                f"claimed profile {profile!r} is not in the ProfileSet")
        self.sched = FleetScheduler(
            store, scheduler_name=profile, use_device=use_device,
            device=device, clock=clock, profiles=profiles, **sched_kw)
        self.claims = claims if claims is not None else ShardClaimSet(
            store, profile, identity, peers, n_shards=n_shards,
            clock=self.sched.clock, lease_duration=lease_duration,
            renew_deadline=renew_deadline)
        self.sched._partition_filter = \
            lambda pod: self.claims.owns(pod.namespace)
        self.sched.fence_provider = self._fences
        self.loop = ServeLoop(self.sched, window_size=window, depth=depth)
        self.dead = False
        #: >0 while the lease-loss seam has claim maintenance paused (the
        #: zombie window: scheduling continues on stale claims)
        self.paused_claims = 0

    # -- scheduler wiring ----------------------------------------------------
    def _fences(self) -> Optional[list]:
        return self.claims.fences() or None

    def owns_pod(self, pod) -> bool:
        return pod.scheduler_name == self.profile \
            and self.claims.owns(pod.namespace)

    # -- ownership transitions -----------------------------------------------
    def _adopt_shard(self, shard: int) -> int:
        """Shard replay on claim gain (the recovery contract, scoped to
        the shard): list the authoritative store and re-enter every
        unbound owned pod in creation order. Returns pods enqueued."""
        CLAIM_CHANGES.labels("gained").inc()
        pods = [p for p in self.sched.store.list(PODS)[0]
                if not p.node_name and not p.deleted
                and p.scheduler_name == self.profile
                and shard_of(p.namespace, self.n_shards) == shard]
        if pods:
            # the informer batch-delivery verb: one queue lock + one
            # heap push + row-cache encode per batch, same as arrival
            self.sched._add_pods_to_queue(pods)
        return len(pods)

    def _drop_shard(self, shard: int) -> int:
        """Purge a lost shard's pods from queue + row cache. Returns pods
        dropped."""
        CLAIM_CHANGES.labels("lost").inc()
        dropped = 0
        pending = self.sched.queue.pending_pods()
        for bucket in pending.values():
            for pod in bucket:
                if pod.scheduler_name == self.profile \
                        and shard_of(pod.namespace, self.n_shards) == shard:
                    self.sched.queue.delete(pod)
                    if self.sched.pod_rows is not None:
                        self.sched.pod_rows.invalidate(pod)
                    dropped += 1
        return dropped

    def maintain_claims(self) -> tuple[list, list]:
        """One claim round + the gain/loss transitions. Split from
        step() so the manager (and the replay harness, via
        ScriptedClaims) can drive it at the recorded points."""
        before = self.claims.failovers if hasattr(self.claims, "failovers") \
            else 0
        gained, lost = self.claims.step()
        after = getattr(self.claims, "failovers", before)
        if after > before:
            FAILOVERS.labels(self.identity).inc(after - before)
        for shard in lost:
            self._drop_shard(shard)
        for shard in gained:
            self._adopt_shard(shard)
        SHARD_CLAIMS.labels(self.identity).set(
            float(len(self.claims.owned())))
        return gained, lost

    def apply_claims(self, tokens: dict) -> None:
        """Replay-side transition driver: install a recorded claim map
        (ScriptedClaims) and run the same gain/loss transitions the live
        instance ran."""
        gained, lost = self.claims.set_claims(tokens)
        for shard in lost:
            self._drop_shard(shard)
        for shard in gained:
            self._adopt_shard(shard)

    # -- the step loop -------------------------------------------------------
    def sync(self) -> None:
        self.sched.sync()

    def step(self) -> int:
        """One fleet tick: claim maintenance (unless paused by the
        lease-loss seam), then one serve tick (pump + cut windows).
        Returns pods bound."""
        if self.dead:
            return 0
        if chaos.take("fleet.lease-loss"):
            # the GC-pause / network-partition stand-in: claims freeze,
            # scheduling continues — the fence must kill what follows
            self.paused_claims = max(self.paused_claims,
                                     LEASE_LOSS_PAUSE_STEPS)
        if self.paused_claims > 0:
            self.paused_claims -= 1
        if self.paused_claims == 0:
            # claim maintenance resumes IN the step the pause ends, so
            # an unpaused instance never schedules on stale belief (the
            # manager's disjointness probe relies on exactly this)
            self.maintain_claims()
        return self.loop.step()

    def kill(self) -> None:
        """Process-death stand-in: stop stepping WITHOUT releasing
        anything — the leases expire on their own and a survivor
        reclaims (the failover the sweeps drive)."""
        self.dead = True

    def stats(self) -> dict:
        return {
            "identity": self.identity,
            "profile": self.profile,
            "shards": sorted(self.claims.owned()),
            "dead": self.dead,
            "paused_claims": self.paused_claims,
            "fenced_waves": self.sched.fenced_waves,
            "pods_bound": self.loop.pods_bound,
            "windows_cut": self.loop.windows_cut,
        }
