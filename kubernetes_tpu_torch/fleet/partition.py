"""Partition math + shard claims for the active-active fleet.

Copied from the reference (`kubernetes_tpu.fleet.partition`) with the
port's imports.

A profile's namespaces hash onto a fixed ring of `n_shards` shards
(`shard_of`, crc32 — stable across processes and runs, so every
instance, the replay harness, and the bench agree on ownership without
coordination). Each shard is one `Lease` (`shard_lease_name`) claimed
through the `LeaderElector`; rendezvous hashing over the LIVE
instance set (`preferred_owner`) assigns each shard a preferred owner,
so the claim layout is deterministic given membership, rebalances
automatically when an instance joins or dies, and moves only the dead
instance's shards on failover (rendezvous stability).

The fencing token of a claim is the shard Lease's resourceVersion at
ACQUISITION: the store assigns strictly increasing rvs, so every later
claimant's token is strictly greater, and the store's fence table (its
commit core) rejects a superseded claimant's writes whole.
`ShardClaimSet.step()` advances the fence through the store's
`advance_fence` verb BEFORE reporting a gain, so the instance replays
its new shard only after any zombie predecessor is already fenced out.
"""
from __future__ import annotations

import zlib
from typing import Optional

from kubernetes_tpu_torch.api.types import Lease
from kubernetes_tpu_torch.store.store import LEASES, NotFoundError
from kubernetes_tpu_torch.utils.clock import Clock, RealClock
from kubernetes_tpu_torch.utils.leader_election import (
    LeaderElectionConfig, LeaderElector,
)

DEFAULT_SHARDS = 8


def shard_of(namespace: str, n_shards: int = DEFAULT_SHARDS) -> int:
    """Stable namespace -> shard hash (crc32: identical across processes,
    Python versions, and runs — PYTHONHASHSEED never enters)."""
    return zlib.crc32(namespace.encode()) % max(1, n_shards)


def shard_lease_name(profile: str, shard: int) -> str:
    return f"fleet-{profile}-s{shard}"


def heartbeat_lease_name(profile: str, identity: str) -> str:
    return f"fleet-hb-{profile}-{identity}"


def preferred_owner(shard: int, live: list) -> Optional[str]:
    """Rendezvous (highest-random-weight) hash: each live instance scores
    crc32("{identity}:{shard}") and the max wins. Removing one instance
    moves ONLY its shards; adding one steals ~1/n of each peer's."""
    if not live:
        return None
    return max(sorted(live),
               key=lambda ident: zlib.crc32(f"{ident}:{shard}".encode()))


class ShardClaimSet:
    """One instance's live shard claims over the shared store.

    Composition of existing pieces, as the roadmap prescribes: a
    heartbeat `Lease` (node-heartbeat analog) makes the instance's
    liveness observable; one `LeaderElector` per shard does the
    acquire/renew/step-down CAS dance on the shard Lease; rendezvous
    preference gates WHICH electors an instance steps, so claims
    converge to the deterministic layout without thundering herds.

    `step()` returns (gained, lost) shard lists after: renewing the
    heartbeat, computing the live set, stepping/releasing electors, and
    — for every gain — advancing the store's fence to the new claim
    token (the handoff write that makes a predecessor's late wave dead
    on arrival). The chaos seam `fleet.lease-loss` is consumed by
    `FleetInstance`, not here: a paused instance simply stops calling
    step() while continuing to schedule, which is exactly the zombie
    the fence exists to kill."""

    def __init__(self, store, profile: str, identity: str, peers: list,
                 n_shards: int = DEFAULT_SHARDS,
                 clock: Optional[Clock] = None,
                 lease_duration: float = 6.0,
                 renew_deadline: float = 4.0,
                 retry_period: float = 0.5):
        self.store = store
        self.profile = profile
        self.identity = identity
        self.peers = sorted(set(peers) | {identity})
        self.n_shards = int(n_shards)
        self.clock = clock or RealClock()
        self.lease_duration = float(lease_duration)
        self._electors = {
            shard: LeaderElector(store, LeaderElectionConfig(
                lock_name=shard_lease_name(profile, shard),
                identity=identity,
                lease_duration=lease_duration,
                renew_deadline=renew_deadline,
                retry_period=retry_period), clock=self.clock)
            for shard in range(self.n_shards)
        }
        #: shard -> fencing token (claim Lease rv at acquisition)
        self._tokens: dict[int, int] = {}
        #: shards reclaimed from an EXPIRED holder (failover accounting)
        self.failovers = 0

    # -- liveness ------------------------------------------------------------
    def _heartbeat(self, now: float) -> None:
        key = heartbeat_lease_name(self.profile, self.identity)
        try:
            def renew(lease):
                lease.renew_time = now
                return lease
            self.store.guaranteed_update(LEASES, key, renew)
        except NotFoundError:
            try:
                self.store.create(LEASES, Lease(
                    name=key, holder=self.identity, acquire_time=now,
                    renew_time=now, lease_duration=self.lease_duration))
            except Exception:   # noqa: BLE001 — lost create race: renew next step
                pass
        except Exception:       # noqa: BLE001 — store blip: retry next step
            pass

    def live_peers(self, now: float) -> list:
        """Peers (self included) whose heartbeat Lease is unexpired."""
        live = [self.identity]
        for peer in self.peers:
            if peer == self.identity:
                continue
            try:
                lease = self.store.get(
                    LEASES, heartbeat_lease_name(self.profile, peer))
            except Exception:   # noqa: BLE001 — absent or unreadable: not live
                continue
            if lease.renew_time + lease.lease_duration > now:
                live.append(peer)
        return sorted(live)

    # -- the claim step ------------------------------------------------------
    def _claim_token(self, shard: int) -> int:
        """The fencing token of a fresh acquisition: the shard Lease's rv
        right after the acquire CAS landed."""
        try:
            return int(self.store.get(
                LEASES, shard_lease_name(self.profile, shard))
                .resource_version)
        except Exception:   # noqa: BLE001 — vanished: poison token
            return 0

    def _advance_fence(self, shard: int, token: int) -> bool:
        advance = getattr(self.store, "advance_fence", None)
        if advance is None:
            return True   # store without fencing: partitioning + CAS only
        try:
            return bool(advance(shard_lease_name(self.profile, shard),
                                int(token)))
        except Exception:   # noqa: BLE001 — store blip: treat as lost
            return False

    def step(self) -> tuple[list, list]:
        """One claim-maintenance round. Returns (gained, lost) shards."""
        now = self.clock.now()
        self._heartbeat(now)
        live = self.live_peers(now)
        gained: list = []
        lost: list = []
        for shard, elector in self._electors.items():
            preferred = preferred_owner(shard, live) == self.identity
            was = elector.is_leader
            if preferred:
                had_holder = False
                if not was:
                    # failover accounting: acquiring a shard whose lease
                    # EXISTS with another (expired) holder is a reclaim
                    try:
                        cur = self.store.get(
                            LEASES, shard_lease_name(self.profile, shard))
                        had_holder = bool(cur.holder) \
                            and cur.holder != self.identity
                    except Exception:   # noqa: BLE001 — fresh shard
                        had_holder = False
                leading = elector.step()
                if leading and not was:
                    token = self._claim_token(shard)
                    if token <= 0 or not self._advance_fence(shard, token):
                        # a newer claimant already fenced past us: the
                        # acquire CAS we won is stale — give it back
                        elector.release()
                        continue
                    self._tokens[shard] = token
                    gained.append(shard)
                    if had_holder:
                        self.failovers += 1
                elif was and not leading:
                    self._tokens.pop(shard, None)
                    lost.append(shard)
            else:
                if was:
                    elector.release()
                if shard in self._tokens:
                    self._tokens.pop(shard, None)
                    lost.append(shard)
        return gained, lost

    def release_all(self) -> list:
        """Voluntary surrender of every claim (clean shutdown)."""
        lost = []
        for shard, elector in self._electors.items():
            if elector.is_leader:
                elector.release()
            if shard in self._tokens:
                self._tokens.pop(shard, None)
                lost.append(shard)
        return lost

    # -- the read surface the scheduler consumes -----------------------------
    def owned(self) -> set:
        return set(self._tokens)

    def tokens(self) -> dict:
        return dict(self._tokens)

    def owns(self, namespace: str) -> bool:
        return shard_of(namespace, self.n_shards) in self._tokens

    def fences(self) -> list:
        """[(scope, token), ...] for every live claim — what each wave or
        serial bind presents to the store's fence check."""
        return [(shard_lease_name(self.profile, shard), token)
                for shard, token in sorted(self._tokens.items())]


class ScriptedClaims:
    """Replay-side claim driver: the differential harness feeds it the
    RECORDED per-step claim map (shard -> token) instead of running
    electors, so a replayed instance observes exactly the ownership
    timeline the live instance did — lease traffic and all its store
    writes excluded by construction."""

    def __init__(self, profile: str, n_shards: int = DEFAULT_SHARDS):
        self.profile = profile
        self.n_shards = int(n_shards)
        self._tokens: dict[int, int] = {}

    def set_claims(self, tokens: dict) -> tuple[list, list]:
        """Install the recorded claim map; returns (gained, lost) exactly
        like ShardClaimSet.step()."""
        new = {int(s): int(t) for s, t in tokens.items()}
        gained = sorted(s for s in new if s not in self._tokens)
        lost = sorted(s for s in self._tokens if s not in new)
        self._tokens = new
        return gained, lost

    def step(self) -> tuple[list, list]:
        return [], []   # externally driven

    def release_all(self) -> list:
        lost = sorted(self._tokens)
        self._tokens = {}
        return lost

    def owned(self) -> set:
        return set(self._tokens)

    def tokens(self) -> dict:
        return dict(self._tokens)

    def owns(self, namespace: str) -> bool:
        return shard_of(namespace, self.n_shards) in self._tokens

    def fences(self) -> list:
        return [(shard_lease_name(self.profile, shard), token)
                for shard, token in sorted(self._tokens.items())]
