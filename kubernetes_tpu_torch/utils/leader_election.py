"""Leader election over the versioned store — active/passive HA.

Mirrors client-go/tools/leaderelection (leaderelection.go:183) with a lease
resourcelock (resourcelock/leaselock.go): candidates CAS a lease record
through the store's optimistic concurrency; the holder renews before
renew_deadline, others acquire after lease_duration of silence. The
reference wires this at cmd/kube-scheduler/app/server.go:248-263.

Copied from the JAX package (`kubernetes_tpu.utils.leader_election`) with
the port's imports.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import Lease
from kubernetes_tpu_torch.store.store import (
    Store, LEASES, NotFoundError, ConflictError, AlreadyExistsError,
)
from kubernetes_tpu_torch.utils.clock import Clock, RealClock

__all__ = ["Lease", "LeaderElectionConfig", "LeaderElector"]


@dataclass
class LeaderElectionConfig:
    lock_name: str = "kube-scheduler"
    identity: str = "candidate"
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: Optional[Callable[[], None]] = None
    on_stopped_leading: Optional[Callable[[], None]] = None


class LeaderElector:
    def __init__(self, store: Store, config: LeaderElectionConfig,
                 clock: Optional[Clock] = None):
        # the fencing invariant (leaderelection.go:128 validation): the
        # holder must abdicate at renew_deadline, strictly BEFORE the
        # lease_duration window in which another candidate may acquire —
        # an equal or larger deadline would allow two leaders
        if config.renew_deadline >= config.lease_duration:
            raise ValueError(
                f"renew_deadline ({config.renew_deadline}) must be < "
                f"lease_duration ({config.lease_duration}): a leader must "
                "stop before its lease can be re-acquired")
        self.store = store
        self.config = config
        self.clock = clock or RealClock()
        self._leading = False
        self._observed: Optional[Lease] = None
        self._observed_at = 0.0
        # last SUCCESSFUL renew (fencing clock): step() tolerates store
        # failures only until last_renew + renew_deadline
        self._last_renew = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        return self._leading

    # -- one acquisition/renewal attempt (leaderelection.go:287) -------------
    def try_acquire_or_renew(self) -> bool:
        now = self.clock.now()
        cfg = self.config
        new_record = Lease(
            name=cfg.lock_name, holder=cfg.identity,
            acquire_time=now, renew_time=now,
            lease_duration=cfg.lease_duration)
        try:
            current = self.store.get(LEASES, cfg.lock_name)
        except NotFoundError:
            try:
                self.store.create(LEASES, new_record)
            except AlreadyExistsError:
                return False
            self._observe(new_record, now)
            return True
        # refresh observation clock on any record change
        if self._observed is None or \
                self._observed.resource_version != current.resource_version:
            self._observe(current, now)
        if current.holder != cfg.identity:
            if self._observed_at + current.lease_duration > now and current.holder:
                return False  # current leader still valid
            new_record.acquire_time = now
            new_record.leader_transitions = current.leader_transitions + 1
        else:
            new_record.acquire_time = current.acquire_time
            new_record.leader_transitions = current.leader_transitions
        try:
            updated = self.store.update(LEASES, new_record,
                                        expect_rv=current.resource_version)
        except (ConflictError, NotFoundError):
            return False
        self._observe(updated, now)
        return True

    def _observe(self, record: Lease, now: float) -> None:
        self._observed = record
        self._observed_at = now

    # -- run loop ------------------------------------------------------------
    def step(self) -> bool:
        """One election step; returns current leadership. Suitable for
        deterministic test pumping as well as the background loop.

        Fencing (leaderelection.go renewLoop): a store failure during a
        renew is TRANSIENT — the holder keeps leading and retrying — but
        only until `renew_deadline` past the last successful renew; at the
        deadline it fires on_stopped_leading and stops, strictly before
        the lease (lease_duration > renew_deadline) becomes acquirable by
        another candidate. A definitive loss (the CAS failed because the
        record moved, or another holder is valid) steps down immediately."""
        now = self.clock.now()
        try:
            got = self.try_acquire_or_renew()
        except Exception:   # noqa: BLE001 — store unreachable: transient
            got = None
        if got:
            self._last_renew = now
            if not self._leading:
                self._leading = True
                if self.config.on_started_leading:
                    self.config.on_started_leading()
        elif self._leading:
            if got is None \
                    and now - self._last_renew < self.config.renew_deadline:
                # transient renew failure inside the deadline: keep
                # leading, the run loop retries (no split brain — the
                # lease itself is still unexpired for everyone else)
                return self._leading
            # deadline blown, or the lock definitively moved: stop
            # leading NOW, before the lease can be re-acquired
            self._leading = False
            if self.config.on_stopped_leading:
                self.config.on_stopped_leading()
        return self._leading

    def run(self) -> None:
        while not self._stop.is_set():
            self.step()
            self.clock.sleep(self.config.retry_period)

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self.run, daemon=True,
                                            name=f"elector-{self.config.identity}")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def release(self) -> None:
        """Voluntarily give up the lease (leaderelection.go release)."""
        if not self._leading:
            return
        try:
            current = self.store.get(LEASES, self.config.lock_name)
            if current.holder == self.config.identity:
                current.holder = ""
                current.renew_time = 0.0
                self.store.update(LEASES, current,
                                  expect_rv=current.resource_version)
        except (NotFoundError, ConflictError):
            pass
        self._leading = False
        if self.config.on_stopped_leading:
            self.config.on_stopped_leading()
