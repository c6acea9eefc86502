"""CronJob controller — pkg/controller/cronjob/cronjob_controller.go.

syncOne semantics: for every CronJob, find the unmet schedule times since
the last run (getRecentUnmetScheduleTimes), start a Job for the most
recent one, and apply the concurrency policy against still-active owned
Jobs (Allow runs them side by side, Forbid skips the new run, Replace
deletes the active ones first). Too many missed runs (>100) emits the
reference's warning and resets the cursor; the optional starting deadline
drops runs that are already stale.

Schedules are evaluated in **UTC** (utils.cron.CronSchedule), a deliberate
divergence from the reference controller-manager's local-time evaluation:
firing times here never depend on the host's timezone.

The port's copy of the reference's `controllers/cronjob.py` with the
port's imports.
"""
from __future__ import annotations

import time as _time
from typing import Optional

from kubernetes_tpu_torch.api.types import CronJob, Job
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL, WARNING
from kubernetes_tpu_torch.store.store import (
    Store, CRONJOBS, JOBS, AlreadyExistsError, NotFoundError,
)
from kubernetes_tpu_torch.utils.cron import CronSchedule, CronParseError

MAX_MISSED = 100          # cronjob_controller.go:~"Too many missed times"


class CronJobController(DirtyKeyController):
    KIND = CRONJOBS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        self.recorder = EventRecorder(store, component="cronjob-controller")
        # (schedule expr, cursor) -> next fire time, so the steady-state
        # resync is O(1) per CronJob instead of a minute-scan per pump
        self._next: dict[str, tuple[str, float, Optional[float]]] = {}

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _time.time()

    def pump(self) -> int:
        # time moves even when no event does: one resync pass covers every
        # schedule (the reference's 10s resync) — event-dirtied keys ride
        # the same drain instead of reconciling twice
        self.informers.pump_all()
        for cj in self.informers.informer(CRONJOBS).list():
            self._dirty.add(cj.key)
        return self.reconcile_dirty()

    def _active_owned_jobs(self, cj: CronJob) -> list[Job]:
        return [j for j in self.store.list(JOBS)[0]
                if j.namespace == cj.namespace
                and j.owner_ref is not None
                and j.owner_ref[:2] == ("CronJob", cj.name)
                and not j.complete and not j.job_failed]

    def reconcile(self, cj: CronJob) -> None:
        if cj.suspend or cj.template is None:
            return
        try:
            sched = CronSchedule(cj.schedule)
        except CronParseError as e:
            self.recorder.event("CronJob", cj.key, WARNING,
                                "InvalidSchedule", str(e))
            return
        now = self._now()
        start = cj.last_schedule_time
        if start is None:
            # first sight: start the clock now — the first run fires at the
            # next matching minute (the reference anchors on creation time)
            self._set_cursor(cj, now)
            return
        cached = self._next.get(cj.key)
        if cached is not None and cached[0] == cj.schedule \
                and cached[1] == start:
            nxt = cached[2]
            if nxt is None or nxt > now:
                return   # nothing due yet: skip the minute scan entirely
        # unmet times in (start, now]
        unmet = []
        t = sched.next_after(start)
        if t is None or t > now:
            self._next[cj.key] = (cj.schedule, start, t)
            return
        while t is not None and t <= now:
            unmet.append(t)
            if len(unmet) > MAX_MISSED:
                self.recorder.event(
                    "CronJob", cj.key, WARNING, "TooManyMissedTimes",
                    f"too many missed start times (> {MAX_MISSED}); "
                    "check clock skew")
                self._set_cursor(cj, now)
                return
            t = sched.next_after(t)
        if not unmet:
            return
        run_time = unmet[-1]   # only the most recent unmet time runs
        if cj.starting_deadline_seconds is not None and \
                now - run_time > cj.starting_deadline_seconds:
            self.recorder.event("CronJob", cj.key, WARNING, "MissSchedule",
                                "missed starting deadline for run")
            self._set_cursor(cj, run_time)
            return
        active = self._active_owned_jobs(cj)
        if active:
            if cj.concurrency_policy == "Forbid":
                self.recorder.event(
                    "CronJob", cj.key, NORMAL, "JobAlreadyActive",
                    "skipping run: previous Job still active")
                self._set_cursor(cj, run_time)
                return
            if cj.concurrency_policy == "Replace":
                for j in active:
                    try:
                        self.store.delete(JOBS, j.key)
                    except NotFoundError:
                        pass
        job = Job(
            name=f"{cj.name}-{int(run_time // 60)}",   # minute-stamped name
            namespace=cj.namespace,
            template=cj.template,
            completions=cj.completions,
            parallelism=cj.parallelism,
            owner_ref=("CronJob", cj.name, ""))
        try:
            self.store.create(JOBS, job)
            self.recorder.event("CronJob", cj.key, NORMAL, "SuccessfulCreate",
                                f"Created job {job.name}")
        except AlreadyExistsError:
            pass   # this tick already ran (controller restart replay)
        self._set_cursor(cj, run_time)

    def _set_cursor(self, cj: CronJob, t: float) -> None:
        def mutate(cur):
            if cur.last_schedule_time is not None \
                    and cur.last_schedule_time >= t:
                return None
            cur.last_schedule_time = t
            return cur
        try:
            self.store.guaranteed_update(CRONJOBS, cj.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            pass
