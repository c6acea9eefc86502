"""Job controller — pkg/controller/job/job_controller.go:69.

Run-to-completion reconciliation: keep `parallelism` pods active until
`completions` pods have Succeeded; count failures against `backoff_limit`
(exceeding it fails the Job and stops creating); finished Jobs with a TTL
are deleted by the ttl-after-finished sweep (reference:
pkg/controller/ttlafterfinished). Pods carry the `job-name` label the
reference's generated selector keys on.

The port's copy of the reference's `controllers/job.py` with the port's
imports.
"""
from __future__ import annotations

import itertools
import time as _time

from kubernetes_tpu_torch.api.types import Job, Pod
from kubernetes_tpu_torch.controllers.base import DirtyKeyController
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL
from kubernetes_tpu_torch.store.store import (
    Store, PODS, JOBS, AlreadyExistsError, NotFoundError,
)

JOB_NAME_LABEL = "job-name"
_suffix = itertools.count(1)


class JobController(DirtyKeyController):
    KIND = JOBS

    def __init__(self, store: Store, clock=None):
        super().__init__(store, clock=clock)
        from kubernetes_tpu_torch.apiserver.admission import AdmissionChain
        self.admission = AdmissionChain()
        self.recorder = EventRecorder(store, component="controllermanager")

    def _register_extra_handlers(self) -> None:
        pods = self.informers.informer(PODS)
        pods.add_event_handler(on_add=self._pod_changed,
                               on_update=lambda o, n: self._pod_changed(n),
                               on_delete=self._pod_changed)

    def _pod_changed(self, pod: Pod) -> None:
        if pod.owner_ref is not None and pod.owner_ref[0] == "Job":
            self._dirty.add(f"{pod.namespace}/{pod.owner_ref[1]}")

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _time.time()

    def pump(self) -> int:
        n = super().pump()
        n += self.sweep_finished()
        return n

    # -- syncJob -------------------------------------------------------------
    def _owned_pods(self, job: Job) -> list[Pod]:
        pods, _rv = self.store.list(PODS)
        return [p for p in pods
                if p.namespace == job.namespace and not p.deleted
                and p.owner_ref is not None
                and p.owner_ref[:2] == ("Job", job.name)]

    def reconcile(self, job: Job) -> None:
        pods = self._owned_pods(job)
        # completion and failure LATCH (a terminal Job never re-runs):
        # succeeded counts survive their pods — PodGC/namespace sweeps
        # deleting finished pods must not resurrect the workload
        succeeded = max(job.succeeded if job.complete else 0,
                        sum(1 for p in pods if p.phase == "Succeeded"))
        failed = max(job.failed,
                     sum(1 for p in pods if p.phase == "Failed"))
        active = [p for p in pods if p.phase not in ("Succeeded", "Failed")]
        complete = job.complete or succeeded >= job.completions
        job_failed = job.job_failed or failed > job.backoff_limit

        created = 0
        if not complete and not job_failed:
            # active pods cover the remaining completions up to parallelism
            want = min(job.parallelism, job.completions - succeeded)
            from kubernetes_tpu_torch.apiserver.admission import AdmissionError
            for _ in range(max(0, want - len(active))):
                pod = self._template_pod(job)
                admitted = None
                try:
                    pod = admitted = self.admission.admit(PODS, pod, self.store)
                    self.store.create(PODS, pod)
                    created += 1
                except AlreadyExistsError:
                    self.admission.refund(PODS, admitted, self.store)
                    continue
                except AdmissionError as e:
                    self.recorder.event(
                        "Job", job.key, "Warning", "FailedCreate",
                        f"Error creating: {e}")
                    break
        elif active:
            # terminal job: active pods are torn down (job_controller.go
            # deletes running pods once the job fails; completed jobs have
            # no active pods by construction but clean up defensively)
            for p in active:
                try:
                    self.store.delete(PODS, p.key)
                except NotFoundError:
                    pass

        now = self._now()

        def mutate(cur):
            new_active = len(active) + created if not (complete or job_failed) else 0
            if (cur.active == new_active and cur.succeeded == succeeded
                    and cur.failed == failed and cur.complete == complete
                    and cur.job_failed == job_failed):
                return None
            cur.active = new_active
            cur.succeeded = succeeded
            cur.failed = failed
            if complete and not cur.complete:
                cur.completion_time = now
            if job_failed and not cur.job_failed and cur.completion_time is None:
                cur.completion_time = now
            cur.complete = complete
            cur.job_failed = job_failed
            return cur
        try:
            self.store.guaranteed_update(JOBS, job.key, mutate,
                                         allow_skip=True)
        except NotFoundError:
            return
        if complete and not job.complete:
            self.recorder.event("Job", job.key, NORMAL, "Completed",
                                f"Job completed ({succeeded} succeeded)")
        if job_failed and not job.job_failed:
            self.recorder.event(
                "Job", job.key, "Warning", "BackoffLimitExceeded",
                f"Job has reached the specified backoff limit "
                f"({failed} > {job.backoff_limit})")

    def _template_pod(self, job: Job) -> Pod:
        from kubernetes_tpu_torch.api.types import PodTemplate
        tmpl = job.template or PodTemplate()
        return tmpl.make_pod(
            f"{job.name}-{next(_suffix):x}", job.namespace,
            owner_ref=("Job", job.name, f"job-{job.name}"),
            extra_labels={JOB_NAME_LABEL: job.name})

    # -- ttl-after-finished (pkg/controller/ttlafterfinished) ----------------
    def sweep_finished(self) -> int:
        n = 0
        now = self._now()
        for j in self.informers.informer(JOBS).list():
            if j.ttl_seconds_after_finished is None:
                continue
            if not (j.complete or j.job_failed) or j.completion_time is None:
                continue
            if now - j.completion_time >= j.ttl_seconds_after_finished:
                try:
                    self.store.delete(JOBS, j.key)
                    n += 1
                except NotFoundError:
                    pass
        return n
