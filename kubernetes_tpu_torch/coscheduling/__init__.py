"""kubernetes_tpu_torch.coscheduling — all-or-nothing PodGroup placement.

The gang-scheduling subsystem: the `PodGroup` API object (types), the
queue's group-adjacent ordering + gang backoff map
(queue.scheduling_queue), the shell's atomic gang segment
(scheduler.Scheduler._gang_segment), the device group-boundary
checkpoint/rewind (core.tpu_scheduler.TPUScheduler.gang_checkpoint /
gang_rewind over kernels.gang_carry_checkpoint), the serial referee
trial (oracle.gang.GangTrial — burst gang decisions must stay
bit-identical to it), and the phase/timeout controller
(controllers.podgroup.PodGroupController).
"""
from kubernetes_tpu_torch.coscheduling.types import (   # noqa: F401
    LABEL_POD_GROUP, PHASE_PENDING, PHASE_PRESCHEDULING, PHASE_SCHEDULED,
    PHASE_UNSCHEDULABLE, PodGroup, pod_group_key, pod_group_name,
    pod_group_status_mutator,
)
