"""Pruned Kubernetes API data model — the subset the scheduler reads.

Mirrors the semantics (not the code) of the reference's `k8s.io/api/core/v1`
types as consumed by `pkg/scheduler` (reference: pkg/scheduler/nodeinfo/
node_info.go:47,139; pkg/apis/core/types.go). Quantities are plain integers:
CPU in milli-cores, memory/ephemeral-storage in bytes, scalar (extended)
resources in their native integer unit.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Iterable, Optional

# ---------------------------------------------------------------------------
# Resource names (reference: k8s.io/api/core/v1/types.go ResourceName)
# ---------------------------------------------------------------------------
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

# Default requests applied by priorities (NOT predicates) when a pod does not
# specify them (reference: algorithm/priorities/util/non_zero.go:31-34).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

# Zone/region well-known labels (reference: k8s.io/api/core/v1/well_known_labels.go)
LABEL_ZONE_FAILURE_DOMAIN = "failure-domain.beta.kubernetes.io/zone"
LABEL_ZONE_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_HOSTNAME = "kubernetes.io/hostname"

# Taint applied for `node.Spec.Unschedulable` (reference: pkg/scheduler/api/well_known_labels.go)
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"


def is_extended_resource_name(name: str) -> bool:
    """Reference: k8s.io/api/core/v1/helper.IsExtendedResourceName — any
    resource not in the default kubernetes.io namespace and not a native one."""
    if name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE, RESOURCE_PODS):
        return False
    if name.startswith("requests."):
        return False
    return "/" in name and not name.startswith("kubernetes.io/")


# ---------------------------------------------------------------------------
# Label selectors
# ---------------------------------------------------------------------------
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


@dataclass(frozen=True)
class Requirement:
    """One match expression: node-selector ops include Gt/Lt; label-selector
    ops are In/NotIn/Exists/DoesNotExist."""
    key: str
    op: str
    values: tuple[str, ...] = ()

    def matches(self, labels: dict[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key)
        if self.op == IN:
            return has and val in self.values
        if self.op == NOT_IN:
            # Reference labels.Requirement: NotIn also matches when key absent.
            return not has or val not in self.values
        if self.op == EXISTS:
            return has
        if self.op == DOES_NOT_EXIST:
            return not has
        if self.op in (GT, LT):
            # Reference: both label value and requirement value must parse as
            # integers; non-parse → no match.
            if not has:
                return False
            try:
                lv = int(val)
                rv = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lv > rv if self.op == GT else lv < rv
        raise ValueError(f"unknown selector op {self.op!r}")


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: match_labels AND match_expressions. A None
    selector matches nothing; an empty selector matches everything
    (reference: apimachinery LabelSelectorAsSelector)."""
    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[Requirement, ...] = ()

    @staticmethod
    def from_dict(match_labels: dict[str, str] | None = None,
                  match_expressions: Iterable[Requirement] = ()) -> "LabelSelector":
        return LabelSelector(
            match_labels=tuple(sorted((match_labels or {}).items())),
            match_expressions=tuple(match_expressions),
        )

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass(frozen=True)
class NodeSelectorTerm:
    """Terms are ORed; requirements within a term are ANDed. An empty term
    (no requirements) matches nothing (reference: predicates.go:889 comments)."""
    match_expressions: tuple[Requirement, ...] = ()

    def matches(self, labels: dict[str, str]) -> bool:
        if not self.match_expressions:
            return False
        return all(r.matches(labels) for r in self.match_expressions)


def node_selector_terms_match(terms: Iterable[NodeSelectorTerm], labels: dict[str, str]) -> bool:
    """ORed terms; empty list matches nothing (reference: predicates.go:833-838)."""
    return any(t.matches(labels) for t in terms)


# ---------------------------------------------------------------------------
# Affinity
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int  # 1-100
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    # None → matches all nodes; empty tuple → matches no node.
    required: Optional[tuple[NodeSelectorTerm, ...]] = None
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: Optional[LabelSelector]
    topology_key: str
    namespaces: tuple[str, ...] = ()  # empty → pod's own namespace


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int  # 1-100
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


def has_pod_affinity_terms(pod) -> bool:
    """True when the pod carries any inter-pod (anti-)affinity terms — the
    predicate behind NodeInfo.pods_with_affinity and the queue's
    assigned-pod wake-up filter."""
    a = pod.affinity
    return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)


# ---------------------------------------------------------------------------
# Taints & tolerations
# ---------------------------------------------------------------------------
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key with Exists → tolerates everything
    op: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty → matches all effects
    # None → tolerate forever; N → evictable N seconds after the NoExecute
    # taint lands (read by the node-lifecycle taint manager)
    toleration_seconds: Optional[float] = None

    def tolerates(self, taint: Taint) -> bool:
        """Reference: k8s.io/api/core/v1/toleration.go ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.op in (TOLERATION_OP_EXISTS, ""):
            # "" defaults to Equal in the API but Exists when key is empty;
            # we normalize: empty key + any op tolerates all keys only with Exists.
            if self.op == TOLERATION_OP_EXISTS:
                return True
            return self.value == taint.value
        if self.op == TOLERATION_OP_EQUAL:
            return self.value == taint.value
        return False


def tolerations_tolerate_taint(tolerations: Iterable[Toleration], taint: Taint) -> bool:
    return any(t.tolerates(taint) for t in tolerations)


def find_intolerable_taint(taints: Iterable[Taint], tolerations: Iterable[Toleration],
                           effect_filter) -> Optional[Taint]:
    """Reference: v1helper.TolerationsTolerateTaintsWithFilter — first
    filtered taint not tolerated, else None."""
    for taint in taints:
        if not effect_filter(taint):
            continue
        if not tolerations_tolerate_taint(tolerations, taint):
            return taint
    return None


# ---------------------------------------------------------------------------
# Containers & pods
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass(frozen=True)
class Container:
    name: str = ""
    image: str = ""
    # resource requests/limits; missing keys mean "not specified"
    requests: tuple[tuple[str, int], ...] = ()
    limits: tuple[tuple[str, int], ...] = ()
    ports: tuple[ContainerPort, ...] = ()

    @staticmethod
    def make(name: str = "", image: str = "",
             requests: dict[str, int] | None = None,
             limits: dict[str, int] | None = None,
             ports: Iterable[ContainerPort] = ()) -> "Container":
        return Container(name=name, image=image,
                         requests=tuple(sorted((requests or {}).items())),
                         limits=tuple(sorted((limits or {}).items())),
                         ports=tuple(ports))

    def requests_dict(self) -> dict[str, int]:
        return dict(self.requests)

    def limits_dict(self) -> dict[str, int]:
        return dict(self.limits)


# ---------------------------------------------------------------------------
# Volumes (pruned: the scheduler-relevant subset of v1.Volume / PV / PVC)
# ---------------------------------------------------------------------------
# volume plugins with per-node attach limits (predicates.go Max*VolumeCount)
PLUGIN_EBS = "ebs"
PLUGIN_GCE_PD = "gce-pd"
PLUGIN_AZURE_DISK = "azure-disk"
PLUGIN_CINDER = "cinder"
PLUGIN_CSI = "csi"

# reference defaults (volumeutil Default*VolumeLimit)
DEFAULT_VOLUME_LIMITS = {
    PLUGIN_EBS: 39,
    PLUGIN_GCE_PD: 16,
    PLUGIN_AZURE_DISK: 16,
    PLUGIN_CINDER: 256,
}


@dataclass(frozen=True)
class VolumeSource:
    """Pruned v1.Volume: either a direct backing volume (plugin + id) or a
    PVC reference."""
    name: str
    pvc: str = ""            # persistentVolumeClaim.claimName (same namespace)
    plugin: str = ""         # direct volume plugin (PLUGIN_*)
    volume_id: str = ""      # backing volume id for direct volumes
    read_only: bool = False


@dataclass
class PersistentVolume:
    """Pruned v1.PersistentVolume."""
    name: str
    plugin: str = ""
    volume_id: str = ""
    capacity: int = 0                       # bytes
    labels: dict[str, str] = field(default_factory=dict)  # zone/region labels
    storage_class: str = ""
    claim_ref: str = ""                     # "namespace/name" when bound
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "PersistentVolume":
        out = _shallow(self)
        out.labels = dict(self.labels)
        return out


@dataclass
class PersistentVolumeClaim:
    """Pruned v1.PersistentVolumeClaim."""
    name: str
    namespace: str = "default"
    request: int = 0                        # bytes
    storage_class: str = ""
    volume_name: str = ""                   # bound PV name
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "PersistentVolumeClaim":
        return _shallow(self)


def _shallow(obj):
    """Shallow copy skipping the copy protocol (__reduce_ex__/_reconstruct
    costs ~4x a plain dict copy, and clone() sits on the store's per-write
    hot path)."""
    cls = obj.__class__
    out = cls.__new__(cls)
    out.__dict__.update(obj.__dict__)
    return out


_pod_uid_counter = itertools.count(1)


@dataclass
class Pod:
    """Pruned v1.Pod: metadata + the spec/status fields the scheduler reads."""
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    # spec
    node_name: str = ""          # spec.nodeName (set by binding)
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: tuple[Toleration, ...] = ()
    containers: tuple[Container, ...] = ()
    init_containers: tuple[Container, ...] = ()
    priority: int = 0            # resolved PriorityClass value
    priority_class_name: str = ""   # resolved by the priority admission plugin
    scheduler_name: str = "default-scheduler"
    # defaulted to "default" by the serviceaccount admission plugin
    service_account_name: str = ""
    volumes: tuple[VolumeSource, ...] = ()
    # status
    nominated_node_name: str = ""
    phase: str = "Pending"
    conditions: tuple["PodCondition", ...] = ()
    start_time: Optional[float] = None
    # controller owner reference (kind, name, uid) — read by
    # NodePreferAvoidPods priority and selector-spread listers
    owner_ref: Optional[tuple[str, str, str]] = None
    # bookkeeping
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deleted: bool = False

    def __post_init__(self):
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}/{next(_pod_uid_counter)}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "Pod":
        """Fast copy: nested spec structures are frozen dataclasses and are
        shared; only the mutable dicts and top-level fields are fresh. The
        store uses this on every read/write (the serialize boundary)."""
        out = _shallow(self)
        out.labels = dict(self.labels)
        out.node_selector = dict(self.node_selector)
        return out


@dataclass(frozen=True)
class PodCondition:
    """Pruned v1.PodCondition (the scheduler writes PodScheduled=False with
    a reason/message on failure; reference: factory.go:715-726)."""
    type: str       # "PodScheduled", ...
    status: str     # "True" / "False" / "Unknown"
    reason: str = ""
    message: str = ""


POD_SCHEDULED = "PodScheduled"
CONDITION_TRUE = "True"
CONDITION_FALSE = "False"
# condition/event reasons (reference: v1.PodReasonUnschedulable,
# core/generic_scheduler.go SchedulerError usage in scheduler.go:350)
REASON_UNSCHEDULABLE = "Unschedulable"
REASON_SCHEDULER_ERROR = "SchedulerError"


@dataclass
class EventRecord:
    """Pruned v1.Event: the user-visible audit record the scheduler emits
    (reference: record.EventRecorder calls, scheduler.go:268,325,433).
    Aggregated by (object, reason, message) with a count like the
    reference's event correlator."""
    name: str
    involved_kind: str          # "Pod", ...
    involved_key: str           # namespace/name of the object
    type: str                   # "Normal" / "Warning"
    reason: str                 # "Scheduled", "FailedScheduling", "Preempted"
    message: str = ""
    count: int = 1
    namespace: str = "default"
    component: str = ""         # emitting component (v1.EventSource.Component)
    # bookkeeping
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "EventRecord":
        return _shallow(self)


@dataclass(frozen=True)
class ImageState:
    names: tuple[str, ...]
    size_bytes: int


@dataclass(frozen=True)
class NodeCondition:
    type: str       # Ready, MemoryPressure, DiskPressure, PIDPressure, ...
    status: str     # "True" / "False" / "Unknown"


@dataclass
class Node:
    """Pruned v1.Node."""
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    # spec
    taints: tuple[Taint, ...] = ()
    unschedulable: bool = False
    pod_cidr: str = ""        # allocated by controllers.nodeipam
    # scheduler.alpha.kubernetes.io/preferAvoidPods annotation, reduced to
    # the controller UIDs it names (reference: node_prefer_avoid_pods.go)
    prefer_avoid_pod_uids: tuple[str, ...] = ()
    # status
    allocatable: dict[str, int] = field(default_factory=dict)  # cpu(milli), memory(bytes), pods, ephemeral-storage, scalar
    images: tuple[ImageState, ...] = ()
    conditions: tuple[NodeCondition, ...] = ()
    # bookkeeping
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "Node":
        out = _shallow(self)
        out.labels = dict(self.labels)
        out.annotations = dict(self.annotations)
        out.allocatable = dict(self.allocatable)
        return out


def get_zone_key(node: Node) -> str:
    """Reference: pkg/util/node.GetZoneKey — region+":\\x00:"+zone from the
    failure-domain labels; empty string when both are empty."""
    region = node.labels.get(LABEL_ZONE_REGION, "")
    zone = node.labels.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if region == "" and zone == "":
        return ""
    return region + ":\x00:" + zone


# ---------------------------------------------------------------------------
# Workload objects used by SelectorSpread (services / RCs / RSs / STSs)
# ---------------------------------------------------------------------------
@dataclass
class Service:
    name: str
    namespace: str = "default"
    selector: dict[str, str] = field(default_factory=dict)  # empty → selects nothing
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PodTemplate:
    """Pruned v1.PodTemplateSpec — the pod shape workload controllers stamp
    out (reference: pkg/apis/core/types.go PodTemplateSpec as embedded in
    apps/batch workload specs)."""
    labels: dict[str, str] = field(default_factory=dict)
    containers: tuple[Container, ...] = ()
    node_selector: dict[str, str] = field(default_factory=dict)
    tolerations: tuple[Toleration, ...] = ()
    affinity: Optional[Affinity] = None
    priority_class_name: str = ""
    scheduler_name: str = "default-scheduler"

    def make_pod(self, name: str, namespace: str,
                 owner_ref: Optional[tuple[str, str, str]] = None,
                 extra_labels: Optional[dict[str, str]] = None,
                 node_name: str = "") -> Pod:
        labels = dict(self.labels)
        if extra_labels:
            labels.update(extra_labels)
        return Pod(
            name=name, namespace=namespace, labels=labels,
            containers=self.containers or (Container.make(name="c"),),
            node_selector=dict(self.node_selector),
            tolerations=self.tolerations, affinity=self.affinity,
            priority_class_name=self.priority_class_name,
            scheduler_name=self.scheduler_name,
            node_name=node_name, owner_ref=owner_ref)


@dataclass
class ReplicaSet:
    """Pruned apps/v1.ReplicaSet (also stands in for RC). `template` drives
    the pods the controller stamps out; None keeps the legacy
    selector-labels-only shape (reference: pkg/apis/apps/types.go
    ReplicaSetSpec)."""
    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    replicas: int = 1            # spec.replicas (PDB expected-scale source)
    template: Optional[PodTemplate] = None
    # set by the deployment controller on rollout-owned sets
    owner_ref: Optional[tuple[str, str, str]] = None
    # status (reconciled by controllers.replicaset)
    observed_replicas: int = 0
    ready_replicas: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Deployment:
    """Pruned apps/v1.Deployment: declarative rollout over owned
    ReplicaSets (reference: pkg/apis/apps/types.go DeploymentSpec;
    controller pkg/controller/deployment)."""
    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    replicas: int = 1
    template: Optional[PodTemplate] = None
    strategy: str = "RollingUpdate"        # RollingUpdate | Recreate
    max_surge: int = 1                     # rolling: extra pods allowed
    max_unavailable: int = 1               # rolling: pods that may be down
    paused: bool = False
    # status
    observed_revision: str = ""            # template hash of the newest RS
    updated_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Job:
    """Pruned batch/v1.Job: run-to-completion workload
    (reference: pkg/apis/batch/types.go JobSpec; controller
    pkg/controller/job)."""
    name: str
    namespace: str = "default"
    template: Optional[PodTemplate] = None
    completions: int = 1
    parallelism: int = 1
    backoff_limit: int = 6
    ttl_seconds_after_finished: Optional[float] = None
    # controller owner reference (kind, name, uid) — the CronJob controller
    # claims its Jobs through this, like pods carry owner_ref; the typed
    # tuple matters: serde rebuilds tuple[str, str, str] from JSON lists
    owner_ref: Optional[tuple[str, str, str]] = None
    # status
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    complete: bool = False
    job_failed: bool = False               # backoff limit exceeded
    completion_time: Optional[float] = None
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class DaemonSet:
    """Pruned apps/v1.DaemonSet. In the reference snapshot the DS controller
    schedules its own pods (sets nodeName directly,
    pkg/controller/daemon/daemon_controller.go:81) — mirrored here."""
    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    template: Optional[PodTemplate] = None
    # status
    desired_number_scheduled: int = 0
    current_number_scheduled: int = 0
    number_ready: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class StatefulSet:
    """Pruned apps/v1.StatefulSet: stable ordinal identities name-0..N-1,
    OrderedReady scale-up/down (reference: pkg/apis/apps/types.go
    StatefulSetSpec; controller pkg/controller/statefulset)."""
    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    template: Optional[PodTemplate] = None
    replicas: int = 1
    service_name: str = ""
    pod_management_policy: str = "OrderedReady"   # | Parallel
    # status
    current_replicas: int = 0
    ready_replicas: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class HorizontalPodAutoscaler:
    """Pruned autoscaling/v1.HorizontalPodAutoscaler (reference:
    pkg/apis/autoscaling/types.go; controller
    pkg/controller/podautoscaler/horizontal.go): CPU-utilization-driven
    scaling of a workload's replica count."""
    name: str
    namespace: str = "default"
    # scaleTargetRef — (kind, name); Deployment is the supported target
    scale_target_ref: tuple[str, str] = ("Deployment", "")
    min_replicas: int = 1
    max_replicas: int = 10
    # targetCPUUtilizationPercentage: desired avg usage / request percent
    target_cpu_utilization: int = 80
    # status
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization: Optional[int] = None
    last_scale_time: Optional[float] = None
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PodMetrics:
    """metrics.k8s.io PodMetrics stand-in (the metrics-server feed the HPA
    reads): per-pod CPU usage in millicores, keyed like the pod."""
    name: str
    namespace: str = "default"
    cpu_usage: int = 0                     # millicores
    window: float = 30.0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class CronJob:
    """Pruned batch/v1beta1.CronJob (reference: pkg/apis/batch/types.go;
    controller pkg/controller/cronjob/cronjob_controller.go): creates Jobs
    on a 5-field cron schedule."""
    name: str
    namespace: str = "default"
    schedule: str = "* * * * *"
    template: Optional[PodTemplate] = None
    completions: int = 1
    parallelism: int = 1
    suspend: bool = False
    # Allow | Forbid | Replace (cronjob_controller.go concurrencyPolicy)
    concurrency_policy: str = "Allow"
    starting_deadline_seconds: Optional[float] = None
    # status
    last_schedule_time: Optional[float] = None
    creation_time: Optional[float] = None
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Namespace:
    """Pruned v1.Namespace (cluster-scoped). DELETE moves it to Terminating;
    the namespace controller empties it then removes it (reference:
    pkg/controller/namespace finalization). `annotations` carries the
    scheduler.alpha.kubernetes.io/{defaultTolerations,tolerationsWhitelist}
    JSON the podtolerationrestriction admission plugin reads."""
    name: str
    phase: str = "Active"                  # Active | Terminating
    annotations: dict[str, str] = field(default_factory=dict)
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name


@dataclass
class ConfigMap:
    name: str
    namespace: str = "default"
    data: dict[str, str] = field(default_factory=dict)
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Secret:
    name: str
    namespace: str = "default"
    type: str = "Opaque"
    data: dict[str, str] = field(default_factory=dict)   # base64 by convention
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ServiceAccount:
    name: str
    namespace: str = "default"
    secrets: tuple[str, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PodDisruptionBudget:
    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    # spec: exactly one of min_available / max_unavailable; int or "N%"
    # (policy/v1beta1 PodDisruptionBudgetSpec). Both None = no reconcile
    # (tests that pin disruptions_allowed literals keep working).
    min_available: Optional[object] = None
    max_unavailable: Optional[object] = None
    # status (reconciled by controllers.disruption from pod state)
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease, pruned: one record serves BOTH the
    leader-election resourcelock (LeaderElectionRecord analog — `holder`,
    transitions) and the node heartbeat (NodeLease, kubelet
    nodelease.NewController): a node's kubelet renews `node-<name>` every
    lease interval, and the node-lifecycle controller grades Ready→Unknown
    from renew_time staleness instead of polling status fields."""
    name: str
    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration: float = 15.0
    leader_transitions: int = 0
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "Lease":
        return copy.copy(self)


def node_lease_key(node_name: str) -> str:
    """The per-node heartbeat Lease key (kube-node-lease namespace analog;
    shared by the hollow kubelet's renewer and the health monitor)."""
    return f"node-{node_name}"


@dataclass
class Endpoints:
    """Pruned v1.Endpoints — one subset: the ready backends of a Service.
    Addresses are (pod_key, node_name) pairs (no pod IPs exist in this
    model; the key is the routable identity). Reconciled by
    controllers.endpoints from the service selector."""
    name: str
    namespace: str = "default"
    addresses: tuple[tuple[str, str], ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "Endpoints":
        return _shallow(self)


@dataclass
class ResourceQuota:
    """Pruned v1.ResourceQuota: per-namespace hard caps on aggregate pod
    requests and object counts. `hard` / `used` map resource names
    ("cpu" milli, "memory" bytes, "pods") to totals; `used` is reconciled
    by controllers.resourcequota and enforced at admission
    (plugin/pkg/admission/resourcequota)."""
    name: str
    namespace: str = "default"
    hard: dict[str, int] = field(default_factory=dict)
    used: dict[str, int] = field(default_factory=dict)
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "ResourceQuota":
        out = _shallow(self)
        out.hard = dict(self.hard)
        out.used = dict(self.used)
        return out


@dataclass
class PriorityClass:
    """Pruned scheduling.k8s.io/v1beta1 PriorityClass — resolved into
    pod.priority by the priority admission plugin
    (plugin/pkg/admission/priority; the scheduler reads the resolved value
    via util.GetPodPriority)."""
    name: str
    value: int = 0
    global_default: bool = False
    description: str = ""
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "PriorityClass":
        return _shallow(self)


# ---------------------------------------------------------------------------
# Resource aggregate (reference: nodeinfo.Resource, node_info.go:139)
# ---------------------------------------------------------------------------
@dataclass
class ResourceAgg:
    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar: dict[str, int] = field(default_factory=dict)

    @staticmethod
    def from_allocatable(alloc: dict[str, int]) -> "ResourceAgg":
        r = ResourceAgg()
        for name, q in alloc.items():
            if name == RESOURCE_CPU:
                r.milli_cpu = q
            elif name == RESOURCE_MEMORY:
                r.memory = q
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                r.ephemeral_storage = q
            elif name == RESOURCE_PODS:
                r.allowed_pod_number = q
            else:
                r.scalar[name] = q
        return r

    def add_requests(self, requests: dict[str, int]) -> None:
        for name, q in requests.items():
            if name == RESOURCE_CPU:
                self.milli_cpu += q
            elif name == RESOURCE_MEMORY:
                self.memory += q
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage += q
            elif name != RESOURCE_PODS:
                self.scalar[name] = self.scalar.get(name, 0) + q

    def set_max(self, requests: dict[str, int]) -> None:
        """Reference: Resource.SetMaxResource — elementwise max (for init containers)."""
        for name, q in requests.items():
            if name == RESOURCE_CPU:
                self.milli_cpu = max(self.milli_cpu, q)
            elif name == RESOURCE_MEMORY:
                self.memory = max(self.memory, q)
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage = max(self.ephemeral_storage, q)
            elif name != RESOURCE_PODS:
                self.scalar[name] = max(self.scalar.get(name, 0), q)

    def clone(self) -> "ResourceAgg":
        return ResourceAgg(self.milli_cpu, self.memory, self.ephemeral_storage,
                           self.allowed_pod_number, dict(self.scalar))


def get_resource_request(pod: Pod) -> ResourceAgg:
    """Reference: predicates.GetResourceRequest (predicates.go:743) —
    sum over containers, then elementwise max with each init container."""
    r = ResourceAgg()
    for c in pod.containers:
        r.add_requests(c.requests_dict())
    for c in pod.init_containers:
        r.set_max(c.requests_dict())
    return r


def get_resource_limits(pod: Pod) -> ResourceAgg:
    """Reference: priorities/resource_limits.go:93 getResourceLimits — sum
    container limits, then elementwise max with each init container."""
    r = ResourceAgg()
    for c in pod.containers:
        r.add_requests(c.limits_dict())
    for c in pod.init_containers:
        r.set_max(c.limits_dict())
    return r


def get_nonzero_requests(requests: dict[str, int]) -> tuple[int, int]:
    """Reference: priorities/util/non_zero.go:38 — default 100m CPU / 200MB
    memory when *unset* (explicit zero stays zero)."""
    cpu = requests[RESOURCE_CPU] if RESOURCE_CPU in requests else DEFAULT_MILLI_CPU_REQUEST
    mem = requests[RESOURCE_MEMORY] if RESOURCE_MEMORY in requests else DEFAULT_MEMORY_REQUEST
    return cpu, mem


def get_pod_nonzero_requests(pod: Pod) -> tuple[int, int]:
    """Reference: priorities/resource_allocation.go:97 getNonZeroRequests —
    per-container defaulted sums (init containers are NOT considered)."""
    cpu = mem = 0
    for c in pod.containers:
        ccpu, cmem = get_nonzero_requests(c.requests_dict())
        cpu += ccpu
        mem += cmem
    return cpu, mem


def get_container_ports(*pods: Pod) -> list[ContainerPort]:
    """Reference: pkg/scheduler/util.GetContainerPorts — ports with HostPort>0."""
    out = []
    for pod in pods:
        for c in pod.containers:
            for p in c.ports:
                if p.host_port > 0:
                    out.append(p)
    return out
