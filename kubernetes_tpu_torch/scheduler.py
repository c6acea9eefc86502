"""Scheduler shell: owns the scheduling loop, one pod per cycle (or a burst
per launch), assume → bind pipeline, informer wiring, failure re-queue.

Mirrors pkg/scheduler/scheduler.go (New :121, Run :250, scheduleOne :438,
assume :382, bind :411, recordSchedulingFailure :266) and
pkg/scheduler/eventhandlers.go:319 AddAllEventHandlers. The algorithm is
pluggable: the device path (`use_device=True`, the default:
core.torch_scheduler.TorchScheduler on `device`, `cuda` by default) or the
port's copy of the oracle's generic scheduler (`use_device=False`);
binding I/O stays off the decision path like the reference's bind
goroutine (scheduler.go:523).

Copied from the reference (`kubernetes_tpu.scheduler`) with the port's
imports. What differs:
- `use_tpu=` is `use_device=` plus `device=`, and the device path is the
  default; the device algorithm is TorchScheduler, built with the
  arguments the reference gives its TPUScheduler except that its serial
  cycles stay on the device (`serial_path="device"`, not "adaptive"), and
  the burst classes take its class signature;
- the pod-row cache is the port's `ops.pod_rows.PodRowCache`;
- a decision extender (a filter, prioritize or preempt verb) routes
  scheduling to the port's `GenericScheduler` with its extender passes,
  by the reference's rule and with its warning; a bind-only extender keeps
  the device route and binds the pods it manages;
- the stale-node checks of a burst ask the store's `missing_keys` once
  for all of a launch's or a wave's hosts (one request on the remote
  client), where the reference probes `contains` a host;
- a wave's dedupe token carries a random per-instance id, where the
  reference numbers instances within a process: the port's remote client
  sends the token to the server, whose dedupe map outlives a scheduler
  process.
"""
from __future__ import annotations

import itertools
import threading
import time
import urllib.error
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch import chaos, obs
from kubernetes_tpu_torch.api.types import (
    Pod, Node, PodCondition, POD_SCHEDULED, CONDITION_FALSE,
    REASON_UNSCHEDULABLE, REASON_SCHEDULER_ERROR,
)
from kubernetes_tpu_torch.coscheduling.types import (
    PHASE_PRESCHEDULING, pod_group_key,
)
from kubernetes_tpu_torch.store.record import EventRecorder, NORMAL, WARNING
from kubernetes_tpu_torch.cache.cache import SchedulerCache, Snapshot
from kubernetes_tpu_torch.core import StaleNodeRefusal
from kubernetes_tpu_torch.oracle.gang import GangTrial
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    GenericScheduler, FitError, ScheduleResult, default_priority_configs,
)
from kubernetes_tpu_torch.queue.scheduling_queue import PriorityQueue
from kubernetes_tpu_torch.store.store import (
    Store, PODS, NODES, PODGROUPS, SERVICES, REPLICASETS, PDBS, PVS, PVCS,
    ConflictError, FencedError, NotFoundError,
)
from kubernetes_tpu_torch.oracle.volumes import VolumeListers, VolumeBinder
from kubernetes_tpu_torch.store.informer import InformerFactory
from kubernetes_tpu_torch.framework.v1alpha1 import (
    Framework, Registry, PluginContext, UNSCHEDULABLE as FW_UNSCHEDULABLE,
)
from kubernetes_tpu_torch.utils.clock import Clock, RealClock
from kubernetes_tpu_torch.utils.tracing import Trace, SLOW_CYCLE_THRESHOLD

DEFAULT_SCHEDULER_NAME = "default-scheduler"


# gang (PodGroup) scheduling observability — the obs catalogue additions:
# attempts by outcome, and how long a gang waited from group creation (or
# first sighting) to its committed placement
GANG_ATTEMPTS = obs.counter(
    "gang_attempts_total",
    "Atomic PodGroup placement attempts, by outcome: scheduled (whole "
    "gang committed), rejected (a member found no node — everything "
    "rewound, group parked), incomplete (fewer than minMember members "
    "queued), degraded (plugins/volumes force the per-pod path), "
    "error (members vanished between trial and commit).", ("outcome",))
GANG_WAIT = obs.histogram(
    "gang_wait_duration_seconds",
    "Seconds from PodGroup creation (or first scheduler sighting) to the "
    "gang's committed placement.",
    buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600))
STALE_BINDS = obs.counter(
    "stale_bind_requeues_total",
    "Bind decisions refused because the target node vanished between "
    "decision and commit (mid-burst node death): the pod is re-queued "
    "with backoff in creation order, and the dead node's device-mirror "
    "row, victim-table row, cache entry, and NodeTree slot are "
    "invalidated eagerly (the informer's DELETED event confirms later).")
CLUSTER_UTILIZATION = obs.gauge(
    "cluster_resource_utilization",
    "Cluster-wide requested/allocatable fill fraction by resource "
    "(cpu/memory/ephemeral_storage), computed from the scheduler's "
    "NodeInfo snapshot at collect time — the packing-lane report and "
    "the tuner reward's live input (round 22).", ("resource",))
COMMIT_RETRIES = obs.counter(
    "store_commit_retries_total",
    "commit_wave store-write retries by the scheduler's idempotent retry "
    "loop, by outcome: retried (another attempt followed), recovered (a "
    "retry landed — or deduped against a wave that had already landed "
    "under the same token), exhausted (all attempts failed; the per-pod "
    "crash-resolution path took over).", ("outcome",))

#: exception classes the commit retry loop treats as transient: the chaos
#: plane's injected store fault, transport-level failures (the remote
#: store), and server-side 5xx (classified by the remote client)
def _retryable_store_error(exc: BaseException) -> bool:
    if isinstance(exc, chaos.SchedulerCrash):
        return False                 # a crash stand-in is never "transient"
    if isinstance(exc, chaos.InjectedFault):
        return True
    if isinstance(exc, (urllib.error.URLError, OSError, TimeoutError)):
        return True
    code = getattr(exc, "code", None)
    return code in (500, 502, 503, 504)


class Histogram:
    """Prometheus-style cumulative histogram (reference buckets:
    ExponentialBuckets(0.001, 2, 15), metrics.go:93)."""

    BOUNDS = tuple(0.001 * 2 ** i for i in range(15))

    def __init__(self):
        self.buckets = [0] * len(self.BOUNDS)
        self.count = 0
        self.sum = 0.0

    def observe(self, seconds: float) -> None:
        self.observe_many(seconds, 1)

    def observe_many(self, seconds: float, count: int) -> None:
        """`count` identical observations in one pass — the burst commit
        records its per-pod share without 10k bucket walks."""
        if count <= 0:
            return
        self.count += count
        self.sum += seconds * count
        for i, b in enumerate(self.BOUNDS):
            if seconds <= b:
                self.buckets[i] += count

    def __eq__(self, other) -> bool:
        return (isinstance(other, Histogram)
                and self.buckets == other.buckets
                and self.count == other.count and self.sum == other.sum)

    def render(self, name: str, labels: str = "") -> list[str]:
        sep = "," if labels else ""
        out = []
        for i, b in enumerate(self.BOUNDS):
            out.append(f'{name}_bucket{{{labels}{sep}le="{b:g}"}} '
                       f'{self.buckets[i]}')
        out.append(f'{name}_bucket{{{labels}{sep}le="+Inf"}} {self.count}')
        out.append(f'{name}_sum{{{labels}}} {self.sum:.6f}'
                   if labels else f'{name}_sum {self.sum:.6f}')
        out.append(f'{name}_count{{{labels}}} {self.count}'
                   if labels else f'{name}_count {self.count}')
        return out


@dataclass
class SchedulerMetrics:
    """Counter mirror of pkg/scheduler/metrics/metrics.go."""
    schedule_attempts: dict[str, int] = field(default_factory=lambda: {
        "scheduled": 0, "unschedulable": 0, "error": 0})
    binding_count: int = 0
    preemption_attempts: int = 0
    preemption_victims: int = 0
    e2e_latency_sum: float = 0.0
    # per-phase duration histograms (scheduling_duration_seconds{operation},
    # metrics.go:67-169) — device-shaped phases: encode (host feature
    # encoding), kernel (device dispatch), fetch (device->host readback),
    # plus the reference's algorithm/preemption/binding/e2e
    phase_duration: dict[str, "Histogram"] = field(default_factory=dict)
    binding_duration: "Histogram" = field(default_factory=lambda: Histogram())
    e2e_duration: "Histogram" = field(default_factory=lambda: Histogram())

    def observe(self, result: str, count: int = 1) -> None:
        self.schedule_attempts[result] = \
            self.schedule_attempts.get(result, 0) + count

    def observe_phase(self, phase: str, seconds: float,
                      count: int = 1) -> None:
        h = self.phase_duration.get(phase)
        if h is None:
            h = self.phase_duration[phase] = Histogram()
        h.observe_many(seconds, count)

    def reset(self) -> None:
        """DELETE /metrics analog. Re-derives every field from the
        dataclass defaults, so a newly added field can never be silently
        missed the way the old hand-copied reset_metrics field list could
        (a fresh instance IS the definition of 'reset')."""
        import dataclasses
        fresh = type(self)()
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))


class Scheduler:
    """One scheduler instance: queue + cache + algorithm + binder."""

    # slow-cycle trace threshold (generic_scheduler.go:186 uses 100ms): a
    # serial cycle slower than this logs its step timeline via utils.Trace
    slow_cycle_threshold = SLOW_CYCLE_THRESHOLD

    def __init__(self, store: Store,
                 scheduler_name: str = DEFAULT_SCHEDULER_NAME,
                 algorithm=None,
                 use_device: bool = True,
                 device=None,
                 percentage_of_nodes_to_score: int = 50,
                 hard_pod_affinity_weight: int = 1,
                 clock: Optional[Clock] = None,
                 disable_preemption: bool = False,
                 plugin_registry: Optional[Registry] = None,
                 plugins_enabled: Optional[list] = None,
                 plugin_args: Optional[dict] = None,
                 predicate_names: Optional[list] = None,
                 priority_weights: Optional[dict] = None,
                 extenders: Optional[list] = None,
                 mesh=None,
                 profiles=None):
        self.store = store
        self.name = scheduler_name
        # scheduling profiles (round 19): a profiles.ProfileSet makes THIS
        # process serve every named profile — responsibility is membership
        # in the set (unknown schedulerNames are REPORTED, never
        # default-scored), per-pod scoring selects the profile's weight
        # row ([profiles x priorities] tensor on the device path, per-profile
        # PriorityConfig lists on the oracle path), and rank-aware
        # profiles turn on gang set-scoring. Mutually exclusive with the
        # single-vector priority_weights.
        if profiles is not None:
            if priority_weights is not None:
                raise ValueError(
                    "profiles and priority_weights are mutually exclusive")
            profiles.validate()
        self.profiles = profiles
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.recorder = EventRecorder(store, component=scheduler_name)
        self.clock = clock or RealClock()
        self.cache = SchedulerCache(clock=self.clock)
        self.queue = PriorityQueue(clock=self.clock)
        self.metrics = SchedulerMetrics()
        self.informers = InformerFactory(store)
        self.disable_preemption = disable_preemption
        self._snapshot = Snapshot()
        self._stop = threading.Event()
        self._bind_threads: list[threading.Thread] = []
        # idempotent commit retry: one fresh token per wave (REUSED across
        # that wave's retries) keys the store's dedupe map. The prefix is
        # unique per instance across processes (a random id, not a process
        # counter): fleet peers sharing a profile name, and a scheduler
        # restarted against a long-lived apiserver, must never have a wave
        # answered from another instance's recorded result
        self._wave_seq = itertools.count(1)
        self._token_prefix = f"{scheduler_name}#{uuid.uuid4().hex}"
        # fleet mode (round 18): when set, every wave/bind write carries
        # the instance's live partition-lease fencing tokens — a write
        # from a superseded claim is rejected whole by the store
        # (FencedError) and its pods are dropped to the claim's new
        # holder instead of re-queued
        self.fence_provider: Optional[Callable[[], Optional[list]]] = None
        self.fenced_waves = 0
        # crash-restart recovery context: while a burst's windows commit,
        # this tracks the exact walk-counter/rotation boundary of the
        # committed prefix plus the window in flight — recover() reads it
        # to resume with decisions matching an oracle that never crashed
        self._crash_ctx: Optional[dict] = None
        services = self.informers.informer(SERVICES)
        replicasets = self.informers.informer(REPLICASETS)
        self._services_fn = services.list
        self._replicasets_fn = replicasets.list
        # volume-aware scheduling (volumebinder bridge)
        self.volume_listers = VolumeListers(
            pvcs_fn=self.informers.informer(PVCS).list,
            pvs_fn=self.informers.informer(PVS).list)
        self.volume_binder = VolumeBinder(self.volume_listers, store=store)
        # gang scheduling: the PodGroup informer (registered here so
        # sync()/pump() carry it) + first-sighting times for the
        # wait-duration histogram when a group has no creation timestamp
        self._podgroups = self.informers.informer(PODGROUPS)
        self._gang_first_seen: dict[str, float] = {}
        self._predicate_names = predicate_names
        self._priority_weights = priority_weights
        # encode-at-admission pod-row cache (round 17): per-pod feature
        # rows + interned class signatures are computed ONCE at informer
        # delivery and gathered at window planning, instead of re-encoded
        # on every window's critical path. Only the device burst algorithm
        # reads it (the oracle shell decides per pod anyway); the
        # bit-identity contract (cached row == fresh encode, pod_rows
        # fuzz) keeps decisions oracle-parity by construction.
        self.pod_rows = None
        self.extenders = extenders or []
        self._extender_binder = next(
            (e for e in self.extenders if e.is_binder), None)
        decision_extenders = [
            e for e in self.extenders
            if e.config.filter_verb or e.config.prioritize_verb
            or e.config.preempt_verb]
        if use_device and decision_extenders and algorithm is None:
            # decision-affecting extenders need per-node host_priority and
            # HTTP round trips the device path doesn't model; silently
            # ignoring them would change decisions, so route scheduling
            # through the generic scheduler instead (bind-only extenders
            # keep the device path: binding already goes through
            # _extender_binder)
            import warnings
            warnings.warn("filter/prioritize extenders configured: scheduling "
                          "runs on the oracle path, not the device kernel "
                          "path")
            use_device = False
        if algorithm is not None:
            self.algorithm = algorithm
        elif use_device:
            from kubernetes_tpu_torch.core.torch_scheduler import (
                TorchScheduler)
            self.algorithm = TorchScheduler(
                percentage_of_nodes_to_score=percentage_of_nodes_to_score,
                hard_pod_affinity_weight=hard_pod_affinity_weight,
                services_fn=self._services_fn,
                replicasets_fn=self._replicasets_fn,
                nominated=self.queue.nominated,
                volume_listers=self.volume_listers,
                volume_binder=self.volume_binder,
                node_tree=self.cache.node_tree,
                # single-pod cycles run on the device (K2) like every
                # other decision of the shell
                serial_path="device",
                # "auto" shards the node axis over every visible card
                # (parallel/sharding.py); the factory/CLI path opts in
                mesh=mesh,
                # the shell only consumes the suggested host + failure
                # reasons; skipping the per-node score readback saves a
                # full-vector transfer every cycle
                collect_host_priority=False,
                # `cuda` unless the caller asks for the plain versions
                # ("cpu", as the tests do)
                device=device)
            self.algorithm.metrics = self.metrics   # encode/kernel/fetch phases
            from kubernetes_tpu_torch.ops.pod_rows import PodRowCache
            self.pod_rows = PodRowCache(
                profile_fn=(profiles.index_of if profiles is not None
                            else None))
            self.algorithm.pod_rows = self.pod_rows
            if profiles is not None:
                self.algorithm.set_profiles(profiles)
            if hasattr(store, "contains"):
                # mid-burst node-death detection: the wave drivers scan
                # each launch's decisions against the store after the
                # packed fetch and refuse the launch whole (StaleNodeRefusal
                # -> _burst_segment invalidates + replans) when a node
                # vanished under it
                self.algorithm.stale_scan = self._stale_scan
            if priority_weights is not None:
                from kubernetes_tpu_torch.factory import tpu_kernel_weights
                self.algorithm.weights = tpu_kernel_weights(priority_weights)
                self.algorithm.priority_name_weights = priority_weights
            if predicate_names is not None:
                self.algorithm.enabled_predicates = set(predicate_names)
                self.algorithm.check_resources = bool(
                    {"GeneralPredicates", "PodFitsResources"} & set(predicate_names))
        else:
            self.algorithm = GenericScheduler(
                percentage_of_nodes_to_score=percentage_of_nodes_to_score,
                hard_pod_affinity_weight=hard_pod_affinity_weight,
                nominated_pods_fn=self.queue.nominated.pods_for_node)
            self.algorithm.extenders = self.extenders
        if profiles is not None:
            # per-profile PriorityConfig lists (the oracle/serial scoring
            # side of the tensor rows — same vectors, pinnable parity)
            self._profile_configs = [
                profiles.oracle_configs(
                    i, services_fn=self._services_fn,
                    replicasets_fn=self._replicasets_fn,
                    hard_pod_affinity_weight=hard_pod_affinity_weight)
                for i in range(len(profiles))]
            self._priority_configs = self._profile_configs[0]
        elif priority_weights is not None:
            from kubernetes_tpu_torch.factory import build_priority_configs
            self._profile_configs = None
            self._priority_configs = build_priority_configs(
                priority_weights, services_fn=self._services_fn,
                replicasets_fn=self._replicasets_fn,
                hard_pod_affinity_weight=hard_pod_affinity_weight)
        else:
            self._profile_configs = None
            self._priority_configs = default_priority_configs(
                services_fn=self._services_fn, replicasets_fn=self._replicasets_fn,
                hard_pod_affinity_weight=hard_pod_affinity_weight)
        # plugin framework (framework/v1alpha1: registry -> per-point slices)
        self.framework = Framework(
            plugin_registry if plugin_registry is not None else Registry(),
            plugin_args=plugin_args,
            snapshot_fn=lambda: self._snapshot.node_infos,
            store=store, enabled=plugins_enabled)
        self._add_all_event_handlers()
        self._register_debug()

    def _note_profile_scheduled(self, pods: list) -> None:
        """Book successful bindings on the per-profile scheduled counter
        (scheduler_profile_scheduled_total + the /debug/sched section)."""
        if self.profiles is None:
            return
        for p in pods:
            pid = self.profiles.index_of(p.scheduler_name)
            if pid is not None:
                self.profiles.note_scheduled(pid)

    def _register_debug(self) -> None:
        """Publish this scheduler's /debug/sched sections (queue depths,
        parked gangs, device mirror, ledger) into the obs debug registry.
        Weakref-held: a dropped scheduler's section silently disappears
        instead of pinning the whole object graph (latest instance wins,
        matching the one-scheduler-per-process deployment shape)."""
        import weakref
        ref = weakref.ref(self)

        def snap():
            s = ref()
            if s is None:
                return None
            return s.debug_state()
        obs.register_debug("scheduler", snap)
        # cluster_resource_utilization{resource}: callback gauges over
        # the live snapshot (read at collect time — /metrics and the
        # timeseries scraper see the CURRENT fill, no push cadence).
        # Latest scheduler wins per child, same as the debug sections.
        # The children read the snapshot's utilization sums, which
        # update_snapshot keeps (the reference walks every node of the
        # snapshot for each child: ~14 ms at 15,000 nodes on one host
        # core, three times a time-series sample).
        for res in ("cpu", "memory", "ephemeral_storage"):
            def _util_reader(r=res):
                s = ref()
                if s is None:
                    return float("nan")
                from kubernetes_tpu_torch.cache.node_info import (
                    utilization_of)
                return utilization_of(s._snapshot.sums)[r]
            CLUSTER_UTILIZATION.labels(res).set_function(_util_reader)
        if self.profiles is not None:
            # loaded profiles, weight rows, per-profile scheduled counts
            pref = weakref.ref(self.profiles)

            def psnap():
                ps = pref()
                return None if ps is None else ps.debug_state()
            obs.register_debug("profiles", psnap)

    def reload_profiles(self) -> None:
        """Re-derive every profile-dependent cache after a ProfileSet row
        write (the tuner's set_row): the per-profile oracle
        PriorityConfig lists AND the device-side weight tensor (the device
        algorithm's set_profiles clears _ptab/_wtab_dev/_union_weights/
        _profile_static so the next launch gathers the NEW rows). A
        serving scheduler that skips this keeps scoring with the stale
        tensor — the write is not live until reload."""
        if self.profiles is None:
            return
        self._profile_configs = [
            self.profiles.oracle_configs(
                i, services_fn=self._services_fn,
                replicasets_fn=self._replicasets_fn,
                hard_pod_affinity_weight=self.hard_pod_affinity_weight)
            for i in range(len(self.profiles))]
        self._priority_configs = self._profile_configs[0]
        set_prof = getattr(self.algorithm, "set_profiles", None)
        if set_prof is not None:
            set_prof(self.profiles)

    def debug_state(self) -> dict:
        from kubernetes_tpu_torch.obs.ledger import LEDGER
        from kubernetes_tpu_torch.cache.node_info import utilization_of
        out = {
            "name": self.name,
            "queue": self.queue.debug_state(),
            "ledger": LEDGER.debug_state(),
            "utilization": utilization_of(self._snapshot.sums),
        }
        algo_dbg = getattr(self.algorithm, "debug_state", None)
        if algo_dbg is not None:
            out["device"] = algo_dbg()
        store_dbg = getattr(self.store, "debug_state", None)
        if store_dbg is not None:
            out["store"] = store_dbg()
        return out

    # -- event handlers (reference: eventhandlers.go:319) --------------------
    def _responsible_for(self, pod: Pod) -> bool:
        if self.profiles is not None:
            # multi-profile responsibility: any profile in the set claims
            # the pod; an unknown schedulerName is REPORTED (counter +
            # event, once per uid) and refused — never silently scored by
            # the default profile
            if self.profiles.index_of(pod.scheduler_name) is None:
                self.profiles.report_unknown(pod, recorder=self.recorder)
                return False
            return True
        return pod.scheduler_name == self.name

    def _add_all_event_handlers(self) -> None:
        pods = self.informers.informer(PODS)
        # assigned pods -> cache
        pods.add_event_handler(
            on_add=self._add_pod_to_cache,
            on_update=self._update_pod_in_cache,
            on_delete=self._delete_pod_from_cache,
            on_delete_many=self._delete_pods_from_cache,
            filter_fn=lambda p: bool(p.node_name))
        # unassigned pods owned by this scheduler -> queue (adds, updates,
        # and deletes all arrive in informer run batches: one queue lock +
        # one heap push / row-cache pass per batch, and the pod-row
        # cache encodes each row here — at delivery — so window planning
        # gathers instead of re-encoding)
        pods.add_event_handler(
            on_add=self._add_pod_to_queue,
            on_add_many=self._add_pods_to_queue,
            on_update=self._update_pod_in_queue,
            on_update_many=self._update_pods_in_queue,
            on_delete=self._delete_pod_from_queue,
            on_delete_many=self._delete_pods_from_queue,
            filter_fn=lambda p: not p.node_name and self._responsible_for(p))
        nodes = self.informers.informer(NODES)
        nodes.add_event_handler(
            on_add=self._add_node, on_update=self._update_node,
            on_delete=self._delete_node)
        # service/RS/PDB events wake the queue (eventhandlers.go:32-86)
        for kind in (SERVICES, REPLICASETS, PDBS):
            self.informers.informer(kind).add_event_handler(
                on_add=lambda _o: self.queue.move_all_to_active(),
                on_update=lambda _o, _n: self.queue.move_all_to_active(),
                on_delete=lambda _o: self.queue.move_all_to_active())

    def _add_pod_to_cache(self, pod: Pod) -> None:
        self.cache.add_pod(pod)
        self.queue.assigned_pod_added(pod)

    def _update_pod_in_cache(self, old: Pod, new: Pod) -> None:
        if self._skip_pod_update(old, new):
            return
        self.cache.update_pod(old, new)
        self.queue.assigned_pod_updated(new)

    def _skip_pod_update(self, old: Pod, new: Pod) -> bool:
        """Ignore self-inflicted updates on assumed pods — but only when the
        diff is limited to resourceVersion / nodeName / status-ish fields;
        real label/spec changes must reach the cache
        (reference: eventhandlers.go:275 skipPodUpdate)."""
        if not self.cache.is_assumed_pod(new):
            return False
        assumed = self.cache.get_pod(new)
        if assumed is None:
            return False

        def sanitize(p: Pod) -> Pod:
            # reference skipPodUpdate strips ResourceVersion, spec.NodeName,
            # and the ENTIRE status (eventhandlers.go:275-315) — kubelet
            # status writes (phase, conditions, startTime) on an assumed pod
            # must not look like real updates
            c = p.clone()
            c.resource_version = 0
            c.node_name = ""
            c.nominated_node_name = ""
            c.phase = "Pending"
            c.conditions = ()
            c.start_time = None
            return c

        return sanitize(assumed) == sanitize(new)

    def _delete_pod_from_cache(self, pod: Pod) -> None:
        self.cache.remove_pod(pod)
        self.queue.move_all_to_active()

    def _delete_pods_from_cache(self, pods: list) -> None:
        """Batched delete run (round 23): per-pod cache removal, then ONE
        move_all_to_active for the whole run — the per-event loop would
        re-walk the unschedulable map once per delete."""
        for pod in pods:
            self.cache.remove_pod(pod)
        self.queue.move_all_to_active()

    def _add_pod_to_queue(self, pod: Pod) -> None:
        if self.pod_rows is not None:
            self.pod_rows.insert(pod)
        self.queue.add(pod)

    def _add_pods_to_queue(self, pods: list) -> None:
        """Batched informer delivery: encode every row once, then ONE
        queue lock + one heap-core push for the whole batch."""
        if self.pod_rows is not None:
            self.pod_rows.insert_many(pods)
        self.queue.add_many(pods)

    def _update_pod_in_queue(self, old: Pod, new: Pod) -> None:
        if self.pod_rows is not None:
            # update-in-place: same uid, new resourceVersion — re-encode
            # at delivery so the window gathers the NEW spec's row
            self.pod_rows.insert(new)
        self.queue.update(old, new)

    def _update_pods_in_queue(self, pairs: list) -> None:
        """Batched informer update run (round 23): re-encode every row
        once, then ONE queue lock for the whole run."""
        if self.pod_rows is not None:
            self.pod_rows.insert_many([new for _old, new in pairs])
        self.queue.update_many(pairs)

    def _delete_pod_from_queue(self, pod: Pod) -> None:
        if self.pod_rows is not None:
            # covers real deletes AND the unassigned->assigned transition
            # (the filtering handler delivers it as a delete of the old
            # object): a bound or gone pod's row is never gathered again
            self.pod_rows.invalidate(pod)
        self.queue.delete(pod)

    def _delete_pods_from_queue(self, pods: list) -> None:
        """Batched informer delete run (round 23): one row-cache
        invalidation pass + ONE queue lock for the whole run."""
        if self.pod_rows is not None:
            self.pod_rows.invalidate_many(pods)
        self.queue.delete_many(pods)

    def _add_node(self, node: Node) -> None:
        self.cache.add_node(node)
        self.queue.move_all_to_active()

    def _update_node(self, old: Node, new: Node) -> None:
        self.cache.update_node(old, new)
        if self._node_scheduling_properties_changed(old, new):
            self.queue.move_all_to_active()

    @staticmethod
    def _node_scheduling_properties_changed(old: Node, new: Node) -> bool:
        """Reference: eventhandlers.go:424 — only allocatable / labels /
        taints / unschedulable / condition changes wake the queue."""
        return (old.allocatable != new.allocatable
                or old.labels != new.labels
                or old.taints != new.taints
                or old.unschedulable != new.unschedulable
                or old.conditions != new.conditions)

    def _delete_node(self, node: Node) -> None:
        self.cache.remove_node(node)

    # -- lifecycle -----------------------------------------------------------
    def sync(self) -> None:
        self.informers.sync_all()

    def pump(self) -> int:
        return self.informers.pump_all()

    # -- one cycle (reference: scheduleOne :438) ------------------------------
    def schedule_one(self, timeout: Optional[float] = 0.05) -> bool:
        """Pop + schedule + assume + bind one pod. Returns False when the
        queue stayed empty for `timeout`."""
        pod = self.queue.pop(timeout=timeout)
        if pod is None:
            return False
        if pod.deleted:
            # reference: scheduler.go:447 skip-deleting-pod event
            self.recorder.pod_event(pod, WARNING, "FailedScheduling",
                                    f"skip schedule deleting pod: {pod.key}")
            return True
        gk = pod_group_key(pod)
        if gk is not None:
            # a gang member must never schedule alone: gather the rest of
            # its group from the activeQ and run the atomic gang segment
            # (the serial loop and the burst loop share one gang path)
            members = [(pod, self.queue.scheduling_cycle)]
            members += self.queue.pop_group(gk)
            self._gang_segment(gk, members, bucket=len(members))
            return True
        self._process_one(pod, self.queue.scheduling_cycle)
        return True

    def _process_one(self, pod: Pod, cycle: int,
                     names: Optional[list[str]] = None) -> bool:
        """Schedule + assume + bind one already-popped pod. `names` reuses an
        already-consumed NodeTree enumeration (burst bookkeeping) instead of
        consuming a fresh one. Returns True when the pod was bound (or its
        bind was dispatched to a permit-waiting bind thread)."""
        start = self.clock.now()
        # utiltrace analog (generic_scheduler.go:185): per-cycle step
        # timeline, logged only when the cycle is slow. Spans for the
        # cycle land in the obs ring buffer regardless (bounded, cheap).
        cycle_trace = Trace(f"scheduling cycle {pod.key}",
                            threshold=self.slow_cycle_threshold)
        crashed = False
        try:
            return self._process_one_traced(pod, cycle, names, start,
                                            cycle_trace)
        except chaos.SchedulerCrash:
            crashed = True   # freeze the recovery context for recover()
            raise
        finally:
            if not crashed:
                # a completed (or ordinarily failed) cycle leaves no
                # window in flight — stale contexts must not survive it
                self._crash_ctx = None
            if cycle_trace.log_if_long():
                cycle_trace.emit_spans()

    def _process_one_traced(self, pod: Pod, cycle: int,
                            names: Optional[list[str]], start: float,
                            cycle_trace: Trace) -> bool:
        # mid-stream node death, serial twin: the node.dead seam's
        # pre-cycle crossing lands a kill HERE — before this cycle's
        # decision — and the reconciliation sweep folds any store-side
        # node deletion into the cache/tree/mirror immediately, so the
        # decision (and a FitError's preemption scan) runs against the
        # post-churn world exactly like a burst launch the stale scan
        # refused. O(1) when nothing died.
        chaos.node_dead_point("pre-cycle")
        if self._reconcile_node_deaths() and names is not None:
            # the enumeration the caller consumed (a refused burst's
            # pre-drawn walk, or a burst tail's) describes a world that
            # still contained the dead node: discard it and re-ground on
            # a fresh post-churn enumeration, exactly what a serial loop
            # that saw the death before this cycle would draw
            names = None
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        cycle_trace.step("snapshot updated")
        if names is None:
            # serial-cycle crash bracket: checkpoint the rotation BEFORE
            # this cycle's enumeration so a crash between decision and a
            # landed bind recovers to the pre-decision boundary (the
            # re-queued pod then re-derives the identical decision)
            tree_chk = self.cache.node_tree.checkpoint()
            self._ctx_open(tree_chk)
            names = self.cache.node_tree.list_names()
        self._last_names = names
        try:
            t_alg = self.clock.now()
            try:
                result = self._schedule(pod, names)
            finally:
                self.metrics.observe_phase("algorithm",
                                           self.clock.now() - t_alg)
                cycle_trace.step("scheduling algorithm")
                # ledger: the serial cycle has no separate device
                # dispatch/fetch boundary — one stamp keeps the per-pod
                # phase decomposition telescoping on every path
                from kubernetes_tpu_torch.obs.ledger import LEDGER
                LEDGER.stamp_serial(pod.key)
        except FitError as err:
            self.metrics.observe("unschedulable")
            if not self.disable_preemption:
                t_pre = self.clock.now()
                self._preempt(pod, err)
                self.metrics.observe_phase("preemption",
                                           self.clock.now() - t_pre)
                cycle_trace.step("preemption")
            self._record_failure(pod, cycle, REASON_UNSCHEDULABLE, str(err))
            return False
        except Exception as err:
            self.metrics.observe("error")
            self._record_failure(pod, cycle, REASON_SCHEDULER_ERROR, str(err))
            raise
        if self._crash_ctx is not None:
            # window bracket for this cycle's bind: before = pre-decision
            # boundary, after = the advanced counters + one enumeration
            c = self._crash_ctx
            self._ctx_window(
                {"li0": c["li"], "lni0": c["lni"], "committed0": 0,
                 "li1": getattr(self.algorithm, "last_index", 0),
                 "lni1": getattr(self.algorithm, "last_node_index", 0),
                 "committed1": 1},
                [pod.key], [result.suggested_host])
        assumed = pod.clone()
        assumed.node_name = result.suggested_host
        ctx = PluginContext()
        if assumed.volumes:
            node = self._snapshot.node_infos[result.suggested_host].node
            reservations = self.volume_binder.assume_pod_volumes(assumed, node)
            ctx.write("volume-reservations", reservations)
        # Reserve point (scheduler.go:507)
        st = self.framework.run_reserve_plugins(ctx, assumed, result.suggested_host)
        if not st.is_success():
            # release whatever earlier reserve plugins took (the v1alpha1
            # reference skips this; later versions unreserve here too)
            self.framework.run_unreserve_plugins(ctx, assumed, result.suggested_host)
            self.metrics.observe("error")
            self._record_failure(pod, cycle, REASON_SCHEDULER_ERROR, st.message)
            return False
        try:
            self.cache.assume_pod(assumed)
        except Exception as err:
            self.framework.run_unreserve_plugins(ctx, assumed, result.suggested_host)
            self.metrics.observe("error")
            self._record_failure(pod, cycle, REASON_SCHEDULER_ERROR, str(err))
            return False
        self.queue.nominated.delete(pod)
        cycle_trace.step("pod assumed")
        # Permit may WAIT: when permit plugins exist, bind runs off the
        # scheduling thread like the reference's bind goroutine
        # (scheduler.go:523) so allow()/reject() can come from this loop
        if self.framework.permit:
            t = threading.Thread(
                target=self._bind,
                args=(assumed, result.suggested_host, pod, cycle, ctx),
                daemon=True)
            t.start()
            self._bind_threads.append(t)
            cycle_trace.step("binding dispatched")
            bound = True   # outcome unknown until the thread resolves
        else:
            bound = self._bind(assumed, result.suggested_host, pod, cycle,
                               ctx)
            cycle_trace.step("binding")
        e2e = self.clock.now() - start
        self.metrics.e2e_latency_sum += e2e
        self.metrics.e2e_duration.observe(e2e)
        return bound

    def wait_for_binds(self, timeout: float = 5.0) -> None:
        """Join outstanding async bind threads (test/shutdown helper)."""
        for t in self._bind_threads:
            t.join(timeout)
        self._bind_threads = [t for t in self._bind_threads if t.is_alive()]

    def _pod_priority_configs(self, pod: Pod) -> list:
        """The oracle-path PriorityConfig list for one pod: its profile's
        vector when profiles are configured, else the single set."""
        if self._profile_configs is not None:
            pid = self.profiles.index_of(pod.scheduler_name)
            return self._profile_configs[0 if pid is None else pid]
        return self._priority_configs

    def _schedule(self, pod: Pod, names: list[str],
                  extra_configs=None) -> ScheduleResult:
        if isinstance(self.algorithm, GenericScheduler):
            from kubernetes_tpu_torch.factory import (
                build_predicate_set, DEFAULT_PREDICATE_NAMES)
            funcs = build_predicate_set(
                self._predicate_names or DEFAULT_PREDICATE_NAMES,
                self._snapshot.node_infos,
                volume_listers=self.volume_listers,
                volume_binder=self.volume_binder,
                services_fn=self._services_fn)
            cfgs = self._pod_priority_configs(pod)
            if extra_configs:
                cfgs = list(cfgs) + list(extra_configs)
            return self.algorithm.schedule(
                pod, self._snapshot.node_infos, names,
                predicate_funcs=funcs,
                priority_configs=cfgs)
        if extra_configs:
            # trial-scoped extra priorities (gang locality): the device
            # algorithm routes these through its host twin
            return self.algorithm.schedule(
                pod, self._snapshot.node_infos, names,
                extra_configs=extra_configs)
        return self.algorithm.schedule(pod, self._snapshot.node_infos, names)

    def _gang_schedule_fn(self, tracker: dict):
        """Member dispatch for a serial gang trial: rank-aware profiles
        append a GangLocalityPriority bound to the trial's LIVE zone
        counts (`tracker["zones"]`), weighted by the member's profile
        gang weight — the serial half of the fused kernel's per-segment
        zone-count carry. Placement-blind members dispatch unchanged."""
        if self.profiles is None:
            return self._schedule
        from kubernetes_tpu_torch.oracle.generic_scheduler import PriorityConfig
        from kubernetes_tpu_torch.oracle import priorities as prios

        def fn(pod: Pod, names: list[str]) -> ScheduleResult:
            gw = self.profiles.gang_weight_for(pod.scheduler_name)
            if not gw:
                return self._schedule(pod, names)
            cfg = PriorityConfig(
                "GangLocalityPriority", gw,
                function=lambda _p, nis, nodes: [
                    prios.gang_locality_map(tracker["zones"], nis[n.name])
                    for n in nodes])
            return self._schedule(pod, names, extra_configs=[cfg])

        return fn

    def _bind(self, assumed: Pod, host: str, orig: Pod, cycle: int,
              ctx: Optional[PluginContext] = None) -> bool:
        """Reference: the bind goroutine (scheduler.go:523) — Permit (may
        wait) + Prebind + store write + FinishBinding; on failure
        ForgetPod + Unreserve + re-queue. Returns True when the binding
        landed."""
        ctx = ctx or PluginContext()
        t_bind = self.clock.now()

        def fail(unschedulable: bool, message: str = "") -> None:
            self.cache.forget_pod(assumed)
            try:
                self.volume_binder.forget_pod_volumes(
                    ctx.read("volume-reservations"))
            except KeyError:
                pass
            self.framework.run_unreserve_plugins(ctx, assumed, host)
            self.metrics.observe("unschedulable" if unschedulable else "error")
            self._record_failure(
                orig, cycle,
                REASON_UNSCHEDULABLE if unschedulable else REASON_SCHEDULER_ERROR,
                message)

        # mid-cycle node death: the chaos seam may kill the target here,
        # and the stale check refuses the bind exactly like a NotFound
        # store write — forget + re-queue with backoff (the serial twin
        # of _commit_burst's per-wave stale-host check)
        chaos.node_dead_point("pre-bind")
        if self._host_is_stale(host):
            STALE_BINDS.inc()
            self._invalidate_dead_node(host)
            fail(False, f"{NODES}/{host} (node deleted before bind)")
            return False
        st = self.framework.run_permit_plugins(ctx, assumed, host)
        if not st.is_success():
            fail(st.code == FW_UNSCHEDULABLE, st.message)
            return False
        st = self.framework.run_prebind_plugins(ctx, assumed, host)
        if not st.is_success():
            fail(st.code == FW_UNSCHEDULABLE, st.message)
            return False
        try:
            try:
                self.volume_binder.bind_pod_volumes(
                    ctx.read("volume-reservations"))
            except KeyError:
                pass
            # crash seams bracketing the serial bind write (the same
            # process-death stand-in the wave commit carries)
            chaos.check("sched.crash")
            if self._extender_binder is not None \
                    and self._extender_binder.is_interested(assumed):
                # extender-managed binding (factory.go GetBinder: a binder
                # extender owns the write only for pods it manages)
                self._extender_binder.bind(assumed, host)
            else:
                self._store_bind_pod(assumed.key, host)
            chaos.check("sched.crash")
            self.cache.finish_binding(assumed)
            self.metrics.binding_count += 1
            self.metrics.binding_duration.observe(self.clock.now() - t_bind)
            self.metrics.observe_phase("binding", self.clock.now() - t_bind)
            self.metrics.observe("scheduled")
            self._note_profile_scheduled([assumed])
            # user-visible audit record (scheduler.go:433)
            self.recorder.pod_event(
                assumed, NORMAL, "Scheduled",
                f"Successfully assigned {assumed.key} to {host}")
            return True
        except chaos.SchedulerCrash:
            raise   # process-death stand-in: recovery, not re-queue
        except FencedError:
            # superseded partition claim: the write was rejected whole.
            # Forget silently and DROP the pod — it belongs to the
            # claim's new holder now; a zombie writing failure events
            # for it would be exactly the write fencing forbids.
            from kubernetes_tpu_torch.fleet import BIND_CONFLICTS
            BIND_CONFLICTS.labels("fenced").inc()
            self.fenced_waves += 1
            self.cache.forget_pod(assumed)
            if self.pod_rows is not None:
                self.pod_rows.invalidate(assumed)
            return False
        except ConflictError as err:
            # rv-CAS bind loss (already bound by another scheduler): the
            # winner's binding stands; the loser re-queues with backoff —
            # _record_failure drops the requeue once the store shows the
            # pod bound, which is the usual case
            from kubernetes_tpu_torch.fleet import BIND_CONFLICTS
            BIND_CONFLICTS.labels("requeued").inc()
            fail(False, f"rv-CAS bind conflict: {err}")
            return False
        except Exception as err:
            fail(False, str(err))
            return False

    def _store_bind_pod(self, pod_key: str, host: str):
        """The serial bind write, carrying the instance's partition-lease
        fencing tokens when fleet mode is on and the store's verb takes
        them (probed per call only on the fleet path — the solo hot path
        is the plain verb unchanged)."""
        if self.fence_provider is None:
            return self.store.bind_pod(pod_key, host)
        fence = self.fence_provider()
        if not fence:
            return self.store.bind_pod(pod_key, host)
        import inspect
        try:
            takes = "fence" in inspect.signature(
                self.store.bind_pod).parameters
        except (TypeError, ValueError):
            takes = False
        if takes:
            return self.store.bind_pod(pod_key, host, fence=fence)
        return self.store.bind_pod(pod_key, host)

    def _record_failure(self, pod: Pod, cycle: int,
                        reason: str = REASON_SCHEDULER_ERROR,
                        message: str = "") -> None:
        """Reference: scheduler.go:266 recordSchedulingFailure — re-queue
        (factory.go:643 MakeDefaultErrorFunc), emit a FailedScheduling
        event, and write the PodScheduled=False condition so the failure is
        visible to store watchers (factory.go:715)."""
        try:
            current = self.store.get(PODS, pod.key)
        except NotFoundError:
            self.queue.delete(pod)
            return
        if current.node_name:
            return
        self.queue.add_unschedulable_if_not_present(current, cycle)
        self.recorder.pod_event(pod, WARNING, "FailedScheduling",
                                message or reason)
        try:
            self.store.update_pod_condition(pod.key, PodCondition(
                type=POD_SCHEDULED, status=CONDITION_FALSE,
                reason=reason, message=message))
        except NotFoundError:
            pass

    # -- preemption (reference: scheduler.go:292 preempt) ----------------------
    def _preempt(self, pod: Pod, err: FitError) -> None:
        from kubernetes_tpu_torch.oracle.preemption import Preemptor
        self.metrics.preemption_attempts += 1
        try:
            updated = self.store.get(PODS, pod.key)   # factory.go:732
        except NotFoundError:
            return
        names = getattr(self, "_last_names", list(self._snapshot.node_infos))
        result = None
        if not any(getattr(e.config, "preempt_verb", "")
                   for e in self.extenders) \
                and hasattr(self.algorithm, "preempt"):
            # device victim scan: one launch over all candidate nodes
            # (oracle-identical decisions; None = not expressible on device)
            result = self.algorithm.preempt(
                updated, self._snapshot.node_infos, names, err,
                self.informers.informer(PDBS).list())
        if result is None:
            preemptor = Preemptor(pdbs_fn=self.informers.informer(PDBS).list,
                                  extenders=self.extenders)
            from kubernetes_tpu_torch.factory import (
                build_predicate_set, DEFAULT_PREDICATE_NAMES)
            predicate_set_fn = lambda infos: build_predicate_set(
                self._predicate_names or DEFAULT_PREDICATE_NAMES, infos,
                volume_listers=self.volume_listers,
                volume_binder=self.volume_binder,
                services_fn=self._services_fn)
            result = preemptor.preempt(
                updated, self._snapshot.node_infos, names,
                err, nominated_pods_fn=self.queue.nominated.pods_for_node,
                predicate_set_fn=predicate_set_fn)
        self._apply_preemption_result(pod, updated, result)

    def _apply_preemption_result(self, pod: Pod, updated: Pod, result) -> None:
        """Side effects of one preemption decision (the back half of the
        reference's preempt, scheduler.go:310-339): in-memory nomination,
        the NominatedNodeName API write, victim deletion + audit events,
        stale-nomination cleanup. Shared by the serial path and the batched
        pressure tail so the two cannot drift."""
        if result.node is not None:
            # in-memory nomination first (scheduler.go:310), then the API write
            self.queue.nominated.add(updated, result.node.name)
            try:
                self.store.set_nominated_node_name(pod.key, result.node.name)
            except NotFoundError:
                # matches the reference's early error return, which also
                # skips the nominated_to_clear loop (scheduler.go:313-318)
                self.queue.nominated.delete(updated)
                return
            for victim in result.victims:
                try:
                    self.store.delete(PODS, victim.key)
                except NotFoundError:
                    pass
                self.metrics.preemption_victims += 1
                # victim audit record (scheduler.go:325)
                self.recorder.pod_event(
                    victim, NORMAL, "Preempted",
                    f"by {updated.key} on node {result.node.name}")
        # nomination cleanup happens even when no node was found: Preempt may
        # return the preemptor itself so its stale NominatedNodeName is
        # removed (scheduler.go:329-339)
        for p in result.nominated_to_clear:
            self.queue.nominated.delete(p)
            try:
                self.store.set_nominated_node_name(p.key, "")
            except NotFoundError:
                pass

    # -- burst mode (device throughput path) ----------------------------------
    def _pod_is_burstable(self, pod: Pod, services=None, replicasets=None) -> bool:
        """A pod may ride a device burst unless its per-node state depends
        on in-burst placements in a way no burst kernel models yet — only
        volume binding remains. Affinity/port/spread pods are admitted: the
        kernels fold their interactions (self-node bans, carried spread
        counts) and refuse anything they can't replay exactly."""
        if pod.volumes:
            return False
        return True

    def _burst_class(self, pod: Pod, services, replicasets):
        """Segmentation key: pods with in-burst-dynamic features (affinity /
        host ports / selector-spread) burst only with spec-identical peers
        (the kernels' eligibility contract); plain pods share one generic
        segment even when heterogeneous."""
        from kubernetes_tpu_torch.api.types import (
            has_pod_affinity_terms, get_container_ports)
        from kubernetes_tpu_torch.oracle.priorities import get_selectors
        if has_pod_affinity_terms(pod) or get_container_ports(pod) \
                or get_selectors(pod, services, replicasets):
            from kubernetes_tpu_torch.core.torch_scheduler import (
                TorchScheduler)
            return TorchScheduler._class_signature(pod)
        return "plain"

    def schedule_burst(self, max_pods: int = 1024) -> int:
        """Drain up to max_pods from the queue and schedule them with device
        bursts where safe, serially otherwise — decisions identical to the
        serial loop. PodGroup members collapse into atomic gang segments
        (all-or-nothing placement; see _gang_segment). Returns pods bound,
        derived from the commit paths' actual bound counts (not a
        schedule_attempts metric delta, which a concurrent metric observer
        — or reset() — could skew)."""
        total = 0
        for _pass in range(64):
            bound, drained = self._schedule_burst_pass(max_pods)
            total += bound
            if bound > 0 or drained == 0:
                return total
            # the pass drained pods but bound none — e.g. a rejected gang
            # consumed the whole drain window and parked: every drained pod
            # left the activeQ (parked/backed off), so ready singletons
            # behind the gang drain on the next pass instead of waiting for
            # the caller's next call. The activeQ strictly shrinks across
            # zero-bound passes (a real-clock backoff expiring mid-call can
            # re-admit a gang, hence the pass cap rather than `while True`).
        return total

    def _schedule_burst_pass(self, max_pods: int) -> tuple[int, int]:
        """One drain+schedule pass; returns (pods bound, pods drained)."""
        drained = []
        for pod, cycle in self.queue.pop_burst(max_pods):
            if pod.deleted:
                # same audit record as the serial path (scheduler.go:447)
                self.recorder.pod_event(
                    pod, WARNING, "FailedScheduling",
                    f"skip schedule deleting pod: {pod.key}")
                continue
            drained.append((pod, cycle))
        if not drained:
            return 0, 0
        # gang gathering: a group's members collapse into ONE atomic item at
        # the position of the group's first member (the queue's group-anchor
        # ordering makes them adjacent; collapsing is robust to interleaving
        # regardless), and members the drain limit cut off are pulled from
        # the activeQ so gangs are always attempted whole
        items: list = []
        gang_at: dict[str, int] = {}
        for pod, cycle in drained:
            gk = pod_group_key(pod)
            if gk is None:
                items.append((pod, cycle))
                continue
            idx = gang_at.get(gk)
            if idx is None:
                gang_at[gk] = len(items)
                items.append([gk, [(pod, cycle)]])
            else:
                items[idx][1].append((pod, cycle))
        for gk, idx in gang_at.items():
            items[idx][1].extend(self.queue.pop_group(gk))
        # fused planning (round 10): consecutive plain singleton runs and
        # eligible plain gangs collapse into ONE device launch + ONE packed
        # fetch (algorithm.schedule_burst_fused — gang boundaries become
        # scan segment boundaries). Anything the fused path can't express
        # (plugins, volumes, affinity/port/spread classes, incomplete or
        # missing groups, active nominations) keeps the per-segment
        # machinery, which knows how to park/degrade/serialize.
        fuse_ok = (getattr(self.algorithm, "supports_fused_segments", False)
                   and not self.framework.reserve
                   and not self.framework.permit
                   and not self.framework.prebind)
        services = self._services_fn()
        replicasets = self._replicasets_fn()

        # plain-burstable classification from the pod-row cache: one
        # np.take per flag field for the whole drain window instead of
        # per-pod predicate walks (selector-spread needs live service/RS
        # lists, so any registered selector source keeps the direct path;
        # flag values are bit-identical to the predicates by the row
        # contract — has_aff_terms/has_ports/has_volumes ARE those calls)
        plain_map = None
        if self.pod_rows is not None and not services and not replicasets:
            flat_drained = [p for p, _c in drained]
            g = self.pod_rows.gather(
                flat_drained, ("has_aff_terms", "has_ports", "has_volumes"))
            if g is not None:
                plain = ~(g["has_aff_terms"] | g["has_ports"]
                          | g["has_volumes"])
                plain_map = {id(p): bool(v)
                             for p, v in zip(flat_drained, plain)}

        def plain_burstable(pod: Pod) -> bool:
            if plain_map is not None:
                got = plain_map.get(id(pod))
                if got is not None:
                    return got
            return (self._pod_is_burstable(pod)
                    and self._burst_class(pod, services, replicasets)
                    == "plain")

        bound = 0
        window: list = []   # fused entries in queue order:
        wrun: list = []     # ("run", pairs) | ("gang", gk, group, members)
        srun: list = []     # non-fusable singleton accumulator

        def close_wrun() -> None:
            if wrun:
                window.append(("run", list(wrun)))
                wrun.clear()

        def flush_window() -> None:
            nonlocal bound
            close_wrun()
            if not window:
                return
            if any(e[0] == "gang" for e in window):
                bound += self._fused_window(window, max_pods)
            else:
                # no gang segment in the window: the ordinary burst path is
                # already one launch + one packed fetch per segment
                pairs = [pr for e in window for pr in e[1]]
                bound += self._schedule_singletons_burst(pairs, max_pods)
            window.clear()

        def flush_srun() -> None:
            nonlocal bound
            if srun:
                bound += self._schedule_singletons_burst(list(srun),
                                                         max_pods)
                srun.clear()

        for it in items:
            if isinstance(it, list):
                gk, members = it
                flush_srun()
                group = None
                if fuse_ok and not self.queue.nominated.has_any() \
                        and all(plain_burstable(p) for p, _c in members):
                    group = self._fusable_gang(gk, members)
                if group is not None:
                    close_wrun()
                    window.append(("gang", gk, group, members))
                else:
                    flush_window()
                    bound += self._gang_segment(gk, members,
                                                bucket=max_pods)
            elif fuse_ok and not self.queue.nominated.has_any() \
                    and plain_burstable(it[0]):
                flush_srun()
                wrun.append(it)
            else:
                flush_window()
                srun.append(it)
        flush_srun()
        flush_window()
        return bound, len(drained)

    def _schedule_singletons_burst(self, pairs: list, bucket: int) -> int:
        """Schedule a run of non-gang pods: device burst segments where
        safe, serial cycles otherwise (the pre-gang schedule_burst body)."""
        pods = [p for p, _ in pairs]
        cycles = [c for _, c in pairs]
        # the burst fold skips the per-pod Reserve/Permit/Prebind points, so
        # any configured plugin forces the serial path (decisions and plugin
        # side effects must not differ by path)
        can_burst = (hasattr(self.algorithm, "schedule_burst")
                     and not self.framework.reserve
                     and not self.framework.permit
                     and not self.framework.prebind)
        services = self._services_fn()
        replicasets = self._replicasets_fn()
        bound = 0
        i = 0
        while i < len(pods):
            # serial path for mask-stale pods and under active nominations
            # (the two-pass ghost check lives on the oracle path)
            if not can_burst or self.queue.nominated.has_any() \
                    or not self._pod_is_burstable(pods[i], services, replicasets):
                if self._process_one(pods[i], cycles[i]):
                    bound += 1
                i += 1
                continue
            seg_class = self._burst_class(pods[i], services, replicasets)
            j = i
            while j < len(pods) and not self.queue.nominated.has_any() \
                    and self._pod_is_burstable(pods[j], services, replicasets) \
                    and self._burst_class(pods[j], services,
                                          replicasets) == seg_class:
                j += 1
            bound += self._burst_segment(pods[i:j], cycles[i:j], bucket)
            i = j
        return bound

    # -- gang scheduling (coscheduling.PodGroup) ------------------------------
    def _gang_segment(self, group_key: str, members: list,
                      bucket: int) -> int:
        """All-or-nothing placement of one PodGroup's gathered members.

        The gang is trial-placed as ONE atomic burst segment through the
        existing wave machinery (schedule_burst with NO per-wave commit
        callback, so nothing reaches the cache or store mid-trial); the
        commit happens only when EVERY member found a node and the group's
        minMember is covered. Otherwise the in-flight device folds are
        discarded and li/lni + the NodeTree rotation cursor rewind to the
        pre-gang checkpoint (TorchScheduler.gang_rewind — the wave rewind
        contract generalized to per-group), no partial bind is ever
        observable, and the group parks in the queue's gang backoff map so
        queued singletons behind it are not starved. When the kernels
        refuse the gang's feature mix, the serial referee trial
        (oracle.gang.GangTrial) runs the SAME semantics pod by pod —
        decisions are bit-identical either way, which the gang parity fuzz
        pins. Returns pods bound."""
        pods = [p for p, _ in members]
        cycles = [c for _, c in members]
        try:
            group = self.store.get(PODGROUPS, group_key)
        except NotFoundError:
            group = None
        if group is None:
            # membership label without a PodGroup object: there is no gang
            # contract to enforce — members schedule as ordinary singletons
            # (create the PodGroup BEFORE its pods to get atomicity)
            self.queue.clear_group(group_key)
            return self._schedule_singletons_burst(members, bucket)
        now = self.clock.now()
        self._gang_first_seen.setdefault(group_key, now)
        if self.framework.reserve or self.framework.permit \
                or self.framework.prebind or any(p.volumes for p in pods):
            # per-pod extension points and volume reservations cannot be
            # rewound atomically: degrade to the per-pod path (documented
            # limitation — gangs compose with neither plugins nor volumes)
            GANG_ATTEMPTS.labels("degraded").inc()
            return self._schedule_singletons_burst(members, bucket)
        min_member = max(group.min_member, 1)
        from kubernetes_tpu_torch.coscheduling.types import LABEL_POD_GROUP
        already_bound = sum(
            1 for p in self.informers.informer(PODS).list()
            if p.node_name and p.namespace == group.namespace
            and p.labels.get(LABEL_POD_GROUP) == group.name)
        if len(pods) + already_bound < min_member:
            # incomplete: not enough members exist/queued yet — park what is
            # here (phase PreScheduling; the PodGroup controller times the
            # group out to Unschedulable if it never fills)
            GANG_ATTEMPTS.labels("incomplete").inc()
            self._set_group_phase(group_key, PHASE_PRESCHEDULING, now)
            self._park_gang(group, pods,
                            f"waiting for minMember={min_member}: "
                            f"{already_bound} bound + {len(pods)} queued")
            return 0
        self._set_group_phase(group_key, PHASE_PRESCHEDULING, now)
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        tree = self.cache.node_tree
        hosts = None
        committed = 0
        # rank-aware gangs need the per-segment zone-count carry, which
        # only the fused segments kernel and the serial referee model —
        # the plain burst trial would score placement-blind, so it is
        # ineligible for them (the fused window path upstream is the
        # device home for rank-aware gangs)
        rank_aware = self.profiles is not None and any(
            self.profiles.gang_weight_for(p.scheduler_name) for p in pods)
        can_trial_burst = (hasattr(self.algorithm, "schedule_burst")
                           and not self.queue.nominated.has_any()
                           and not rank_aware
                           and all(self._pod_is_burstable(p) for p in pods))
        if can_trial_burst:
            has_gchk = hasattr(self.algorithm, "gang_checkpoint")
            chk = self.algorithm.gang_checkpoint() if has_gchk else (
                getattr(self.algorithm, "last_index", 0),
                getattr(self.algorithm, "last_node_index", 0))
            tree_chk = tree.checkpoint()
            self._ctx_open(tree_chk)
            names = tree.list_names()
            self._last_names = names
            hosts = self.algorithm.schedule_burst(
                pods, self._snapshot.node_infos, names, bucket=bucket)
            if hosts is not None and all(h is not None for h in hosts):
                dead = self._stale_scan(hosts, names)
                if dead:
                    # mid-burst node death during the gang trial: letting
                    # _commit_burst's wave filter fail just the stale
                    # members would bind a PARTIAL gang — rewind the trial
                    # whole (nothing committed), invalidate the dead
                    # nodes, and re-trial against the post-churn world
                    STALE_BINDS.inc(max(1, sum(1 for h in hosts
                                               if h in dead)))
                    if has_gchk:
                        self.algorithm.gang_rewind(chk)
                    else:
                        self.algorithm.last_index = chk[0]
                        self.algorithm.last_node_index = chk[1]
                        discard = getattr(self.algorithm,
                                          "discard_burst_folds", None)
                        if discard is not None:
                            discard()
                    tree.restore(tree_chk)
                    self._crash_ctx = None
                    for h in dead:
                        self._invalidate_dead_node(h)
                    return self._gang_segment(group_key, members,
                                              bucket=bucket)
                # crash bracket: the gang commits as ONE atomic window —
                # before = the pre-gang checkpoint, after = the post-trial
                # counters (a crash mid-commit recovers to whichever side
                # the store proves, never to a partial gang)
                ctx = self._crash_ctx
                self._ctx_window(
                    {"li0": ctx["li"], "lni0": ctx["lni"],
                     "committed0": 0,
                     "li1": getattr(self.algorithm, "last_index", 0),
                     "lni1": getattr(self.algorithm,
                                     "last_node_index", 0),
                     "committed1": len(pods)},
                    [p.key for p in pods], hosts)
                committed = self._commit_burst(pods, hosts, cycles)
                self._ctx_window_done()
                self._crash_ctx = None
                tree.advance_enumerations(len(pods) - 1)
            elif hosts is not None:
                # a member found no node: the gang is REJECTED — discard the
                # in-flight folds and rewind every carry to the pre-gang
                # checkpoint; nothing was committed
                if has_gchk:
                    self.algorithm.gang_rewind(chk)
                else:
                    # generic burst algorithm without the device checkpoint:
                    # rewind the walk counters and drop any resident folds
                    self.algorithm.last_index = chk[0]
                    self.algorithm.last_node_index = chk[1]
                    discard = getattr(self.algorithm,
                                      "discard_burst_folds", None)
                    if discard is not None:
                        discard()
                tree.restore(tree_chk)
                self._crash_ctx = None
                self._reject_gang(group, pods,
                                  sum(1 for h in hosts if h is not None))
                return 0
            else:
                # kernels refused this gang's feature mix: undo the consumed
                # enumeration and run the serial referee trial instead
                tree.restore(tree_chk)
                self._crash_ctx = None
        if hosts is None:
            # serial referee trial: per-member cycles with no packed-block
            # counters — crash recovery over this path is reconcile-only
            self._crash_ctx = None
            trial = GangTrial(self.cache, self.algorithm)

            def refresh():
                self._snapshot = self.cache.update_snapshot(self._snapshot)

            on_placed = None
            schedule_fn = self._schedule
            if rank_aware:
                # trial-scoped zone-count tracker: the serial half of the
                # fused kernel's gang set-scoring carry (a rollback
                # discards it with the trial)
                from kubernetes_tpu_torch.api.types import get_zone_key
                tracker = {"zones": {}}
                schedule_fn = self._gang_schedule_fn(tracker)

                def on_placed(host: str) -> None:
                    ni = self._snapshot.node_infos.get(host)
                    if ni is not None and ni.node is not None:
                        z = get_zone_key(ni.node)
                        if z:
                            tracker["zones"][z] = \
                                tracker["zones"].get(z, 0) + 1

            hosts = trial.run(pods, schedule_fn, refresh,
                              on_placed=on_placed)
            if hosts is None:
                self._reject_gang(group, pods, 0)
                return 0
            dead = self._stale_scan(hosts, list(self._snapshot.node_infos))
            if dead:
                # same contract as the device trial: never bind a partial
                # gang across a node death — roll the trial's assumes back
                # and re-trial post-churn
                STALE_BINDS.inc(max(1, sum(1 for h in hosts if h in dead)))
                trial.rollback(trial.last_assumed, *trial.last_chk)
                for h in dead:
                    self._invalidate_dead_node(h)
                return self._gang_segment(group_key, members, bucket=bucket)
            committed = self._commit_burst(pods, hosts, cycles,
                                           assume=False)
        if committed < len(pods):
            # members vanished between trial and commit (deleted from the
            # store): the survivors are bound, the rest were forgotten and
            # re-queued by the commit path; the controller re-evaluates the
            # group against its live members
            GANG_ATTEMPTS.labels("error").inc()
        else:
            GANG_ATTEMPTS.labels("scheduled").inc()
        created = group.creation_timestamp \
            or self._gang_first_seen.get(group_key, now)
        GANG_WAIT.observe(max(0.0, self.clock.now() - created))
        self._gang_first_seen.pop(group_key, None)
        self.queue.clear_group(group_key)
        return committed

    def _set_group_phase(self, group_key: str, phase: str,
                         now: float) -> None:
        fn = getattr(self.store, "update_pod_group_status", None)
        if fn is None:
            return
        try:
            fn(group_key, phase=phase, now=now)
        except NotFoundError:
            pass

    def _reject_gang(self, group, pods: list, placed: int) -> None:
        """Book a rejected gang attempt: every member is unschedulable (the
        trial rewound, so none is bound) and the group parks as a unit.
        `placed` is how many members found nodes before the rewind."""
        GANG_ATTEMPTS.labels("rejected").inc()
        self.metrics.observe("unschedulable", count=len(pods))
        self._park_gang(
            group, pods,
            f"gang rejected: {placed}/{len(pods)} members found nodes "
            f"(minMember={group.min_member}); trial rewound")

    def _park_gang(self, group, pods: list, message: str) -> None:
        """Park a gang's still-pending members under the group backoff
        window, with the same failure observability the serial path gives
        one pod (FailedScheduling event + PodScheduled=False condition)."""
        alive = []
        for pod in pods:
            try:
                current = self.store.get(PODS, pod.key)
            except NotFoundError:
                self.queue.delete(pod)
                continue
            if current.node_name:
                continue
            alive.append(current)
        self.queue.park_group(group.key, alive)
        msg = f"pod group {group.key}: {message}"
        for p in alive:
            self.recorder.pod_event(p, WARNING, "FailedScheduling", msg)
            try:
                self.store.update_pod_condition(p.key, PodCondition(
                    type=POD_SCHEDULED, status=CONDITION_FALSE,
                    reason=REASON_UNSCHEDULABLE, message=msg))
            except NotFoundError:
                pass

    # -- fused drain windows (round 10) ---------------------------------------
    # test seam: when set, singleton runs inside a fused window are split
    # into scan segments of at most this many pods. Non-gang segment
    # boundaries are semantically inert (only gang segments rewind), so
    # this forces the kernel's checkpoint machinery across many small
    # segments without changing any decision — the segment-boundary fuzz
    # variants set it to 3/4.
    fused_run_split: Optional[int] = None

    def _fusable_gang(self, group_key: str, members: list):
        """A gang may ride a fused window only when the pre-trial host
        checks all pass: the PodGroup object exists, enough members are
        gathered (counting already-bound ones), and no member needs volume
        reservations. Everything else (missing group, incomplete,
        degraded) keeps the per-segment _gang_segment path, which knows
        how to park/degrade. Returns the PodGroup or None."""
        try:
            group = self.store.get(PODGROUPS, group_key)
        except NotFoundError:
            return None
        if group is None:
            return None
        pods = [p for p, _c in members]
        if any(p.volumes for p in pods):
            return None
        min_member = max(group.min_member, 1)
        from kubernetes_tpu_torch.coscheduling.types import LABEL_POD_GROUP
        already_bound = sum(
            1 for p in self.informers.informer(PODS).list()
            if p.node_name and p.namespace == group.namespace
            and p.labels.get(LABEL_POD_GROUP) == group.name)
        if len(pods) + already_bound < min_member:
            return None
        return group

    def _fused_window(self, entries: list, bucket: int) -> int:
        """One launch + one packed fetch for a drain window that contains
        gang segments (algorithm.schedule_burst_fused): gang boundaries
        become device scan segment boundaries, rejected gangs rewind in
        the device carry and park host-side, and decided segments commit
        wave-by-wave out of the single fetched block. Falls back to the
        per-segment machinery when the algorithm refuses the window.
        Returns pods bound."""
        now = self.clock.now()
        if self.fused_run_split:
            split: list = []
            for e in entries:
                if e[0] != "run" or len(e[1]) <= self.fused_run_split:
                    split.append(e)
                    continue
                for lo in range(0, len(e[1]), self.fused_run_split):
                    split.append(("run",
                                  e[1][lo: lo + self.fused_run_split]))
            entries = split
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        tree = self.cache.node_tree
        tree_chk = tree.checkpoint()
        self._ctx_open(tree_chk)
        names = tree.list_names()
        self._last_names = names
        segments = []
        for e in entries:
            if e[0] == "gang":
                _kind, gk, group, members = e
                self._gang_first_seen.setdefault(gk, now)
                self._set_group_phase(gk, PHASE_PRESCHEDULING, now)
                segments.append(([p for p, _c in members], True))
            else:
                segments.append(([p for p, _c in e[1]], False))
        li0 = getattr(self.algorithm, "last_index", None)
        lni0 = getattr(self.algorithm, "last_node_index", None)
        res = self.algorithm.schedule_burst_fused(
            segments, self._snapshot.node_infos, names, bucket=bucket)
        if res is None:
            # window refused: undo the consumed enumeration and run every
            # entry through the per-segment paths
            tree.restore(tree_chk)
            self._crash_ctx = None
            return self._run_entries_unfused(entries, bucket)
        # mid-burst node death: a node deleted between this window's
        # snapshot and now (the node.dead seam fires between dispatch and
        # fetch, and between the fetch and the first wave commit) leaves
        # the fetched block holding decisions for a node that no longer
        # exists. NOTHING from the launch has committed yet, so the launch
        # refuses WHOLE: walk counters and the rotation walk rewind to the
        # pre-launch boundary, the dead node's cache entry, NodeTree slot,
        # device-mirror row, and victim-table row are invalidated, and the
        # same entries replan against the post-churn world — so the
        # decision stream stays bit-identical to a serial oracle that
        # observed the death before the same decisions (a fault costs
        # throughput, never a decision). Deletions landing after this
        # check are caught per-wave by _commit_burst's stale filter (the
        # requeue-with-backoff safety net).
        if li0 is not None:
            decided = [h for seg in res["segments"]
                       for h in (seg.get("hosts") or ())]
            dead = self._stale_scan(decided, names)
            if dead:
                STALE_BINDS.inc(max(1, sum(1 for h in decided
                                           if h in dead)))
                self.algorithm.fused_rewind(li0, lni0)
                tree.restore(tree_chk)   # exact: membership untouched yet
                self._crash_ctx = None
                for h in dead:
                    self._invalidate_dead_node(h)
                return self._fused_window(entries, bucket)
        bound = 0
        consumed = res["consumed"]
        aborted = False
        leftovers: list = []
        W = max(1, int(getattr(self.algorithm, "wave_size", 4096)))
        ctx = self._crash_ctx

        def seg_boundary(li1, lni1, t1) -> dict:
            """Window bracket from the committed-prefix boundary (ctx) to
            a segment/seq boundary — both sides exact on the fused path."""
            return {"li0": ctx["li"], "lni0": ctx["lni"],
                    "committed0": ctx["t"], "li1": int(li1),
                    "lni1": int(lni1), "committed1": int(t1)}

        def fold_boundary(li1, lni1, t1) -> None:
            ctx["li"], ctx["lni"], ctx["t"] = int(li1), int(lni1), int(t1)

        for e, seg in zip(entries, res["segments"]):
            status = seg["status"]
            if aborted or status == "undecided":
                leftovers.append(e)
                continue
            if e[0] == "gang":
                _kind, gk, group, members = e
                pods = [p for p, _c in members]
                cycles = [c for _p, c in members]
                if status == "rejected":
                    # the device carry already rewound; book the rejection
                    # exactly like a trial rewind (park under the group
                    # backoff, every member unschedulable). The rewound
                    # boundary (= pre-gang) is the new committed prefix.
                    self._reject_gang(group, pods, seg["placed"])
                    fold_boundary(seg["li"], seg["lni"], seg["t"])
                    continue
                # decided gang: ONE atomic commit for the whole group (a
                # wave window never splits a gang, so a crash between
                # windows cannot leave a partial gang bound)
                self._ctx_window(
                    seg_boundary(seg["li"], seg["lni"], seg["t"]),
                    [p.key for p in pods], seg["hosts"])
                committed = self._commit_burst(pods, seg["hosts"], cycles)
                self._ctx_window_done()
                bound += committed
                if committed < len(pods):
                    # members vanished between decision and commit: the
                    # survivors are bound, the rest were forgotten and
                    # re-queued — decisions past this segment assumed the
                    # missing folds, so stop consuming the block
                    GANG_ATTEMPTS.labels("error").inc()
                    self.algorithm.fused_rewind(seg["li"], seg["lni"])
                    consumed = seg["t"]
                    aborted = True
                else:
                    GANG_ATTEMPTS.labels("scheduled").inc()
                    created = group.creation_timestamp \
                        or self._gang_first_seen.get(gk, now)
                    GANG_WAIT.observe(max(0.0, self.clock.now() - created))
                self._gang_first_seen.pop(gk, None)
                self.queue.clear_group(gk)
            else:
                pairs = e[1]
                pods = [p for p, _c in pairs]
                cycles = [c for _p, c in pairs]
                hosts = seg["hosts"]   # decided prefix (all, unless failed)
                short_at = None
                for wlo in range(0, len(hosts), W):
                    hi = min(wlo + W, len(hosts))
                    self._ctx_window(
                        seg_boundary(seg["li_seq"][hi - 1],
                                     seg["lni_seq"][hi - 1],
                                     seg["t_seq"][hi - 1]),
                        [p.key for p in pods[wlo:hi]], hosts[wlo:hi])
                    n_b = self._commit_burst(pods[wlo:hi], hosts[wlo:hi],
                                             cycles[wlo:hi])
                    self._ctx_window_done()
                    bound += n_b
                    if n_b < hi - wlo:
                        short_at = hi
                        break
                if short_at is not None:
                    # short commit mid-run: rewind the walk counters to the
                    # end of the short window (its decisions were consumed,
                    # vanished pods re-queued) and discard the rest
                    self.algorithm.fused_rewind(
                        int(seg["li_seq"][short_at - 1]),
                        int(seg["lni_seq"][short_at - 1]))
                    consumed = int(seg["t_seq"][short_at - 1])
                    aborted = True
                    if short_at < len(pairs):
                        leftovers.append(("run", pairs[short_at:]))
                elif status == "failed" and len(hosts) < len(pairs):
                    # the run's tail (failing pod onward) reruns through
                    # the per-segment paths — its serial rerun may preempt
                    leftovers.append(("run", pairs[len(hosts):]))
        # serial semantics consume one NodeTree enumeration per decided
        # cycle; the kernel's consumed-count (rejected gangs rewound it) is
        # authoritative. Nothing decided -> the window's enumeration was
        # never used: restore it so the next cycle replays identically.
        if consumed > 0:
            tree.advance_enumerations(consumed - 1)
        else:
            tree.restore(tree_chk)
        self._crash_ctx = None   # window fully reconciled; nothing in flight
        if leftovers:
            bound += self._run_entries_unfused(leftovers, bucket)
        return bound

    def _run_entries_unfused(self, entries: list, bucket: int) -> int:
        """Process fused-window entries through the per-segment machinery
        (refused windows, and leftovers behind a failure/abort)."""
        bound = 0
        run: list = []
        for e in entries:
            if e[0] == "run":
                run.extend(e[1])
                continue
            if run:
                bound += self._schedule_singletons_burst(run, bucket)
                run = []
            bound += self._gang_segment(e[1], e[3], bucket=bucket)
        if run:
            bound += self._schedule_singletons_burst(run, bucket)
        return bound

    def _burst_segment(self, pods: list[Pod], cycles: list[int],
                       bucket: int) -> int:
        """Schedule one burst segment; returns pods bound."""
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        tree_chk = self.cache.node_tree.checkpoint()
        names = self.cache.node_tree.list_names()
        self._last_names = names
        self._ctx_open(tree_chk)
        # wave-window sink (torch_scheduler.schedule_burst `commit`): the
        # algorithm fetches the whole burst's decisions as ONE packed
        # block and calls back with consecutive `wave_size` windows of
        # DECIDED hosts. A short commit (pods that vanished between
        # decision and commit) returns False, which makes the algorithm
        # stop consuming the block, rewind, and discard the rest.
        progress = {"committed": 0, "bound": 0, "failed": False}

        def commit_wave(lo: int, hosts: list) -> bool:
            k = len(hosts)
            # crash-restart window bracket: the algorithm's commit_marker
            # carries the exact walk counters at both window boundaries
            # (None fields where the packed block can't supply them)
            m = getattr(self.algorithm, "commit_marker", None)
            self._ctx_window(m, [p.key for p in pods[lo:lo + k]], hosts)
            n_bound = self._commit_burst(pods[lo:lo + k], hosts,
                                         cycles[lo:lo + k])
            self._ctx_window_done()
            progress["committed"] = lo + k
            progress["bound"] += n_bound
            if n_bound < k:
                progress["failed"] = True
                return False
            return True

        try:
            if getattr(self.algorithm, "supports_wave_commit", False):
                hosts = self.algorithm.schedule_burst(
                    pods, self._snapshot.node_infos, names, bucket=bucket,
                    commit=commit_wave)
            else:
                hosts = self.algorithm.schedule_burst(
                    pods, self._snapshot.node_infos, names, bucket=bucket)
        except StaleNodeRefusal as e:
            # mid-burst node death (round 14): the launch's decision block
            # references vanished nodes and was refused before any of its
            # decisions committed (the driver reconciled the committed
            # prefix — earlier chunks — and dropped its folds). Invalidate
            # the dead nodes everywhere and replan the uncommitted
            # remainder against the post-churn world: every surviving
            # decision is made with the node gone, exactly like a serial
            # loop that observed the death here.
            STALE_BINDS.inc(e.n_stale)
            done = progress["committed"]
            if done == 0:
                # the enumeration this segment consumed was never used
                self.cache.node_tree.restore(tree_chk)
            else:
                self.cache.node_tree.advance_enumerations(done - 1)
            self._crash_ctx = None
            for h in e.dead:
                self._invalidate_dead_node(h)
            return progress["bound"] + self._burst_segment(
                pods[done:], cycles[done:], bucket)
        if hosts is None:
            # the algorithm refused the whole burst (it can't reproduce the
            # serial walk for this cluster/workload; refusals happen before
            # any wave is dispatched or committed) — run pods one by one;
            # pod 0 rides the enumeration list_names() above already consumed
            # so every pod sees exactly its serial-loop node order
            bound = 0
            for i, (pod, cycle) in enumerate(zip(pods, cycles)):
                if self._process_one(pod, cycle,
                                     names=names if i == 0 else None):
                    bound += 1
            return bound
        kf = len(pods)
        if any(host is None for host in hosts):
            # burst contract (torch_scheduler.schedule_burst): decisions from
            # the first None on are UNDECIDED — the algorithm rewound its
            # counters and device folds to the non-None prefix, whose
            # decisions are serial-exact and final. Commit the prefix, then
            # run the tail serially (a failing pod's serial rerun can
            # preempt — nominating a node and deleting victims — state the
            # discarded kernel decisions never saw).
            kf = hosts.index(None)
        done = progress["committed"]   # waves already committed in-flight
        bound = progress["bound"]
        if done < kf:
            bound += self._commit_burst(pods[done:kf], hosts[done:kf],
                                        cycles[done:kf])
        # serial semantics consume one NodeTree enumeration per pod; the
        # kernel modeled cycles 0..kf-1 on the segment's single
        # enumeration — fast-forward the rest of the committed prefix
        if kf > 0:
            self.cache.node_tree.advance_enumerations(kf - 1)
        # committed prefix fully reconciled: recovery past this point is
        # per-cycle (serial tail) or reconcile-only (pressure tail)
        self._crash_ctx = None
        if kf < len(pods):
            if progress["failed"]:
                # wave-commit failure: the algorithm discarded the in-flight
                # wave's decisions and its device folds (rewind contract) —
                # schedule the remainder as a fresh segment against a fresh
                # snapshot and enumeration (the forgotten pods re-queued)
                return bound + self._burst_segment(pods[kf:], cycles[kf:],
                                                   bucket)
            # the tail's first pod rides one fresh enumeration (or the
            # segment's own when the kernel decided nothing) whether it runs
            # batched or serial
            tail_names = names if kf == 0 \
                else self.cache.node_tree.list_names()
            tail_bound = self._try_pressure_tail(pods[kf:], cycles[kf:],
                                                 tail_names)
            if tail_bound is not None:
                return bound + tail_bound
            for k in range(kf, len(pods)):
                if self._process_one(pods[k], cycles[k],
                                     names=tail_names if k == kf else None):
                    bound += 1
        return bound

    # -- mid-burst node-death tolerance ---------------------------------------
    def _stale_scan(self, decided: list, names: list) -> set:
        """The launch-level node-death scan (wave drivers + fused window
        call it after the packed fetch, before the first commit): returns
        the set of nodes from this launch's world that no longer exist in
        the store. Decided hosts are probed individually (cheap, and the
        production-critical case — never bind to a dead node); a death
        whose rows received NO decisions still shifts rotation and
        tie-breaking, so a node-count shrink triggers the full-name probe.
        Stores without the O(1) count verb (remote) keep the decided-host
        probe only."""
        if getattr(self.store, "missing_keys", None) is None:
            return set()
        dead = self._dead_hosts(decided)
        if not dead:
            count = getattr(self.store, "count", None)
            if count is not None and count(NODES) < len(names):
                dead = self._dead_hosts(names)
        return dead

    def _dead_hosts(self, hosts) -> set:
        """The hosts among `hosts` the store no longer has: ONE
        `missing_keys` call (one request for the whole set on the remote
        client)."""
        return set(self.store.missing_keys(NODES, sorted(set(hosts))))

    def _host_is_stale(self, host: str) -> bool:
        """True when the decision's target node no longer exists in the
        store (deleted between the packed fetch and this commit). Stores
        without the existence probe (no `contains`) skip the check — the
        bind write itself then resolves the race."""
        contains = getattr(self.store, "contains", None)
        return contains is not None and not contains(NODES, host)

    def _invalidate_dead_node(self, host: str) -> None:
        """Eagerly invalidate every decision structure referencing a node
        the store no longer has: the cache entry + NodeTree slot (the
        informer's DELETED event confirms later — both removals are
        idempotent) and the algorithm's device-mirror/victim-table rows.
        Runs in BOTH worlds (the oracle shell shares this path), so
        post-churn decision streams stay bit-identical: every subsequent
        cycle sees the node gone, whichever path detected it."""
        info = self._snapshot.node_infos.get(host)
        node = info.node if info is not None else None
        if node is None:
            # the snapshot can lag the cache (pre-cycle reconciliation
            # runs before the refresh) — the cache's object carries the
            # zone labels the NodeTree removal needs
            node = self.cache.get_node(host)
        if node is not None:
            self.cache.remove_node(node)
        inv = getattr(self.algorithm, "invalidate_node", None)
        if inv is not None:
            inv(host)

    def _reconcile_node_deaths(self) -> bool:
        """Serial twin of the launch-level stale scan: fold store-side
        node deletions the informers haven't delivered yet into the
        cache/tree/mirror before a serial cycle decides. O(1) (one store
        count) when nothing died; the informer's DELETED event later
        confirms — both removals are idempotent. Returns True when a
        death was found (the caller re-grounds any pre-drawn
        enumeration)."""
        count = getattr(self.store, "count", None)
        if count is None or not hasattr(self.store, "contains"):
            return False
        tree = self.cache.node_tree
        if count(NODES) >= tree.num_nodes:
            return False
        contains = self.store.contains
        found = False
        for host in tree.all_names():
            if not contains(NODES, host):
                self._invalidate_dead_node(host)
                found = True
        return found

    def _commit_burst(self, pods: list[Pod], hosts: list[str],
                      cycles: list[int], assume: bool = True) -> int:
        """Commit a burst's decided prefix (or one pipelined wave of it):
        ONE batched cache assume + vectorized device-mirror sync, then ONE
        batched store write for all bindings, one batched finish, one
        batched event write, and aggregated metrics — the per-pod
        lock/call overhead of the serial bind path amortized across the
        wave (VERDICT r4 weak #4: the 38us/pod host bind ceiling; the wave
        pipeline then hides what remains behind the next wave's device
        time). Pods an extender binder manages keep the per-pod path
        (extender-owned writes can't batch through our store). Returns the
        number of pods actually bound.

        Invariant: bursts only form when NO reserve/permit/prebind plugins
        are configured (schedule_burst's can_burst gate routes plugin-ful
        workloads to the serial _process_one/_bind path), so skipping the
        framework points here cannot skip real plugin work.

        `assume=False` is the serial-gang-trial commit: the members were
        already assumed one by one (oracle.gang.GangTrial), and nothing was
        folded on device, so both the batched cache assume AND the device-
        mirror sync are skipped — the cache generation bumps from the trial
        re-encode the touched rows on the next cycle instead."""
        if not pods:
            return 0
        assert not (self.framework.reserve or self.framework.permit
                    or self.framework.prebind), \
            "burst commit reached with framework plugins configured"
        # mid-burst node death (the round-14 tolerance contract): the
        # chaos seam may kill a node right here — between the packed
        # fetch and this wave's store write — and the stale-host check
        # then fails EXACTLY the decisions targeting vanished nodes:
        # those pods are never assumed, re-queue with backoff in creation
        # order (wave order is creation order), and the dead node's
        # mirror/victim/NodeTree rows invalidate eagerly. The short wave
        # count makes the burst driver abort + rewind, so undecided
        # successors reschedule against the post-churn world — the same
        # state a serial loop's failed bind leaves behind.
        chaos.node_dead_point("pre-bind")
        if getattr(self.store, "missing_keys", None) is not None:
            stale_hosts = self._dead_hosts(hosts)
            if stale_hosts:
                for h in stale_hosts:
                    self._invalidate_dead_node(h)
                live: list[tuple[Pod, str, int]] = []
                for pod, host, cycle in zip(pods, hosts, cycles):
                    if host not in stale_hosts:
                        live.append((pod, host, cycle))
                        continue
                    STALE_BINDS.inc()
                    self.metrics.observe("error")
                    self._record_failure(
                        pod, cycle, REASON_SCHEDULER_ERROR,
                        f"{NODES}/{host} (node deleted before bind)")
                pods = [p for p, _h, _c in live]
                hosts = [h for _p, h, _c in live]
                cycles = [c for _p, _h, c in live]
                if not pods:
                    return 0
        eb = self._extender_binder
        if eb is not None and any(eb.is_interested(p) for p in pods):
            n_bound = 0
            for pod, host, cycle in zip(pods, hosts, cycles):
                if assume:
                    assumed = self._assume_for_burst(pod, host)
                else:
                    assumed = pod.clone()
                    assumed.node_name = host
                if self._bind(assumed, host, pod, cycle):
                    n_bound += 1
            return n_bound
        t_bind = self.clock.now()
        assumed_list = []
        for pod, host in zip(pods, hosts):
            assumed = pod.clone()
            assumed.node_name = host
            assumed_list.append(assumed)
        if assume:
            self.cache.assume_pods(assumed_list)    # one lock for the wave
        note_many = getattr(self.algorithm, "note_burst_assumed_many", None) \
            if assume else None
        if note_many is not None:
            # the device scan already folded these deltas: sync the host
            # mirror + generation map in one vectorized pass (generations
            # read once, after every assume of the wave landed)
            note_many(assumed_list, hosts,
                      self.cache.node_generations(hosts))
        elif assume:
            note = getattr(self.algorithm, "note_burst_assumed", None)
            if note is not None:
                for assumed, host in zip(assumed_list, hosts):
                    gen = self.cache.node_generation(host)
                    if gen is not None:
                        note(assumed, host, gen)
        # the wave's whole store-write tail — batched binds PLUS the
        # Scheduled audit records for the binds that land — is ONE
        # commit-core call (store.commit_core.PyCommitCore);
        # watch fan-out is deliberately deferred to the ONE fanout_wave
        # call below so consumers copy events out while this thread
        # finishes the cache/metric tail (the call-count contract is
        # pinned by TestCommitWaveContract)
        bindings = [(a.key, h) for a, h in zip(assumed_list, hosts)]
        commit_wave = getattr(self.store, "commit_wave", None)
        emit_batch = commit_wave is None
        conflicted: list = []
        try:
            # crash seam, pre-write side: the wave has been assumed in the
            # cache but NOTHING reached the store — recovery must re-queue
            # every pod of this window
            chaos.check("sched.crash")
            if commit_wave is not None:
                missing_list, conflicted = self._commit_wave_retrying(
                    commit_wave, bindings)
                missing = set(missing_list)
            else:
                missing = set(self.store.bind_pods(bindings))
            # crash seam, post-write side: the wave LANDED but the cache
            # finish / metrics / fan-out tail never ran — recovery must
            # adopt every landed binding
            chaos.check("sched.crash")
        except chaos.SchedulerCrash:
            # the process-death stand-in must NOT be absorbed by the
            # graceful per-pod resolution below: it propagates to the test
            # harness, which then drives Scheduler.recover()
            raise
        except FencedError:
            # the partition lease this wave wrote under was superseded
            # mid-flight: the store rejected the WHOLE wave atomically
            # (nothing landed, no events). Forget the assumes and DROP
            # the pods — they belong to the claim's new holder, which
            # re-lists them from the store; a zombie must not keep
            # writing failure events/conditions for pods it lost.
            # (the finally below still runs the fan-out call)
            from kubernetes_tpu_torch.fleet import BIND_CONFLICTS
            BIND_CONFLICTS.labels("fenced").inc(len(assumed_list))
            self.fenced_waves += 1
            for assumed in assumed_list:
                self.cache.forget_pod(assumed)
                if self.pod_rows is not None:
                    self.pod_rows.invalidate(assumed)
            return 0
        except Exception:
            # a mid-batch store failure may have partially committed:
            # resolve each pod by what actually landed — bound pods finish,
            # the rest forget + re-queue, exactly like the serial _bind's
            # per-pod failure handling (their audit records re-emit below;
            # fire-and-forget records tolerate the crash-path duplicate)
            from kubernetes_tpu_torch.obs import flight as obs_flight
            obs_flight.RECORDER.note_crash("commit-wave-crash")
            emit_batch = True
            missing = set()
            for assumed, host in zip(assumed_list, hosts):
                try:
                    landed = self.store.get(PODS, assumed.key)
                except Exception:
                    # gone OR unreachable: either way the binding can't be
                    # confirmed — forget + re-queue (a pod that did land
                    # re-syncs as bound when the informer catches up)
                    missing.add(assumed.key)
                    continue
                if landed.node_name != host:
                    missing.add(assumed.key)
        finally:
            fanout = getattr(self.store, "fanout_wave", None)
            if fanout is not None:
                fanout()
        confl_set = set(conflicted)
        bound = []
        for assumed, pod, host, cycle in zip(assumed_list, pods, hosts,
                                             cycles):
            if assumed.key in confl_set:
                # rv-CAS bind loss: another scheduler bound this pod
                # between decision and commit (claim handoff window /
                # nominated race). The existing binding stands; the loser
                # forgets its assume and re-queues with backoff in
                # creation order — _record_failure reads the store and
                # drops the requeue when the pod is (as usual) already
                # bound by the winner.
                from kubernetes_tpu_torch.fleet import BIND_CONFLICTS
                BIND_CONFLICTS.labels("requeued").inc()
                self.cache.forget_pod(assumed)
                self.metrics.observe("error")
                self._record_failure(
                    pod, cycle, REASON_SCHEDULER_ERROR,
                    f"{PODS}/{assumed.key} (rv-CAS bind conflict: bound "
                    f"by another scheduler)")
                continue
            if assumed.key in missing:
                # vanished between decision and commit: same handling as a
                # failed bind write (_bind's fail path)
                self.cache.forget_pod(assumed)
                self.metrics.observe("error")
                self._record_failure(pod, cycle, REASON_SCHEDULER_ERROR,
                                     f"{PODS}/{assumed.key}")
                continue
            bound.append((assumed, host))
        k = len(bound)
        if not k:
            return 0
        self.cache.finish_bindings([a for a, _h in bound])  # one lock
        dt = self.clock.now() - t_bind
        self.metrics.binding_count += k
        self.metrics.binding_duration.observe_many(dt / k, k)
        self.metrics.observe_phase("binding", dt / k, count=k)
        self.metrics.observe("scheduled", count=k)
        self._note_profile_scheduled([a for a, _h in bound])
        if emit_batch:
            # stores without the wave verb (and the crash-resolution path)
            # land audit records in one batched write (scheduler.go:433)
            self.recorder.pod_events_batch([
                (a, NORMAL, "Scheduled",
                 f"Successfully assigned {a.key} to {h}") for a, h in bound])
        return k

    def _commit_wave_retrying(self, commit_wave,
                              bindings: list) -> tuple[list, list]:
        """Idempotent commit_wave: bounded exponential backoff with jitter
        on transient store failures, under ONE dedupe token for the wave.
        A pre-land failure (nothing written) simply re-runs the wave; an
        AMBIGUOUS failure (the wave landed, the response was lost) is
        answered by the store's token map on retry — the wave can neither
        double-land nor double-emit its events. Exhausted retries fall
        back to the caller's per-pod crash resolution, which is also safe
        (it reads back what actually landed). Returns (missing keys,
        rv-CAS conflicted keys) — conflicted pods were bound by another
        scheduler between decision and commit and are NEVER overwritten.

        Stores whose commit_wave takes `event_spec` (round 17) build the
        wave's Scheduled records INSIDE the commit core — no per-pod
        record construction on this thread; older/alternate stores get
        host-built records (identical fields). Stores taking `fence`
        carry the instance's partition-lease tokens (fleet mode); a
        FencedError is DEFINITIVE (ConflictError is never a transient) —
        it propagates for the caller's whole-wave drop, never retried."""
        import inspect
        try:
            # probed per wave, not cached: tests (and alternate stores)
            # swap commit_wave at runtime
            params = inspect.signature(commit_wave).parameters
            takes_token = "token" in params
            takes_spec = "event_spec" in params
            takes_fence = "fence" in params
            takes_conflicts = "conflicts" in params
        except (TypeError, ValueError):
            takes_token = takes_spec = False
            takes_fence = takes_conflicts = False
        kwargs = {}
        if takes_token:
            kwargs["token"] = f"{self._token_prefix}:w{next(self._wave_seq)}"
        if takes_fence and self.fence_provider is not None:
            fence = self.fence_provider()
            if fence:
                kwargs["fence"] = fence
        if takes_spec:
            recs = None
            kwargs["event_spec"] = {"component": self.recorder.component}
        else:
            from kubernetes_tpu_torch.api.types import EventRecord
            from kubernetes_tpu_torch.store.record import (
                build_scheduled_records, reserve_seq)
            recs = build_scheduled_records(
                EventRecord, bindings, self.recorder.component,
                reserve_seq(max(1, len(bindings))))
        delay = 0.005
        attempts = 4
        for attempt in range(attempts):
            confl: list = []
            if takes_conflicts:
                # a FRESH list per attempt: a dedupe-answered retry
                # extends it from the recorded wave result
                kwargs["conflicts"] = confl
            try:
                out = commit_wave(bindings, recs, **kwargs)
                if attempt:
                    COMMIT_RETRIES.labels("recovered").inc()
                return out, confl
            except Exception as e:   # noqa: BLE001 — filtered below
                if attempt + 1 >= attempts \
                        or not _retryable_store_error(e):
                    if attempt:
                        COMMIT_RETRIES.labels("exhausted").inc()
                    raise
                COMMIT_RETRIES.labels("retried").inc()
                time.sleep(delay * (0.5 + (attempt % 2) / 2))
                delay *= 2

    def _assume_for_burst(self, pod: Pod, host: str) -> Pod:
        assumed = pod.clone()
        assumed.node_name = host
        self.cache.assume_pod(assumed)
        note = getattr(self.algorithm, "note_burst_assumed", None)
        if note is not None:
            # the device scan already folded this delta: sync the host
            # mirror + generation map so the next encode() skips the row
            gen = self.cache.node_generation(host)
            if gen is not None:
                note(assumed, host, gen)
        return assumed

    def _try_pressure_tail(self, pods: list[Pod], cycles: list[int],
                           names: list[str]) -> Optional[int]:
        """Run a failed burst tail through the batched schedule-else-preempt
        launch (algorithm.preempt_pressure_burst) instead of one serial
        cycle + victim scan per pod. Returns None when the batch isn't
        applicable — the caller falls back to the serial loop — else the
        number of pods bound. Decisions and store/queue side effects are
        identical to the serial path (the batched-kernel gates + shared
        _apply_preemption_result guarantee it; the pressure parity fuzzes
        are the tripwire)."""
        fn = getattr(self.algorithm, "preempt_pressure_burst", None)
        if fn is None or self.disable_preemption or self.extenders:
            return None
        if self.queue.nominated.has_any():
            return None
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        self._last_names = names
        t_launch = self.clock.now()
        outcomes = fn(pods, self._snapshot.node_infos, names,
                      self.informers.informer(PDBS).list())
        if outcomes is None:
            return None
        # metric-shape parity with the serial loop: every pod gets an
        # "algorithm" phase sample (its share of the one launch), failed
        # pods a "preemption" sample, bound pods an e2e sample — so the
        # per-phase histograms keep comparable shapes whichever
        # (decision-identical) path ran
        share = (self.clock.now() - t_launch) / max(len(pods), 1)
        from kubernetes_tpu_torch.oracle.preemption import PreemptionResult
        note = getattr(self.algorithm, "note_burst_assumed", None)
        n = len(names)
        n_bound = 0
        for pod, cycle, oc in zip(pods, cycles, outcomes):
            t_pod = self.clock.now()
            self.metrics.observe_phase("algorithm", share)
            if oc[0] == "bound":
                host = oc[1]
                assumed = pod.clone()
                assumed.node_name = host
                self.cache.assume_pod(assumed)
                if note is not None:
                    gen = self.cache.node_generation(host)
                    if gen is not None:
                        note(assumed, host, gen)
                self.queue.nominated.delete(pod)
                if self._bind(assumed, host, pod, cycle):
                    n_bound += 1
                e2e = share + (self.clock.now() - t_pod)
                self.metrics.e2e_latency_sum += e2e
                self.metrics.e2e_duration.observe(e2e)
                continue
            self.metrics.observe("unschedulable")
            self.metrics.preemption_attempts += 1
            try:
                updated = self.store.get(PODS, pod.key)   # factory.go:732
            except NotFoundError:
                updated = None
            if updated is not None:
                if oc[0] == "nominated":
                    node = self._snapshot.node_infos[oc[1]].node
                    result = PreemptionResult(node, oc[2], [])
                else:
                    # no candidate nodes at all: the oracle returns the pod
                    # itself so its stale nomination is cleared (:330-333)
                    result = PreemptionResult(
                        None, [], [] if oc[1] else [updated])
                self._apply_preemption_result(pod, updated, result)
            self.metrics.observe_phase("preemption",
                                       self.clock.now() - t_pod)
            self._record_failure(pod, cycle, REASON_UNSCHEDULABLE,
                                 str(FitError(pod, n, {})))
        # the kernel modeled one enumeration per pod on the axis order
        # (identity rotation is a batch gate); consume the remainder
        self.cache.node_tree.advance_enumerations(len(pods) - 1)
        return n_bound

    # -- crash-restart warm recovery ------------------------------------------
    # The recovery context brackets every committed burst window with the
    # exact walk-counter / NodeTree boundary on each side. A crash
    # (chaos.SchedulerCrash — the process-death stand-in — escaping the
    # commit path) freezes it; recover() reads the store to learn which
    # side of the in-flight window actually landed and rewinds/advances
    # the decision state to exactly where an oracle that never crashed
    # would be, then reconciles cache/queue/nominations from a relist.
    def _ctx_open(self, tree_chk) -> None:
        """Open a burst recovery context at the segment's pre-enumeration
        boundary (tree checkpoint taken BEFORE list_names)."""
        self._crash_ctx = {
            "tree_chk": tree_chk,
            "li": getattr(self.algorithm, "last_index", 0),
            "lni": getattr(self.algorithm, "last_node_index", 0),
            "t": 0, "exact": True, "window": None,
        }

    def _ctx_window(self, marker: Optional[dict], keys: list,
                    hosts: list) -> None:
        """Bracket one commit window: `marker` is the algorithm's
        commit_marker (exact boundary counters where the packed block
        carries them; None fields degrade recovery to reconcile-only)."""
        ctx = self._crash_ctx
        if ctx is None:
            return
        m = marker or {}
        ctx["window"] = {
            "keys": list(keys), "hosts": list(hosts),
            "li0": m.get("li0"), "lni0": m.get("lni0"),
            "li1": m.get("li1"), "lni1": m.get("lni1"),
            "t0": m.get("committed0"), "t1": m.get("committed1"),
        }

    def _ctx_window_done(self) -> None:
        """Fold a successfully committed window into the context's
        committed-prefix boundary."""
        ctx = self._crash_ctx
        if ctx is None or ctx["window"] is None:
            return
        w = ctx.pop("window")
        ctx["window"] = None
        if w["li1"] is None or w["lni1"] is None or w["t1"] is None:
            ctx["exact"] = False
        else:
            ctx["li"], ctx["lni"], ctx["t"] = w["li1"], w["lni1"], w["t1"]

    def recover(self) -> dict:
        """Crash-restart warm recovery (the reference's restart story —
        factory.go:643 re-queue, re-list on restart — compressed into one
        in-process path, plus the device state a restarted device scheduler
        must rebuild):

        1. decide the commit boundary: when a burst window was in flight,
           read the store to learn whether it landed (commit_wave is
           atomic per window: all its binds or none), and set the walk
           counters / NodeTree rotation to that side's exact boundary —
           the state an oracle that never crashed would hold;
        2. re-list every informer (authoritative store view; handlers
           reconcile caches/queue with DeltaFIFO Replace semantics);
        3. reconcile the scheduler cache: assumed-but-unbound pods are
           forgotten and RE-QUEUED (their assume died with the crash),
           assumed pods whose binding landed are ADOPTED (finish), bound
           pods the cache never saw are adopted via the relist;
        4. rebuild the nomination map from the store's
           nominatedNodeName fields;
        5. drop every device-resident structure (folds for uncommitted
           decisions, the victim table) — the next encode re-uploads from
           the now-authoritative host mirror.

        Returns a report dict (requeued/adopted keys, whether the walk
        counters were recovered exactly)."""
        self.wait_for_binds()
        report = {"requeued": [], "adopted": [], "exact": True,
                  "window_landed": None}
        # -- 1. commit boundary from the frozen context ----------------------
        ctx, self._crash_ctx = self._crash_ctx, None
        li = lni = t = None
        if ctx is not None:
            li, lni, t = ctx["li"], ctx["lni"], ctx["t"]
            exact = ctx["exact"]
            w = ctx.get("window")
            if w is not None:
                landed = False
                for key, host in zip(w["keys"], w["hosts"]):
                    try:
                        cur = self.store.get(PODS, key)
                    except NotFoundError:
                        continue
                    if cur.node_name == host:
                        landed = True
                        break
                report["window_landed"] = landed
                side = ("li1", "lni1", "t1") if landed \
                    else ("li0", "lni0", "t0")
                vals = [w[k] for k in side]
                if any(v is None for v in vals):
                    exact = False
                else:
                    li, lni, t = vals
            report["exact"] = exact
            if exact:
                tree = self.cache.node_tree
                tree.restore(ctx["tree_chk"])
                if t and t > 0:
                    # the committed prefix consumed t enumerations: one
                    # via list_names + (t-1) fast-forwards, mirroring the
                    # shell's own advance pattern
                    tree.list_names()
                    tree.advance_enumerations(t - 1)
            else:
                li = lni = None   # keep current counters; reconcile only
        # -- 2. authoritative relist -----------------------------------------
        for inf in list(self.informers._informers.values()):
            if inf.has_synced:
                inf._relist()
            else:
                inf.sync()
        # -- 3. cache reconcile ----------------------------------------------
        store_pods = {p.key: p for p in self.store.list(PODS)[0]}
        for assumed in self.cache.assumed_pods():
            cur = store_pods.get(assumed.key)
            if cur is not None and cur.node_name == assumed.node_name:
                # bound-but-unobserved: the write landed, the finish never
                # ran (or the informer skipped the self-inflicted update)
                self.cache.finish_binding(assumed)
                report["adopted"].append(assumed.key)
                continue
            # assumed-but-unbound (or bound elsewhere / deleted): the
            # assume died with the crash — forget it; the queue rebuild
            # below re-enters the live store object
            self.cache.forget_pod(assumed)
            if cur is not None and not cur.node_name \
                    and not cur.deleted and self._responsible_for(cur):
                report["requeued"].append(assumed.key)
        # -- 3b. activeQ rebuild from the relist ------------------------------
        # A restarted scheduler's queue is EMPTY: every pending pod
        # re-enters in creation order (the store lists in insertion
        # order), exactly the arrival order the never-crashed world's
        # informer fed its queue — so the post-restart pop order matches
        # the oracle's. This deliberately resets in-process backoff and
        # parked-gang state (it died with the process, as on a real
        # restart); pods mid-pop at the crash (the drained-but-undecided
        # burst tail) re-enter here too.
        pending = [cur for cur in store_pods.values()
                   if not cur.node_name and not cur.deleted
                   and self._responsible_for(cur)]
        for cur in pending:
            self.queue.delete(cur)
        for cur in pending:
            self.queue.add(cur)
        # -- 4. nominations ----------------------------------------------------
        for p in self.queue.nominated.all_pods():
            cur = store_pods.get(p.key)
            if cur is None or cur.node_name or not cur.nominated_node_name:
                self.queue.nominated.delete(p)
        for cur in store_pods.values():
            if not cur.node_name and cur.nominated_node_name:
                self.queue.nominated.add(cur)
        # -- 5. device state ---------------------------------------------------
        rec_dev = getattr(self.algorithm, "recover_device", None)
        if rec_dev is not None:
            rec_dev(li=li, lni=lni)
        else:
            if li is not None and hasattr(self.algorithm, "last_index"):
                self.algorithm.last_index = li
            if lni is not None \
                    and hasattr(self.algorithm, "last_node_index"):
                self.algorithm.last_node_index = lni
        self._snapshot = self.cache.update_snapshot(self._snapshot)
        return report

    def run(self, stop_after: Optional[Callable[[], bool]] = None) -> None:
        """wait.Until(scheduleOne, 0) analog; call from a thread."""
        while not self._stop.is_set():
            self.pump()
            self.schedule_one()
            if stop_after is not None and stop_after():
                return

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
