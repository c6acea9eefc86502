"""TorchScheduler — the port's counterpart of `kubernetes_tpu.core.
tpu_scheduler.TPUScheduler` on PyTorch and CUDA.

Same contract as the JAX package's TPUScheduler for the paths the port
carries:

- schedule(): one pod per launch (K2 `schedule_cycle`), with the same
  ScheduleResult/FitError, feasible sets, evaluated counts and scores;
  with nominated pods (the `nominated` handle), the load of the nominees
  of priority >= the pod's enters the filter as a ghost, the two-pass fit
  of podFitsOnNode. Where the reference decides on its host twin and the
  device cannot express the cycle, schedule() decides on the port's copy
  of that twin (`oracle.generic_scheduler.GenericScheduler`, counted
  under `twin.<reason>`): a call with `extra_configs` (the gang serial
  referee's trial-scoped priorities), and a nominated cycle where the pod
  or a counted nominee is not resource-only (volumes, pod-affinity
  terms, host ports, scalar requests);
- schedule_burst(): spec-identical, single-profile windows in the
  full-scan regime through the uniform K-batch kernel (K3
  `uniform_burst`), one launch and one packed device-to-host copy per
  chunk; every other window through the generic scan (K5
  `schedule_batch`), one launch and one packed copy per window;
- schedule_burst_fused(): a drain window of singleton runs and
  all-or-nothing gangs through the segment kernel (K6
  `schedule_segments`), gang rewinds inside the kernel;
- preempt(): one failed pod's victim scan over every candidate node (K7
  `preempt_scan`), with the oracle Preemptor's PreemptionResult;
- preempt_pressure_burst(): a failed burst tail scheduled-else-preempted
  in one K8 `pressure_batch` launch per 128-pod chunk and ONE fetch for
  the wave, with the serial loop's outcomes.

What the scheduler shell reads from its algorithm is TPUScheduler's too:
`supports_fused_segments`, `supports_wave_commit` with
`schedule_burst(commit=)` (`wave_size` windows of the fetched block,
`commit_marker`, `launch_cap`), `stale_scan` and StaleNodeRefusal,
`recover_device`, `metrics.observe_phase`, `serial_path` ("device",
"host", "adaptive"), `volume_listers` / `volume_binder` (the encoder's
volume masks and the host twin's volume predicates) and the class
signatures. The serving loop reads `inflight_launches`, the uniform
driver's launch queue occupancy (up to `launch_depth` chunks dispatched
and not yet consumed, 0 between bursts; `inflight_peak` keeps its most).
Every uniform, scan, fused and pressure launch opens a record on the
flight recorder (`obs.flight.RECORDER`) with the fetched blocks (copied
out of the pinned ring once their copy completed) and the outcome, and
every launch driver passes the chaos plane's node-death points
`dispatch-fetch` and `fetch-commit` around its fetch.

Device faults degrade as TPUScheduler's do (`breaker`, a copy of
core/breaker.py's DeviceCircuitBreaker). At each seam (`schedule`, the
uniform and scan bursts, the fused window, `preempt`, the pressure wave)
the chaos plane's `device.dispatch` / `device.fetch` points sit before the
launch and before the fetch. A DeviceFault injected there is absorbed:
the fault is booked with the breaker and under
`twin.device-fault` (a pressure wave's under `refusal.device-fault`), the
cycle is decided on the host twin, a burst drops its folds and hands its
undecided tail back to the shell (a trial burst without a commit callback
rewinds its walk counters and returns None), and the scans refuse so the
shell's oracle path decides. Consecutive faults open the circuit: every
device gate then refuses (`twin.circuit-open`, `refusal.circuit-open`)
until a half-open probe succeeds. Any other error — a CUDA error of a
launch or a copy, a kernel that does not build, a planner's refusal, a
wrong stamp — propagates.

`mesh=` (a `parallel.sharding.Mesh`, or "auto") splits the resident node
matrix over several devices: schedule() runs the sharded cycle (K9a/K9b),
the uniform burst the sharded K-batch passes (K9c/K9d), the generic scan
one step of K10a/K10b per live pod and the fused window one step of
K11a/K11b per pod, each window with one fetch; preempt() the sharded
victim scan (K14a on every shard, reduced to a candidate record per
shard, K14b's pick over them) and preempt_pressure_burst() one step of
K13a (one launch a device over its shards) and K13b per pod of each
128-pod chunk, the rows, ghost load and victim planes split per shard,
li / lni chained on the device and one fetch a wave. On several cards a
scan, fused or pressure step's records cross the cards on the device
(the locals write every card's buffer over NVLink and publish stamps the
selects wait for): 2 host calls a card and step, no event, no copy. On 4
x NVIDIA H100 80GB HBM3 at 700.00 W a scan or fused step takes
0.062-0.086 ms (1.7-2.5x the single-card step, against 17-20x when the
host copied the records), a pressure wave's 0.21-0.44 ms (4-9x; PERF.md
sections 5 and 7). The tests run every
mesh path on `["cpu"] * D`
(tests/test_torch_sharding*.py); `chip_smoke.py` drives them on four
shards of one card, and with `--cards` on a host's cards.

Folds stay on the device. The node matrix and the victim table's planes
are uploaded whole once and then kept current by the dirty-row scatter
(K4 `scatter_rows`). Every entry point runs on `cuda` unless
`device="cpu"` is passed. A window the JAX package also refuses is
refused whole (None), counted under `refusal.<reason>`.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch import chaos, obs
from kubernetes_tpu_torch.api.types import (
    Pod, get_container_ports, has_pod_affinity_terms)
from kubernetes_tpu_torch.cache.node_info import NodeInfo, calculate_resource
from kubernetes_tpu_torch.core import StaleNodeRefusal
from kubernetes_tpu_torch.core.breaker import DeviceCircuitBreaker
from kubernetes_tpu_torch.factory import (
    DEFAULT_PREDICATE_NAMES, build_predicate_set, build_priority_configs)
from kubernetes_tpu_torch.obs import flight as obs_flight
from kubernetes_tpu_torch.oracle import predicates as P
from kubernetes_tpu_torch.oracle.generic_scheduler import (
    ScheduleResult, FitError, GenericScheduler, default_priority_configs,
    num_feasible_nodes_to_find, DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
)
from kubernetes_tpu_torch.ops import PRIORITY_AXIS, resolve_device
from kubernetes_tpu_torch.ops import kernels as K
from kubernetes_tpu_torch.ops.node_state import (
    NodeStateEncoder, PodEncoder, PodFeatures, NodeBatch,
    IPA_EXISTING_ANTI, IPA_OWN_AFFINITY,
)
from kubernetes_tpu_torch.ops.pod_rows import pod_class_signature

#: the exceptions the circuit breaker absorbs at the device seams: the
#: chaos plane's injected DeviceFault only. A CUDA error (a launch's return
#: code, or one a device-to-host copy reports), a build failure, a
#: planner's refusal or a wrong stamp stops the run: a card that faulted
#: does not hand its decisions to the host unseen.
_DEVICE_FAULTS = chaos.device_fault_types()

#: rotation-row cache miss sentinel (None is a legal cached value:
#: "this order IS the identity")
_ROT_MISS = object()


def _pad_pow2(n: int, minimum: int = 1) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


class TorchScheduler:
    # node fields of the resident matrix, in upload order
    _NODE_FIELDS = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
                    "allowed_pods", "req_cpu", "req_mem", "req_eph",
                    "nz_cpu", "nz_mem", "pod_count", "alloc_scalar",
                    "req_scalar", "zone_id")
    # per-node mask fields that CANNOT change from in-burst placements
    _STATIC_MASKS = ("sel_ok", "taints_ok", "unsched_ok", "host_ok",
                     "ports_ok")
    # score/filter families the uniform kernel does not model at all
    _INERT_REQUIRED = ("disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok",
                       "node_aff_counts", "taint_counts", "spread_counts",
                       "image_sums", "prefer_avoid")
    # launches in flight ahead of the one being fetched
    launch_depth = 2
    # live launch queue occupancy (chunks dispatched, not yet consumed):
    # the serving backpressure gate reads it without a lock; and the most
    # it has been since a caller last set `inflight_peak` to 0
    inflight_launches = 0
    inflight_peak = 0
    # encode-at-admission pod-row cache (ops.pod_rows.PodRowCache); None =
    # per-window signatures (identical decisions either way)
    pod_rows = None
    # what the scheduler shell reads from its algorithm: it hands fused
    # drain windows to schedule_burst_fused, and a commit callback to
    # schedule_burst, which calls it on consecutive `wave_size` windows of
    # the one fetched block; `launch_cap` (None = B_CAP) caps a uniform
    # launch's chunk, so a serving window is one launch
    supports_fused_segments = True
    supports_wave_commit = True
    wave_size = 4096
    launch_cap: Optional[int] = None
    # serial_path "adaptive": the device is probed once a host-twin cycle
    # takes this long, and the slower path is probed again every this
    # many cycles (TPUScheduler's constants)
    _DEVICE_PROBE_MS = 30.0
    _REPROBE_EVERY = 1024

    def __init__(self,
                 percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE,
                 hard_pod_affinity_weight: int = 1,
                 services_fn=lambda: [],
                 replicasets_fn=lambda: [],
                 collect_host_priority: bool = True,
                 nominated=None,
                 volume_listers=None, volume_binder=None,
                 node_tree=None,
                 serial_path: str = "device",
                 device=None,
                 mesh=None):
        # multi-device mode: the node axis split over a Mesh of torch
        # devices (parallel/sharding.py); "auto" builds one over every
        # visible card when there are several, as TPUScheduler's
        # mesh="auto" does over its devices
        if mesh == "auto":
            mesh = None
            if torch.cuda.device_count() > 1:
                from kubernetes_tpu_torch.parallel import sharding as S
                mesh = S.make_mesh()
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.devices[0]
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.hard_pod_affinity_weight = hard_pod_affinity_weight
        self.services_fn = services_fn
        self.replicasets_fn = replicasets_fn
        self.collect_host_priority = collect_host_priority
        self.check_resources = True   # PodFitsResources enabled
        self.weights = None           # None -> kernels.DEFAULT_WEIGHTS
        self.enabled_predicates = None  # None -> all
        # provider / policy priorities by name: the host twin's configs
        # (None -> the DefaultProvider's)
        self.priority_name_weights = None
        # the host twin (built at its first cycle) and its priority
        # configs: one list, or one per profile
        self._oracle: Optional[GenericScheduler] = None
        self._oracle_cfgs: Optional[list] = None
        self._oracle_cfgs_prof: Optional[list] = None
        # scheduling profiles (set_profiles): in weight-table mode every
        # pod scores with the [profiles x priorities] row of its
        # schedulerName's profile, and the static weights become the
        # cross-profile union gate
        self.profiles = None
        self._ptab: Optional[np.ndarray] = None
        self._wtab_dev: Optional[torch.Tensor] = None
        self._union_weights: Optional[dict] = None
        self._gang_score = False      # any profile rank-aware
        # nominated-pod map handle (any object with has_any()): while
        # preemption has nominated pods, the device paths that do not model
        # them refuse (preempt, the pressure wave, the fused window)
        self.nominated = nominated
        # the volume predicates' listers and binder: the encoder's volume
        # masks and the host twin's volume predicates (None: no volumes)
        self.volume_listers = volume_listers
        self.volume_binder = volume_binder
        # the serial cycle's path: "device" (K2 always, the parity
        # configuration), "host" (the host twin always), "adaptive" (both
        # timed, the faster used: the production shell's choice)
        if serial_path not in ("device", "host", "adaptive"):
            raise ValueError(f"serial_path {serial_path!r}: not device, "
                             f"host or adaptive")
        self.serial_path = serial_path
        self._lat_ora: Optional[float] = None
        self._lat_dev: Optional[float] = None
        self._serial_cycles = 0
        # the shell's SchedulerMetrics handle: burst calls observe their
        # encode / kernel / fetch phase seconds (`observe_phase`)
        self.metrics = None
        # the shell's mid-burst node-death scan, `(decided_hosts,
        # all_names) -> dead set`: with a commit callback, a launch whose
        # decisions name a vanished node raises StaleNodeRefusal before
        # any of them commits
        self.stale_scan = None
        # walk counters at the last window handed to the commit callback
        # (the shell's crash-restart checkpoint; None: no window yet)
        self.commit_marker: Optional[dict] = None
        # NodeTree handle: burst decisions replay the per-cycle
        # zone-interleaved enumeration rotation; None = fixed name order
        self.node_tree = node_tree
        self.last_index = 0
        self.last_node_index = 0
        self.encoder = NodeStateEncoder()
        # resident node matrix: full upload on rebuild, dirty-row scatter
        # otherwise; in mesh mode one dict per shard
        self._dev_nodes = None
        self._dev_key = None
        self._dev_epoch = 0
        # K4's field tables of the resident tables, by (fields, device)
        self._k4_tables: dict = {}
        # inert per-pod fields are shape [1]; the kernels skip or
        # broadcast them
        self._defaults = {
            "ones_bool": np.ones(1, dtype=bool),
            "zeros_i64": np.zeros(1, dtype=np.int64),
            "zeros_i8": np.zeros(1, dtype=np.int8),
            "zeros_bool": np.zeros(1, dtype=bool),
            "tens_i64": np.full(1, 10, dtype=np.int64),
        }
        # rotation-row cache keyed per NodeBatch object (a rebuild or
        # permute makes a fresh batch, invalidating by identity)
        self._rot_rows: dict = {}
        self._rot_rows_b: Optional[int] = None
        # pinned host buffers for the packed decision blocks, by (cap, slot)
        self._pinned: dict = {}
        # host seconds of the last burst, by phase (encode, of which
        # mirror; dispatch; fetch)
        self.last_burst_phases: Optional[dict] = None
        # resident victim planes (K7/K8 input): full upload on a table
        # rebuild or permute, dirty-row scatter otherwise
        self._dev_vic: Optional[dict] = None
        self._dev_vic_key = None
        # host seconds of the last device preemption (a preempt() scan or
        # a pressure wave): encode, scan (dispatch and fetch) and the
        # fetch part of the scan
        self.last_preempt_phases: Optional[dict] = None
        # device circuit breaker: a failed launch or fetch decides that
        # cycle or burst on the host (same decisions); consecutive faults
        # open the circuit, and a half-open probe closes it again
        # (core/breaker.py)
        self.breaker = DeviceCircuitBreaker()

    # -- scheduling profiles -----------------------------------------------------
    def set_profiles(self, profiles) -> None:
        """Attach a profiles.ProfileSet. In tensor mode (several profiles,
        a non-default vector, or a rank-aware profile) every path scores
        each pod with its profile's weight-table row, and the segment
        kernel carries the gang zone counts when a profile is rank-aware.
        A degenerate default set keeps the static-weight programs."""
        self.profiles = profiles
        self._gang_score = False
        self._oracle_cfgs = self._oracle_cfgs_prof = None  # rebuilt lazily
        if profiles is not None and profiles.tensor_mode():
            self._set_weight_table(profiles.weight_table())
            self._gang_score = any(p.rank_aware for p in profiles)
        else:
            self._set_weight_table(None)

    def _profile_id(self, pod: Pod) -> int:
        if self.profiles is None:
            return 0
        pid = self.profiles.index_of(pod.scheduler_name)
        return 0 if pid is None else pid

    def _profile_ids(self, pods: list):
        """Per-pod profile-id vector of a window (None off the weight-table
        path), gathered from the pod-row cache when every row is live."""
        if self._ptab is None:
            return None
        rc = self.pod_rows
        if rc is not None:
            g = rc.gather(pods, ("profile_id",))
            if g is not None:
                return g["profile_id"].astype(np.int64)
        return np.asarray([self._profile_id(p) for p in pods], np.int64)

    # -- weight tensor ---------------------------------------------------------
    def _set_weight_table(self, ptab: Optional[np.ndarray]) -> None:
        """Attach (or drop) the [P, K] weight table: every score family
        any row weights runs, scaled per pod by its row."""
        self._wtab_dev = None
        if ptab is None:
            self._ptab = self._union_weights = None
            return
        self._ptab = np.asarray(ptab, dtype=np.int64)
        self._union_weights = {
            name: int(self._ptab[:, i].max()) if len(self._ptab) else 0
            for i, name in enumerate(PRIORITY_AXIS)}

    def _wtab(self) -> torch.Tensor:
        if self._wtab_dev is None:
            self._wtab_dev = torch.as_tensor(self._ptab).to(self.device)
        return self._wtab_dev

    # -- device input assembly -------------------------------------------------
    def _node_arrays(self, b: NodeBatch):
        """The resident node matrix; only rows the encoder marked
        generation-dirty are re-uploaded (one K4 launch for all fields, on
        each shard that owns one in mesh mode)."""
        key = (b.n_pad, len(b.scalar_names), id(b))
        if self._dev_nodes is None or self._dev_key != key \
                or b.dirty_rows is None:
            host = {k: np.asarray(getattr(b, k)) for k in self._NODE_FIELDS}
            if self.mesh is not None:
                from kubernetes_tpu_torch.parallel import sharding as S
                self._dev_nodes = S.shard_node_arrays(self.mesh, host)
            else:
                self._dev_nodes = {
                    k: torch.as_tensor(v).to(self.device, copy=True)
                    for k, v in host.items()}
            obs.inc("dispatch.upload")
            self._dev_epoch += 1
            self._dev_key = key
            b.dirty_rows = []   # host state fully mirrored; start tracking
            return self._dev_nodes
        if b.dirty_rows:
            self._scatter_dirty(self._dev_nodes, b.dirty_rows, b.n_pad, b,
                                [(k, k) for k in self._NODE_FIELDS])
            obs.inc("dispatch.scatter")
            self._dev_epoch += 1
            b.dirty_rows = []
        return self._dev_nodes

    def _scatter_dirty(self, dev, dirty, n_rows: int, src, fields) -> None:
        """K4 writes of the rows `dirty` of host table `src` (`fields`:
        (device key, host attribute) pairs) into the resident `dev`: on
        each device, one staged buffer (each shard's deduped rows, padded
        to a power-of-two bucket by repeating its first row, and every
        field's rows, taken from the host table straight into it), one
        copy to the device and ONE launch over every shard there that owns
        a dirty row (`K.scatter_dirty`). The device's field table is made
        once per resident table (`K.scatter_table`, kept in `_k4_tables`
        by field set and device)."""
        rows = np.asarray(sorted(set(dirty)), dtype=np.int64)
        keys = tuple(k for k, _f in fields)
        sources = [np.asarray(getattr(src, f)) for _k, f in fields]
        if self.mesh is None:
            groups = [(self.device, [dev], [(0, rows, 0)])]
        else:
            per = self.mesh.rows(n_rows)
            groups = []
            for d in self.mesh.distinct:
                idx = [s for s, x in enumerate(self.mesh.devices) if x == d]
                parts = []
                for k, s in enumerate(idx):
                    mine = rows[(rows >= s * per) & (rows < (s + 1) * per)]
                    if len(mine):
                        parts.append((k, mine, s * per))
                if parts:
                    groups.append((d, [dev[s] for s in idx], parts))
        for d, shards, parts in groups:
            key = (keys, str(d))
            table = self._k4_tables[key] = K.scatter_table(
                shards, keys, self._k4_tables.get(key))
            with K._on(d):
                K.scatter_dirty(table, parts, sources)

    def _pod_arrays(self, f: PodFeatures, upd_fields: bool = False,
                    pod: Optional[Pod] = None) -> dict:
        """Host inputs for one pod; feature fields the pod does not
        exercise stay shape [1]. `upd_fields` adds the node-state delta a
        placement folds in (regular containers only, calculate_resource),
        which the burst scans need."""
        d = self._defaults
        out = {
            "req_cpu": np.int64(f.req_cpu),
            "req_mem": np.int64(f.req_mem),
            "req_eph": np.int64(f.req_eph),
            "req_scalar": f.req_scalar,
            "has_request": np.bool_(f.has_request),
            "unknown_scalar": np.bool_(bool(f.unknown_scalars)),
            "skip": np.bool_(False),
            "check_resources": np.bool_(self.check_resources),
            "nz_cpu": np.int64(f.nz_cpu),
            "nz_mem": np.int64(f.nz_mem),
            "sel_ok": f.sel_ok if f.sel_ok is not None else d["ones_bool"],
            "taints_ok": f.taints_ok if f.taints_ok is not None else d["ones_bool"],
            "unsched_ok": f.unsched_ok if f.unsched_ok is not None else d["ones_bool"],
            "ports_ok": f.ports_ok if f.ports_ok is not None else d["ones_bool"],
            "host_ok": f.host_ok if f.host_ok is not None else d["ones_bool"],
            "disk_ok": f.disk_ok if f.disk_ok is not None else d["ones_bool"],
            "maxvol_ok": f.maxvol_ok if f.maxvol_ok is not None else d["ones_bool"],
            "volbind_ok": f.volbind_ok if f.volbind_ok is not None else d["ones_bool"],
            "volzone_ok": f.volzone_ok if f.volzone_ok is not None else d["ones_bool"],
            "interpod_code": f.interpod_code if f.interpod_code is not None else d["zeros_i8"],
            "node_aff_counts": f.node_aff_counts if f.node_aff_counts is not None else d["zeros_i64"],
            "taint_counts": f.taint_counts if f.taint_counts is not None else d["zeros_i64"],
            "spread_counts": f.spread_counts if f.spread_counts is not None else d["zeros_i64"],
            "interpod_counts": f.interpod_counts if f.interpod_counts is not None else d["zeros_i64"],
            "interpod_tracked": f.interpod_tracked if f.interpod_tracked is not None else d["zeros_bool"],
            "image_sums": f.image_sums if f.image_sums is not None else d["zeros_i64"],
            "prefer_avoid": f.prefer_avoid if f.prefer_avoid is not None else d["tens_i64"],
        }
        if upd_fields:
            upd = calculate_resource(pod)
            upd_scalar = np.zeros_like(f.req_scalar)
            vocab = list(self.encoder._scalar_vocab)
            for name, q in upd.scalar.items():
                upd_scalar[vocab.index(name)] = q
            out.update({"upd_cpu": np.int64(upd.milli_cpu),
                        "upd_mem": np.int64(upd.memory),
                        "upd_eph": np.int64(upd.ephemeral_storage),
                        "upd_scalar": upd_scalar})
        return out

    # -- reason decoding -------------------------------------------------------
    def _decode_reasons(self, b: NodeBatch, f: PodFeatures, idx: int,
                        fail_first: np.ndarray,
                        general_bits: np.ndarray) -> list[str]:
        code = int(fail_first[idx])
        if code == K.FAIL_UNSCHEDULABLE:
            return [P.ERR_NODE_UNSCHEDULABLE]
        if code == K.FAIL_TAINTS:
            return [P.ERR_TAINTS_TOLERATIONS_NOT_MATCH]
        if code == K.FAIL_DISK:
            return ["NoDiskConflict"]
        if code == K.FAIL_MAXVOL:
            return ["MaxVolumeCount"]
        if code in (K.FAIL_VOLBIND, K.FAIL_VOLZONE):
            if f.volbind_reasons and idx in f.volbind_reasons:
                return list(f.volbind_reasons[idx])
            return (["VolumeBindingNoMatch"] if code == K.FAIL_VOLBIND
                    else ["NoVolumeZoneConflict"])
        if code == K.FAIL_INTERPOD:
            ipa = int(f.interpod_code[idx]) if f.interpod_code is not None else 0
            if ipa == IPA_EXISTING_ANTI:
                return [P.ERR_POD_AFFINITY_NOT_MATCH,
                        P.ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH]
            if ipa == IPA_OWN_AFFINITY:
                return [P.ERR_POD_AFFINITY_NOT_MATCH,
                        P.ERR_POD_AFFINITY_RULES_NOT_MATCH]
            return [P.ERR_POD_AFFINITY_NOT_MATCH,
                    P.ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH]
        # general predicates, reason order as predicates.general_predicates
        bits = int(general_bits[idx])
        reasons = []
        if bits & (1 << K.BIT_PODS):
            reasons.append(P.insufficient_resource("pods"))
        if bits & (1 << K.BIT_CPU):
            reasons.append(P.insufficient_resource("cpu"))
        if bits & (1 << K.BIT_MEM):
            reasons.append(P.insufficient_resource("memory"))
        if bits & (1 << K.BIT_EPH):
            reasons.append(P.insufficient_resource("ephemeral-storage"))
        for s, name in enumerate(b.scalar_names):
            if bits & (1 << (K.BIT_SCALAR0 + s)):
                reasons.append(P.insufficient_resource(name))
        if bits & (1 << K.BIT_UNKNOWN_SCALAR):
            reasons.extend(P.insufficient_resource(n) for n in f.unknown_scalars)
        if bits & (1 << K.BIT_HOST):
            reasons.append(P.ERR_POD_NOT_MATCH_HOST_NAME)
        if bits & (1 << K.BIT_PORTS):
            reasons.append(P.ERR_POD_NOT_FITS_HOST_PORTS)
        if bits & (1 << K.BIT_SELECTOR):
            reasons.append(P.ERR_NODE_SELECTOR_NOT_MATCH)
        return reasons

    def _pod_encoder(self, node_infos, b: NodeBatch) -> PodEncoder:
        return PodEncoder(node_infos, b, self.services_fn(),
                          self.replicasets_fn(),
                          hard_pod_affinity_weight=self.hard_pod_affinity_weight,
                          enabled=self.enabled_predicates,
                          volume_listers=self.volume_listers,
                          volume_binder=self.volume_binder,
                          state_encoder=self.encoder)

    # -- single-pod cycle --------------------------------------------------------
    def _device_fault(self, exc: BaseException) -> str:
        """Book one absorbed device fault with the circuit breaker; returns
        the seam (an injected fault carries its own; a CUDA error books
        as device.runtime)."""
        seam = getattr(exc, "seam", "device.runtime")
        self.breaker.record_fault(seam)
        return seam

    def schedule(self, pod: Pod, node_infos: dict[str, NodeInfo],
                 all_node_names: list[str],
                 extra_configs=None) -> ScheduleResult:
        """One pod's cycle. Routes as TPUScheduler.schedule does, in its
        order, where the device cannot decide: `extra_configs`
        (trial-scoped priorities, the gang serial referee's
        GangLocalityPriority) and a nominated cycle the device ghost
        cannot express go to the host twin (`twin.<reason>`); then
        `serial_path` chooses: "host" the twin (`twin.serial-path-host`),
        "adaptive" the faster of the two by their running latencies
        (`twin.adaptive-twin-faster`), "device" K2 (K9a / K9b on a
        mesh)."""
        if not all_node_names:
            raise FitError(pod, 0, {})
        self._serial_cycles += 1
        nominees = []
        if extra_configs:
            reason = "gang-locality-serial"
        else:
            reason = None
            nominees = self._nominees(pod, all_node_names)
            if nominees and any(self._ghost_gate(p) is not None
                                for p in [pod] + [p for _, p in nominees]):
                reason = "nominated-ghosts"
            elif not self.breaker.allow_device():
                # circuit open: host only until a probe succeeds
                reason = "circuit-open"
            elif self.serial_path == "adaptive":
                if self._serial_pick_host_twin():
                    reason = "adaptive-twin-faster"
            elif self.serial_path == "host":
                reason = "serial-path-host"
        t0 = time.perf_counter()
        try:
            if reason is not None:
                return self._schedule_host_twin(
                    reason, pod, node_infos, all_node_names, extra_configs)
            try:
                return self._schedule_device(pod, node_infos,
                                             all_node_names, nominees)
            except _DEVICE_FAULTS as e:
                # a failed launch or fetch decides THIS cycle on the host
                # twin: the same decision, only slower
                self._device_fault(e)
                reason = "device-fault"
                return self._schedule_host_twin(
                    reason, pod, node_infos, all_node_names)
        finally:
            dt = time.perf_counter() - t0
            if reason is not None:
                self._lat_ora = dt if self._lat_ora is None \
                    else 0.7 * self._lat_ora + 0.3 * dt
            else:
                self._lat_dev = dt if self._lat_dev is None \
                    else 0.7 * self._lat_dev + 0.3 * dt

    def _serial_pick_host_twin(self) -> bool:
        """serial_path "adaptive": the host twin first; the device probed
        once a twin cycle takes `_DEVICE_PROBE_MS`; then the faster by the
        running latencies, the slower probed again every
        `_REPROBE_EVERY` cycles (TPUScheduler._serial_pick_host_twin)."""
        ora, dev = self._lat_ora, self._lat_dev
        if ora is None:
            return True
        if ora < self._DEVICE_PROBE_MS / 1e3:
            return True
        if dev is None:
            return False
        if self._serial_cycles % self._REPROBE_EVERY == 0:
            return ora >= dev
        return ora < dev

    def _oracle_fallback(self) -> GenericScheduler:
        """The host twin and its priority configs, built at first use:
        per profile (`ProfileSet.oracle_configs`) when profiles are set,
        else from `priority_name_weights`, else the DefaultProvider's, as
        TPUScheduler._oracle_fallback builds them."""
        if self._oracle is None:
            nom = self.nominated
            self._oracle = GenericScheduler(
                percentage_of_nodes_to_score=self.percentage_of_nodes_to_score,
                hard_pod_affinity_weight=self.hard_pod_affinity_weight,
                nominated_pods_fn=(nom.pods_for_node if nom is not None
                                   else lambda name: []))
        if self._oracle_cfgs is None:
            kw = dict(services_fn=self.services_fn,
                      replicasets_fn=self.replicasets_fn,
                      hard_pod_affinity_weight=self.hard_pod_affinity_weight)
            if self.profiles is not None:
                self._oracle_cfgs_prof = [
                    self.profiles.oracle_configs(i, **kw)
                    for i in range(len(self.profiles))]
                self._oracle_cfgs = self._oracle_cfgs_prof[0]
            elif self.priority_name_weights is not None:
                self._oracle_cfgs = build_priority_configs(
                    self.priority_name_weights, **kw)
            else:
                self._oracle_cfgs = default_priority_configs(**kw)
        return self._oracle

    def _schedule_host_twin(self, reason: str, pod: Pod,
                            node_infos: dict[str, NodeInfo],
                            all_node_names: list[str],
                            extra_configs=None) -> ScheduleResult:
        """One cycle on the host twin (TPUScheduler._schedule_host_twin):
        the walk counters go in and come back out, so the next device
        cycle walks on from where the twin stopped. Counted under
        `twin.<reason>` (the reference's ORACLE_FALLBACKS labels)."""
        obs.inc("twin." + reason)
        o = self._oracle_fallback()
        o.last_index, o.last_node_index = self.last_index, self.last_node_index
        funcs = build_predicate_set(
            sorted(self.enabled_predicates) if self.enabled_predicates
            else DEFAULT_PREDICATE_NAMES, node_infos,
            volume_listers=self.volume_listers,
            volume_binder=self.volume_binder)
        cfgs = self._oracle_cfgs
        if self._oracle_cfgs_prof is not None:
            cfgs = self._oracle_cfgs_prof[self._profile_id(pod)]
        if extra_configs:
            cfgs = list(cfgs) + list(extra_configs)
        try:
            return o.schedule(pod, node_infos, all_node_names,
                              predicate_funcs=funcs, priority_configs=cfgs)
        finally:
            self.last_index = o.last_index
            self.last_node_index = o.last_node_index

    def _schedule_device(self, pod: Pod, node_infos: dict[str, NodeInfo],
                         all_node_names: list[str],
                         nominees: list) -> ScheduleResult:
        b = self.encoder.encode(node_infos, all_node_names)
        nodes = self._node_arrays(b)
        feats = self._pod_encoder(node_infos, b).encode(pod)
        pod_in = self._pod_arrays(feats)
        wtab = None
        weights = self.weights
        if self._ptab is not None:
            pod_in["profile_id"] = np.int64(self._profile_id(pod))
            wtab = self._wtab()
            weights = self._union_weights
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        z_pad = _pad_pow2(len(b.zone_names), 4)
        chaos.check("device.dispatch")
        out = K.schedule_cycle(nodes, pod_in, self.last_index,
                               self.last_node_index, num_to_find, n, z_pad,
                               weights=weights, wtab=wtab,
                               ghost=self._nominated_ghost(nominees, b),
                               **self._mesh_kw())
        obs.inc("dispatch.cycle")
        keys = ["selected", "found", "evaluated", "next_last_index",
                "next_last_node_index", "kept", "total", "fail_first",
                "general_bits"]
        chaos.node_dead_point("dispatch-fetch")
        chaos.check("device.fetch")
        h = {k: out[k].cpu().numpy() for k in keys}
        chaos.node_dead_point("fetch-commit")
        self.breaker.record_success()
        obs.inc("fetch.cycle")
        found = int(h["found"])
        evaluated = int(h["evaluated"])
        start = self.last_index
        self.last_index = int(h["next_last_index"])
        fail_first, general_bits = h["fail_first"], h["general_bits"]
        if found == 0:
            failed = {}
            for pos in range(evaluated):
                idx = (start + pos) % n
                failed[b.names[idx]] = self._decode_reasons(
                    b, feats, idx, fail_first, general_bits)
            raise FitError(pod, n, failed)
        self.last_node_index = int(h["next_last_node_index"])
        host = b.names[int(h["selected"])]
        host_priority = []
        failed = {}
        if self.collect_host_priority:
            kept, total = h["kept"], h["total"]
            for pos in range(evaluated):
                idx = (start + pos) % n
                if kept[idx]:
                    # single-feasible-node cycles skip scoring entirely
                    score = 0 if found == 1 else int(total[idx])
                    host_priority.append((b.names[idx], score))
                elif fail_first[idx] != K.FAIL_NONE:
                    failed[b.names[idx]] = self._decode_reasons(
                        b, feats, idx, fail_first, general_bits)
        return ScheduleResult(host, evaluated, found, host_priority, failed)

    @staticmethod
    def _ghost_gate(pod: Pod) -> Optional[str]:
        """What keeps `pod` out of the device ghost (None: nothing): the
        pressure wave's pod gates. A nominee with volumes, pod-affinity
        terms, host ports or scalar requests changes more of the two-pass
        fit than the resource rows the filter reads."""
        from kubernetes_tpu_torch.api.types import get_resource_request
        if pod.volumes:
            return "volumes"
        if has_pod_affinity_terms(pod):
            return "pod-affinity terms"
        if get_container_ports(pod):
            return "host ports"
        if get_resource_request(pod).scalar:
            return "scalar requests"
        return None

    def _nominees(self, pod: Pod, names: list[str]) -> list:
        """The nominated pods a cycle of `pod` counts, as (node name, pod):
        on each node of `names`, those of priority >= the pod's other than
        the pod itself (`pod_fits_on_node_with_nominated`,
        oracle/preemption.py). Empty without nominees."""
        nom = self.nominated
        if nom is None or not nom.has_any():
            return []
        return [(name, p) for name in names for p in nom.pods_for_node(name)
                if p.priority >= pod.priority and p.uid != pod.uid]

    @staticmethod
    def _nominated_ghost(nominees: list, b: NodeBatch) -> Optional[dict]:
        """The serial cycle's nominated-ghost load ({cpu, mem, eph, cnt}
        [n_pad] int64, or None when no nominee counts): on each node row,
        each counted nominee (`_nominees`) adds the load NodeInfo.add_pod
        adds (calculate_resource) and one pod. Nominees on nodes outside
        the snapshot are ignored. With resource-only nominees (schedule()
        sends any other cycle to the host twin) the filter with the ghost
        is the two-pass fit (the pass without them is implied)."""
        ghost = {k: np.zeros(b.n_pad, np.int64) for k in K.GHOST_FIELDS}
        counted = 0
        for name, p in nominees:
            i = b.index.get(name)
            if i is None:
                continue
            r = calculate_resource(p)
            ghost["cpu"][i] += r.milli_cpu
            ghost["mem"][i] += r.memory
            ghost["eph"][i] += r.ephemeral_storage
            ghost["cnt"][i] += 1
            counted += 1
        if not counted:
            return None
        obs.inc("dispatch.cycle_ghost")
        return ghost

    # -- burst path --------------------------------------------------------------
    @staticmethod
    def _class_signature(pod: Pod) -> tuple:
        """Spec fields that determine a pod's device features against a
        fixed snapshot: equal signatures imply identical encoder output
        (`ops.pod_rows.pod_class_signature`, the canonical definition).
        The shell classifies its burst windows by it."""
        return pod_class_signature(pod)

    @staticmethod
    def class_signatures(pods: list) -> list:
        """`_class_signature` of every pod of a window."""
        return [pod_class_signature(p) for p in pods]

    def _signatures(self, pods: list) -> list:
        """A window's signatures: from the pod-row cache when the shell
        attached one (interned: equal signatures are one tuple), else
        `class_signatures`."""
        rc = self.pod_rows
        if rc is not None:
            return rc.signatures(pods)
        return self.class_signatures(pods)

    def _uniform_class(self, p0: Pod, f0, b: NodeBatch,
                       node_infos: dict[str, NodeInfo]) -> Optional[tuple]:
        """Eligibility + class extraction for a burst of pods spec-identical
        to `p0`: (cls_scalars, extra_ok, ban) when the feature interactions
        reduce to a static per-node mask plus an optional self-node ban,
        else None (TPUScheduler._uniform_class, same rules)."""
        from kubernetes_tpu_torch.api.types import (
            get_container_ports, LABEL_HOSTNAME)
        if f0.unknown_scalars:
            return None
        upd = calculate_resource(p0)
        upd_scalar = np.zeros_like(f0.req_scalar)
        for name, q in upd.scalar.items():
            upd_scalar[list(self.encoder._scalar_vocab).index(name)] = q
        cls = {"req_cpu": f0.req_cpu, "req_mem": f0.req_mem,
               "req_eph": f0.req_eph, "req_scalar": f0.req_scalar,
               "nz_cpu": f0.nz_cpu, "nz_mem": f0.nz_mem,
               "upd_cpu": upd.milli_cpu, "upd_mem": upd.memory,
               "upd_eph": upd.ephemeral_storage,
               "upd_scalar": upd_scalar,
               "has_request": f0.has_request}
        for field in self._INERT_REQUIRED:
            if getattr(f0, field) is not None:
                return None
        nreal = b.n_real
        # interpod scores must be a constant shift: every valid node
        # tracked and equal counts
        if f0.interpod_counts is not None or f0.interpod_tracked is not None:
            tr, ic = f0.interpod_tracked, f0.interpod_counts
            if tr is None or not bool(np.all(tr[:nreal])):
                return None
            if ic is None or (nreal and int(np.ptp(ic[:nreal])) != 0):
                return None
        extra: Optional[np.ndarray] = None

        def and_mask(m) -> None:
            nonlocal extra
            if m is not None:
                mm = np.asarray(m, dtype=bool)
                if mm.shape[0] != b.n_pad:      # inert [1] fields
                    return
                extra = mm.copy() if extra is None else (extra & mm)

        for field in self._STATIC_MASKS:
            and_mask(getattr(f0, field))
        if f0.interpod_code is not None:
            and_mask(f0.interpod_code == 0)
        ban = bool(get_container_ports(p0))   # identical host ports conflict
        a = p0.affinity
        if a is not None and (a.pod_affinity is not None
                              or a.pod_anti_affinity is not None):
            pa, paa = a.pod_affinity, a.pod_anti_affinity
            if (pa and pa.preferred) or (paa and paa.preferred):
                return None

            def self_match(term) -> bool:
                if term.namespaces and p0.namespace not in term.namespaces:
                    return False
                return term.label_selector is not None \
                    and term.label_selector.matches(p0.labels)

            ban_anti = False
            for term in (paa.required if paa else ()):
                if self_match(term):
                    # the node-ban fold is exact only for singleton groups
                    if term.topology_key != LABEL_HOSTNAME:
                        return None
                    ban_anti = True
            for term in (pa.required if pa else ()):
                if self_match(term):
                    # static only when every valid node is in ONE group
                    vals = set()
                    for i in range(nreal):
                        node = node_infos[b.names[i]].node
                        vals.add(None if node is None
                                 else node.labels.get(term.topology_key))
                    if len(vals) != 1 or None in vals:
                        return None
            if ban_anti:
                hosts = set()
                for i in range(nreal):
                    node = node_infos[b.names[i]].node
                    h = None if node is None else node.labels.get(LABEL_HOSTNAME)
                    if h is None or h in hosts:
                        return None       # hostname groups must be singleton
                    hosts.add(h)
                ban = True
        return cls, extra, ban

    def _tree_rotates(self) -> bool:
        """True when the NodeTree's per-cycle enumeration can ever differ
        from the device axis: several zones of uneven sizes."""
        tree = self.node_tree
        if tree is None or len(tree._zones) <= 1:
            return False
        sizes = {len(tree._tree[z]) for z in tree._zones}
        return len(sizes) > 1

    def _axis_order(self, all_node_names: list):
        """(axis_order, start0): keep the resident axis when this launch's
        enumeration is provably order_for_start(start0) of it; any doubt
        falls back to axis == enumeration."""
        tree = self.node_tree
        b = self.encoder._batch
        if tree is None or b is None or b.names == all_node_names \
                or not self._tree_rotates():
            return all_node_names, None
        rr = tree.last_enum_start
        if rr is None:
            return all_node_names, None
        order = tree._order_cache.get(rr)
        if order is None or order != all_node_names:
            return all_node_names, None
        if len(b.names) != len(all_node_names) \
                or set(b.names) != set(all_node_names):
            return all_node_names, None   # membership moved: rebuild
        return b.names, rr

    def _rot_cached(self, b: NodeBatch, rr: int, identity: np.ndarray,
                    kind: str):
        """Padded axis-index row of the enumeration starting at zone index
        `rr`, or None when it is the identity. `kind` "u" pads with the
        n_pad scratch column (K3), "g" with the invalid-row tail (K5/K6)."""
        if self._rot_rows_b != id(b):
            self._rot_rows = {}
            self._rot_rows_b = id(b)
        key = (kind, rr)
        got = self._rot_rows.get(key, _ROT_MISS)
        if got is not _ROT_MISS:
            return got
        names = self.node_tree.order_for_start(rr)
        raw = np.fromiter((b.index[nm] for nm in names), np.int32,
                          len(names))
        if np.array_equal(raw, identity[: len(raw)]):
            row = None
        elif kind == "u":
            row = np.concatenate([
                raw, np.full(b.n_pad + 1 - len(raw), b.n_pad,
                             dtype=np.int32)])
        else:
            row = np.concatenate([
                raw, np.arange(b.n_real, b.n_pad, dtype=np.int32)])
        self._rot_rows[key] = row
        return row

    def _rot_identity(self, b: NodeBatch, kind: str) -> np.ndarray:
        """The axis-order (identity) permutation row of pad layout `kind`."""
        if self._rot_rows_b != id(b):
            self._rot_rows = {}
            self._rot_rows_b = id(b)
        key = ("id", kind)
        row = self._rot_rows.get(key)
        if row is None:
            if kind == "u":
                row = np.concatenate([
                    np.arange(b.n_real, dtype=np.int32),
                    np.full(b.n_pad + 1 - b.n_real, b.n_pad,
                            dtype=np.int32)])
            else:
                row = np.arange(b.n_pad, dtype=np.int32)
            self._rot_rows[key] = row
        return row

    def _burst_rotation(self, b: NodeBatch, n_pods: int,
                        start0: Optional[int] = None):
        """Per-cycle enumeration orders for a burst: pod 0 rides the device
        axis; pod i >= 1 rides the order starting at the tree's current
        zone index walked i-1 steps through rotation_map. None only when
        the tree can never rotate; the row count pads to a power of two."""
        if not self._tree_rotates():
            return None
        tree = self.node_tree
        nxt = tree.rotation_map()
        r = tree.zone_index
        length = n_pods + K.K_BATCH
        identity = self._rot_identity(b, "u")
        perm_rows = [identity]
        id_of_r: dict[int, int] = {}

        def order_id(rr: int) -> int:
            iid = id_of_r.get(rr)
            if iid is None:
                row = self._rot_cached(b, rr, identity, "u")
                if row is None:
                    iid = 0
                else:
                    perm_rows.append(row)
                    iid = len(perm_rows) - 1
                id_of_r[rr] = iid
            return iid

        seq = np.zeros(length, dtype=np.int32)
        if start0 is not None:
            seq[0] = order_id(start0)
        if nxt[r] == r:
            seq[1:] = order_id(r)     # fixed-point walk
        else:
            for i in range(1, length):
                seq[i] = order_id(r)
                r = nxt[r]
        perms = np.stack(perm_rows)
        l_pad = _pad_pow2(len(perm_rows), 4)
        if len(perm_rows) < l_pad:
            perms = np.concatenate(
                [perms, np.repeat(perms[:1], l_pad - len(perm_rows), axis=0)])
        return perms, seq

    def _generic_rotation(self, b: NodeBatch, bucket: int,
                          start0: Optional[int] = None):
        """(perms[L, n_pad], inv_perms, oid_seq[bucket]) for the scans: each
        in-burst cycle's enumeration order as axis indices (invalid rows
        tail every permutation, so the walk masks them out). oid_seq[0] is
        the axis itself, the enumeration the shell consumed for pod 0."""
        tree = self.node_tree
        if tree is None:
            return None
        nxt = tree.rotation_map()
        r = tree.zone_index
        n_pad = b.n_pad
        identity = self._rot_identity(b, "g")
        perm_rows = [identity]
        id_of_r: dict[int, int] = {}

        def order_id(rr: int) -> int:
            iid = id_of_r.get(rr)
            if iid is None:
                row = self._rot_cached(b, rr, identity, "g")
                if row is None:
                    iid = 0
                else:
                    perm_rows.append(row)
                    iid = len(perm_rows) - 1
                id_of_r[rr] = iid
            return iid

        seq = np.zeros(bucket, dtype=np.int32)
        if start0 is not None:
            seq[0] = order_id(start0)   # stale-axis mode (_axis_order)
        for t in range(1, bucket):
            seq[t] = order_id(r)
            r = nxt[r]
        l_pad = _pad_pow2(len(perm_rows), 4)
        while len(perm_rows) < l_pad:
            perm_rows.append(perm_rows[0])
        skey = ("stack-g", tuple(map(id, perm_rows)))
        got = self._rot_rows.get(skey)
        if got is None:
            perms = np.stack(perm_rows)
            inv = np.empty_like(perms)
            for k in range(perms.shape[0]):
                inv[k, perms[k]] = np.arange(n_pad, dtype=np.int32)
            got = self._rot_rows[skey] = (perms, inv)
        perms, inv = got
        return perms, inv, seq

    def _refuse(self, reason: str) -> None:
        obs.inc("refusal." + reason)
        return None

    def _mesh_kw(self) -> dict:
        """The `mesh=` argument of the kernel entry points, in mesh mode
        only (the single-device calls keep the single-device signature)."""
        return {} if self.mesh is None else {"mesh": self.mesh}

    def _adopt_folds(self, rows) -> None:
        """Make a window's folded rows the resident matrix (one dict per
        shard in mesh mode)."""
        if self.mesh is None:
            self._dev_nodes = {**self._dev_nodes, **rows}
        else:
            self._dev_nodes = [{**d, **r}
                               for d, r in zip(self._dev_nodes, rows)]

    def _mesh_phases(self, op: str, phases: dict, before: dict) -> None:
        """Mesh mode: the bytes of the all-gather, the record copies it
        enqueued (uniform bursts, scan and fused windows, pressure waves)
        and the steps (or passes) of the last window, from the counters
        its sharded program books."""
        if self.mesh is None:
            return
        for k, name in (("gather", "gather_bytes"), ("copies", "copies"),
                        ("steps", "steps"),
                        ("passes", "passes"), ("syncs", "syncs")):
            key = f"{k}.{op}"
            if key in before:
                phases[name] = obs.get(key) - before[key]

    def _mesh_counts(self, op: str, *kinds) -> dict:
        return {f"{k}.{op}": obs.get(f"{k}.{op}") for k in kinds}

    def _observe(self, phase: str, seconds: float) -> None:
        """One burst phase's host seconds to the shell's metrics:
        "encode", "kernel" (a launch's dispatch) or "fetch", where
        TPUScheduler observes the same names."""
        if self.metrics is not None:
            self.metrics.observe_phase(phase, seconds)

    def schedule_burst(self, pods: list[Pod], node_infos: dict[str, NodeInfo],
                       all_node_names: list[str],
                       bucket: Optional[int] = None,
                       commit=None) -> Optional[list[Optional[str]]]:
        """Schedule `pods` against one snapshot; returns per-pod host (or
        None when unschedulable), serially equivalent to schedule() per pod
        with cache assumes in between. Spec-identical, single-profile
        windows in the full-scan regime (num_to_find >= n, last_index 0)
        go to the uniform kernel K3, every other window to the generic
        scan K5. Returns None — a whole-burst refusal, counted under
        `refusal.<reason>` — for the windows the JAX package refuses too:
        pods whose masks depend on in-burst placements (affinity, host
        ports) outside the uniform class, and selector spread over mixed
        specs. The shell then runs those pods serially.

        The folds stay on the device: the caller MUST apply the returned
        placements to its cache (assume + note_burst_assumed_many) before
        the next cycle.

        `commit(lo, hosts) -> bool` (optional) is the shell's wave sink:
        it is called with consecutive windows of at most `wave_size`
        decided hosts, read out of the launch's one fetched block, each
        after `commit_marker` holds the walk counters at the window's
        edges. False stops the consumption: the rest of the block and the
        resident folds are discarded, and the delivered prefix returns
        with a None tail. With `stale_scan` set, a launch whose decisions
        name a node the shell no longer has raises StaleNodeRefusal
        before any of its windows commits."""
        if not all_node_names or not pods:
            return [None] * len(pods)
        self.commit_marker = None
        if not self.breaker.allow_device():
            # circuit open: refuse the whole burst before any launch; the
            # shell runs the pods serially, where schedule() picks the
            # host twin under the same open circuit
            obs.inc("twin.circuit-open")
            return None
        t0 = time.perf_counter()
        axis_order, start0 = self._axis_order(all_node_names)
        b = self.encoder.encode(node_infos, axis_order)
        self._node_arrays(b)
        t_mirror = time.perf_counter() - t0
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        bucket = _pad_pow2(bucket if bucket else len(pods), 16)
        enc = self._pod_encoder(node_infos, b)
        sigs = self._signatures(pods)
        s0 = sigs[0]
        uniform_spec = all(s is s0 or s == s0 for s in sigs)
        # a uniform window must be single-profile too: other weight rows
        # change the tie structure the K-batch modes rely on
        pids = self._profile_ids(pods)
        pid0 = 0 if pids is None else int(pids[0])
        uniform_profile = pids is None or int(pids.min()) == int(pids.max())
        uniform = f0 = None
        if num_to_find >= n and self.last_index == 0 and uniform_profile \
                and uniform_spec:
            f0 = enc.encode(pods[0])
            uniform = self._uniform_class(pods[0], f0, b, node_infos)
        # encode = the whole host prologue; mirror = its node-mirror
        # encode and upload part
        phases = {"encode": 0.0, "mirror": t_mirror, "dispatch": 0.0,
                  "fetch": 0.0}
        if uniform is not None:
            cls, extra_ok, ban = uniform
            rotation = self._burst_rotation(b, len(pods), start0)
            # the record opens before any window commits (a replay-mode
            # record clones the world as the launch sees it)
            fl = obs_flight.RECORDER.begin("uniform", self, [(pods, False)],
                                           all_node_names, node_infos)
            phases["encode"] = time.perf_counter() - t0
            self._observe("encode", phases["encode"])
            self.last_burst_phases = phases
            sel = self._uniform_waves(pods, b, cls, extra_ok, ban, rotation,
                                      n, bucket, phases, pid0, commit, fl)
            if sel is None:
                return None
            return [b.names[s] for s in sel] \
                + [None] * (len(pods) - len(sel))
        if any(has_pod_affinity_terms(p) or get_container_ports(p)
               for p in pods):
            # the scan encodes per-node masks once per window; masks that
            # depend on in-burst placements are exact only on the uniform
            # path above
            return self._refuse("burst-affinity-mixed")
        # one encode per signature: equal signatures give identical
        # encoder output against one snapshot
        row_of_sig: dict = {}
        feats, spec_pods, rows = [], [], []
        for p, sig in zip(pods, sigs):
            r = row_of_sig.get(sig)
            if r is None:
                r = row_of_sig[sig] = len(feats)
                feats.append(f0 if (r == 0 and f0 is not None)
                             else enc.encode(p))
                spec_pods.append(p)
            rows.append(r)
        # selector-spread counts change with every in-burst placement; the
        # scan carries them only for spec-identical pods (one selector set)
        carry_spread = any(f.spread_counts is not None for f in feats)
        if carry_spread and not uniform_spec:
            return self._refuse("burst-spread-mixed")
        spread0 = feats[0].spread_counts if carry_spread else None
        if carry_spread and spread0.shape[-1] != b.n_pad:
            return self._refuse("burst-spread-shape")
        specs = [self._pod_arrays(f, upd_fields=True, pod=p)
                 for f, p in zip(feats, spec_pods)]
        if carry_spread:
            # the scan carries ONE [n_pad] vector; the field stays inert
            for spec in specs:
                spec["spread_counts"] = self._defaults["zeros_i64"]
        rotation = rotation_pos = None
        if self._tree_rotates():
            rot = self._generic_rotation(b, bucket, start0)
            if num_to_find >= n:
                rotation_pos = (rot[1], rot[2])   # inv_perms ARE positions
            else:
                rotation = rot
        z_pad = _pad_pow2(len(b.zone_names), 4)
        fl = obs_flight.RECORDER.begin("scan", self, [(pods, False)],
                                       all_node_names, node_infos)
        phases["encode"] = time.perf_counter() - t0
        self._observe("encode", phases["encode"])
        self.last_burst_phases = phases
        return self._scan_waves(pods, b, specs, rows, pids, spread0,
                                rotation, rotation_pos, num_to_find, n,
                                z_pad, bucket, phases, commit, fl)

    def _window_stack(self, specs: list, rows: list, pids, bucket: int,
                      last_pid: int) -> K.PodStack:
        """The window as a K.PodStack: one table row per distinct spec,
        plus a skip row that pads the window to `bucket` pods (the last
        pod's spec with skip set)."""
        n_pods = len(rows)
        specs = list(specs)
        row = np.empty(bucket, dtype=np.int64)
        row[:n_pods] = rows
        if n_pods < bucket:
            specs.append(dict(specs[rows[-1]], skip=np.bool_(True)))
            row[n_pods:] = len(specs) - 1
        prof = None
        if pids is not None:
            prof = np.full(bucket, last_pid, dtype=np.int64)
            prof[:n_pods] = pids
        return K.PodStack.from_specs(specs, row, prof, self.device)

    def _fetch_buffer(self, size: int, slot) -> torch.Tensor:
        """Host buffer for one packed block of `size` int32: pinned when
        the block comes from a card, so its copy runs asynchronously."""
        key = (size, slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(size, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self._pinned[key] = buf
        return buf

    def _fetch(self, packed: torch.Tensor, slot) -> np.ndarray:
        """ONE device-to-host copy of a packed decision block."""
        host = self._fetch_buffer(int(packed.shape[0]), slot)
        host.copy_(packed, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream().synchronize()
        return host.numpy()

    def _stale_refusal(self, decided: list, n: int, b: NodeBatch,
                       fl=None, hosts: list = ()) -> None:
        """The shell's node-death scan over a fetched launch's decided
        hosts, before any of them commits: a vanished node drops the
        resident folds, closes the flight record `fl` as aborted after
        `hosts`, and raises StaleNodeRefusal (the dead set, and how many
        decisions name it)."""
        dead = self.stale_scan(decided, b.names[:n])
        if dead:
            self.discard_burst_folds()
            obs_flight.RECORDER.note_outcome(fl, {
                "hosts": list(hosts), "failed": False, "aborted": True})
            raise StaleNodeRefusal(
                dead, max(1, sum(1 for h in decided if h in dead)))

    def _scan_waves(self, pods: list[Pod], b: NodeBatch, specs: list,
                    rows: list, pids, spread0, rotation, rotation_pos,
                    num_to_find: int, n: int, z_pad: int, bucket: int,
                    phases: dict, commit=None, fl=None) -> list:
        """The generic scan's launch and fetch: the whole window is
        ONE K5 launch (scan length = the bucket), or in mesh mode one
        K10a/K10b step per live pod with no host read between them, and
        ONE fetch of the packed [3B] block of selections and per-pod walk
        counters, which `commit` then consumes in `wave_size` windows.

        Rewind contract, from slices of that one block: the scan keeps
        deciding after a failed pod, so everything from the first failure
        on is undecided; the walk counters are read at the last decided
        pod (with `commit`: at the last window handed to it), and the
        folds are dropped after a failure or an aborted commit (the host
        mirror is authoritative again). A window that decides and commits
        every pod persists its folds."""
        B = bucket
        n_pods = len(pods)
        W = max(1, min(int(self.wave_size), B))
        t = time.perf_counter()
        stack = self._window_stack(specs, rows, pids, B,
                                   0 if pids is None else int(pids[-1]))
        rot = rotp = None
        if rotation is not None:
            perms, inv_perms, seq = rotation
            rot = (perms, inv_perms, np.asarray(seq[:B], dtype=np.int32))
        elif rotation_pos is not None:
            rotp = (rotation_pos[0],
                    np.asarray(rotation_pos[1][:B], dtype=np.int32))
        tensor = self._ptab is not None
        before = self._mesh_counts("burst_scan", "gather", "copies",
                                   "steps")
        try:
            chaos.check("device.dispatch")
            state, _li, _lni, _spread, outs = K.schedule_batch(
                self._dev_nodes, stack, self.last_index,
                self.last_node_index, num_to_find, n, z_pad,
                weights=self._union_weights if tensor else self.weights,
                rotation=rot, spread0=spread0, rotation_pos=rotp,
                wtab=self._wtab() if tensor else None, **self._mesh_kw())
            obs.inc("dispatch.burst_scan")
            t2 = time.perf_counter()
            phases["dispatch"] += t2 - t
            self._observe("kernel", t2 - t)
            chaos.node_dead_point("dispatch-fetch")
            chaos.check("device.fetch")
            h = self._fetch(outs["packed"], "scan")
            chaos.node_dead_point("fetch-commit")
        except _DEVICE_FAULTS as e:
            # the one launch and fetch come before any commit or counter
            # update: refuse the whole burst, and the shell reruns the
            # pods serially against the host mirror
            self._device_fault(e)
            self.discard_burst_folds()
            obs.inc("twin.device-fault")
            obs_flight.RECORDER.note_outcome(fl, {
                "hosts": [], "failed": False, "aborted": True})
            return None
        self.breaker.record_success()
        obs.inc("fetch.burst_scan")
        dt = time.perf_counter() - t2
        phases["fetch"] += dt
        self._observe("fetch", dt)
        self._mesh_phases("burst_scan", phases, before)
        obs_flight.RECORDER.note_block(fl, h)
        sel_arr = h[:n_pods]
        li_after = h[B:2 * B]
        lni_delta = h[2 * B:3 * B]
        neg = sel_arr < 0
        bad = int(np.argmax(neg)) if neg.any() else n_pods
        li0, lni0 = self.last_index, self.last_node_index
        committed, aborted = bad, False
        if commit is not None:
            if self.stale_scan is not None:
                self._stale_refusal(
                    [b.names[s] for s in sel_arr[:bad].tolist()], n, b, fl)
            committed = 0
            for wlo in range(0, bad, W):
                hi = min(wlo + W, bad)
                # the block carries every pod's walk counters: both edges
                # of every window are exact
                self.commit_marker = {
                    "li0": li0 if wlo == 0 else int(li_after[wlo - 1]),
                    "lni0": (lni0 if wlo == 0
                             else lni0 + int(lni_delta[wlo - 1])),
                    "li1": int(li_after[hi - 1]),
                    "lni1": lni0 + int(lni_delta[hi - 1]),
                    "committed0": wlo, "committed1": hi}
                ok = commit(wlo,
                            [b.names[s] for s in sel_arr[wlo:hi].tolist()])
                committed = hi
                if not ok:
                    aborted = True
                    break
        if committed > 0:
            self.last_index = int(li_after[committed - 1])
            self.last_node_index = lni0 + int(lni_delta[committed - 1])
        if bad < n_pods or aborted:
            # post-failure folds, or folds of decisions an aborted commit
            # discarded, never became decisions
            self.discard_burst_folds()
        else:
            self._adopt_folds(state)
        obs_flight.RECORDER.note_outcome(fl, {
            # the whole decided prefix: an aborted commit shortens what
            # returns, not what the device decided
            "hosts": [b.names[s] for s in sel_arr[:bad].tolist()],
            "failed": bad < n_pods,
            "aborted": aborted})
        return [b.names[s] for s in sel_arr[:committed].tolist()] \
            + [None] * (n_pods - committed)

    def _uniform_waves(self, pods: list[Pod], b: NodeBatch, cls, extra_ok,
                       ban: bool, rotation, n: int, bucket: int,
                       phases: dict, pid: int = 0, commit=None,
                       fl=None) -> list:
        """Launch driver of the uniform kernel: each chunk (up to B_CAP
        pods, or `launch_cap`) is ONE K3 launch plus ONE packed [cap+1]
        device-to-host copy, started at dispatch; up to `launch_depth`
        chunks are in flight while the oldest is fetched, and `commit`
        consumes each fetched block in `wave_size` windows. Returns the
        decided prefix (axis indices); the caller pads the undecided tail
        with None. The kernel's failures are a frozen-state suffix (F ==
        0 persists for identical pods), so the decided prefix is the
        block's leading non-negative run. An aborted commit stops at its
        window: the later chunks are dropped unfetched and the resident
        folds discarded; the walk counters stay at the aborted chunk's
        end, as TPUScheduler leaves them.

        `inflight_launches` holds the chunks dispatched and not yet
        consumed, and each fetched block goes to the flight record `fl`
        as a copy taken after its chunk's event completed: the chunk
        `depth` later reuses the pinned slot it sits in."""
        dev = self.device
        hard = K.B_CAP if not self.launch_cap \
            else min(K.B_CAP, int(self.launch_cap))
        cap = _pad_pow2(max(1, min(bucket, hard)), 16)
        W = max(1, min(int(self.wave_size), cap))
        n_pods = len(pods)
        chunks = [(lo, min(cap, n_pods - lo))
                  for lo in range(0, n_pods, cap)]
        depth = max(1, int(self.launch_depth))
        lni_dev = self.last_node_index   # a device scalar after chunk 0
        li_entry, lni_entry = self.last_index, self.last_node_index
        tensor = self._ptab is not None
        weights = self._union_weights if tensor else self.weights
        wtab = self._wtab() if tensor else None
        extra_dev = None if extra_ok is None \
            else torch.as_tensor(extra_ok).to(dev)
        perm_dev = None if rotation is None \
            else torch.as_tensor(rotation[0]).to(dev)
        sel: list[int] = []
        inflight: list[tuple] = []
        before = self._mesh_counts("burst_uniform", "gather", "copies",
                                   "passes", "syncs")

        def dispatch(ci: int) -> None:
            nonlocal lni_dev
            t = time.perf_counter()
            lo, chunk = chunks[ci]
            chaos.check("device.dispatch")
            rot = None
            if rotation is not None:
                win = np.empty(cap + K.K_BATCH, dtype=np.int32)
                piece = rotation[1][lo: lo + len(win)]
                win[: len(piece)] = piece
                win[len(piece):] = piece[-1] if len(piece) else 0
                rot = (perm_dev, torch.as_tensor(win).to(dev))
            rows, packed, lni_out = K.schedule_batch_uniform(
                self._dev_nodes, dict(cls), chunk, lni_dev, n,
                self.check_resources, weights=weights, rotation=rot,
                extra_ok=extra_dev, ban=ban, cap=cap, wtab=wtab, pid=pid,
                **self._mesh_kw())
            lni_dev = lni_out
            self._adopt_folds(rows)
            obs.inc("dispatch.burst_uniform")
            host = self._fetch_buffer(cap + 1, ci % depth)
            host.copy_(packed, non_blocking=True)
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            inflight.append((lo, chunk, host, event))
            self.inflight_launches = len(inflight)
            self.inflight_peak = max(self.inflight_peak, len(inflight))
            dt = time.perf_counter() - t
            phases["dispatch"] += dt
            self._observe("kernel", dt)

        next_ci = 1
        failed = aborted = faulted = False
        try:
            dispatch(0)
            while inflight:
                while len(inflight) < depth and next_ci < len(chunks):
                    dispatch(next_ci)
                    next_ci += 1
                lo, chunk, host, event = inflight.pop(0)
                self.inflight_launches = len(inflight)
                t = time.perf_counter()
                chaos.node_dead_point("dispatch-fetch")
                chaos.check("device.fetch")
                if event is not None:
                    event.synchronize()
                h = host.numpy()
                chaos.node_dead_point("fetch-commit")
                obs.inc("fetch.burst_uniform")
                obs_flight.RECORDER.note_block(fl, h)
                dt = time.perf_counter() - t
                phases["fetch"] += dt
                self._observe("fetch", dt)
                chunk_sel = h[:chunk].tolist()
                bad = next((i for i, s in enumerate(chunk_sel) if s < 0),
                           chunk)
                if commit is not None and self.stale_scan is not None:
                    # earlier chunks stand; this one refuses whole, before
                    # its lni advance (the chunks in flight are dropped
                    # unfetched)
                    self._stale_refusal(
                        [b.names[s] for s in chunk_sel[:bad]], n, b, fl,
                        [b.names[s] for s in sel])
                lni_start = self.last_node_index
                self.last_node_index += int(h[cap])
                for wlo in range(0, bad, W):
                    hi = min(wlo + W, bad)
                    sel.extend(chunk_sel[wlo:hi])
                    if commit is None:
                        continue
                    # the uniform kernel never moves last_index, and the
                    # block holds only the chunk's lni advance: a window
                    # edge inside the chunk has no exact lni (None)
                    self.commit_marker = {
                        "li0": li_entry,
                        "lni0": lni_start if wlo == 0 else None,
                        "li1": li_entry,
                        "lni1": self.last_node_index if hi == chunk
                        else None,
                        "committed0": lo + wlo, "committed1": lo + hi}
                    if not commit(lo + wlo,
                                  [b.names[s] for s in chunk_sel[wlo:hi]]):
                        aborted = True
                        break
                if bad < chunk or aborted:
                    # later chunks decided nothing more (the state is
                    # frozen once no node fits), or their decisions are
                    # discarded: drop them unfetched
                    inflight.clear()
                    if aborted:
                        self.discard_burst_folds()
                    failed = bad < chunk
                    break
        except _DEVICE_FAULTS as e:
            # a failed launch or fetch: what was committed stands, with
            # its counters; the faulted chunk decided nothing, so the rest
            # of the burst goes back to the shell as the undecided tail
            self._device_fault(e)
            obs.inc("twin.device-fault")
            inflight.clear()
            self.discard_burst_folds()
            if commit is None:
                # a trial (gang) burst committed nothing: rewind the walk
                # counters of the chunks already fetched and refuse, so
                # the caller reruns the whole trial serially
                self.last_index, self.last_node_index = li_entry, lni_entry
                obs_flight.RECORDER.note_outcome(fl, {
                    "hosts": [], "failed": False, "aborted": True})
                return None
            faulted = True
        finally:
            self.inflight_launches = 0
        if not (failed or aborted or faulted):
            self.breaker.record_success()
        self._mesh_phases("burst_uniform", phases, before)
        obs_flight.RECORDER.note_outcome(fl, {
            # the decided hosts up to the last commit or abort; `failed`:
            # the next pod found no node on the device
            "hosts": [b.names[s] for s in sel],
            "failed": failed,
            "aborted": aborted})
        return sel

    # -- fused segmented burst: one launch per drain window --------------------
    def schedule_burst_fused(self, segments, node_infos: dict[str, NodeInfo],
                             all_node_names: list[str],
                             bucket: Optional[int] = None):
        """Schedule a drain window of `segments` = [(pods, is_gang), ...] in
        ONE K6 launch (in mesh mode one K11a/K11b step per pod, no host
        read between them) and ONE packed fetch. A gang member that finds no
        node rewinds the carry (rows, li, lni, rotation cursor) to its
        segment's checkpoint inside the kernel, the rest of the gang is
        skipped, and the window goes on against the rewound state.

        Returns None when the window is not expressible on this path
        (counted under `refusal.<reason>`), else {"segments": [...],
        "consumed": n_enumerations} with one record per segment:
          {"status": "decided",  "hosts": [...], "li", "lni", "t"}
          {"status": "rejected", "placed": k,    "li", "lni", "t"}  (gang)
          {"status": "failed",   "hosts": [decided prefix], "li","lni","t"}
          {"status": "undecided"}   (at/after a singleton failure)
        li/lni/t are the carry at the segment's end (the caller's
        fused_rewind target). On return the walk counters stand at the end
        of the decided prefix, and the folds persist unless a singleton
        failure polluted them."""
        n_total = sum(len(p) for p, _g in segments)
        if not all_node_names or n_total == 0:
            return None
        if not self.breaker.allow_device():
            # circuit open: refuse the window before any launch; the
            # shell's per-segment fallback runs the serial loop, where
            # schedule() picks the host twin
            obs.inc("twin.circuit-open")
            return None
        if self.nominated is not None and self.nominated.has_any():
            # the segment kernel has no nominated-ghost input
            return self._refuse("fused-nominated-ghosts")
        flat = [p for seg_pods, _g in segments for p in seg_pods]
        if any(has_pod_affinity_terms(p) or get_container_ports(p)
               or p.volumes for p in flat):
            # masks that depend on in-burst placements (and volume
            # reservations) have no segment-rewind story on the device
            return self._refuse("fused-pod-features")
        t0 = time.perf_counter()
        axis_order, start0 = self._axis_order(all_node_names)
        b = self.encoder.encode(node_infos, axis_order)
        self._node_arrays(b)
        t_mirror = time.perf_counter() - t0
        enc = self._pod_encoder(node_infos, b)
        row_of_sig: dict = {}
        specs, rows = [], []
        for p, sig in zip(flat, self._signatures(flat)):
            r = row_of_sig.get(sig)
            if r is None:
                f = enc.encode(p)
                if f.spread_counts is not None:
                    # spread counts would need a checkpointed vector the
                    # shell's plain-class gate already excludes
                    return self._refuse("fused-spread-selectors")
                r = row_of_sig[sig] = len(specs)
                specs.append(self._pod_arrays(f, upd_fields=True, pod=p))
            rows.append(r)
        pids = self._profile_ids(flat)
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        B = _pad_pow2(max(bucket or 16, n_total), 16)
        rotation = rotation_pos = None
        if self._tree_rotates():
            # one window-wide walk indexed by enumerations CONSUMED in the
            # kernel: a rejected gang rewinds the cursor
            rot = self._generic_rotation(b, B, start0)
            if num_to_find >= n:
                rotation_pos = (rot[1], rot[2])
            else:
                rotation = rot
        seg_start = np.zeros(B, dtype=bool)
        gang = np.zeros(B, dtype=bool)
        idx = 0
        for seg_pods, is_gang in segments:
            seg_start[idx] = True
            if is_gang:
                gang[idx: idx + len(seg_pods)] = True
            idx += len(seg_pods)
        if idx < B:
            seg_start[idx] = True   # padding: its own inert segment
        stack = self._window_stack(specs, rows, pids, B,
                                   0 if pids is None else int(pids[-1]))
        z_pad = _pad_pow2(len(b.zone_names), 4)
        # the fused window is the whole record: gang boundaries, rewinds
        # and the rotation state ride one launch
        fl = obs_flight.RECORDER.begin("fused", self, segments,
                                       all_node_names, node_infos)
        t1 = time.perf_counter()
        tensor = self._ptab is not None
        before = self._mesh_counts("burst_segments", "gather",
                                   "copies", "steps")
        try:
            chaos.check("device.dispatch")
            state, _li, _lni, _spread, packed = K.schedule_batch_segments(
                self._dev_nodes, stack, seg_start, gang, n_total,
                self.last_index, self.last_node_index, num_to_find, n,
                z_pad,
                weights=self._union_weights if tensor else self.weights,
                rotation=rotation, rotation_pos=rotation_pos,
                wtab=self._wtab() if tensor else None,
                gang_score=self._gang_score, **self._mesh_kw())
            obs.inc("dispatch.burst_fused")
            t2 = time.perf_counter()
            chaos.node_dead_point("dispatch-fetch")
            chaos.check("device.fetch")
            h = self._fetch(packed, "fused")
            chaos.node_dead_point("fetch-commit")
        except _DEVICE_FAULTS as e:
            # the one launch and fetch come before any counter update or
            # commit: refuse the window, and the shell reruns every entry
            # through its per-segment path against the host mirror
            self._device_fault(e)
            self.discard_burst_folds()
            obs.inc("twin.device-fault")
            obs_flight.RECORDER.note_outcome(fl, {
                "segments": [], "consumed": 0, "aborted": True})
            return None
        self.breaker.record_success()
        obs.inc("fetch.burst_fused")
        obs_flight.RECORDER.note_block(fl, h)
        self.last_burst_phases = {"encode": t1 - t0, "mirror": t_mirror,
                                  "dispatch": t2 - t1,
                                  "fetch": time.perf_counter() - t2}
        for phase, key in (("encode", "encode"), ("kernel", "dispatch"),
                           ("fetch", "fetch")):
            self._observe(phase, self.last_burst_phases[key])
        self._mesh_phases("burst_segments", self.last_burst_phases, before)
        sel = h[:B]
        li_after = h[B:2 * B]
        lni_delta = h[2 * B:3 * B]
        t_after = h[3 * B:4 * B]
        li0, lni0 = self.last_index, self.last_node_index

        def boundary(j: int) -> tuple[int, int, int]:
            if j < 0:
                return li0, lni0, 0
            return (int(li_after[j]), lni0 + int(lni_delta[j]),
                    int(t_after[j]))

        results = []
        fail_at = None   # first SINGLETON failure: all after is undecided
        idx = 0
        for seg_pods, is_gang in segments:
            L = len(seg_pods)
            if fail_at is not None:
                results.append({"status": "undecided"})
                idx += L
                continue
            ss = sel[idx: idx + L]
            end_li, end_lni, end_t = boundary(idx + L - 1)

            def seqs(k: int, lo=idx) -> dict:
                # per-member walk counters (rewind targets of a short
                # commit inside a singleton run)
                return {"li_seq": li_after[lo: lo + k],
                        "lni_seq": lni0 + lni_delta[lo: lo + k],
                        "t_seq": t_after[lo: lo + k]}

            if is_gang:
                if (ss < 0).any():
                    # the kernel already rewound the carry; a placed
                    # member's selection is still in the block
                    results.append({"status": "rejected",
                                    "placed": int((ss >= 0).sum()),
                                    "li": end_li, "lni": end_lni,
                                    "t": end_t})
                else:
                    results.append({"status": "decided",
                                    "hosts": [b.names[s]
                                              for s in ss.tolist()],
                                    "li": end_li, "lni": end_lni,
                                    "t": end_t, **seqs(L)})
            elif (ss < 0).any():
                k = int(np.argmax(ss < 0))
                fail_at = idx + k
                end_li, end_lni, end_t = boundary(idx + k - 1)
                results.append({"status": "failed",
                                "hosts": [b.names[s]
                                          for s in ss[:k].tolist()],
                                "li": end_li, "lni": end_lni, "t": end_t,
                                **seqs(k)})
            else:
                results.append({"status": "decided",
                                "hosts": [b.names[s] for s in ss.tolist()],
                                "li": end_li, "lni": end_lni, "t": end_t,
                                **seqs(L)})
            idx += L
        if fail_at is not None:
            li_f, lni_f, consumed = boundary(fail_at - 1)
            # post-failure folds never became decisions: drop the matrix
            self.discard_burst_folds()
        else:
            li_f, lni_f, consumed = boundary(n_total - 1)
            self._adopt_folds(state)
        self.last_index, self.last_node_index = li_f, lni_f
        obs_flight.RECORDER.note_outcome(fl, {
            "segments": [{k: r[k] for k in ("status", "hosts", "placed")
                          if k in r} for r in results],
            "consumed": consumed})
        return {"segments": results, "consumed": consumed}

    def fused_rewind(self, li: int, lni: int) -> None:
        """Abort handler of a fused window: a short segment commit makes
        the caller stop consuming the block; the walk counters rewind to
        the segment boundary it got from schedule_burst_fused and the
        resident folds drop (the host mirror is authoritative again)."""
        self.last_index = int(li)
        self.last_node_index = int(lni)
        self.discard_burst_folds()

    # -- device preemption -------------------------------------------------------
    def preempt(self, pod: Pod, node_infos: dict[str, NodeInfo],
                all_node_names: list[str], fit_error, pdbs: list):
        """Device victim scan (K7 `preempt_scan`): one launch over every
        candidate node replaces the reference's fan-out over candidates
        (generic_scheduler.go:966). Returns a PreemptionResult with the
        oracle Preemptor's decisions, or None (counted under
        `refusal.<reason>`) when this preemption is not expressible as
        resources plus static masks, as TPUScheduler.preempt refuses it.

        Eligible when no pod is nominated, the incoming pod has no volumes
        and no extended-resource requests, and every potential victim
        (lower priority, on a candidate node) is mask-inert: no
        (anti-)affinity terms, no host ports when the incoming pod wants
        one, no scalar requests, no match with the incoming pod's required
        terms. Bystanders (priority >= the preemptor's) are never removed,
        so the pod's masks hold under victim removal and fold into the
        static feasibility vector."""
        from kubernetes_tpu_torch.api.types import get_resource_request
        from kubernetes_tpu_torch.oracle.preemption import (
            pod_eligible_to_preempt_others, nodes_where_preemption_might_help,
            PreemptionResult, no_possible_victims)
        if not all_node_names:
            return None
        t0 = time.perf_counter()
        if not self.breaker.allow_device():
            # circuit open: the shell's oracle Preemptor runs this scan
            obs.inc("twin.circuit-open")
            return None
        if self.nominated is not None and self.nominated.has_any():
            return self._refuse("preempt-nominated-ghosts")
        if pod.volumes:
            return self._refuse("preempt-pod-volumes")
        req = get_resource_request(pod)
        if req.scalar:
            return self._refuse("preempt-scalar-request")
        pod_ports = bool(get_container_ports(pod))
        a = pod.affinity
        pod_terms = []
        if a is not None:
            for grp in (a.pod_affinity, a.pod_anti_affinity):
                if grp is not None and grp.required:
                    pod_terms.extend(grp.required)
        if not pod_eligible_to_preempt_others(pod, node_infos):
            return PreemptionResult(None, [], [])
        candidates = nodes_where_preemption_might_help(
            node_infos, all_node_names, fit_error.failed_predicates)
        if not candidates:
            # preemption can't help anywhere: clear the pod's own stale
            # nomination (generic_scheduler.go:330-333)
            return PreemptionResult(None, [], [pod])
        if no_possible_victims(pod, node_infos, candidates):
            return PreemptionResult(None, [], [])
        b = self.encoder.encode(node_infos, all_node_names)
        nodes = self._node_arrays(b)
        vic, slots, gate = self._victim_inputs(
            node_infos, b, candidates, pod.priority, pdbs, pod=pod,
            pod_ports=pod_ports, pod_terms=pod_terms)
        if vic is None:
            return self._refuse(f"preempt-victims-{gate}")
        # no scalar request (refused above): no unknown scalar either
        f = self._pod_encoder(node_infos, b).encode(pod)
        feas = np.zeros(b.n_pad, bool)
        order_rank = np.full(b.n_pad, 1 << 30, np.int64)
        for order, name in enumerate(candidates):
            i = b.index[name]
            feas[i] = True
            order_rank[i] = order
        for mask in (f.sel_ok, f.taints_ok, f.unsched_ok, f.host_ok,
                     f.ports_ok):
            if mask is not None:
                feas &= np.asarray(mask, bool)
        if f.interpod_code is not None:
            # static under victim removal: no victim carries terms or
            # matches the pod's (gated above)
            feas &= np.asarray(f.interpod_code) == 0
        pod_in = {"req_cpu": np.int64(req.milli_cpu),
                  "req_mem": np.int64(req.memory),
                  "req_eph": np.int64(req.ephemeral_storage)}
        t_enc = time.perf_counter()
        try:
            chaos.check("device.dispatch")
            out = K.preemption_scan(nodes, vic, pod_in, feas, order_rank,
                                    b.n_real, self.check_resources,
                                    f.has_request, pod.priority,
                                    **self._mesh_kw())
            obs.inc("dispatch.preempt_scan")
            t_fetch = time.perf_counter()
            chaos.check("device.fetch")
            out = self._fetch(out, "preempt")
        except _DEVICE_FAULTS as e:
            # the scan reads resident state and changes nothing: refuse,
            # and the shell falls back to the oracle Preemptor, whose
            # decisions are the same
            self._device_fault(e)
            obs.inc("twin.device-fault")
            return None
        self.breaker.record_success()
        obs.inc("fetch.preempt_scan")
        t_end = time.perf_counter()
        self.last_preempt_phases = {"encode": t_enc - t0,
                                    "scan": t_end - t_enc,
                                    "fetch": t_end - t_fetch}
        winner = int(out[0])
        if winner < 0:
            return PreemptionResult(None, [], [])
        name = b.names[winner]
        flags = out[3:].astype(bool)
        # a zero-victim winner has no slots entry
        victims = [p for j, p in enumerate(slots.get(name, ())) if flags[j]]
        return PreemptionResult(node_infos[name].node, victims, [])

    # victim-table planes the kernels read, device key <- host field
    _VIC_FIELDS = (("cpu", "cpu"), ("mem", "mem"), ("eph", "eph"),
                   ("prio", "prio"), ("start", "start"),
                   ("valid", "valid"), ("violating", "viol"))

    def _victim_inputs(self, node_infos: dict[str, NodeInfo], b: NodeBatch,
                       names, max_prio: int, pdbs: list,
                       pod: Optional[Pod] = None, pod_ports: bool = False,
                       pod_terms=()):
        """The resident [N, P] victim planes and the slots map for a scan.
        The table is persistent (encoder.victim_table: cached per node
        generation, re-sorted only for dirty rows, permuted on a NodeTree
        rotation) and stays on the device. Over the candidate set, a
        potential victim (priority < max_prio) with affinity terms,
        conflicting ports, scalar requests or a match with the incoming
        pod's required terms, or a node the slot cap cannot hold, refuses:
        returns (None, None, gate), gate one of overflow, affinity-terms,
        ports, scalar, term-match. Else (vic, slots, None)."""
        vt = self.encoder.victim_table(node_infos, b, pdbs,
                                       cap=K.PREEMPT_P)
        if len(names) == b.n_real and (names is b.names or
                                       list(names) == b.names):
            cand = np.arange(b.n_real, dtype=np.int64)
        else:
            cand = np.fromiter((b.index[nm] for nm in names), np.int64,
                               len(names))
        # a dropped slot could be anyone's victim: refuse outright
        if bool(vt.overflow[cand].any()):
            return None, None, "overflow"
        pot = vt.valid[cand] & (vt.prio[cand] < max_prio)
        if bool((pot & vt.aff[cand]).any()):
            return None, None, "affinity-terms"
        if pod_ports and bool((pot & vt.ports[cand]).any()):
            return None, None, "ports"
        if bool((pot & vt.scalar[cand]).any()):
            return None, None, "scalar"
        if pod_terms:
            t = vt.table
            is_cand = np.zeros(b.n_pad, bool)
            is_cand[cand] = True
            hr = t.holder_row
            on_cand = (hr >= 0) & is_cand[np.where(hr >= 0, hr, 0)]
            pot_rows = on_cand & (t.prio < max_prio)
            if bool(pot_rows.any()) and bool(
                    (P.pod_matches_any_term_mask(pod, pod_terms, t)
                     & pot_rows).any()):
                return None, None, "term-match"
        return self._upload_victims(vt), vt.slots, None

    def _upload_victims(self, vt):
        """Sync the resident victim planes from the host table: a full
        upload on a rebuild or permute (dirty_rows None), one K4 scatter of
        the dirty rows otherwise, nothing in the steady state. In mesh mode
        one dict per shard (`shard_victim_planes`), and the scatter runs
        on each shard that owns a dirty row, with its rows only."""
        key = (vt.P, vt.valid.shape[0])
        if (self._dev_vic is None or self._dev_vic_key != key
                or vt.dirty_rows is None):
            host = {k: np.asarray(getattr(vt, f))
                    for k, f in self._VIC_FIELDS}
            if self.mesh is not None:
                from kubernetes_tpu_torch.parallel import sharding as S
                self._dev_vic = S.shard_victim_planes(self.mesh, host)
            else:
                self._dev_vic = {k: torch.as_tensor(v).to(self.device,
                                                          copy=True)
                                 for k, v in host.items()}
            self._dev_vic_key = key
            obs.inc("dispatch.vic_upload")
            vt.dirty_rows = []
            return self._dev_vic
        if vt.dirty_rows:
            self._scatter_dirty(self._dev_vic, vt.dirty_rows,
                                vt.valid.shape[0], vt, self._VIC_FIELDS)
            obs.inc("dispatch.vic_scatter")
            vt.dirty_rows = []
        return self._dev_vic

    def prewarm_preempt(self, node_infos: dict[str, NodeInfo],
                        all_node_names: list[str], pdbs: list) -> None:
        """Build and upload the node matrix and the persistent victim table
        outside any timed window (the steady state, where the table is
        kept incrementally across cycles). Consumes no rotation state and
        folds nothing."""
        b = self.encoder.encode(node_infos, all_node_names)
        self._node_arrays(b)
        self._upload_victims(
            self.encoder.victim_table(node_infos, b, pdbs, cap=K.PREEMPT_P))

    # pods per K8 launch: bounds the per-chunk pod table
    PRESSURE_B_CAP = 128

    def preempt_pressure_burst(self, pods: list[Pod],
                               node_infos: dict[str, NodeInfo],
                               all_node_names: list[str], pdbs: list):
        """Schedule-else-preempt a failed burst tail on the device: one K8
        launch per chunk of up to PRESSURE_B_CAP pods, the carries (rows,
        ghost load, li, lni) chained on the card, ONE fetch for the wave.
        Replays the serial loop exactly: per pod in queue order, a
        ghost-aware schedule attempt (podFitsOnNode's two passes,
        generic_scheduler.go:598,627), else the victim scan and the
        five-criteria pick (:966,1054,837), the nomination becoming ghost
        load for the pods behind it.

        Refused (None, counted under `refusal.<reason>`), as
        TPUScheduler.preempt_pressure_burst refuses: pods already
        nominated (nominated-ghosts), a rotating NodeTree
        (tree-rotation), priorities that rise (priority-order), pods with
        volumes, a stale nomination, affinity terms, host ports or scalar
        requests (pod-features), selector spread (spread-selectors),
        several profiles (profile-mixed), a victim gate
        (pressure-victims-<gate>). Else one outcome per pod:
          ("bound", host)                 scheduled, delta folded on device
          ("nominated", node, victims)    preemption chose `node`
          ("failed", any_candidates)      no fit and no preemption; False
            when no node is a candidate (the oracle then clears the pod's
            own stale nomination, :330-333)."""
        from kubernetes_tpu_torch.api.types import get_resource_request
        if not pods or not all_node_names:
            return None
        t0 = time.perf_counter()
        if not self.breaker.allow_device():
            # circuit open: the shell's serial loop (host twin and oracle
            # Preemptor) runs the tail instead
            return self._refuse("circuit-open")
        if self.nominated is not None and self.nominated.has_any():
            return self._refuse("nominated-ghosts")
        if self._tree_rotates():
            return self._refuse("tree-rotation")
        prios = [p.priority for p in pods]
        if any(a < bb for a, bb in zip(prios, prios[1:])):
            return self._refuse("priority-order")
        for p in pods:
            if p.volumes or p.nominated_node_name \
                    or has_pod_affinity_terms(p) or get_container_ports(p) \
                    or get_resource_request(p).scalar:
                return self._refuse("pod-features")
        axis_order, _start0 = self._axis_order(all_node_names)
        b = self.encoder.encode(node_infos, axis_order)
        self._node_arrays(b)
        enc = self._pod_encoder(node_infos, b)
        # one encode per signature, one table row per (signature, priority)
        feat_by_sig: dict = {}
        row_of: dict = {}
        specs, rows = [], []
        for p, sig in zip(pods, self._signatures(pods)):
            f = feat_by_sig.get(sig)
            if f is None:
                f = feat_by_sig[sig] = enc.encode(p)
                if f.spread_counts is not None:
                    # spread scores depend on in-wave placements, which the
                    # pressure scan does not carry
                    return self._refuse("spread-selectors")
            key = (sig, p.priority)
            r = row_of.get(key)
            if r is None:
                r = row_of[key] = len(specs)
                d = self._pod_arrays(f, upd_fields=True, pod=p)
                d["pprio"] = np.int64(p.priority)
                specs.append(d)
            rows.append(r)
        weights = self.weights
        if self._ptab is not None:
            # one static weight row for the wave: the kernel has no
            # per-pod row gather
            pids = self._profile_ids(pods)
            if int(pids.min()) != int(pids.max()):
                return self._refuse("profile-mixed")
            weights = {name: int(self._ptab[int(pids[0]), i])
                       for i, name in enumerate(PRIORITY_AXIS)}
        vic, slots, gate = self._victim_inputs(node_infos, b, all_node_names,
                                               prios[0], pdbs)
        if vic is None:
            return self._refuse(f"pressure-victims-{gate}")
        n = b.n_real
        num_to_find = num_feasible_nodes_to_find(
            n, self.percentage_of_nodes_to_score)
        z_pad = _pad_pow2(len(b.zone_names), 4)
        cap = self.PRESSURE_B_CAP
        chunks = []
        for lo in range(0, len(pods), cap):
            k = min(cap, len(pods) - lo)
            chunks.append((lo, k, _pad_pow2(k, 8)))
        if any(k < bucket for _lo, k, bucket in chunks):
            # skip padding: the last pod's spec, consuming nothing
            specs.append(dict(specs[rows[-1]], skip=np.bool_(True)))
        stack = K.PodStack.from_specs(specs, np.zeros(0, np.int64), None,
                                      self.device)
        planes = vic if self.mesh is None else vic[0]
        width = len(K.PRESSURE_HEAD) + int(planes["prio"].shape[1])
        total = sum(bucket for _lo, _k, bucket in chunks)
        packed = torch.empty((total, width), dtype=torch.int32,
                             device=self.device)
        rows_arr = np.asarray(rows, np.int64)
        li, lni = self.last_index, self.last_node_index
        if self.mesh is None:
            mut = {k: self._dev_nodes[k] for k in K._MUTABLE}
            ghost = {k: torch.zeros(b.n_pad, dtype=torch.int64,
                                    device=self.device)
                     for k in K.GHOST_FIELDS}
        else:
            # one ghost vector per shard, zeroed per wave
            per = self.mesh.rows(b.n_pad)
            mut = [{k: d[k] for k in K._MUTABLE} for d in self._dev_nodes]
            ghost = [{k: torch.zeros(per, dtype=torch.int64, device=dev)
                      for k in K.GHOST_FIELDS} for dev in self.mesh.devices]
        # pressure records are digests only (no replay referee)
        fl = obs_flight.RECORDER.begin("pressure", self, [(pods, False)],
                                       all_node_names, node_infos)
        before = self._mesh_counts("pressure", "gather", "copies",
                                   "steps")
        t_enc = time.perf_counter()
        off = 0
        work = {}  # the chunk chain's cluster workspace, where one is needed
        try:
            for lo, k, bucket in chunks:
                chaos.check("device.dispatch")
                row = np.full(bucket, len(specs) - 1, np.int64)
                row[:k] = rows_arr[lo: lo + k]
                mut, ghost, li, lni, _outs = K.pressure_batch(
                    self._dev_nodes, mut, ghost,
                    K.PodStack(stack.table, row, skip=stack.skip_flags()),
                    vic, li, lni, num_to_find, n, z_pad, weights=weights,
                    out=packed[off: off + bucket], work=work,
                    **self._mesh_kw())
                obs.inc("dispatch.pressure_batch")
                off += bucket
            t_fetch = time.perf_counter()
            # ONE device-to-host copy for every chunk of the wave
            chaos.check("device.fetch")
            h = self._fetch(packed.reshape(-1),
                            "pressure").reshape(total, width)
        except _DEVICE_FAULTS as e:
            # no counter or host mirror has moved yet: refuse the wave
            # (the shell's serial loop decides the same outcomes) and drop
            # the resident rows the launched chunks folded
            self._device_fault(e)
            self.discard_burst_folds()
            obs_flight.RECORDER.note_outcome(fl, {"outcomes": [],
                                                  "aborted": True})
            return self._refuse("device-fault")
        self.breaker.record_success()
        obs.inc("fetch.pressure_batch")
        t_end = time.perf_counter()
        self.last_preempt_phases = {"encode": t_enc - t0,
                                    "scan": t_end - t_enc,
                                    "fetch": t_end - t_fetch}
        self._mesh_phases("pressure", self.last_preempt_phases, before)
        outcomes = []
        lni_sum = 0
        off = 0
        li_end = self.last_index
        for lo, k, bucket in chunks:
            blk = h[off: off + bucket]
            for j in range(k):
                sel, win = int(blk[j, 0]), int(blk[j, 1])
                if sel >= 0:
                    outcomes.append(("bound", b.names[sel]))
                elif win >= 0:
                    name = b.names[win]
                    flags = blk[j, len(K.PRESSURE_HEAD):].astype(bool)
                    victims = [p for s, p in enumerate(slots.get(name, []))
                               if flags[s]]
                    outcomes.append(("nominated", name, victims))
                else:
                    outcomes.append(("failed", bool(blk[j, 2])))
            # the skip padding consumes nothing: the counters stand at the
            # chunk's last pod, and padding leaves li reduced mod n
            lni_sum += int(blk[:bucket, 4].astype(np.int64).sum())
            li_end = int(blk[bucket - 1, 3])
            off += bucket
        # persist: the folded rows are now the resident ones; the shell
        # syncs the host mirror per bound pod (note_burst_assumed)
        self._adopt_folds(mut)
        self.last_index = li_end
        self.last_node_index += lni_sum
        obs_flight.RECORDER.note_outcome(fl, {"outcomes": [
            oc if oc[0] != "nominated"
            else ("nominated", oc[1], sorted(v.name for v in oc[2]))
            for oc in outcomes]})
        return outcomes

    def gang_checkpoint(self) -> dict:
        """Snapshot the walk counters and the resident matrix at a group
        boundary. The port folds bursts into fresh tensors, so the pinned
        dict stays the pre-gang matrix until an upload or scatter (the
        epoch) writes into it."""
        dev = self._dev_nodes
        if dev is not None:
            dev = dict(dev) if isinstance(dev, dict) \
                else [dict(d) for d in dev]
        return {"li": self.last_index, "lni": self.last_node_index,
                "dev": dev,
                "key": self._dev_key, "epoch": self._dev_epoch}

    def gang_rewind(self, chk: dict) -> None:
        """Discard everything since `chk`: the walk counters rewind, and
        the pinned pre-gang matrix is restored when no host upload or
        scatter happened since (same epoch); otherwise the matrix drops
        and re-uploads from the host mirror, which never saw the trial."""
        self.last_index = chk["li"]
        self.last_node_index = chk["lni"]
        if self._dev_nodes is not None:
            obs.inc("gang_rewind_folds")
        if chk["dev"] is not None and self._dev_epoch == chk["epoch"]:
            self._dev_nodes = chk["dev"]
            self._dev_key = chk["key"]
        else:
            self.discard_burst_folds()

    # -- resident-state bookkeeping ------------------------------------------------
    def discard_burst_folds(self) -> None:
        """Forget the resident node matrix: folds for decisions the caller
        discarded must not leak into later cycles; the next use re-uploads
        from the host mirror."""
        if self._dev_nodes is not None:
            obs.inc("discarded_folds")
        self._dev_nodes = None

    def recover_device(self, li: Optional[int] = None,
                       lni: Optional[int] = None) -> None:
        """Crash-restart reset (the shell's recover): drop the resident
        node matrix (folds of decisions that never committed must not
        survive) and victim planes, and rewind the walk counters to the
        recovered commit boundary. The next encode re-uploads from the
        host mirror, which the shell's reconcile made authoritative."""
        self.discard_burst_folds()
        self._dev_vic = None
        self._dev_vic_key = None
        if li is not None:
            self.last_index = int(li)
        if lni is not None:
            self.last_node_index = int(lni)
        self.commit_marker = None

    def invalidate_node(self, host: str) -> None:
        """A node died mid-burst: drop the resident matrix and victim
        planes, and the encoder's generation entries for `host`."""
        self.discard_burst_folds()
        self._dev_vic = None
        self._dev_vic_key = None
        self.encoder._generations.pop(host, None)
        self.encoder._vt_gens.pop(host, None)

    def note_burst_assumed(self, pod: Pod, host: str, generation: int) -> None:
        """Fold one placed pod into the host mirror (the device already
        folded it) and sync the encoder's generation map, so the next
        encode neither re-encodes nor re-uploads the row."""
        b = self.encoder._batch
        if b is None or host not in b.index:
            return
        self.encoder.note_assumed(b, host, pod, generation=generation,
                                  mark_dirty=False)

    def note_burst_assumed_many(self, pods: list[Pod], hosts: list[str],
                                generations: list) -> None:
        """Batched note_burst_assumed for a committed wave; entries whose
        node left the mirror or the cache (generation None) are skipped."""
        b = self.encoder._batch
        if b is None:
            return
        keep = [(p, h, g) for p, h, g in zip(pods, hosts, generations)
                if g is not None and h in b.index]
        if not keep:
            return
        kp, kh, kg = zip(*keep)
        self.encoder.note_assumed_many(b, list(kp), list(kh), list(kg))

    def load_state(self, state: dict, node_infos: dict[str, NodeInfo],
                   all_node_names: list[str]) -> None:
        """Adopt carried device state (carry.state_from_jax): encode the
        host mirror for `node_infos`, then make the carried node matrix
        (with any burst folds) the resident one and take over the walk
        counters and the profile set, or else the bare weight table. The
        carried matrix must describe the same snapshot."""
        b = self.encoder.encode(node_infos, all_node_names)
        nodes = {k: v.to(self.device) for k, v in state["nodes"].items()}
        for k in self._NODE_FIELDS:
            want = tuple(np.shape(getattr(b, k)))
            if tuple(nodes[k].shape) != want:
                raise ValueError(f"carried {k} has shape "
                                 f"{tuple(nodes[k].shape)}, mirror {want}")
        if self.mesh is not None:
            # re-shard the carried rows, folds included
            from kubernetes_tpu_torch.parallel import sharding as S
            nodes = S.shard_node_arrays(self.mesh, nodes)
        self._dev_nodes = nodes
        self._dev_key = (b.n_pad, len(b.scalar_names), id(b))
        self._dev_epoch += 1
        b.dirty_rows = []
        self.last_index = int(state["last_index"])
        self.last_node_index = int(state["last_node_index"])
        if state.get("profiles") is not None:
            from kubernetes_tpu_torch.profiles import ProfileSet
            self.set_profiles(ProfileSet.from_dict(
                {"profiles": state["profiles"]}))
            ptab = state.get("ptab")
            if ptab is not None and not np.array_equal(
                    ptab.cpu().numpy(), self._ptab):
                raise ValueError("carried weight table differs from the "
                                 "carried profile set's")
        else:
            self.profiles = None
            self._gang_score = False
            ptab = state.get("ptab")
            self._set_weight_table(None if ptab is None
                                   else ptab.cpu().numpy())

    def debug_state(self) -> dict:
        """Mirror shape and epoch, walk counters, device, profiles, the
        victim table (slots, rows, generations, dirty rows, residency, and
        the encoder's rebuild and row re-sort counts), the circuit
        breaker, the mesh and its device count, the serial path and its running latencies, the
        launch count of every kernel (K1-K14b) and the refusals."""
        dev = self._dev_nodes
        mirror = None
        if isinstance(dev, dict):
            mirror = {"fields": len(dev),
                      "n_pad": int(dev["valid"].shape[-1])}
        elif dev is not None:
            mirror = {"fields": len(dev[0]),
                      "n_pad": sum(int(d["valid"].shape[-1]) for d in dev),
                      "shards": len(dev)}
        vt = self.encoder._vt
        vic = None
        if vt is not None:
            vic = {"P": int(vt.P), "rows": int(vt.valid.shape[0]),
                   "generations": len(self.encoder._vt_gens),
                   "dirty_rows": (None if vt.dirty_rows is None
                                  else len(vt.dirty_rows)),
                   "resident": self._dev_vic is not None,
                   "rebuilds": obs.get("encoder.victim_rebuilds"),
                   "row_resorts": obs.get("encoder.victim_row_resorts")}
        return {
            "mirror": mirror,
            "dev_epoch": self._dev_epoch,
            "breaker": self.breaker.debug_state(),
            "last_index": self.last_index,
            "last_node_index": self.last_node_index,
            "victim_table": vic,
            "device": str(self.device),
            "mesh": self.mesh is not None,
            "devices": 1 if self.mesh is None else self.mesh.size,
            "profiles": None if self.profiles is None
            else [p.name for p in self.profiles],
            "weight_table": self._ptab is not None,
            "gang_score": self._gang_score,
            "serial_path": self.serial_path,
            "serial_lat_ms": {
                "host_twin": (None if self._lat_ora is None
                              else round(self._lat_ora * 1e3, 3)),
                "device": (None if self._lat_dev is None
                           else round(self._lat_dev * 1e3, 3))},
            "launches": K.launches(),
            "refusals": obs.family("refusal"),
        }
