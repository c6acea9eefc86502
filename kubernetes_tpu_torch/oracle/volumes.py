"""Volume predicates and the volume binder bridge, copied from the
reference oracle (`kubernetes_tpu.oracle.volumes`) with the port's imports.

`default_predicate_set` reaches `make_volume_predicates` when the host
twin is given volume listers; without them the volume predicates are
always-fit, as in the reference. Mirrors the reference's volume-aware
scheduling:
- NoDiskConflict (predicates.go:288): direct-volume double-attach conflicts.
- MaxPDVolumeCountChecker (predicates.go:452): per-plugin attach limits
  counting unique volumes on the node plus the pod's (unbound/missing PVCs
  count pessimistically as unique).
- VolumeZoneChecker (predicates.go:625): bound PVs with zone/region labels
  restrict the node's failure domain.
- VolumeBindingChecker (predicates.go:1581 via CheckVolumeBinding): bound
  PVCs' PVs must fit the node; unbound PVCs need a matching available PV.
- VolumeBinder (pkg/scheduler/volumebinder bridging
  controller/volume/scheduling): CheckVolumeBinding's find step, and the
  assume / bind half the scheduler shell runs around a binding. The
  BalanceAttachedNodeVolumes gate is left out (off by default; only the
  reference's config surface turns it on).

Failure reason strings follow predicates/error.go: NoDiskConflict,
MaxVolumeCount, NoVolumeZoneConflict, VolumeBindingNoMatch,
VolumeNodeAffinityConflict.
"""
from __future__ import annotations

from typing import Callable, Optional

from kubernetes_tpu_torch.api.types import (
    Pod, Node, VolumeSource, PersistentVolume, PersistentVolumeClaim,
    PLUGIN_EBS, PLUGIN_GCE_PD, PLUGIN_AZURE_DISK, PLUGIN_CINDER, PLUGIN_CSI,
    DEFAULT_VOLUME_LIMITS,
    LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo

ERR_DISK_CONFLICT = "NoDiskConflict"
ERR_MAX_VOLUME_COUNT = "MaxVolumeCount"
ERR_VOLUME_ZONE_CONFLICT = "NoVolumeZoneConflict"
ERR_VOLUME_BIND_CONFLICT = "VolumeBindingNoMatch"
ERR_VOLUME_NODE_CONFLICT = "VolumeNodeAffinityConflict"

# plugins where two read-only attachments of the same volume may share a node
_RO_SHARABLE = {PLUGIN_GCE_PD}


class VolumeListers:
    """PVC/PV lookup bundle the predicates consume."""

    def __init__(self,
                 pvcs_fn: Callable[[], list[PersistentVolumeClaim]] = lambda: [],
                 pvs_fn: Callable[[], list[PersistentVolume]] = lambda: []):
        self.pvcs_fn = pvcs_fn
        self.pvs_fn = pvs_fn

    def pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        for c in self.pvcs_fn():
            if c.namespace == namespace and c.name == name:
                return c
        return None

    def pv(self, name: str) -> Optional[PersistentVolume]:
        for v in self.pvs_fn():
            if v.name == name:
                return v
        return None


def _volume_conflict(v: VolumeSource, existing: VolumeSource) -> bool:
    """Reference: isVolumeConflict — same backing volume on the same node;
    GCE PD tolerates all-read-only sharing."""
    if not v.plugin or not v.volume_id:
        return False
    if v.plugin != existing.plugin or v.volume_id != existing.volume_id:
        return False
    if v.plugin in _RO_SHARABLE and v.read_only and existing.read_only:
        return False
    return True


def no_disk_conflict(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:288."""
    for v in pod.volumes:
        for ep in node_info.pods:
            for ev in ep.volumes:
                if _volume_conflict(v, ev):
                    return False, [ERR_DISK_CONFLICT]
    return True, []


class MaxVolumeCountChecker:
    """One per plugin family (predicates.go:452)."""

    def __init__(self, plugin: str, listers: VolumeListers,
                 max_volumes: Optional[int] = None):
        self.plugin = plugin
        self.listers = listers
        self.max_volumes = max_volumes

    def _limit(self, node: Optional[Node]) -> int:
        if self.max_volumes is not None:
            return self.max_volumes
        if node is not None:
            # CSI-era per-node limits live in allocatable
            # ("attachable-volumes-<plugin>")
            limit = node.allocatable.get(f"attachable-volumes-{self.plugin}")
            if limit is not None:
                return limit
        return DEFAULT_VOLUME_LIMITS.get(self.plugin, 1 << 30)

    def _filter(self, pod: Pod, into: set) -> None:
        for v in pod.volumes:
            if v.plugin == self.plugin and v.volume_id:
                into.add(v.volume_id)
            elif v.pvc:
                pvc = self.listers.pvc(pod.namespace, v.pvc)
                if pvc is None or not pvc.volume_name:
                    # missing/unbound PVC counts pessimistically as unique
                    # (predicates.go:440-448)
                    into.add(f"pvc-{pod.namespace}/{v.pvc}")
                    continue
                pv = self.listers.pv(pvc.volume_name)
                if pv is None:
                    into.add(f"pv-{pvc.volume_name}")
                elif pv.plugin == self.plugin:
                    into.add(pv.volume_id or pv.name)

    def check(self, pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
        if not pod.volumes:
            return True, []
        new: set = set()
        self._filter(pod, new)
        if not new:
            return True, []
        existing: set = set()
        for ep in node_info.pods:
            self._filter(ep, existing)
        limit = self._limit(node_info.node)
        num_existing = len(existing)
        num_new = len(new - existing)
        if num_existing + num_new > limit:
            return False, [ERR_MAX_VOLUME_COUNT]
        return True, []


def _zone_match(pv_value: str, node_value: Optional[str]) -> bool:
    """PV zone labels may hold a __-separated set (volumeutil.LabelZonesToSet)."""
    if node_value is None:
        return False
    return node_value in pv_value.split("__")


def make_volume_zone_predicate(listers: VolumeListers):
    def volume_zone(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
        """Reference: predicates.go:625 VolumeZoneChecker.predicate."""
        if not pod.volumes or node_info.node is None:
            return True, []
        node = node_info.node
        for v in pod.volumes:
            if not v.pvc:
                continue
            pvc = listers.pvc(pod.namespace, v.pvc)
            if pvc is None or not pvc.volume_name:
                continue
            pv = listers.pv(pvc.volume_name)
            if pv is None:
                continue
            for label in (LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION):
                want = pv.labels.get(label)
                if want and not _zone_match(want, node.labels.get(label)):
                    return False, [ERR_VOLUME_ZONE_CONFLICT]
        return True, []
    return volume_zone


class VolumeBinder:
    """pkg/scheduler/volumebinder analog: find/assume/bind PVC→PV.

    - find_pod_volumes: CheckVolumeBinding's work — bound PVCs' PVs must be
      node-compatible; unbound PVCs need a matching unclaimed PV.
    - assume: reserve the chosen PVs in memory (cleared by forget).
    - bind: write claim_ref / volume_name through the store.
    """

    def __init__(self, listers: VolumeListers, store=None):
        self.listers = listers
        self.store = store
        self._assumed: dict[str, str] = {}   # pv name -> pvc key

    def _pv_fits_node(self, pv: PersistentVolume, node: Node) -> bool:
        for label in (LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION):
            want = pv.labels.get(label)
            if want and not _zone_match(want, node.labels.get(label)):
                return False
        return True

    def _find_match(self, pvc: PersistentVolumeClaim, node: Node
                    ) -> Optional[PersistentVolume]:
        best = None
        for pv in self.listers.pvs_fn():
            if pv.claim_ref or pv.name in self._assumed:
                continue
            if pv.storage_class != pvc.storage_class:
                continue
            if pv.capacity < pvc.request:
                continue
            if not self._pv_fits_node(pv, node):
                continue
            if best is None or pv.capacity < best.capacity:
                best = pv   # smallest fitting PV, like the volume binder
        return best

    def find_pod_volumes(self, pod: Pod, node: Node
                         ) -> tuple[bool, bool, list[str]]:
        """(all_bound_satisfied, all_unbound_satisfiable, reasons)."""
        reasons: list[str] = []
        bound_ok = True
        unbound_ok = True
        for v in pod.volumes:
            if not v.pvc:
                continue
            pvc = self.listers.pvc(pod.namespace, v.pvc)
            if pvc is None:
                unbound_ok = False
                reasons.append(ERR_VOLUME_BIND_CONFLICT)
                continue
            if pvc.volume_name:
                pv = self.listers.pv(pvc.volume_name)
                if pv is None or not self._pv_fits_node(pv, node):
                    bound_ok = False
                    reasons.append(ERR_VOLUME_NODE_CONFLICT)
            else:
                if self._find_match(pvc, node) is None:
                    unbound_ok = False
                    reasons.append(ERR_VOLUME_BIND_CONFLICT)
        return bound_ok, unbound_ok, reasons

    def make_predicate(self):
        def check_volume_binding(pod: Pod, node_info: NodeInfo
                                 ) -> tuple[bool, list[str]]:
            if not pod.volumes or node_info.node is None:
                return True, []
            bound_ok, unbound_ok, reasons = self.find_pod_volumes(
                pod, node_info.node)
            if bound_ok and unbound_ok:
                return True, []
            return False, reasons
        return check_volume_binding

    # -- assume / bind -------------------------------------------------------
    def assume_pod_volumes(self, pod: Pod, node: Node) -> list[tuple[str, str]]:
        """Reserve matches for the pod's unbound PVCs; returns
        [(pvc_key, pv_name)] reservations."""
        reservations = []
        for v in pod.volumes:
            if not v.pvc:
                continue
            pvc = self.listers.pvc(pod.namespace, v.pvc)
            if pvc is None or pvc.volume_name:
                continue
            pv = self._find_match(pvc, node)
            if pv is not None:
                self._assumed[pv.name] = pvc.key
                reservations.append((pvc.key, pv.name))
        return reservations

    def forget_pod_volumes(self, reservations: list[tuple[str, str]]) -> None:
        for _pvc_key, pv_name in reservations:
            self._assumed.pop(pv_name, None)

    def bind_pod_volumes(self, reservations: list[tuple[str, str]]) -> None:
        """Write the bindings through the store, then drop reservations."""
        from kubernetes_tpu_torch.store.store import PVS, PVCS
        for pvc_key, pv_name in reservations:
            if self.store is not None:
                def set_claim(pv, _pvc_key=pvc_key):
                    pv.claim_ref = _pvc_key
                    return pv

                def set_volume(pvc, _pv_name=pv_name):
                    pvc.volume_name = _pv_name
                    return pvc
                self.store.guaranteed_update(PVS, pv_name, set_claim)
                self.store.guaranteed_update(PVCS, pvc_key, set_volume)
            self._assumed.pop(pv_name, None)


def make_volume_predicates(listers: VolumeListers,
                           binder: Optional[VolumeBinder] = None
                           ) -> dict[str, Callable]:
    """The volume slots of the default predicate set."""
    binder = binder or VolumeBinder(listers)
    return {
        "NoDiskConflict": no_disk_conflict,
        "MaxEBSVolumeCount": MaxVolumeCountChecker(PLUGIN_EBS, listers).check,
        "MaxGCEPDVolumeCount": MaxVolumeCountChecker(PLUGIN_GCE_PD, listers).check,
        "MaxAzureDiskVolumeCount": MaxVolumeCountChecker(PLUGIN_AZURE_DISK, listers).check,
        "MaxCinderVolumeCount": MaxVolumeCountChecker(PLUGIN_CINDER, listers).check,
        "MaxCSIVolumeCountPred": MaxVolumeCountChecker(PLUGIN_CSI, listers).check,
        "NoVolumeZoneConflict": make_volume_zone_predicate(listers),
        "CheckVolumeBinding": binder.make_predicate(),
    }
