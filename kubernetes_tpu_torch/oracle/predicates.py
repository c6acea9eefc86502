"""Filter predicates, copied from the reference oracle
(`kubernetes_tpu.oracle.predicates`) with the port's imports.

Pure-Python transliteration of the semantics of
pkg/scheduler/algorithm/predicates/predicates.go. The port's node and pod
encoders and FitError reason decoding read its failure reasons,
node-selector / affinity matching and the inter-pod affinity metadata with
its vectorized selector masks; `TorchScheduler`'s host twin runs the
predicates themselves in PREDICATE_ORDERING (`pod_fits_on_node`). Each
predicate returns (fit, [reason...]).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from kubernetes_tpu_torch.api.types import (
    Pod, Node, Taint,
    get_resource_request, get_container_ports,
    node_selector_terms_match,
    NO_SCHEDULE, NO_EXECUTE,
    TAINT_NODE_UNSCHEDULABLE, find_intolerable_taint,
    RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS, RESOURCE_EPHEMERAL_STORAGE,
    IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo

# Failure reasons (reference: predicates/error.go)
ERR_NODE_SELECTOR_NOT_MATCH = "NodeSelectorNotMatch"
ERR_POD_NOT_MATCH_HOST_NAME = "PodNotMatchHostName"
ERR_POD_NOT_FITS_HOST_PORTS = "PodNotFitsHostPorts"
ERR_TAINTS_TOLERATIONS_NOT_MATCH = "TaintsTolerationsNotMatch"
ERR_NODE_UNSCHEDULABLE = "NodeUnschedulable"
ERR_NODE_UNKNOWN_CONDITION = "NodeUnknownCondition"
ERR_NODE_NOT_READY = "NodeNotReady"
ERR_NODE_NETWORK_UNAVAILABLE = "NodeNetworkUnavailable"
ERR_NODE_UNDER_MEMORY_PRESSURE = "NodeUnderMemoryPressure"
ERR_NODE_UNDER_DISK_PRESSURE = "NodeUnderDiskPressure"
ERR_NODE_UNDER_PID_PRESSURE = "NodeUnderPIDPressure"
ERR_POD_AFFINITY_NOT_MATCH = "PodAffinityNotMatch"
ERR_POD_AFFINITY_RULES_NOT_MATCH = "PodAffinityRulesNotMatch"
ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH = "PodAntiAffinityRulesNotMatch"
ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH = "ExistingPodsAntiAffinityRulesNotMatch"
ERR_NODE_LABEL_PRESENCE_VIOLATED = "NodeLabelPresenceViolated"
ERR_SERVICE_AFFINITY_VIOLATED = "CheckServiceAffinity"


def insufficient_resource(resource: str) -> str:
    return f"InsufficientResource:{resource}"


# Predicate evaluation order (reference: predicates.go:143-149)
PREDICATE_ORDERING = [
    "CheckNodeCondition", "CheckNodeUnschedulable",
    "GeneralPredicates", "HostName", "PodFitsHostPorts",
    "MatchNodeSelector", "PodFitsResources", "NoDiskConflict",
    "PodToleratesNodeTaints", "PodToleratesNodeNoExecuteTaints",
    "CheckNodeLabelPresence", "CheckServiceAffinity",
    "MaxEBSVolumeCount", "MaxGCEPDVolumeCount", "MaxCSIVolumeCountPred",
    "MaxAzureDiskVolumeCount", "MaxCinderVolumeCount",
    "CheckVolumeBinding", "NoVolumeZoneConflict",
    "CheckNodeMemoryPressure", "CheckNodePIDPressure", "CheckNodeDiskPressure",
    "MatchInterPodAffinity",
]

# Failure reasons that preemption cannot resolve (reference: generic_scheduler.go:65-84)
UNRESOLVABLE_FAILURES = {
    ERR_NODE_SELECTOR_NOT_MATCH,
    ERR_POD_AFFINITY_RULES_NOT_MATCH,
    ERR_POD_NOT_MATCH_HOST_NAME,
    ERR_TAINTS_TOLERATIONS_NOT_MATCH,
    "NodeLabelPresenceViolated",
    ERR_NODE_NOT_READY,
    ERR_NODE_NETWORK_UNAVAILABLE,
    ERR_NODE_UNSCHEDULABLE,
    ERR_NODE_UNKNOWN_CONDITION,
    ERR_NODE_UNDER_MEMORY_PRESSURE,
    ERR_NODE_UNDER_DISK_PRESSURE,
    ERR_NODE_UNDER_PID_PRESSURE,
    # volume placement can't be fixed by evicting pods
    # (generic_scheduler.go:81-83)
    "NoVolumeZoneConflict",
    "VolumeNodeAffinityConflict",
    "VolumeBindingNoMatch",
}


# ---------------------------------------------------------------------------
# Individual predicates
# ---------------------------------------------------------------------------
def pod_fits_resources(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:764 PodFitsResources."""
    fails: list[str] = []
    allowed = node_info.allocatable.allowed_pod_number
    if len(node_info.pods) + 1 > allowed:
        fails.append(insufficient_resource(RESOURCE_PODS))

    req = get_resource_request(pod)
    if req.milli_cpu == 0 and req.memory == 0 and req.ephemeral_storage == 0 and not req.scalar:
        return len(fails) == 0, fails

    alloc = node_info.allocatable
    used = node_info.requested
    if alloc.milli_cpu < req.milli_cpu + used.milli_cpu:
        fails.append(insufficient_resource(RESOURCE_CPU))
    if alloc.memory < req.memory + used.memory:
        fails.append(insufficient_resource(RESOURCE_MEMORY))
    if alloc.ephemeral_storage < req.ephemeral_storage + used.ephemeral_storage:
        fails.append(insufficient_resource(RESOURCE_EPHEMERAL_STORAGE))
    for name, q in req.scalar.items():
        if alloc.scalar.get(name, 0) < q + used.scalar.get(name, 0):
            fails.append(insufficient_resource(name))
    return len(fails) == 0, fails


def pod_matches_node_selector_and_affinity(pod: Pod, node: Node) -> bool:
    """Reference: predicates.go:854 podMatchesNodeSelectorAndAffinityTerms."""
    if pod.node_selector:
        for k, v in pod.node_selector.items():
            if node.labels.get(k) != v:
                return False
    affinity = pod.affinity
    if affinity is not None and affinity.node_affinity is not None:
        na = affinity.node_affinity
        if na.required is None:
            return True
        return node_selector_terms_match(na.required, node.labels)
    return True


def pod_match_node_selector(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    if node_info.node is None:
        return False, [ERR_NODE_UNKNOWN_CONDITION]
    if pod_matches_node_selector_and_affinity(pod, node_info.node):
        return True, []
    return False, [ERR_NODE_SELECTOR_NOT_MATCH]


def pod_fits_host(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    if not pod.node_name:
        return True, []
    if node_info.node is None:
        return False, [ERR_NODE_UNKNOWN_CONDITION]
    if pod.node_name == node_info.node.name:
        return True, []
    return False, [ERR_POD_NOT_MATCH_HOST_NAME]


def pod_fits_host_ports(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    want = get_container_ports(pod)
    if not want:
        return True, []
    for p in want:
        if node_info.used_ports.check_conflict(p.host_ip, p.protocol, p.host_port):
            return False, [ERR_POD_NOT_FITS_HOST_PORTS]
    return True, []


def general_predicates(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:1112 — resources + host + ports + selector,
    accumulating all failures (no short-circuit inside GeneralPredicates)."""
    fails: list[str] = []
    for pred in (pod_fits_resources, pod_fits_host, pod_fits_host_ports, pod_match_node_selector):
        fit, reasons = pred(pod, node_info)
        if not fit:
            fails.extend(reasons)
    return len(fails) == 0, fails


def check_node_unschedulable(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:1511."""
    if node_info.node is None:
        return False, [ERR_NODE_UNKNOWN_CONDITION]
    tolerates = any(
        t.tolerates(Taint(key=TAINT_NODE_UNSCHEDULABLE, effect=NO_SCHEDULE))
        for t in pod.tolerations
    )
    if node_info.node.unschedulable and not tolerates:
        return False, [ERR_NODE_UNSCHEDULABLE]
    return True, []


def pod_tolerates_node_taints(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:1531 — NoSchedule + NoExecute taints."""
    if node_info.node is None:
        return False, [ERR_NODE_UNKNOWN_CONDITION]
    bad = find_intolerable_taint(
        node_info.taints, pod.tolerations,
        lambda t: t.effect in (NO_SCHEDULE, NO_EXECUTE))
    if bad is None:
        return True, []
    return False, [ERR_TAINTS_TOLERATIONS_NOT_MATCH]


def pod_tolerates_node_no_execute_taints(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    bad = find_intolerable_taint(node_info.taints, pod.tolerations,
                                 lambda t: t.effect == NO_EXECUTE)
    if bad is None:
        return True, []
    return False, [ERR_TAINTS_TOLERATIONS_NOT_MATCH]


def _condition(node: Optional[Node], ctype: str) -> str:
    if node is None:
        return "Unknown"
    for c in node.conditions:
        if c.type == ctype:
            return c.status
    return "Unknown"


def check_node_condition(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    """Reference: predicates.go:1610 — Ready must be True, NetworkUnavailable
    must be False; node.Spec.Unschedulable also fails here."""
    if node_info.node is None:
        return False, [ERR_NODE_UNKNOWN_CONDITION]
    reasons = []
    for c in node_info.node.conditions:
        if c.type == "Ready" and c.status != "True":
            reasons.append(ERR_NODE_NOT_READY)
        elif c.type == "NetworkUnavailable" and c.status != "False":
            reasons.append(ERR_NODE_NETWORK_UNAVAILABLE)
    if node_info.node.unschedulable:
        reasons.append(ERR_NODE_UNSCHEDULABLE)
    return len(reasons) == 0, reasons


def is_pod_best_effort(pod: Pod) -> bool:
    """QoS BestEffort — no container has any request (limits are out of our
    pruned model; requests-only matches the scheduler-relevant behavior)."""
    for c in list(pod.containers) + list(pod.init_containers):
        if c.requests:
            return False
    return True


def check_node_memory_pressure(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    if not is_pod_best_effort(pod):
        return True, []
    if _condition(node_info.node, "MemoryPressure") == "True":
        return False, [ERR_NODE_UNDER_MEMORY_PRESSURE]
    return True, []


def check_node_disk_pressure(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    if _condition(node_info.node, "DiskPressure") == "True":
        return False, [ERR_NODE_UNDER_DISK_PRESSURE]
    return True, []


def check_node_pid_pressure(pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
    if _condition(node_info.node, "PIDPressure") == "True":
        return False, [ERR_NODE_UNDER_PID_PRESSURE]
    return True, []


# ---------------------------------------------------------------------------
# Inter-pod affinity (reference: predicates.go:1196-1500)
# ---------------------------------------------------------------------------
def term_namespaces(defining_pod: Pod, term) -> tuple[str, ...]:
    """Reference: priorities/util.GetNamespacesFromPodAffinityTerm."""
    return term.namespaces if term.namespaces else (defining_pod.namespace,)


def pod_matches_term_props(target: Pod, defining_pod: Pod, term) -> bool:
    """Namespace + label selector match (PodMatchesTermsNamespaceAndSelector)."""
    if target.namespace not in term_namespaces(defining_pod, term):
        return False
    if term.label_selector is None:
        return False
    return term.label_selector.matches(target.labels)


def nodes_same_topology(a: Optional[Node], b: Optional[Node], key: str) -> bool:
    """Reference: priorities/util.NodesHaveSameTopologyKey."""
    if a is None or b is None or not key:
        return False
    return key in a.labels and key in b.labels and a.labels[key] == b.labels[key]


# ---------------------------------------------------------------------------
# Vectorized selector matching over a columnar pod table
# ---------------------------------------------------------------------------
# The table (ops.node_state.PodTable, duck-typed here to keep the oracle
# import-free of the device stack) dictionary-encodes every snapshot pod's
# namespace and label pairs:
#   ns_id[P] i32; key_ids/val_ids[P, L] i32 (-1 padding);
#   ns_vocab/key_vocab/val_vocab: str -> id; val_ints[V] f64 (parsed integer
#   value of each vocab entry, NaN when unparseable — Gt/Lt support).
# These are the SHARED vectorized twins of _selector_matches /
# LabelSelector.matches / pod_matches_term_props: one boolean mask over the
# existing-pod axis instead of a Python call per pod. Every mask must stay
# bit-identical to a row-by-row scalar evaluation — the encoder parity
# fuzzes enforce it.


def _pair_mask(table, k: str, v: str) -> np.ndarray:
    """[P] bool: pod labels contain the exact (k, v) pair."""
    kid = table.key_vocab.get(k)
    vid = table.val_vocab.get(v)
    if kid is None or vid is None:
        return np.zeros(len(table.pods), dtype=bool)
    return ((table.key_ids == kid) & (table.val_ids == vid)).any(axis=1)


def _requirement_mask(table, req) -> np.ndarray:
    """Vectorized twin of Requirement.matches over the pod axis."""
    n = len(table.pods)
    kid = table.key_vocab.get(req.key)
    if req.op == IN:
        if kid is None:
            return np.zeros(n, dtype=bool)
        vids = [table.val_vocab[v] for v in req.values
                if v in table.val_vocab]
        if not vids:
            return np.zeros(n, dtype=bool)
        return ((table.key_ids == kid)
                & np.isin(table.val_ids, vids)).any(axis=1)
    if req.op == NOT_IN:
        # scalar twin: matches when the key is absent OR the value differs
        if kid is None:
            return np.ones(n, dtype=bool)
        vids = [table.val_vocab[v] for v in req.values
                if v in table.val_vocab]
        if not vids:
            return np.ones(n, dtype=bool)
        return ~((table.key_ids == kid)
                 & np.isin(table.val_ids, vids)).any(axis=1)
    if req.op == EXISTS:
        if kid is None:
            return np.zeros(n, dtype=bool)
        return (table.key_ids == kid).any(axis=1)
    if req.op == DOES_NOT_EXIST:
        if kid is None:
            return np.ones(n, dtype=bool)
        return ~(table.key_ids == kid).any(axis=1)
    if req.op in (GT, LT):
        # both sides must parse as integers (Requirement.matches)
        if kid is None:
            return np.zeros(n, dtype=bool)
        try:
            rv = int(req.values[0])
        except (ValueError, IndexError):
            return np.zeros(n, dtype=bool)
        has = table.key_ids == kid
        # label keys are unique per pod, so at most one lane carries the key
        vsel = np.where(has, table.val_ids, -1).max(axis=1)
        vals = np.full(n, np.nan)
        ok = vsel >= 0
        vals[ok] = table.val_ints[vsel[ok]]
        with np.errstate(invalid="ignore"):
            return vals > rv if req.op == GT else vals < rv
    raise ValueError(f"unknown selector op {req.op!r}")


def selector_match_mask(selector, table) -> np.ndarray:
    """[P] bool twin of priorities._selector_matches: dict selectors match
    by exact pairs; LabelSelector adds match_expressions."""
    n = len(table.pods)
    m = np.ones(n, dtype=bool)
    if isinstance(selector, dict):
        for k, v in selector.items():
            m &= _pair_mask(table, k, v)
        return m
    for k, v in selector.match_labels:
        m &= _pair_mask(table, k, v)
    for req in selector.match_expressions:
        m &= _requirement_mask(table, req)
    return m


def pod_matches_term_props_mask(defining_pod: Pod, term, table) -> np.ndarray:
    """[P] bool twin of pod_matches_term_props(target, defining_pod, term)
    evaluated for every table row as `target` at once."""
    n = len(table.pods)
    if term.label_selector is None:
        return np.zeros(n, dtype=bool)
    ns_ids = [table.ns_vocab[x] for x in term_namespaces(defining_pod, term)
              if x in table.ns_vocab]
    if not ns_ids:
        return np.zeros(n, dtype=bool)
    m = np.isin(table.ns_id, ns_ids)
    return m & selector_match_mask(term.label_selector, table)


def pod_matches_any_term_mask(defining_pod: Pod, terms, table) -> np.ndarray:
    """[P] bool: table rows matching ANY of `defining_pod`'s terms — the
    vectorized twin of `any(pod_matches_term_props(p, defining_pod, t) for
    t in terms)` per row. The preemption inertness gate uses this to find
    potential victims whose removal would change the incoming pod's
    (anti-)affinity masks."""
    m = np.zeros(len(table.pods), dtype=bool)
    for term in terms:
        m |= pod_matches_term_props_mask(defining_pod, term, table)
    return m


class InterPodAffinityChecker:
    """MatchInterPodAffinity over a full snapshot {node name -> NodeInfo}.

    Like the reference's predicate metadata (predicates/metadata.go:71), the
    cluster-wide scans run once per incoming pod, producing topology-pair
    COUNTS; the per-node check is then O(terms) label lookups. This is also
    the shape the device kernel consumes: per-term topology-value sets
    become dictionary-encoded masks over the node axis.

    Counts (not sets) make the metadata INCREMENTAL: preemption's reprieve
    loop and the nominated-ghost two-pass mutate one pod at a time and call
    add_pod/remove_pod — the reference's meta.AddPod/RemovePod
    (metadata.go:210/:239) — instead of recomputing the cluster scan per
    fit check.
    """

    def __init__(self, node_infos: dict[str, NodeInfo]):
        self.node_infos = node_infos
        self._meta_uid: Optional[str] = None
        self._meta = None
        # optional columnar acceleration (set_table_source): the metadata's
        # whole-cluster term scans then run as one mask over the pod axis
        self._table_fn = None
        self._topo_fn = None

    def set_table_source(self, table_fn, topo_fn) -> None:
        """Enable vectorized metadata scans: `table_fn()` returns the
        columnar pod table, `topo_fn(key)` the per-node dictionary-encoded
        label values (ids[N] i32 over the table's node axis, value->id
        vocab). Results are bit-identical to the scalar scan."""
        self._table_fn = table_fn
        self._topo_fn = topo_fn

    def invalidate(self) -> None:
        """Drop the per-pod metadata cache (whole-snapshot change, or a
        mutation the caller can't express as add_pod/remove_pod)."""
        self._meta_uid = None
        self._meta = None

    # -- incremental updates (metadata.go:210 RemovePod / :239 AddPod) -------
    def _apply_delta(self, target: Pod, other: Pod,
                     node: Optional[Node], sign: int) -> None:
        if self._meta is None or self._meta_uid != target.uid \
                or node is None or other.uid == target.uid:
            return
        violating, aff_terms, anti_terms = self._meta
        oa = other.affinity
        if oa is not None and oa.pod_anti_affinity is not None:
            for term in oa.pod_anti_affinity.required:
                if term.topology_key in node.labels and \
                        pod_matches_term_props(target, other, term):
                    k = (term.topology_key, node.labels[term.topology_key])
                    violating[k] = violating.get(k, 0) + sign
                    if violating[k] <= 0:
                        del violating[k]
        for term, values, total in aff_terms + anti_terms:
            if pod_matches_term_props(other, target, term):
                total[0] += sign
                if term.topology_key in node.labels:
                    v = node.labels[term.topology_key]
                    values[v] = values.get(v, 0) + sign
                    if values[v] <= 0:
                        del values[v]

    def add_pod(self, target: Pod, other: Pod, node: Optional[Node]) -> None:
        self._apply_delta(target, other, node, 1)

    def remove_pod(self, target: Pod, other: Pod,
                   node: Optional[Node]) -> None:
        self._apply_delta(target, other, node, -1)

    def _node_of(self, pod: Pod) -> Optional[Node]:
        ni = self.node_infos.get(pod.node_name)
        return ni.node if ni else None

    def _metadata(self, pod: Pod):
        if self._meta_uid == pod.uid:
            return self._meta
        # (a) Existing pods' required anti-affinity: count of entries per
        # (topologyKey, value) the incoming pod would violate.
        violating: dict[tuple[str, str], int] = {}
        for ni in self.node_infos.values():
            for existing in ni.pods_with_affinity:
                ea = existing.affinity
                if ea is None or ea.pod_anti_affinity is None:
                    continue
                e_node = self._node_of(existing)
                if e_node is None:
                    continue
                for term in ea.pod_anti_affinity.required:
                    if term.topology_key in e_node.labels and \
                            pod_matches_term_props(pod, existing, term):
                        k = (term.topology_key,
                             e_node.labels[term.topology_key])
                        violating[k] = violating.get(k, 0) + 1

        # (b) The pod's own required terms: per term, matching-pod counts by
        # topology value plus the total match count ([mutable] so deltas
        # apply in place).
        def term_values(term) -> tuple[dict[str, int], list[int]]:
            if self._table_fn is not None:
                return self._term_values_vec(pod, term)
            values: dict[str, int] = {}
            total = [0]
            for ni in self.node_infos.values():
                for existing in ni.pods:
                    if pod_matches_term_props(existing, pod, term):
                        total[0] += 1
                        e_node = self._node_of(existing)
                        if e_node is not None and term.topology_key in e_node.labels:
                            v = e_node.labels[term.topology_key]
                            values[v] = values.get(v, 0) + 1
            return values, total

        a = pod.affinity
        aff_terms = []
        anti_terms = []
        if a is not None and a.pod_affinity is not None:
            for term in a.pod_affinity.required:
                aff_terms.append((term, *term_values(term)))
        if a is not None and a.pod_anti_affinity is not None:
            for term in a.pod_anti_affinity.required:
                anti_terms.append((term, *term_values(term)))
        self._meta = (violating, aff_terms, anti_terms)
        self._meta_uid = pod.uid
        return self._meta

    def _term_values_vec(self, pod: Pod, term) -> tuple[dict[str, int], list[int]]:
        """Columnar twin of the scalar term_values scan: one mask over the
        pod axis, counts grouped by the matching pods' node label values."""
        table = self._table_fn()
        m = pod_matches_term_props_mask(pod, term, table)
        total = [int(np.count_nonzero(m))]
        values: dict[str, int] = {}
        if total[0]:
            ids, vocab = self._topo_fn(term.topology_key)
            rows = table.name_row[m]
            rows = rows[rows >= 0]          # node_name outside the snapshot
            if rows.size:
                vids = ids[rows]
                vids = vids[vids >= 0]      # node object/label absent
                if vids.size:
                    cnt = np.bincount(vids, minlength=len(vocab))
                    for v, vid in vocab.items():
                        c = int(cnt[vid])
                        if c:
                            values[v] = c
        return values, total

    def check(self, pod: Pod, node_info: NodeInfo) -> tuple[bool, list[str]]:
        node = node_info.node
        labels = node.labels if node is not None else {}
        violating, aff_terms, anti_terms = self._metadata(pod)
        # 1. Existing pods' required anti-affinity must not be violated.
        for key, value in violating:
            if labels.get(key) == value:
                return False, [ERR_POD_AFFINITY_NOT_MATCH,
                               ERR_EXISTING_PODS_ANTI_AFFINITY_RULES_NOT_MATCH]
        # 2. The pod's own required affinity/anti-affinity.
        for term, values, total in aff_terms:
            if labels.get(term.topology_key) not in values:
                # First-pod-in-cluster rule (reference: predicates.go:1454-1464):
                # if no pod anywhere matches the term, the term is waived when
                # the pod matches its own term (it would otherwise never schedule).
                if total[0] == 0 and pod_matches_term_props(pod, pod, term):
                    continue
                return False, [ERR_POD_AFFINITY_NOT_MATCH,
                               ERR_POD_AFFINITY_RULES_NOT_MATCH]
        for term, values, _total in anti_terms:
            if labels.get(term.topology_key) in values:
                return False, [ERR_POD_AFFINITY_NOT_MATCH,
                               ERR_POD_ANTI_AFFINITY_RULES_NOT_MATCH]
        return True, []


# ---------------------------------------------------------------------------
# Policy-configured predicates (factory.go:204 RegisterCustomFitPredicate)
# ---------------------------------------------------------------------------
def make_node_label_presence(labels: list[str], presence: bool) -> Callable:
    """Reference: predicates.go:943 CheckNodeLabelPresence — all the listed
    labels must exist on the node (presence=True) or none may
    (presence=False), regardless of value."""
    labels = list(labels)

    def check_node_label_presence(pod: Pod, node_info: NodeInfo
                                  ) -> tuple[bool, list[str]]:
        node = node_info.node
        if node is None:
            return False, []
        for label in labels:
            exists = label in node.labels
            if (exists and not presence) or (not exists and presence):
                return False, [ERR_NODE_LABEL_PRESENCE_VIOLATED]
        return True, []

    return check_node_label_presence


def make_service_affinity(labels: list[str],
                          node_infos: dict[str, NodeInfo],
                          services_fn: Callable) -> Callable:
    """Reference: predicates.go:1030 checkServiceAffinity — pods of the same
    service co-locate on nodes agreeing on the listed label values. Missing
    constraints are reverse-engineered: if the pod's nodeSelector doesn't pin
    a listed label and some already-scheduled pod of the same service exists,
    that pod's NODE supplies the missing values (metadata producer
    predicates.go:970: services selecting the pod + same-namespace pods
    matching the pod's own labels)."""
    labels = list(labels)

    def check_service_affinity(pod: Pod, node_info: NodeInfo
                               ) -> tuple[bool, list[str]]:
        node = node_info.node
        if node is None:
            return False, []
        # metadata: services selecting this pod; same-namespace pods whose
        # labels are a superset of this pod's labels
        services = [s for s in services_fn()
                    if s.namespace == pod.namespace and s.selector
                    and all(pod.labels.get(k) == v
                            for k, v in s.selector.items())]
        matching = [p for ni in node_infos.values() for p in ni.pods
                    if p.namespace == pod.namespace
                    and all(p.labels.get(k) == v
                            for k, v in pod.labels.items())]
        # FilterOutPods (node_info.go:656): keep pods not on this node (and
        # this-node pods present in the NodeInfo, which ours always are)
        this = node.name
        filtered = [p for p in matching
                    if p.node_name != this or any(q is p for q in node_info.pods)]
        affinity_labels = {l: pod.node_selector[l] for l in labels
                           if l in pod.node_selector}
        if len(labels) > len(affinity_labels) and services and filtered:
            first_ni = node_infos.get(filtered[0].node_name)
            if first_ni is not None and first_ni.node is not None:
                src = first_ni.node.labels
                for l in labels:
                    if l not in affinity_labels and l in src:
                        affinity_labels[l] = src[l]
        if all(node.labels.get(k) == v for k, v in affinity_labels.items()):
            return True, []
        return False, [ERR_SERVICE_AFFINITY_VIOLATED]

    return check_service_affinity


# ---------------------------------------------------------------------------
# Driver: run predicates in reference order with short-circuit
# ---------------------------------------------------------------------------
def default_predicate_set(node_infos: dict[str, NodeInfo],
                          taint_nodes_by_condition: bool = True,
                          volume_listers=None,
                          volume_binder=None) -> dict[str, Callable]:
    """The DefaultProvider predicate set (reference: defaults.go:40), keyed by
    name; evaluated in PREDICATE_ORDERING.

    TaintNodesByCondition is Beta/default-on in this snapshot
    (kube_features.go:468), so the effective default set drops the
    condition/pressure predicates and adds the mandatory
    PodToleratesNodeTaints + CheckNodeUnschedulable (defaults.go:60-90).
    Pass taint_nodes_by_condition=False for the pre-gate behavior.

    Volume-topology predicates (NoVolumeZoneConflict, Max*VolumeCount,
    NoDiskConflict, CheckVolumeBinding) are registered as always-fit until
    the volume model lands."""
    ipa = InterPodAffinityChecker(node_infos)
    always_fit = lambda pod, ni: (True, [])
    preds = {
        # handle for callers that mutate snapshot state mid-pod; not a
        # predicate (pod_fits_on_node iterates PREDICATE_ORDERING only)
        "_ipa_checker": ipa,
        "GeneralPredicates": general_predicates,
        "PodToleratesNodeTaints": pod_tolerates_node_taints,
        "MatchInterPodAffinity": ipa.check,
    }
    if volume_listers is not None:
        from kubernetes_tpu_torch.oracle.volumes import make_volume_predicates
        preds.update(make_volume_predicates(volume_listers, volume_binder))
    else:
        for name in ("NoDiskConflict", "MaxEBSVolumeCount", "MaxGCEPDVolumeCount",
                     "MaxAzureDiskVolumeCount", "MaxCinderVolumeCount",
                     "MaxCSIVolumeCountPred",
                     "CheckVolumeBinding", "NoVolumeZoneConflict"):
            preds[name] = always_fit
    if taint_nodes_by_condition:
        preds["CheckNodeUnschedulable"] = check_node_unschedulable
    else:
        preds["CheckNodeCondition"] = check_node_condition
        preds["CheckNodeMemoryPressure"] = check_node_memory_pressure
        preds["CheckNodeDiskPressure"] = check_node_disk_pressure
        preds["CheckNodePIDPressure"] = check_node_pid_pressure
    return preds


def pod_fits_on_node(pod: Pod, node_info: NodeInfo,
                     predicate_funcs: dict[str, Callable],
                     always_check_all: bool = False) -> tuple[bool, list[str]]:
    """One pass of podFitsOnNode (reference: generic_scheduler.go:598) without
    nominated-pod handling (the caller layers that on)."""
    failed: list[str] = []
    for key in PREDICATE_ORDERING:
        pred = predicate_funcs.get(key)
        if pred is None:
            continue
        fit, reasons = pred(pod, node_info)
        if not fit:
            failed.extend(reasons)
            if not always_check_all:
                break
    return len(failed) == 0, failed
