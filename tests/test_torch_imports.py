"""Import hygiene of the port, and its constants against the JAX package.

`kubernetes_tpu_torch` imports torch and numpy, never jax and nothing of
`kubernetes_tpu`: a fresh interpreter imports every module of the port and
must find neither in `sys.modules`.
"""
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import kubernetes_tpu_torch
from kubernetes_tpu.ops import kernels as JK
from kubernetes_tpu_torch import ops as P
from kubernetes_tpu_torch.ops import kernels as PK

ROOT = Path(__file__).resolve().parents[1]
#: seconds the child interpreter of the import check may take: it imports
#: torch and every module of the port, a few seconds on a loaded host
CHILD_TIMEOUT_S = 240


#: the scheduler shell and the host modules it reads, each a copy of the
#: JAX package's module of the same relative path
SHELL_MODULES = (
    "kubernetes_tpu_torch.scheduler",
    "kubernetes_tpu_torch.utils.clock", "kubernetes_tpu_torch.utils.heap",
    "kubernetes_tpu_torch.utils.tracing",
    "kubernetes_tpu_torch.coscheduling.types",
    "kubernetes_tpu_torch.framework.v1alpha1",
    "kubernetes_tpu_torch.obs", "kubernetes_tpu_torch.obs.registry",
    "kubernetes_tpu_torch.obs.ledger", "kubernetes_tpu_torch.obs.trace",
    "kubernetes_tpu_torch.chaos",
    "kubernetes_tpu_torch.store.store",
    "kubernetes_tpu_torch.store.commit_core",
    "kubernetes_tpu_torch.store.record", "kubernetes_tpu_torch.store.remote",
    "kubernetes_tpu_torch.store.informer",
    "kubernetes_tpu_torch.cache.cache",
    "kubernetes_tpu_torch.queue.scheduling_queue",
    "kubernetes_tpu_torch.core.breaker", "kubernetes_tpu_torch.oracle.gang",
)
#: the serving path's copies: the serve loop, gate and arrivals, the
#: fleet, the flight recorder and the leader election
SERVING_MODULES = (
    "kubernetes_tpu_torch.serve", "kubernetes_tpu_torch.serve.backpressure",
    "kubernetes_tpu_torch.serve.arrivals", "kubernetes_tpu_torch.serve.loop",
    "kubernetes_tpu_torch.fleet", "kubernetes_tpu_torch.fleet.partition",
    "kubernetes_tpu_torch.fleet.instance",
    "kubernetes_tpu_torch.fleet.manager",
    "kubernetes_tpu_torch.obs.flight",
    "kubernetes_tpu_torch.utils.leader_election",
)
#: the scheduler command and what it reads: the config and Policy, the
#: gates, the metrics exposition, the hollow generators, the process
#: metrics, the time-series scraper and the tuner
COMMAND_MODULES = (
    "kubernetes_tpu_torch.apis", "kubernetes_tpu_torch.apis.config",
    "kubernetes_tpu_torch.apis.policy", "kubernetes_tpu_torch.utils.features",
    "kubernetes_tpu_torch.factory", "kubernetes_tpu_torch.metrics",
    "kubernetes_tpu_torch.models", "kubernetes_tpu_torch.models.hollow",
    "kubernetes_tpu_torch.cmd", "kubernetes_tpu_torch.cmd.scheduler",
    "kubernetes_tpu_torch.obs.procmetrics",
    "kubernetes_tpu_torch.obs.timeseries",
    "kubernetes_tpu_torch.tuner", "kubernetes_tpu_torch.tuner.simulator",
    "kubernetes_tpu_torch.tuner.search",
    "kubernetes_tpu_torch.tuner.controller",
    "kubernetes_tpu_torch.tuner.cell",
)

#: the extender passes and the HTTP pair: the extender, the serde codec,
#: the apiserver (auth, admission, webhooks, the REST server) and the
#: remote store client
HTTP_MODULES = (
    "kubernetes_tpu_torch.core.extender", "kubernetes_tpu_torch.api.serde",
    "kubernetes_tpu_torch.apiserver",
    "kubernetes_tpu_torch.apiserver.auth",
    "kubernetes_tpu_torch.apiserver.admission",
    "kubernetes_tpu_torch.apiserver.webhook",
    "kubernetes_tpu_torch.apiserver.server",
    "kubernetes_tpu_torch.store.remote",
)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kubernetes_tpu_torch.__path__, "kubernetes_tpu_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "kubernetes_tpu_torch.core.torch_scheduler" in mods
    assert "kubernetes_tpu_torch.carry" in mods
    assert "kubernetes_tpu_torch.profiles" in mods
    assert "kubernetes_tpu_torch.oracle.preemption" in mods
    assert "kubernetes_tpu_torch.parallel.sharding" in mods
    # the host twin's copies of the oracle and the factory registries
    assert "kubernetes_tpu_torch.factory" in mods
    assert "kubernetes_tpu_torch.oracle.volumes" in mods
    for m in SHELL_MODULES + SERVING_MODULES + COMMAND_MODULES \
            + HTTP_MODULES:
        assert m in mods, m
    from kubernetes_tpu_torch import factory
    from kubernetes_tpu_torch.oracle import generic_scheduler, preemption
    for mod, fn in ((factory, "build_predicate_set"),
                    (factory, "build_priority_configs"),
                    (generic_scheduler, "GenericScheduler"),
                    (preemption, "pod_fits_on_node_with_nominated")):
        assert callable(getattr(mod, fn)), fn
    # the sharded preemption programs live in the walked modules
    from kubernetes_tpu_torch.parallel import sharding
    for fn in ("shard_victim_planes", "sharded_preempt",
               "sharded_pressure"):
        assert callable(getattr(sharding, fn)), fn
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m.startswith('jaxlib')"
        " or m == 'kubernetes_tpu' or m.startswith('kubernetes_tpu.')"
        " or m.endswith('.native') or '.native.' in m)\n"
        "print(json.dumps(bad))\n")
    # a child that does not end fails the test (TimeoutExpired) instead of
    # holding its worker until the run's own limit
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=CHILD_TIMEOUT_S)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _import_lines_name_no_jax(modules, self_contained=()):
    """Every import line of `modules` names neither jax nor the JAX
    package, lazy imports inside functions included; each imports from
    the port but those in `self_contained` (which import no package
    module at all)."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|kubernetes_tpu)\b"
                     r"(?!_torch)")
    root = Path(kubernetes_tpu_torch.__path__[0]).parent
    for m in modules:
        path = root / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = root / m.replace(".", "/") / "__init__.py"
        lines = path.read_text().splitlines()
        assert m in self_contained or any(
            "kubernetes_tpu_torch" in ln for ln in lines), path
        for ln in lines:
            assert not pat.match(ln), (path, ln)


def test_serving_modules_import_neither_jax_nor_the_jax_package():
    """The serving modules' import lines (the child interpreter above sees
    only what importing the modules runs)."""
    _import_lines_name_no_jax(SERVING_MODULES)


def test_command_modules_import_neither_jax_nor_the_jax_package():
    """`apis/`, `cmd/`, `models/`, `tuner/`, `metrics.py`, the gates and
    the two process-level `obs/` modules, lazy imports included; and
    importing the command alone in a fresh interpreter loads neither."""
    _import_lines_name_no_jax(COMMAND_MODULES, self_contained=(
        "kubernetes_tpu_torch.apis.policy",
        "kubernetes_tpu_torch.utils.features"))
    code = (
        "import json, sys\n"
        "import kubernetes_tpu_torch.cmd.scheduler\n"
        "import kubernetes_tpu_torch.tuner.cell\n"
        "from kubernetes_tpu_torch.tuner import simulator, search\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'kubernetes_tpu'"
        " or m.startswith('kubernetes_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=CHILD_TIMEOUT_S)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_http_modules_import_neither_jax_nor_the_jax_package():
    """`core/extender.py`, `api/serde.py`, `apiserver/*` and
    `store/remote.py`, lazy imports included (the reference's admission
    imports its controllers lazily; the port's carries its own copies);
    and importing them alone in a fresh interpreter loads neither."""
    _import_lines_name_no_jax(HTTP_MODULES, self_contained=(
        "kubernetes_tpu_torch.apiserver",))
    code = (
        "import importlib, json, sys\n"
        f"for m in {HTTP_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'kubernetes_tpu'"
        " or m.startswith('kubernetes_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=CHILD_TIMEOUT_S)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_admission_copies_equal_the_jax_controllers():
    """The taint keys and `pod_usage` the port's admission carries equal
    the reference controllers' (`controllers/nodelifecycle.py`,
    `controllers/resourcequota.py`) on the same pods."""
    from kubernetes_tpu.api import types as JT
    from kubernetes_tpu.controllers import nodelifecycle, resourcequota
    from kubernetes_tpu_torch.apiserver import admission
    from tests.test_torch_encoders import to_port
    assert admission.TAINT_NOT_READY == nodelifecycle.TAINT_NOT_READY
    assert admission.TAINT_UNREACHABLE == nodelifecycle.TAINT_UNREACHABLE
    for pod in (JT.Pod(name="a"),
                JT.Pod(name="b", containers=(JT.Container.make(
                    name="c", requests={"cpu": 250, "memory": 3 << 30}),),
                    init_containers=(JT.Container.make(
                        name="i", requests={"cpu": 900}),)),
                JT.Pod(name="c", containers=(JT.Container.make(
                    name="c", requests={"example.com/gpu": 2}),))):
        assert admission.pod_usage(to_port(pod)) == \
            resourcequota.pod_usage(pod)


def test_no_port_module_reaches_a_native_core(monkeypatch):
    """The port keeps the pure-Python heap and commit cores: no module
    imports a `native` package (the JAX package's C++ cores), and the
    commit core refuses to be forced native."""
    import re
    pat = re.compile(r"^\s*(from\s+\S*native\S*\s+import|import\s+\S*native"
                     r"|from\s+\S+\s+import\s+native\b)")
    for path in sorted(Path(kubernetes_tpu_torch.__path__[0]).rglob("*.py")):
        for line in path.read_text().splitlines():
            assert not pat.match(line), (path, line)
    import pytest
    from kubernetes_tpu_torch.store import commit_core
    from kubernetes_tpu_torch.store.store import Store
    from kubernetes_tpu_torch.utils.heap import NumericKeyedHeap, _PyHeapCore
    assert Store().core_impl == "twin"
    monkeypatch.setenv("KTPU_COMMITCORE", "native")
    with pytest.raises(RuntimeError):
        commit_core.make_commit_core(16, 16, object, KeyError, KeyError)
    h = NumericKeyedHeap(lambda x: x[0], lambda x: x[1])
    assert isinstance(h._core, _PyHeapCore)


def test_constants_equal_the_jax_module():
    for name in ("MAX_PRIORITY", "MB", "IMAGE_MIN", "IMAGE_MAX",
                 "ZONE_WEIGHTING", "FAIL_NONE", "FAIL_UNSCHEDULABLE",
                 "FAIL_GENERAL", "FAIL_DISK", "FAIL_TAINTS", "FAIL_MAXVOL",
                 "FAIL_VOLBIND", "FAIL_VOLZONE", "FAIL_INTERPOD", "BIT_PODS",
                 "BIT_CPU", "BIT_MEM", "BIT_EPH", "BIT_SCALAR0",
                 "BIT_UNKNOWN_SCALAR", "BIT_HOST", "BIT_PORTS",
                 "BIT_SELECTOR", "DEFAULT_WEIGHTS", "PRIORITY_AXIS",
                 "K_BATCH", "B_CAP"):
        assert getattr(P, name) == getattr(JK, name), name
        assert getattr(PK, name) == getattr(JK, name), name


def test_kernel_sources_exist_for_every_kernel():
    from kubernetes_tpu_torch.ops import _build
    assert tuple(PK.KERNELS) == tuple(_build.NAMES)
    # K9a-d, K10a/b and K11a/b, the mesh kernels, each a source of its own
    assert set(_build.NAMES) >= {
        "shard_cycle_local", "shard_cycle_select", "shard_uniform_sweep",
        "shard_uniform_select", "shard_scan_local", "shard_scan_select",
        "shard_segments_local", "shard_segments_select",
        "shard_preempt_local", "shard_preempt_select",
        "shard_pressure_local", "shard_pressure_select"}
    for name in _build.NAMES:
        assert (_build.CSRC / f"{name}.cu").exists(), name
        # every kernel source includes only the package's own headers
        src = (_build.CSRC / f"{name}.cu").read_text()
        for line in src.splitlines():
            if line.startswith('#include "'):
                assert (_build.CSRC / line.split('"')[1]).exists(), line
        assert name in _build.SIGNATURES
    assert json.dumps(sorted(_build.SIGNATURES)) == json.dumps(
        sorted(_build.NAMES))


def test_preempt_constants_equal_the_jax_package():
    from kubernetes_tpu.core.tpu_scheduler import TPUScheduler
    from kubernetes_tpu.oracle import predicates as jpreds
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.oracle import predicates as ppreds
    assert PK.PREEMPT_P == JK.PREEMPT_P
    assert TorchScheduler.PRESSURE_B_CAP == TPUScheduler.PRESSURE_B_CAP
    assert ppreds.UNRESOLVABLE_FAILURES == jpreds.UNRESOLVABLE_FAILURES


def _enum_slots(src: str, end: str) -> list:
    """The names of the C enum that ends in `end`, before `end`."""
    import re
    m = re.search(r"enum\s*\{([^}]*\b" + end + r"\b[^}]*)\}", src)
    body = re.sub(r"//[^\n]*", "", m.group(1))
    names = [x.strip() for x in body.split(",") if x.strip()]
    return names[: names.index(end)]


def test_launch_slot_tables_match_the_kernel_enums():
    """The host's scalar and pointer tables and the kernels' argument
    enums have one slot each, in one order: a slot missing on either side
    would shift every pointer after it."""
    from kubernetes_tpu_torch.ops import _build
    cycle = (_build.CSRC / "cycle.cuh").read_text()
    pointers = _enum_slots(cycle, "P_COUNT")
    assert len(pointers) == len(PK._SCAN_PTRS)
    assert len(_enum_slots(cycle, "I_COUNT")) == len(PK._SCAN_INTS)
    for name, slot in zip(PK._SCAN_PTRS, pointers):
        # the enum spells the host name in capitals, short forms aside
        short = {"allowed_pods": "ALLOWED", "req_scalar_p": "REQ_SCALAR_P",
                 "interpod_code": "IPA_CODE", "node_aff_counts": "NA",
                 "taint_counts": "TT", "spread_counts": "SC",
                 "interpod_counts": "IC", "image_sums": "IMG",
                 "prefer_avoid": "PA", "interpod_tracked": "TRACKED",
                 "vic_violating": "VIC_VIOL", "req_scalar": "REQ_SCALAR"}
        assert slot == "P_" + short.get(name, name.upper()), (name, slot)
    # K7's one grid-wide launch: its grid in the scalars, the device's
    # record array and ticket in place of the aggregate planes
    preempt = (_build.CSRC / "preempt_scan.cu").read_text()
    vic = {"vic_violating": "VVIOL", "allowed_pods": "ALLOWED"}
    assert _enum_slots(preempt, "PP_COUNT") == [
        "PP_" + vic.get(k, k.upper().replace("VIC_", "V"))
        for k in PK._PREEMPT_PTRS]
    assert PK._PREEMPT_PTRS[-5:] == ("feas", "rank", "records", "ticket",
                                     "out")
    assert _enum_slots(preempt, "PI_COUNT") == [
        "PI_" + k.upper() for k in PK._PREEMPT_INTS]
    assert PK._PREEMPT_INTS[-1] == "blocks"
    # K9a's nominated-ghost slots (the serial cycle's two-pass fit): the
    # last four of its pointer table and of its C enum
    local = (_build.CSRC / "shard_cycle_local.cu").read_text()
    assert PK._SCL_PTRS[-4:] == ("ghost_cpu", "ghost_mem", "ghost_eph",
                                 "ghost_cnt")
    assert _enum_slots(local, "LP_COUNT")[-4:] == [
        "LP_GHOST_CPU", "LP_GHOST_MEM", "LP_GHOST_EPH", "LP_GHOST_CNT"]
    # the candidate record of the sharded pick (victim.cuh `CR_*`)
    victim = (_build.CSRC / "victim.cuh").read_text()
    assert _enum_slots(victim, "CR_I64") == [
        "CR_" + k.upper() for k in PK.CAND_SLOTS]


# the mesh kernels K9a-d, K10a/b, K11a/b, K13a/b and K14a/b, and K3, whose
# pass K9d shares: (source holding the enums, the C enum's last slot of the
# scalar table, of the pointer table, the enum prefixes, host tables); K10,
# K11 and K13 share `shard_scan.cuh`'s
_MESH_SLOTS = [
    ("uniform_burst.cu", "UBI_COUNT", "UBP_COUNT", "UBI_", "UBP_",
     "_UNIFORM_INTS", "_UNIFORM_PTRS"),
    ("shard_cycle_local.cu", "CL_COUNT", "LP_COUNT", "CL_", "LP_",
     "_SCL_INTS", "_SCL_PTRS"),
    ("shard_cycle_select.cu", "CS_COUNT", "SP_COUNT", "CS_", "SP_",
     "_SCS_INTS", "_SCS_PTRS"),
    ("shard_uniform_sweep.cu", "US_COUNT", "UP_COUNT", "US_", "UP_",
     "_SUS_INTS", "_SUS_PTRS"),
    ("shard_uniform_select.cu", "UD_COUNT", "DP_COUNT", "UD_", "DP_",
     "_SUD_INTS", "_SUD_PTRS"),
    ("shard_scan.cuh", "SLI_COUNT", "SLP_COUNT", "SLI_", "SLP_",
     "_SSL_INTS", "_SSL_PTRS"),
    ("shard_scan.cuh", "SSI_COUNT", "SSP_COUNT", "SSI_", "SSP_",
     "_SSS_INTS", "_SSS_PTRS"),
    ("shard_preempt_local.cu", "PLI_COUNT", "PLP_COUNT", "PLI_", "PLP_",
     "_SPL_INTS", "_SPL_PTRS"),
    ("shard_preempt_select.cu", "PSI_COUNT", "PSP_COUNT", "PSI_", "PSP_",
     "_SPS_INTS", "_SPS_PTRS"),
]


def test_mesh_launch_slot_tables_match_the_kernel_enums():
    """K9a-d, K10a/b, K11a/b, K13a/b, K14a/b: the host's scalar and
    pointer slot tables
    name the kernels' C enum slots one to one, in order (the enum spells
    the host name in capitals after its prefix, short forms aside)."""
    from kubernetes_tpu_torch.ops import _build
    short = {"allowed_pods": "ALLOWED", "interpod_code": "IPA_CODE",
             "node_aff_counts": "NA", "taint_counts": "TT",
             "spread_counts": "SC", "interpod_counts": "IC",
             "image_sums": "IMG", "prefer_avoid": "PA",
             "interpod_tracked": "TRACKED"}
    for name, iend, pend, ipre, ppre, itab, ptab in _MESH_SLOTS:
        src = (_build.CSRC / name).read_text()
        for end, pre, table in ((iend, ipre, itab), (pend, ppre, ptab)):
            slots = _enum_slots(src, end)
            host = getattr(PK, table)
            assert len(slots) == len(host), (name, table)
            for h, c in zip(host, slots):
                assert c == pre + short.get(h, h.upper()), (name, h, c)
    # K9b's pointer table: its cluster select's staging area and workspace
    # in place of the one-block select's flat planes and scratch, then the
    # stamps of the records K9a wrote in place
    assert PK._SCS_PTRS == ("gathered", "w", "ic_b", "tr_b", "perm",
                            "inv_perm", "pos", "total", "kept", "out",
                            "recs", "workspace", "stamps")
    # K9d's: its cluster's workspace in place of the one-block select's
    # flat tie / stay planes and tie lists
    assert PK._SUD_PTRS == ("gathered", "perm", "oid_seq", "state", "out",
                            "lni_out", "owner", "workspace")
    assert PK._SUD_INTS == ("n_pad", "rows", "D", "stride", "hoff", "B",
                            "K", "cap", "L", "n_oid", "ban")
    # K9c's and K3's: the pass-start scores computed in the kernel (K1
    # inline), so no K1 output slot
    assert PK._SUS_PTRS == ("w", "valid", "extra", "alloc_cpu", "alloc_mem",
                            "allowed", "xalloc", "salloc", "sused", "clsv",
                            "st", "tot", "flags", "state", "folded", "rec")
    assert "tot0" not in PK._UNIFORM_PTRS
    # K14a's one launch a device over its shards: after the shard's rows,
    # planes and slices, its record row in place, the device's stamps,
    # block records and tickets, then the peers' rows and stamps; the
    # call's exchange and the blocks a shard takes last. K14b reads the
    # records in place after their stamps
    preempt = (_build.CSRC / "shard_preempt_local.cu").read_text()
    tail = ("feas", "rank", "rec", "stamps", "records", "tickets") + tuple(
        f"peer_rec{k}" for k in range(PK.MAX_PEERS)) + tuple(
        f"peer_stamps{k}" for k in range(PK.MAX_PEERS))
    assert PK._SPL_PTRS[-len(tail):] == tail
    assert _enum_slots(preempt, "PLP_COUNT")[-len(tail):] == [
        "PLP_" + k.upper() for k in tail]
    assert PK._SPL_INTS[-5:] == ("D", "half", "round", "stamp", "blocks")
    assert _enum_slots(preempt, "PLI_COUNT")[-5:] == [
        "PLI_D", "PLI_HALF", "PLI_ROUND", "PLI_STAMP", "PLI_BLOCKS"]
    assert PK.LOCAL_GROUP_SHARDS * 8 * (len(PK._SPL_INTS)
                                        + len(PK._SPL_PTRS)) <= 4096
    assert _build.SIGNATURES["shard_preempt_local"] \
        == _build.SIGNATURES["shard_scan_local"]
    assert list(_build.QUERIES["shard_preempt_local"]) == [
        "shard_preempt_local_occupancy"]
    select = (_build.CSRC / "shard_preempt_select.cu").read_text()
    assert PK._SPS_INTS == ("D", "chunk", "P", "round", "stamp")
    assert PK._SPS_PTRS == ("gathered", "stamps", "out")
    assert _enum_slots(select, "PSP_COUNT") == [
        "PSP_GATHERED", "PSP_STAMPS", "PSP_OUT"]
    assert "stamps_wait(" in select and "pick_records_warp(" in select
    # the pass-state slots K9c and K9d share (uniform.cuh's last enum)
    uniform = (_build.CSRC / "uniform.cuh").read_text()
    state = [x.strip() for x in uniform.split("enum {")[-1].split("}")[0]
             .split(",")]
    assert state == ["ST_DONE", "ST_LNI", "ST_PASS", "ST_VFOLD", "ST_LNI0",
                     "ST_LANES"]
    assert [PK.ST_DONE, PK.ST_LNI, PK.ST_PASS, PK.ST_VFOLD, PK.ST_LNI0,
            PK.ST_LANES] == list(range(6))
    # the step-state slots of the sharded scans (shard_scan.cuh's first
    # enum), K10 and K11 alike
    scan = (_build.CSRC / "shard_scan.cuh").read_text()
    steps = _enum_slots(scan, "SS_COUNT")
    assert steps == ["SS_STEP", "SS_NEXT", "SS_LI", "SS_LNI", "SS_LNI0",
                     "SS_FOLD_SEL", "SS_FOLD_ROW", "SS_REWIND", "SS_T",
                     "SS_CHK_T", "SS_CHK_LI", "SS_CHK_LNI", "SS_FAILED",
                     "SS_GHOST_SEL"]
    assert [getattr(PK, s) for s in steps] == list(range(len(steps)))
    assert PK.SS_COUNT == len(steps)
    # the local kernels' checkpoint slots follow `_MUTABLE`
    assert [s for s in PK._SSL_PTRS if s.startswith("chk_")] == [
        "chk_" + k for k in PK._MUTABLE] + ["chk_spread"]


def test_cluster_geometry_slots_match_the_kernel_enum():
    """The geometry array every cluster launch takes (K5 / K6 a window,
    K10b / K11b a step) names `ClusterGeom`'s C enum slots in order, the
    select's staged record planes follow `RP_*`, and each cluster kernel's
    launch takes the geometry and has its occupancy query."""
    import ctypes
    from kubernetes_tpu_torch.ops import _build
    cycle = (_build.CSRC / "cluster_cycle.cuh").read_text()
    assert _enum_slots(cycle, "CG_COUNT") == [
        "CG_" + k.upper() for k in PK.CLUSTER_GEOM]
    assert _enum_slots(cycle, "RP_N") == [
        "RP_LOCAL", "RP_NA", "RP_TT", "RP_SC", "RP_IC"]
    assert len(_enum_slots(cycle, "RP_N")) == PK._RP_N
    plan = PK.select_plan(16384, 4)
    assert len(plan.geometry()) == len(PK.CLUSTER_GEOM)
    for name in PK.CLUSTER_KERNELS + PK.SELECT_CLUSTER_KERNELS:
        sig = _build.SIGNATURES[name]
        assert sig[2] is ctypes.POINTER(ctypes.c_longlong), name
        assert list(_build.QUERIES[name]) == [name + "_clusters"]
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_clusters(' in src, name
    # the selects launch one cluster through `cudaLaunchKernelEx` (the
    # helpers of cluster_cycle.cuh), never a plain <<<...>>> block
    assert "cudaLaunchKernelEx(&cfg, kernel" in cycle
    for name in PK.SELECT_CLUSTER_KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "<<<" not in src and "select_launch(" in src, name


def test_grouped_local_launch_matches_the_kernel_table():
    """K10a / K11a take every shard of a device in one launch: the host
    packs each shard's `_SSL_INTS` then `_SSL_PTRS` as one run of words
    (the C struct `ScanLocalArgs`, `SL_WORDS` = SLI_COUNT + SLP_COUNT), as
    many shards a launch as `LOCAL_GROUP_SHARDS` on both sides, and the
    launch takes (words, shard count, device index, stream, launch
    count). The locals and the cluster selects of a mesh step count each
    launch they make into the count the host gives them (`Relaunch`)."""
    import ctypes
    import re
    from kubernetes_tpu_torch.ops import _build
    scan = (_build.CSRC / "shard_scan.cuh").read_text()
    assert "constexpr int SL_WORDS = SLI_COUNT + SLP_COUNT;" in scan
    assert "static_assert(sizeof(ScanLocalArgs) == 8 * SL_WORDS" in scan
    assert re.search(r"struct ScanLocalArgs \{\s*i64 v\[SLI_COUNT\];\s*"
                     r"void\* p\[SLP_COUNT\];\s*\};", scan)
    shards = re.search(r"constexpr int LOCAL_GROUP_SHARDS = (\d+);", scan)
    assert int(shards.group(1)) == PK.LOCAL_GROUP_SHARDS
    # the classic 4 KB kernel-parameter limit holds a launch's table
    assert PK.LOCAL_GROUP_SHARDS * 8 * (len(PK._SSL_INTS)
                                        + len(PK._SSL_PTRS)) <= 4096
    for name in ("shard_scan_local", "shard_segments_local"):
        assert _build.SIGNATURES[name] == [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(const i64* words, int n,' \
            in src, name
        assert "__grid_constant__ ScanLocalGroup" in src, name
        assert re.search(r"void\* stream,\s*int\* launched\)", src), name
    assert "if (e == cudaSuccess) ++*launched;" in scan
    select = (_build.CSRC / "cluster_select.cuh").read_text()
    assert "if (e == 0) ++*launched;" in select
    for name in PK.SELECT_CLUSTER_KERNELS:
        assert _build.SIGNATURES[name][-1] is ctypes.POINTER(ctypes.c_int)
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert re.search(r"void\* stream, int\* launched\)", src), name


def test_pressure_launches_match_the_kernel_tables():
    """K8 launches one thread-block cluster a chunk: its launch takes the
    geometry (`pressure_plan`) and has its occupancy query, and no
    cooperative launch or grid barrier is left; the layout's K8 part (the
    ghost load and the victim aggregates a slot) is the planner's. K13a
    takes a device's shards as K10a does, with its row blocks' partial
    records (`PARTIAL_WORDS`, the pick's `VB_WORDS` plus the resolvable
    flag) in its `partials` slot and no second kernel; K13b binds its
    launch (device index, launch count)."""
    import ctypes
    import re
    from kubernetes_tpu_torch.ops import _build
    k8 = (_build.CSRC / "pressure_batch.cu").read_text()
    for gone in ("cudaLaunchCooperativeKernel", "this_grid", "grid.sync"):
        assert gone not in k8, gone
    assert 'extern "C" int pressure_batch_clusters(' in k8
    assert "pressure_batch" in PK.CLUSTER_KERNELS
    assert _build.SIGNATURES["pressure_batch"][2] is ctypes.POINTER(
        ctypes.c_longlong)
    cycle = (_build.CSRC / "cluster_cycle.cuh").read_text()
    assert "if (pressure && rows) o += sp * 8 * 4;" in cycle
    assert "if (pressure && rows) o += sp * (8 * 5 + 1);" in cycle
    assert PK._PRESSURE_SLOT_BYTES == 8 * 4 + 8 * 5 + 1
    victim = (_build.CSRC / "victim.cuh").read_text()
    vb_words = int(re.search(r"constexpr int VB_WORDS = (\d+);",
                             victim).group(1))
    k13a = (_build.CSRC / "shard_pressure_local.cu").read_text()
    assert "constexpr int PARTIAL_WORDS = VB_WORDS + 1;" in k13a
    assert PK.PARTIAL_WORDS == vb_words + 1
    scan = (_build.CSRC / "shard_scan.cuh").read_text()
    threads = re.search(r"constexpr int LOCAL_GROUP_THREADS = (\d+);", scan)
    assert int(threads.group(1)) == PK.LOCAL_GROUP_THREADS
    assert _enum_slots(scan, "SLP_COUNT")[-1] == "SLP_PARTIALS"
    assert PK._SSL_PTRS[-1] == "partials"
    assert _build.SIGNATURES["shard_pressure_local"] \
        == _build.SIGNATURES["shard_scan_local"]
    assert "__grid_constant__ ScanLocalGroup" in k13a
    assert "reduce_kernel" not in k13a and "<<<" not in k13a
    k13b = (_build.CSRC / "shard_pressure_select.cu").read_text()
    assert _build.SIGNATURES["shard_pressure_select"][-1] is ctypes.POINTER(
        ctypes.c_int)
    assert re.search(r"int device, void\* stream,\s*int\* launched\)", k13b)
