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


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kubernetes_tpu_torch.__path__, "kubernetes_tpu_torch."))


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "kubernetes_tpu_torch.core.torch_scheduler" in mods
    assert "kubernetes_tpu_torch.carry" in mods
    assert "kubernetes_tpu_torch.profiles" in mods
    assert "kubernetes_tpu_torch.oracle.preemption" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m.startswith('jaxlib')"
        " or m == 'kubernetes_tpu' or m.startswith('kubernetes_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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
    preempt = (_build.CSRC / "preempt_scan.cu").read_text()
    assert len(_enum_slots(preempt, "PP_COUNT")) == len(PK._PREEMPT_PTRS)
    assert len(_enum_slots(preempt, "PI_COUNT")) == 9
