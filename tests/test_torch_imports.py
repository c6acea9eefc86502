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
