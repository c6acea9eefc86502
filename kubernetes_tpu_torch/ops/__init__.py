"""Device layer of the port: dense node-state encoding and the kernels.

Device policy: every entry point runs on `cuda` unless the caller passes
`device="cpu"` (the tests do). A CUDA request without a card raises; the
port never carries on on the CPU by itself.

Dtype policy (the JAX package's numeric contract): int64 resource math and
scores, float64 only where the JAX kernels use it (balanced allocation,
selector spread, inter-pod min-max), floor division exactly as JAX `//`,
first-index argmax, and JAX's clamping of out-of-range gathers.

The constants below are the wire format shared with `kubernetes_tpu/ops/
kernels.py` (its lines 30-85 plus K_BATCH/B_CAP); tests pin them equal.
"""
from __future__ import annotations

MAX_PRIORITY = 10
MB = 1024 * 1024
IMAGE_MIN = 23 * MB
IMAGE_MAX = 1000 * MB
ZONE_WEIGHTING = 2.0 / 3.0

# fail-first codes (order of the default predicate set)
FAIL_NONE = 0
FAIL_UNSCHEDULABLE = 1
FAIL_GENERAL = 2
FAIL_DISK = 3          # NoDiskConflict (ordering: before taints)
FAIL_TAINTS = 4
FAIL_MAXVOL = 5        # Max*VolumeCount family
FAIL_VOLBIND = 6       # CheckVolumeBinding
FAIL_VOLZONE = 7       # NoVolumeZoneConflict
FAIL_INTERPOD = 8

# general_bits layout (GeneralPredicates sub-failures, predicates.go:1112)
BIT_PODS = 0
BIT_CPU = 1
BIT_MEM = 2
BIT_EPH = 3
BIT_SCALAR0 = 4          # bit 4+s for scalar resource s (s < 36)
BIT_UNKNOWN_SCALAR = 59     # pod wants a scalar no node advertises
BIT_HOST = 60
BIT_PORTS = 61
BIT_SELECTOR = 62

# default priority weights (reference: defaults.go:108, register_priorities.go)
DEFAULT_WEIGHTS = {
    "selector_spread": 1,
    "interpod": 1,
    "least_requested": 1,
    "most_requested": 0,      # ClusterAutoscalerProvider swaps this for least
    "rtcr": 0,                # RequestedToCapacityRatioPriority (default shape)
    "balanced": 1,
    "prefer_avoid": 10000,
    "node_affinity": 1,
    "taint_toleration": 1,
    "image_locality": 1,
}

# column order of the [profiles x priorities] int64 weight table; a
# wire-format constant for resident tensors
PRIORITY_AXIS = ("selector_spread", "interpod", "least_requested",
                 "most_requested", "rtcr", "balanced", "prefer_avoid",
                 "node_affinity", "taint_toleration", "image_locality",
                 "gang_locality")

K_BATCH = 512        # pods resolved per O(N) pass of the uniform burst
B_CAP = 16384        # uniform output-buffer capacity; callers chunk above it


def resolve_device(device=None):
    """The torch device an entry point runs on: `cuda` by default. Raises
    when CUDA is asked for and no card is visible."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch runs on CUDA by default and no CUDA "
            "device is available; pass device='cpu' for the plain versions")
    return dev
