"""Filter/score/select kernels of the port: plain PyTorch versions and the
wrappers of their hand-written CUDA kernels (`ops/csrc/`).

Each JAX device program of `kubernetes_tpu/ops/kernels.py` that the burst
paths run has three things here:

- a plain PyTorch version (`*_plain`): the readable spec, a line-for-line
  mirror of the JAX function, and what runs for tensors on the CPU;
- a CUDA kernel, launched through `_build.load(...)` (nvcc, ctypes);
- a wrapper under the JAX name that takes the plain version for CPU tensors
  and launches the kernel for CUDA tensors. It never falls back: a CUDA
  tensor either goes through the kernel or the wrapper raises.

Each wrapper books `launch.<kernel>` in `obs` where it launches its kernel,
and nowhere else.

| kernel         | replaces (kubernetes_tpu/ops/kernels.py)           |
| local_total    | `_local_total` :110                                |
| schedule_cycle | `_feasibility` :296, `_fit_scores` :157,           |
|                | `_cycle_core` :359 -> `schedule_cycle` :509        |
| uniform_burst  | `_uniform_core` :1097 -> `schedule_batch_uniform`  |
|                | :1364                                              |
| scatter_rows   | `core/tpu_scheduler.py` `_scatter_rows` :158       |
| schedule_batch | `_fold_state` :549 + `_batch_core` :569 ->         |
|                | `schedule_batch` :668                              |
| schedule_segments | `_segments_core` :785 ->                        |
|                | `schedule_batch_segments` :949                     |

Numeric contract: int64 resource math and scores, float64 exactly where
JAX uses it, floor division as JAX `//` (torch `//` on integer tensors
floors too; the CUDA side uses `floordiv` from `csrc/common.cuh`),
first-index argmax (bool masks are cast before `torch.argmax`), and JAX's
clamping of out-of-range gathers/slices. Python ints stay exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.ops import (  # noqa: F401  (re-exported constants)
    MAX_PRIORITY, MB, IMAGE_MIN, IMAGE_MAX, ZONE_WEIGHTING,
    FAIL_NONE, FAIL_UNSCHEDULABLE, FAIL_GENERAL, FAIL_DISK, FAIL_TAINTS,
    FAIL_MAXVOL, FAIL_VOLBIND, FAIL_VOLZONE, FAIL_INTERPOD,
    BIT_PODS, BIT_CPU, BIT_MEM, BIT_EPH, BIT_SCALAR0, BIT_UNKNOWN_SCALAR,
    BIT_HOST, BIT_PORTS, BIT_SELECTOR,
    DEFAULT_WEIGHTS, PRIORITY_AXIS, K_BATCH, B_CAP,
)
from kubernetes_tpu_torch.ops import _build

_AXIS_INDEX = {n: i for i, n in enumerate(PRIORITY_AXIS)}
I64 = torch.int64
I32 = torch.int32
I64_MIN = -2 ** 63
I64_MAX = 2 ** 63 - 1
I32_MIN = -2 ** 31

#: the kernels' names, in port order (obs books `launch.<name>`)
KERNELS = ("local_total", "schedule_cycle", "uniform_burst", "scatter_rows",
           "schedule_batch", "schedule_segments")


def launches() -> dict[str, int]:
    """Launch counts of every hand kernel since `obs.reset("launch.")`."""
    return {k: obs.get("launch." + k) for k in KERNELS}


def _wsel(weights, wrow, name):
    """Effective weight of one family: the python int of the static
    `weights` dict, or the pod's weight-row lane (tensor mode; the dict
    then only gates which families run)."""
    if wrow is None:
        return weights[name]
    return wrow[_AXIS_INDEX[name]]


def _inert(arr) -> bool:
    """True for a per-node pod field left at its shape-[1] default."""
    return arr.ndim >= 1 and arr.shape[-1] == 1


def _row_at(tab: torch.Tensor, idx) -> torch.Tensor:
    """`tab[idx]` with JAX's index rules: a negative index wraps once, then
    the gather clamps into range (weight-table rows, rotation orders)."""
    p = int(_host(idx))
    n = tab.shape[0]
    if p < 0:
        p += n
    return tab[min(max(p, 0), n - 1)]


def _wrap32(x: int) -> int:
    """int64 -> int32 as `astype(int32)` does: wrap modulo 2**32."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _host(v):
    """A host value for a per-call scalar (syncs only if it is on a card)."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return v


def _t(v, device, dtype=None) -> torch.Tensor:
    """`v` (numpy, python or tensor) as a tensor on `device`."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.as_tensor(np.asarray(v))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device)


def _gate(weights) -> int:
    """Bitmask over PRIORITY_AXIS of the families the static weights run."""
    g = 0
    for i, name in enumerate(PRIORITY_AXIS):
        if weights.get(name):
            g |= 1 << i
    return g


def _weight_row(weights, wrow, device) -> torch.Tensor:
    """The [K] int64 weight row the CUDA kernels read: the pod's gathered
    table row in tensor mode, else the static weights in axis order."""
    if wrow is not None:
        return _t(wrow, device, I64).contiguous()
    return torch.tensor([int(weights.get(n, 0)) for n in PRIORITY_AXIS],
                        dtype=I64).to(device)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name}: CUDA kernel given a CPU tensor")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")


# ---------------------------------------------------------------------------
# K1 local_total — LeastRequested, MostRequested, RTCR, BalancedAllocation
# ---------------------------------------------------------------------------
def local_total_plain(weights, req_cpu, req_mem, alloc_cpu, alloc_mem,
                      wrow=None):
    """The four row-local resource priorities, exact integer/float formulas
    (`_local_total`, kernels.py:110). Elementwise on [N] tensors or scalars."""
    req_cpu = torch.as_tensor(req_cpu)
    req_mem = torch.as_tensor(req_mem)
    alloc_cpu = torch.as_tensor(alloc_cpu)
    alloc_mem = torch.as_tensor(alloc_mem)
    total = torch.zeros_like(alloc_cpu)

    if weights["least_requested"]:
        def least(req, cap):
            ok = (cap > 0) & (req <= cap)
            return torch.where(
                ok, (cap - req) * MAX_PRIORITY // torch.clamp(cap, min=1), 0)
        total = total + _wsel(weights, wrow, "least_requested") * (
            (least(req_cpu, alloc_cpu) + least(req_mem, alloc_mem)) // 2)

    if weights["most_requested"]:
        def most(req, cap):
            ok = (cap > 0) & (req <= cap)
            return torch.where(
                ok, req * MAX_PRIORITY // torch.clamp(cap, min=1), 0)
        total = total + _wsel(weights, wrow, "most_requested") * (
            (most(req_cpu, alloc_cpu) + most(req_mem, alloc_mem)) // 2)

    if weights["rtcr"]:
        # default broken-linear shape {0->10, 100->0}
        def rtcr_res(req, cap):
            p = torch.where((cap == 0) | (req > cap), 100,
                            100 - (cap - req) * 100 // torch.clamp(cap, min=1))
            return 10 - (10 * p) // 100
        total = total + _wsel(weights, wrow, "rtcr") * (
            (rtcr_res(req_cpu, alloc_cpu) + rtcr_res(req_mem, alloc_mem))
            // 2)

    if weights["balanced"]:
        cpu_f = torch.where(alloc_cpu == 0, 1.0,
                            req_cpu.double() / alloc_cpu.double())
        mem_f = torch.where(alloc_mem == 0, 1.0,
                            req_mem.double() / alloc_mem.double())
        balanced = torch.where(
            (cpu_f >= 1.0) | (mem_f >= 1.0), 0,
            ((1.0 - torch.abs(cpu_f - mem_f)) * float(MAX_PRIORITY)).to(I64))
        total = total + _wsel(weights, wrow, "balanced") * balanced

    return total


def _local_total_launch(weights, req_cpu, req_mem, alloc_cpu, alloc_mem,
                        wrow, add_cpu: int = 0, add_mem: int = 0):
    """Launch K1 over [N] vectors: out = local_total(req + add, alloc)."""
    n = int(alloc_cpu.shape[0])
    dev = alloc_cpu.device
    _require_cuda("local_total", req_cpu, req_mem, alloc_cpu, alloc_mem)
    w = _weight_row(weights, wrow, dev)
    out = torch.empty(n, dtype=I64, device=dev)
    lib = _build.load("local_total")
    obs.inc("launch.local_total")
    _check(lib.local_total_launch(
        n, _ptr(req_cpu), _ptr(req_mem), int(add_cpu), int(add_mem),
        _ptr(alloc_cpu), _ptr(alloc_mem), _gate(weights), _ptr(w),
        _ptr(out), _stream()), "local_total")
    return out


def local_total(weights, req_cpu, req_mem, alloc_cpu, alloc_mem, wrow=None):
    """K1. CPU tensors -> `local_total_plain`; CUDA [N] tensors -> the
    kernel (`csrc/local_total.cu`)."""
    if not (isinstance(alloc_cpu, torch.Tensor) and alloc_cpu.is_cuda):
        return local_total_plain(weights, req_cpu, req_mem, alloc_cpu,
                                 alloc_mem, wrow=wrow)
    return _local_total_launch(weights, req_cpu, req_mem, alloc_cpu,
                               alloc_mem, wrow)


# ---------------------------------------------------------------------------
# K2 schedule_cycle — feasibility, rotation walk, scores, k-th tie select
# ---------------------------------------------------------------------------
def _fit_scores_plain(nodes, pod, kept, weights, z_pad, wrow=None,
                      gang=None):
    """Enabled priorities, masked-normalized over `kept` (`_fit_scores`,
    kernels.py:157). Returns total[N] int64. `gang` = (gz[z_pad], member)
    is the rank-aware gang input: a member scores each node by
    min(members already placed in its zone, 10) times the gang weight."""
    alloc_cpu, alloc_mem = nodes["alloc_cpu"], nodes["alloc_mem"]
    req_cpu = pod["nz_cpu"] + nodes["nz_cpu"]
    req_mem = pod["nz_mem"] + nodes["nz_mem"]

    const = 0
    total = torch.zeros(nodes["valid"].shape, dtype=I64,
                        device=alloc_cpu.device) + local_total_plain(
        weights, req_cpu, req_mem, alloc_cpu, alloc_mem, wrow=wrow)

    if gang is not None and weights.get("gang_locality"):
        gz, gmember = gang
        zone_id = nodes["zone_id"]
        gw = _wsel(weights, wrow, "gang_locality")
        zh = zone_id[:, None] == torch.arange(
            z_pad, dtype=zone_id.dtype, device=zone_id.device)[None, :]
        glc = torch.sum(torch.where(zh, gz[None, :], 0), dim=1)
        gl = torch.clamp(glc, max=MAX_PRIORITY)
        total = total + torch.where(gmember & (zone_id > 0), gw * gl, 0)

    if weights["node_affinity"]:
        na = pod["node_aff_counts"]
        if not _inert(na):
            na_max = torch.max(torch.where(kept, na, 0))
            total = total + _wsel(weights, wrow, "node_affinity") * torch.where(
                na_max == 0, na,
                MAX_PRIORITY * na // torch.clamp(na_max, min=1))

    if weights["taint_toleration"]:
        tt = pod["taint_counts"]
        if _inert(tt):
            const = const + _wsel(weights, wrow, "taint_toleration") \
                * MAX_PRIORITY
        else:
            tt_max = torch.max(torch.where(kept, tt, 0))
            total = total + _wsel(weights, wrow, "taint_toleration") \
                * torch.where(tt_max == 0, MAX_PRIORITY,
                              MAX_PRIORITY - MAX_PRIORITY * tt
                              // torch.clamp(tt_max, min=1))

    if weights["selector_spread"]:
        sc = pod["spread_counts"]
        if _inert(sc):
            const = const + _wsel(weights, wrow, "selector_spread") \
                * MAX_PRIORITY
        else:
            zone_id = nodes["zone_id"]
            max_by_node = torch.max(torch.where(kept, sc, 0))
            f = torch.where(
                max_by_node > 0,
                float(MAX_PRIORITY) * ((max_by_node - sc).double()
                                       / torch.clamp(max_by_node,
                                                     min=1).double()),
                float(MAX_PRIORITY))
            in_zone = kept & (zone_id > 0)
            zh = zone_id[:, None] == torch.arange(
                z_pad, dtype=zone_id.dtype, device=zone_id.device)[None, :]
            izh = zh & in_zone[:, None]
            zone_counts = torch.sum(torch.where(izh, sc[:, None], 0), dim=0)
            zone_present = torch.any(izh, dim=0)
            have_zones = torch.any(in_zone)
            max_by_zone = torch.max(torch.where(zone_present, zone_counts, 0))
            zc = torch.sum(torch.where(zh, zone_counts[None, :], 0), dim=1)
            zs = torch.where(
                max_by_zone > 0,
                float(MAX_PRIORITY) * ((max_by_zone - zc).double()
                                       / torch.clamp(max_by_zone,
                                                     min=1).double()),
                float(MAX_PRIORITY))
            f = torch.where(have_zones & (zone_id > 0),
                            f * (1.0 - ZONE_WEIGHTING) + ZONE_WEIGHTING * zs,
                            f)
            total = total + _wsel(weights, wrow, "selector_spread") \
                * f.to(I64)

    if weights["interpod"]:
        ic = pod["interpod_counts"]
        tracked = pod["interpod_tracked"]
        if not (_inert(ic) and _inert(tracked)):
            sel = kept & tracked
            ic_max = torch.clamp(
                torch.max(torch.where(sel, ic, I64_MIN)), min=0)
            ic_min = torch.clamp(
                torch.min(torch.where(sel, ic, I64_MAX)), max=0)
            diff = ic_max - ic_min
            total = total + _wsel(weights, wrow, "interpod") * torch.where(
                (diff > 0) & tracked,
                (float(MAX_PRIORITY) * ((ic - ic_min).double()
                                        / torch.clamp(diff, min=1).double())
                 ).to(I64),
                0)

    if weights["image_locality"]:
        s = pod["image_sums"]
        if not _inert(s):
            scl = torch.clamp(s, IMAGE_MIN, IMAGE_MAX)
            total = total + _wsel(weights, wrow, "image_locality") * (
                MAX_PRIORITY * (scl - IMAGE_MIN) // (IMAGE_MAX - IMAGE_MIN))

    if weights["prefer_avoid"]:
        pa = pod["prefer_avoid"]
        if _inert(pa):
            const = const + _wsel(weights, wrow, "prefer_avoid") \
                * MAX_PRIORITY
        else:
            total = total + _wsel(weights, wrow, "prefer_avoid") * pa

    return total + const


def _feasibility_plain(nodes, pod):
    """(feasible[N], fail_first[N] int8, general_bits[N] int64) —
    `_feasibility`, kernels.py:296."""
    valid = nodes["valid"]
    dev = valid.device
    bits = torch.zeros(valid.shape, dtype=I64, device=dev)
    check_res = pod["check_resources"]
    pods_over = check_res & (nodes["pod_count"] + 1 > nodes["allowed_pods"])
    bits |= torch.where(pods_over, 1 << BIT_PODS, 0)
    has_req = pod["has_request"] & check_res
    over_cpu = nodes["alloc_cpu"] < pod["req_cpu"] + nodes["req_cpu"]
    over_mem = nodes["alloc_mem"] < pod["req_mem"] + nodes["req_mem"]
    over_eph = nodes["alloc_eph"] < pod["req_eph"] + nodes["req_eph"]
    bits |= torch.where(has_req & over_cpu, 1 << BIT_CPU, 0)
    bits |= torch.where(has_req & over_mem, 1 << BIT_MEM, 0)
    bits |= torch.where(has_req & over_eph, 1 << BIT_EPH, 0)
    over_scalar = nodes["alloc_scalar"] < pod["req_scalar"][None, :] \
        + nodes["req_scalar"]
    wants_scalar = pod["req_scalar"][None, :] > 0
    scalar_fail = has_req & wants_scalar & over_scalar
    s_count = scalar_fail.shape[1]
    scalar_bits = torch.sum(
        torch.where(scalar_fail,
                    (1 << (BIT_SCALAR0 + torch.arange(
                        s_count, dtype=I64, device=dev)))[None, :], 0), dim=1)
    bits |= scalar_bits
    bits |= torch.where(check_res & pod["unknown_scalar"],
                        1 << BIT_UNKNOWN_SCALAR, 0)
    if not _inert(pod["host_ok"]):
        bits |= torch.where(~pod["host_ok"], 1 << BIT_HOST, 0)
    if not _inert(pod["ports_ok"]):
        bits |= torch.where(~pod["ports_ok"], 1 << BIT_PORTS, 0)
    if not _inert(pod["sel_ok"]):
        bits |= torch.where(~pod["sel_ok"], 1 << BIT_SELECTOR, 0)

    general_fail = bits != 0
    skip = pod["skip"]
    fail_first = torch.zeros(valid.shape, dtype=I64, device=dev)
    for mask_key, code in (("interpod_code", FAIL_INTERPOD),
                           ("volzone_ok", FAIL_VOLZONE),
                           ("volbind_ok", FAIL_VOLBIND),
                           ("maxvol_ok", FAIL_MAXVOL),
                           ("taints_ok", FAIL_TAINTS),
                           ("disk_ok", FAIL_DISK)):
        field = pod[mask_key]
        if _inert(field):
            continue
        failed = (field > 0) if mask_key == "interpod_code" else ~field
        fail_first = torch.where(failed, code, fail_first)
    fail_first = torch.where(general_fail, FAIL_GENERAL, fail_first)
    if not _inert(pod["unsched_ok"]):
        fail_first = torch.where(~pod["unsched_ok"], FAIL_UNSCHEDULABLE,
                                 fail_first)
    feasible = valid & (fail_first == FAIL_NONE) & ~skip
    return feasible, fail_first.to(torch.int8), bits


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """First-index argmax of a bool mask (0 when none is set)."""
    return torch.argmax(mask.to(torch.uint8))


def _cycle_core_plain(nodes, pod, last_index, last_node_index, num_to_find,
                      n_real, weights, z_pad, perm=None, inv_perm=None,
                      pos=None, wtab=None, gang=None):
    """One fused cycle (`_cycle_core`, kernels.py:359): identity walk, the
    `perm`/`inv_perm` rotated walk, or the gather-free `pos` mode."""
    dev = nodes["valid"].device
    n_pad = nodes["valid"].shape[0]
    i = torch.arange(n_pad, dtype=I64, device=dev)
    nr = int(n_real)
    n_safe = max(nr, 1)
    li = int(last_index) % n_safe
    ntf = int(num_to_find)
    lni = int(last_node_index)
    in_range = i < nr

    feasible, fail_first, general_bits = _feasibility_plain(nodes, pod)
    feas = feasible & in_range
    skip = bool(pod["skip"])

    if pos is not None:
        F = int(torch.sum(feas.to(I64)))
        kept = feas
        found = min(F, ntf)
        evaluated = 0 if skip else nr
    else:
        feas_p = feas if perm is None else feas[perm.long()]
        S = torch.cumsum(feas_p.to(I64), 0)
        F = int(S[-1])
        pre = int(S[max(li - 1, 0)]) if li > 0 else 0
        after = i >= li
        rank_p = torch.where(after, S - pre, F - pre + S)
        kept_p = feas_p & (rank_p <= ntf)
        kept = kept_p if perm is None else kept_p[inv_perm.long()]
        found = min(F, ntf)
        reached = F >= ntf
        pstar = int(_first_true(kept_p & (rank_p == ntf)))
        stop_pos = pstar - li if pstar >= li else nr - li + pstar
        evaluated = stop_pos + 1 if reached else nr
        evaluated = 0 if skip else evaluated

    wrow = None
    if wtab is not None:
        wrow = _row_at(wtab, pod["profile_id"])
    total = _fit_scores_plain(nodes, pod, kept, weights, z_pad, wrow=wrow,
                              gang=gang)

    tmask = torch.where(kept, total, I64_MIN)
    max_score = int(torch.max(tmask))
    is_tie = kept & (tmask == max_score)
    num_ties = max(int(torch.sum(is_tie.to(I64))), 1)
    k = lni % num_ties
    if pos is not None:
        posl = pos.to(I64)
        rel = torch.where(posl >= li, posl - li, nr - li + posl)
        t_pos = torch.where(is_tie, rel, 2 ** 30)
        kth = torch.sort(t_pos).values[min(k, n_pad - 1)]
        sel = int(_first_true(is_tie & (rel == kth)))
    else:
        tie_p = is_tie if perm is None else is_tie[perm.long()]
        T = torch.cumsum(tie_p.to(I64), 0)
        preT = int(T[max(li - 1, 0)]) if li > 0 else 0
        trank = torch.where(after, T - preT, T[-1] - preT + T)
        sel = int(_first_true(tie_p & (trank == k + 1)))
        if perm is not None:
            sel = int(perm[sel])
    selected = sel if found > 0 else -1

    def s64(v):
        return torch.tensor(v, dtype=I64, device=dev)
    return {
        "selected": s64(selected),
        "found": s64(found),
        "evaluated": s64(evaluated),
        "max_score": s64(max_score if found > 0 else 0),
        "total": total,
        "kept": kept,
        "feasible": feasible,
        "fail_first": fail_first,
        "general_bits": general_bits,
        "next_last_index": s64((int(last_index) + evaluated) % n_safe),
        "next_last_node_index": s64(lni + (1 if found > 1 else 0)),
    }


def schedule_cycle_plain(nodes, pod, last_index, last_node_index,
                         num_to_find, n_real, z_pad, weights=None, wtab=None,
                         perm=None, inv_perm=None, pos=None):
    """Plain version of K2 (the JAX `schedule_cycle` entry point, plus the
    `perm`/`inv_perm` and `pos` rotation modes its burst scans use)."""
    dev = nodes["valid"].device
    pod = {k: _t(v, dev) for k, v in pod.items()}
    if wtab is not None:
        wtab = _t(wtab, dev, I64)
    return _cycle_core_plain(nodes, pod, last_index, last_node_index,
                             num_to_find, n_real, weights or DEFAULT_WEIGHTS,
                             z_pad, perm=perm, inv_perm=inv_perm, pos=pos,
                             wtab=wtab)


# pod scalar slots of K2's packed int64 input (csrc/schedule_cycle.cu)
_CYCLE_SCALARS = ("req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem",
                  "has_request", "check_resources", "unknown_scalar", "skip",
                  "profile_id")
# per-node pod fields of K2, in argument order; None/inert -> NULL pointer
_CYCLE_MASKS = ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
                "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok")
_CYCLE_COUNTS = ("node_aff_counts", "taint_counts", "spread_counts",
                 "interpod_counts", "image_sums", "prefer_avoid")


def _pack_scalars(vals: list, dev) -> torch.Tensor:
    """One int64 vector of per-call scalars, one host-to-device copy."""
    return torch.tensor([int(np.asarray(_host(v))) for v in vals],
                        dtype=I64).to(dev)


def _schedule_cycle_launch(nodes, pod, last_index, last_node_index,
                           num_to_find, n_real, z_pad, weights, wtab,
                           perm, inv_perm, pos):
    dev = nodes["valid"].device
    n_pad = int(nodes["valid"].shape[0])
    s_count = int(nodes["alloc_scalar"].shape[1])
    fields = [nodes[k] for k in ("valid", "alloc_cpu", "alloc_mem",
                                 "alloc_eph", "allowed_pods", "req_cpu",
                                 "req_mem", "req_eph", "nz_cpu", "nz_mem",
                                 "pod_count", "alloc_scalar", "req_scalar",
                                 "zone_id")]
    _require_cuda("schedule_cycle", *fields)
    if nodes["zone_id"].dtype != I32 or nodes["valid"].dtype != torch.bool:
        raise ValueError("schedule_cycle: zone_id must be int32, valid bool")
    pid = pod.get("profile_id", 0)
    scal = _pack_scalars([pod[k] for k in _CYCLE_SCALARS[:-1]] + [pid], dev)
    req_scalar = _t(pod["req_scalar"], dev, I64).contiguous()
    if req_scalar.numel() != s_count:
        raise ValueError("schedule_cycle: req_scalar width != node scalars")

    def dense(key, dtype):
        v = pod.get(key)
        if v is None or _inert(v):
            return None
        v = _t(v, dev, dtype).contiguous()
        if v.shape[-1] != n_pad:
            raise ValueError(f"schedule_cycle: {key} is not [n_pad]")
        return v
    masks = [dense(k, torch.bool) for k in _CYCLE_MASKS]
    code = dense("interpod_code", torch.int8)
    counts = [dense(k, I64) for k in _CYCLE_COUNTS]
    tracked = dense("interpod_tracked", torch.bool)
    # interpod runs unless BOTH of its fields are inert; an inert side
    # broadcasts its single element
    ic_inert = counts[3] is None
    tr_inert = tracked is None
    ipa_on = not (ic_inert and tr_inert)
    ic_b = _t(pod["interpod_counts"], dev, I64).reshape(-1)[:1] \
        if ic_inert else None
    tr_b = _t(pod["interpod_tracked"], dev, torch.bool).reshape(-1)[:1] \
        if tr_inert else None
    if ipa_on:
        if ic_inert:
            counts[3] = ic_b
        if tr_inert:
            tracked = tr_b
    if wtab is not None:
        wtab = _t(wtab, dev, I64)
        wrow = _row_at(wtab, pid)
    else:
        wrow = None
    w = _weight_row(weights, wrow, dev)
    mode = 0
    if pos is not None:
        mode = 2
        pos = _t(pos, dev, I32).contiguous()
    elif perm is not None:
        mode = 1
        perm = _t(perm, dev, I32).contiguous()
        inv_perm = _t(inv_perm, dev, I32).contiguous()
    # K1 first: the row-local resource families over every node
    base = _local_total_launch(weights, nodes["nz_cpu"], nodes["nz_mem"],
                               nodes["alloc_cpu"], nodes["alloc_mem"], wrow,
                               add_cpu=int(np.asarray(_host(pod["nz_cpu"]))),
                               add_mem=int(np.asarray(_host(pod["nz_mem"]))))
    total = torch.empty(n_pad, dtype=I64, device=dev)
    kept = torch.empty(n_pad, dtype=torch.bool, device=dev)
    feasible = torch.empty(n_pad, dtype=torch.bool, device=dev)
    fail_first = torch.empty(n_pad, dtype=torch.int8, device=dev)
    general_bits = torch.empty(n_pad, dtype=I64, device=dev)
    scratch = torch.empty(2 * n_pad, dtype=I32, device=dev)
    zscratch = torch.empty(2 * int(z_pad), dtype=I64, device=dev)
    out = torch.empty(6, dtype=I64, device=dev)
    lib = _build.load("schedule_cycle")
    tensors = fields + masks + [code] + counts + [tracked]
    ptrs = (ctypes.c_void_p * len(tensors))(*[_ptr(t) for t in tensors])
    obs.inc("launch.schedule_cycle")
    _check(lib.schedule_cycle_launch(
        n_pad, s_count, int(n_real), int(z_pad), int(last_index),
        int(last_node_index), int(num_to_find), mode,
        int(ipa_on), int(ic_inert), int(tr_inert), ptrs,
        _ptr(scal), _ptr(req_scalar), _gate(weights), _ptr(w), _ptr(base),
        _ptr(perm), _ptr(inv_perm), _ptr(pos),
        _ptr(total), _ptr(kept), _ptr(feasible), _ptr(fail_first),
        _ptr(general_bits), _ptr(scratch), _ptr(zscratch), _ptr(out),
        _stream()), "schedule_cycle")
    return {
        "selected": out[0], "found": out[1], "evaluated": out[2],
        "max_score": out[3], "total": total, "kept": kept,
        "feasible": feasible, "fail_first": fail_first,
        "general_bits": general_bits, "next_last_index": out[4],
        "next_last_node_index": out[5],
    }


def schedule_cycle(nodes, pod, last_index, last_node_index, num_to_find,
                   n_real, z_pad, weights=None, wtab=None, perm=None,
                   inv_perm=None, pos=None):
    """K2: one scheduling cycle. `nodes` is the dict of node tensors, `pod`
    the dict of pod fields (inert per-node fields are shape [1]); the
    output dict has the JAX entry point's keys. `perm`/`inv_perm` select
    the rotated walk and `pos` the gather-free full-scan mode. `wtab` is
    the [P, K] weight table, `pod["profile_id"]` picks its row."""
    weights = weights or DEFAULT_WEIGHTS
    if not nodes["valid"].is_cuda:
        return schedule_cycle_plain(nodes, pod, last_index, last_node_index,
                                    num_to_find, n_real, z_pad,
                                    weights=weights, wtab=wtab, perm=perm,
                                    inv_perm=inv_perm, pos=pos)
    return _schedule_cycle_launch(nodes, pod, last_index, last_node_index,
                                  num_to_find, n_real, z_pad, weights, wtab,
                                  perm, inv_perm, pos)


# ---------------------------------------------------------------------------
# K3 uniform_burst — the spec-identical K-batch burst (the main path)
# ---------------------------------------------------------------------------
def _uniform_flags(cls, check_resources):
    """Static flags of a uniform class (the JAX entry point's cache key
    work): which fold rows are carried and which families are static."""
    has_req = bool(cls["has_request"])
    req_scalar = np.asarray(cls["req_scalar"]).reshape(-1)
    upd_scalar = np.asarray(cls["upd_scalar"]).reshape(-1)
    carry_eph = bool(int(cls["upd_eph"]) != 0)
    static_eph = bool(not carry_eph and int(cls["req_eph"]) != 0)
    carried_s = tuple(int(s) for s in range(len(req_scalar))
                      if upd_scalar[s] != 0)
    static_s = tuple(int(s) for s in range(len(req_scalar))
                     if req_scalar[s] != 0 and upd_scalar[s] == 0)
    return (bool(check_resources), has_req, carry_eph, static_eph,
            carried_s, static_s)


def _uniform_core_plain(nodes, cls, n_pods, last_node_index, n_real, perm,
                        oid_seq, extra_ok, weights, flags, b_cap, k_batch,
                        rotate, ban, has_extra, wrow=None):
    """`_uniform_core` (kernels.py:1097) in PyTorch: a host while loop over
    O(N) passes, each resolving up to `k_batch` pods (STAY/ELIM modes with
    prefix validation). Mirrors the JAX program op for op, scratch column
    and index clamps included."""
    check_res, has_req, carry_eph, static_eph, carried_s, static_s = flags
    dev = nodes["valid"].device
    n_pad = nodes["valid"].shape[0]
    in_range = torch.arange(n_pad, device=dev) < int(n_real)
    ok = nodes["valid"] & in_range
    if has_extra:
        ok = ok & extra_ok
    if check_res and has_req:
        if static_eph:
            ok = ok & ~(nodes["alloc_eph"] < cls["req_eph"] + nodes["req_eph"])
        for s in static_s:
            ok = ok & ~(nodes["alloc_scalar"][:, s]
                        < cls["req_scalar"][s] + nodes["req_scalar"][:, s])

    def pad1(v):
        return torch.cat([v, torch.zeros(1, dtype=v.dtype, device=dev)])
    ok = pad1(ok)
    alloc_cpu = pad1(nodes["alloc_cpu"])
    alloc_mem = pad1(nodes["alloc_mem"])
    allowed = pad1(nodes["allowed_pods"])
    alloc_eph = pad1(nodes["alloc_eph"])

    rows = [nodes["req_cpu"], nodes["req_mem"], nodes["nz_cpu"],
            nodes["nz_mem"], nodes["pod_count"]]
    delta = [cls["upd_cpu"], cls["upd_mem"], cls["nz_cpu"], cls["nz_mem"], 1]
    ieph = None
    if carry_eph:
        ieph = len(rows)
        rows.append(nodes["req_eph"])
        delta.append(cls["upd_eph"])
    isc0 = len(rows)
    alloc_sc = []
    for s in carried_s:
        rows.append(nodes["req_scalar"][:, s])
        delta.append(cls["upd_scalar"][s])
        alloc_sc.append(pad1(nodes["alloc_scalar"][:, s]))
    st = torch.stack([pad1(r) for r in rows])
    delta_vec = torch.tensor([int(d) for d in delta], dtype=I64, device=dev)
    n1 = n_pad + 1

    def clamp_idx(idx):
        # JAX clamps out-of-range gathers to the last element
        return torch.clamp(idx.long(), 0, n1 - 1)

    tot = local_total_plain(weights, cls["nz_cpu"] + st[2],
                            cls["nz_mem"] + st[3], alloc_cpu, alloc_mem,
                            wrow=wrow).to(I32)
    jlane = torch.arange(k_batch, dtype=I64, device=dev)
    B = int(n_pods)

    def resource_fit(rowvals, idx):
        fit = ok[idx] if idx is not None else ok
        a_cpu = alloc_cpu[idx] if idx is not None else alloc_cpu
        a_mem = alloc_mem[idx] if idx is not None else alloc_mem
        a_pods = allowed[idx] if idx is not None else allowed
        if check_res:
            fit = fit & (rowvals[4] + 1 <= a_pods)
            if has_req:
                fit = fit & (a_cpu >= cls["req_cpu"] + rowvals[0]) \
                    & (a_mem >= cls["req_mem"] + rowvals[1])
                if carry_eph:
                    a_eph = alloc_eph[idx] if idx is not None else alloc_eph
                    fit = fit & (a_eph >= cls["req_eph"] + rowvals[ieph])
                for jj, s in enumerate(carried_s):
                    a_s = alloc_sc[jj][idx] if idx is not None \
                        else alloc_sc[jj]
                    fit = fit & (a_s >= cls["req_scalar"][s]
                                 + rowvals[isc0 + jj])
        return fit

    def lane_fit(rowvals, idx):
        nt = local_total_plain(
            weights, cls["nz_cpu"] + rowvals[2], cls["nz_mem"] + rowvals[3],
            alloc_cpu[idx], alloc_mem[idx], wrow=wrow).to(I32)
        return nt, resource_fit(rowvals, idx)

    def slice_clamped(seq, start, size):
        # jax.lax.dynamic_slice clamps the start so the window fits
        start = min(max(start, 0), max(seq.shape[0] - size, 0))
        return seq[start: start + size]

    out = torch.full((b_cap + k_batch,), -1, dtype=I32, device=dev)
    lni0 = int(last_node_index)
    lni = lni0
    banned = torch.zeros(n1, dtype=torch.bool, device=dev)
    done = 0
    if rotate:
        perm = perm.long()
    while done < B:
        feas = resource_fit(st, None)
        if ban:
            feas = feas & ~banned
        tm = torch.where(feas, tot, I32_MIN)
        mx = int(torch.max(tm))
        tie = feas & (tm == mx)
        T = int(torch.sum(tie.to(I64)))
        F = int(torch.sum(feas.to(I64)))
        remaining = B - done
        kbig = (T >= 2) and (F > 1)
        if rotate:
            oid = slice_clamped(oid_seq, done, k_batch).long()
            tie_perm = tie[perm]
            C_all = torch.cumsum(tie_perm.to(I64), 1)
        else:
            C = torch.cumsum(tie.to(I64), 0)

        if ban:
            elim = kbig
        else:
            pos0 = lni % max(T, 1)
            if rotate:
                c0 = C_all[oid[0]]
                p0 = int(torch.sum((c0 < pos0 + 1).to(I64)))
                sel0 = perm[oid[0], min(p0, n_pad)]
            else:
                sel0 = torch.searchsorted(
                    C, torch.tensor([pos0 + 1], dtype=I64, device=dev))[0]
            sel0 = clamp_idx(sel0)
            nt0, fit0 = lane_fit(st[:, sel0] + delta_vec, sel0)
            elim = bool((int(nt0) != mx) or not bool(fit0)) and kbig

        m_stay = min(remaining, k_batch, T)
        max_elim = max(_wrap32((T - lni + 1) // 2), 1)
        m_elim = min(min(remaining, k_batch), min(max_elim, max(F - 1, 1)))
        if rotate:
            same = torch.cumprod((oid == oid[0]).to(I64), 0)
            m_elim = min(m_elim, max(int(torch.sum(same)), 1))
        if F == 0:
            m = min(remaining, k_batch)
        elif elim:
            m = m_elim
        elif kbig:
            m = m_stay
        else:
            m = 1
        active = (jlane < m) & (F > 0)
        pos_stay = (lni + jlane) % max(T, 1)
        pos_elim = torch.clamp(lni + 2 * jlane, max=max(T - 1, 0))
        pos = pos_elim if (elim and m > 1) else pos_stay
        if not rotate:
            selq = torch.searchsorted(C, pos + 1)
            sel = torch.where(active, selq, n_pad)
        else:
            crows = C_all[oid]
            posp = torch.sum((crows < (pos + 1)[:, None]).to(I64), dim=1)
            selq = perm[oid, torch.clamp(posp, max=n_pad)]
            sel = torch.where(active, selq, n_pad)
        sel = clamp_idx(sel)
        rows_after = st[:, sel] + delta_vec[:, None]
        new_tot, fit_after = lane_fit(rows_after, sel)
        leaves = torch.ones_like(fit_after) if ban \
            else ((new_tot != mx) | ~fit_after)
        fail = (~leaves if elim else leaves) & active
        first_bad = int(_first_true(fail)) if bool(torch.any(fail)) \
            else k_batch
        v = m if F == 0 else min(first_bad + 1, m)
        if rotate:
            owner = torch.full((n1,), k_batch, dtype=I64, device=dev)
            owner.scatter_reduce_(0, sel, torch.where(active, jlane, k_batch),
                                  reduce="amin")
            dup = active & (owner[sel] != jlane)
            first_dup = int(_first_true(dup)) if bool(torch.any(dup)) \
                else k_batch
            v = min(v, first_dup)
            v = m if F == 0 else max(v, 1)
        accept = active & (jlane < v)
        st = st.index_add(1, sel, torch.where(accept[None, :],
                                              delta_vec[:, None], 0))
        selw = torch.where(accept, sel, n_pad)
        # accepted lanes name distinct nodes; parked lanes all write the
        # scratch column, whose value nothing reads
        tot = tot.clone()
        tot[selw] = new_tot
        if ban:
            banned = banned.clone()
            banned[selw] = banned[selw] | accept
        emit = torch.where((jlane < v) & (F > 0), sel, -1).to(I32)
        out[done: done + k_batch] = emit
        lni = lni + (v if F > 1 else 0)
        done = done + v

    out[b_cap] = lni - lni0
    unpad = lambda v: v[:n_pad]  # noqa: E731
    out_rows = {"req_cpu": unpad(st[0]), "req_mem": unpad(st[1]),
                "nz_cpu": unpad(st[2]), "nz_mem": unpad(st[3]),
                "pod_count": unpad(st[4])}
    if carry_eph:
        out_rows["req_eph"] = unpad(st[ieph])
    if carried_s:
        rs = nodes["req_scalar"].clone()
        for jj, s in enumerate(carried_s):
            rs[:, s] = unpad(st[isc0 + jj])
        out_rows["req_scalar"] = rs
    return out_rows, out[: b_cap + 1], torch.tensor(lni, dtype=I64,
                                                    device=dev)


def _uniform_args(nodes, cls, n_pods, cap, rotation, extra_ok, wtab, pid,
                  check_resources):
    cap = B_CAP if cap is None else int(cap)
    if n_pods > cap:
        raise ValueError(f"uniform burst of {n_pods} exceeds cap={cap}")
    dev = nodes["valid"].device
    flags = _uniform_flags(cls, check_resources)
    wrow = None
    if wtab is not None:
        wtab = _t(wtab, dev, I64)
        wrow = _row_at(wtab, pid)
    if rotation is None:
        perm = oid_seq = None
    else:
        perm = _t(rotation[0], dev, I32).contiguous()
        oid_seq = _t(rotation[1], dev, I32).contiguous()
    extra = None if extra_ok is None else _t(extra_ok, dev, torch.bool)
    return cap, flags, wrow, perm, oid_seq, extra


def schedule_batch_uniform_plain(nodes, cls, n_pods, last_node_index, n_real,
                                 check_resources, weights=None, rotation=None,
                                 extra_ok=None, ban=False, cap=None,
                                 wtab=None, pid=0):
    """Plain version of K3, the JAX entry point's signature and outputs:
    (folded_state_rows, packed[cap+1] int32, lni tensor)."""
    weights = weights or DEFAULT_WEIGHTS
    cap, flags, wrow, perm, oid_seq, extra = _uniform_args(
        nodes, cls, n_pods, cap, rotation, extra_ok, wtab, pid,
        check_resources)
    dev = nodes["valid"].device
    cls_t = {k: _t(v, dev, I64) for k, v in cls.items() if k != "has_request"}
    return _uniform_core_plain(
        nodes, cls_t, n_pods, int(_host(last_node_index)), n_real, perm,
        oid_seq, extra, weights, flags, cap, K_BATCH, rotation is not None,
        bool(ban), extra is not None, wrow=wrow)


def _uniform_launch(nodes, cls, n_pods, last_node_index, n_real,
                    check_resources, weights, rotation, extra_ok, ban, cap,
                    wtab, pid):
    cap, flags, wrow, perm, oid_seq, extra = _uniform_args(
        nodes, cls, n_pods, cap, rotation, extra_ok, wtab, pid,
        check_resources)
    check_res, has_req, carry_eph, static_eph, carried_s, static_s = flags
    dev = nodes["valid"].device
    n_pad = int(nodes["valid"].shape[0])
    _require_cuda("uniform_burst", nodes["valid"], nodes["alloc_cpu"],
                  nodes["alloc_mem"], nodes["allowed_pods"], perm, oid_seq,
                  extra)
    # the carried fold rows, stacked [R, n_pad] (a fresh copy: the kernel
    # folds into it, the resident matrix stays as it was)
    rows = [nodes["req_cpu"], nodes["req_mem"], nodes["nz_cpu"],
            nodes["nz_mem"], nodes["pod_count"]]
    xalloc, xreq, delta = [], [], [int(cls["upd_cpu"]), int(cls["upd_mem"]),
                                   int(cls["nz_cpu"]), int(cls["nz_mem"]), 1]
    if carry_eph:
        rows.append(nodes["req_eph"])
        xalloc.append(nodes["alloc_eph"])
        xreq.append(int(cls["req_eph"]))
        delta.append(int(cls["upd_eph"]))
    req_scalar = np.asarray(cls["req_scalar"]).reshape(-1)
    upd_scalar = np.asarray(cls["upd_scalar"]).reshape(-1)
    for s in carried_s:
        rows.append(nodes["req_scalar"][:, s])
        xalloc.append(nodes["alloc_scalar"][:, s])
        xreq.append(int(req_scalar[s]))
        delta.append(int(upd_scalar[s]))
    st = torch.stack(rows).contiguous()
    R = st.shape[0]
    xa = torch.stack(xalloc).contiguous() if xalloc else None
    # resource families that cannot change in-burst: static (alloc, used,
    # request) rows merged into the feasibility mask at kernel start
    salloc, sused, sreq = [], [], []
    if check_res and has_req:
        if static_eph:
            salloc.append(nodes["alloc_eph"])
            sused.append(nodes["req_eph"])
            sreq.append(int(cls["req_eph"]))
        for s in static_s:
            salloc.append(nodes["alloc_scalar"][:, s])
            sused.append(nodes["req_scalar"][:, s])
            sreq.append(int(req_scalar[s]))
    sa = torch.stack(salloc).contiguous() if salloc else None
    su = torch.stack(sused).contiguous() if sused else None
    clsv = torch.tensor(
        [int(cls["req_cpu"]), int(cls["req_mem"]), int(cls["nz_cpu"]),
         int(cls["nz_mem"])] + delta + xreq + sreq, dtype=I64).to(dev)
    L = 0 if perm is None else int(perm.shape[0])
    if perm is not None and perm.shape[1] != n_pad + 1:
        raise ValueError("uniform_burst: perm rows must be n_pad+1 wide")
    n_oid = 0 if oid_seq is None else int(oid_seq.shape[0])
    if oid_seq is not None and n_oid < K_BATCH:
        raise ValueError("uniform_burst: oid_seq shorter than K_BATCH")
    # K1 first: the pass-start scores of every node
    tot0 = _local_total_launch(weights, nodes["nz_cpu"], nodes["nz_mem"],
                               nodes["alloc_cpu"], nodes["alloc_mem"], wrow,
                               add_cpu=int(cls["nz_cpu"]),
                               add_mem=int(cls["nz_mem"]))
    w = _weight_row(weights, wrow, dev)
    lni_in = _t(last_node_index, dev, I64).reshape(1).contiguous()
    out = torch.empty(cap + K_BATCH, dtype=I32, device=dev)
    lni_out = torch.empty(1, dtype=I64, device=dev)
    # scratch: tot[n], ok/banned/feasible[n] bytes, tie lists [max(L,1), n_pad],
    # owner[n_pad+1]
    tot = torch.empty(n_pad, dtype=I32, device=dev)
    flags_b = torch.empty(3 * n_pad, dtype=torch.uint8, device=dev)
    ties = torch.empty(max(L, 1) * n_pad, dtype=I32, device=dev)
    owner = torch.empty(n_pad + 1, dtype=I32, device=dev)
    lib = _build.load("uniform_burst")
    obs.inc("launch.uniform_burst")
    _check(lib.uniform_burst_launch(
        n_pad, int(n_real), int(n_pods), cap, K_BATCH, R,
        len(salloc), int(check_res), int(has_req), L, n_oid, int(bool(ban)),
        _gate(weights), _ptr(w),
        _ptr(nodes["valid"]), _ptr(extra), _ptr(nodes["alloc_cpu"]),
        _ptr(nodes["alloc_mem"]), _ptr(nodes["allowed_pods"]), _ptr(xa),
        _ptr(sa), _ptr(su), _ptr(clsv), _ptr(st), _ptr(tot0), _ptr(perm),
        _ptr(oid_seq), _ptr(lni_in), _ptr(out), _ptr(lni_out), _ptr(tot),
        _ptr(flags_b), _ptr(ties), _ptr(owner), _stream()), "uniform_burst")
    out_rows = {"req_cpu": st[0], "req_mem": st[1], "nz_cpu": st[2],
                "nz_mem": st[3], "pod_count": st[4]}
    r = 5
    if carry_eph:
        out_rows["req_eph"] = st[r]
        r += 1
    if carried_s:
        rs = nodes["req_scalar"].clone()
        for jj, s in enumerate(carried_s):
            rs[:, s] = st[r + jj]
        out_rows["req_scalar"] = rs
    return out_rows, out[: cap + 1], lni_out[0]


def schedule_batch_uniform(nodes, cls, n_pods, last_node_index, n_real,
                           check_resources, weights=None, rotation=None,
                           extra_ok=None, ban=False, cap=None, wtab=None,
                           pid=0):
    """K3: the uniform-class burst. `cls` holds the shared per-pod scalars
    (req_cpu/req_mem/req_eph, req_scalar[S], nz_cpu/nz_mem, upd_cpu/
    upd_mem/upd_eph, upd_scalar[S], has_request). Returns (folded_state_
    rows, packed[cap+1] int32, lni) where packed[:n_pods] are node indices
    (-1 = unschedulable) and packed[cap] the lastNodeIndex advance — one
    array, one device-to-host copy. `rotation` = (perm[L, n_pad+1] int32,
    oid_seq[cap + K_BATCH] int32) when per-cycle enumerations rotate;
    `extra_ok` [n_pad] bool merges burst-static masks; `ban` makes each
    placement ban its own node."""
    weights = weights or DEFAULT_WEIGHTS
    if not nodes["valid"].is_cuda:
        return schedule_batch_uniform_plain(
            nodes, cls, n_pods, last_node_index, n_real, check_resources,
            weights=weights, rotation=rotation, extra_ok=extra_ok, ban=ban,
            cap=cap, wtab=wtab, pid=pid)
    return _uniform_launch(nodes, cls, n_pods, last_node_index, n_real,
                           check_resources, weights, rotation, extra_ok, ban,
                           cap, wtab, pid)


# ---------------------------------------------------------------------------
# K4 scatter_rows — dirty-row upload into the resident node matrix
# ---------------------------------------------------------------------------
def scatter_rows_plain(dev: dict, rows, upd: dict) -> dict:
    """Write rows `rows` of every field in `upd` into `dev` in place (the
    JAX twin returns a new dict; the port keeps one resident matrix and
    saves the copy). Duplicate rows carry identical values. Index rules
    are JAX's: a negative row wraps once, a row still outside [0, n) is
    dropped."""
    rows = torch.as_tensor(rows).long()
    for k, v in upd.items():
        dst = dev[k]
        n = dst.shape[0]
        r = torch.where(rows < 0, rows + n, rows).to(dst.device)
        keep = (r >= 0) & (r < n)
        dst[r[keep]] = _t(v, dst.device, dst.dtype)[keep]
    return dev


def _scatter_launch(dev: dict, rows, upd: dict) -> dict:
    keys = list(upd)
    dsts = [dev[k] for k in keys]
    device = dsts[0].device
    rows_t = _t(rows, device, I32).contiguous()
    srcs = [_t(upd[k], device, dev[k].dtype).contiguous() for k in keys]
    _require_cuda("scatter_rows", *dsts)
    n_rows = int(rows_t.shape[0])
    meta = []
    for d, s in zip(dsts, srcs):
        width = 1 if d.dim() == 1 else int(d.shape[1])
        if s.shape[0] != n_rows or s.numel() != n_rows * width:
            raise ValueError("scatter_rows: update shape mismatch")
        meta += [d.data_ptr(), s.data_ptr(), int(d.shape[0]), width,
                 d.element_size()]
    meta_t = torch.tensor(meta, dtype=I64).to(device)
    total = sum(n_rows * m for m in meta[3::5])
    lib = _build.load("scatter_rows")
    obs.inc("launch.scatter_rows")
    _check(lib.scatter_rows_launch(
        len(keys), n_rows, total, _ptr(rows_t), _ptr(meta_t), _stream()),
        "scatter_rows")
    return dev


def scatter_rows(dev: dict, rows, upd: dict) -> dict:
    """K4: write the dirty rows of every field in one launch (in place;
    returns `dev`)."""
    if not next(iter(dev.values())).is_cuda:
        return scatter_rows_plain(dev, rows, upd)
    return _scatter_launch(dev, rows, upd)


# ---------------------------------------------------------------------------
# K5 schedule_batch / K6 schedule_segments — the generic burst scans
# ---------------------------------------------------------------------------
#: node-state rows a placement folds into (`_MUTABLE`, kernels.py:531)
_MUTABLE = ("req_cpu", "req_mem", "req_eph", "req_scalar",
            "nz_cpu", "nz_mem", "pod_count")
#: per-row scalar slots of the scan kernels' [U, 13] pod table: K2's
#: scalars (slot 9, K2's profile id, unused: ids are per pod) plus the
#: fold deltas
_SCAN_SCALARS = _CYCLE_SCALARS + ("upd_cpu", "upd_mem", "upd_eph")
_NODE_STATIC = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
                "allowed_pods", "alloc_scalar", "zone_id")


class PodStack:
    """A window of B pods for the scan kernels, stored as the host builds
    it: `table[k]` holds one row per distinct pod spec (`[U]` scalars,
    `[U, S]` scalar vectors, `[U, W]` per-node fields), `row[b]` (host
    int64) is pod b's table row and `profile_id[b]` its weight-table row
    (None off the weight-table path).

    A per-node field has W = n_pad when any spec of the window has it
    dense and W = 1 when every spec leaves it inert: inertness is decided
    per field per window, exactly as the JAX package's [B, ...] stack
    decides it (`_stack_pods`), while memory and upload stay O(U x n_pad)
    instead of O(B x n_pad)."""

    def __init__(self, table: dict, row, profile_id=None):
        self.table = table
        self.row = np.asarray(row, dtype=np.int64)
        self.profile_id = None if profile_id is None \
            else np.asarray(profile_id, dtype=np.int64)

    @classmethod
    def from_dense(cls, pods: dict, device) -> "PodStack":
        """The JAX layout (a dict of [B, ...] arrays, `profile_id` [B]
        optional) as a stack with one table row per pod."""
        pods = dict(pods)
        prof = pods.pop("profile_id", None)
        table = {k: _t(v, device) for k, v in pods.items()}
        b = int(table["skip"].shape[0])
        return cls(table, np.arange(b),
                   None if prof is None else np.asarray(_host(prof)))

    @classmethod
    def from_specs(cls, specs: list, row, profile_id, device) -> "PodStack":
        """One host dict per distinct spec (the `_pod_arrays` output) and
        each pod's spec row. A field that is [1] for some specs and
        [n_pad] for others is broadcast up, as `_stack_pods` does."""
        table = {}
        for k in specs[0]:
            vals = [np.asarray(d[k]) for d in specs]
            shapes = {v.shape for v in vals}
            if len(shapes) > 1:
                target = max(shapes)
                vals = [np.broadcast_to(v, target) for v in vals]
            table[k] = torch.as_tensor(np.stack(vals)).to(device)
        return cls(table, row, profile_id)

    def __len__(self) -> int:
        return len(self.row)

    def pod(self, b: int) -> dict:
        """Pod b's fields (the JAX scan's per-step slice)."""
        r = int(self.row[b])
        p = {k: v[r] for k, v in self.table.items()}
        if self.profile_id is not None:
            p["profile_id"] = np.int64(self.profile_id[b])
        return p


def _fold_state_plain(state: dict, pod: dict, sel: int) -> None:
    """Fold one placement's delta into the mutable rows, in place
    (`_fold_state`, kernels.py:549). JAX adds a zero at row max(sel, 0)
    on a miss; the callers fold only hits."""
    state["req_cpu"][sel] += pod["upd_cpu"]
    state["req_mem"][sel] += pod["upd_mem"]
    state["req_eph"][sel] += pod["upd_eph"]
    state["req_scalar"][sel] += pod["upd_scalar"]
    state["nz_cpu"][sel] += pod["nz_cpu"]
    state["nz_mem"][sel] += pod["nz_mem"]
    state["pod_count"][sel] += 1


def _scan_setup(nodes, pods, rotation, rotation_pos, spread0, carry_in,
                wtab):
    """Inputs shared by K5/K6 and their plain versions: the pod stack, the
    rotation mode (0 axis order, 1 perm/inv_perm, 2 positions), the
    carried rows and spread vector, the weight table."""
    dev = nodes["valid"].device
    stack = pods if isinstance(pods, PodStack) \
        else PodStack.from_dense(pods, dev)
    perms = inv_perms = oid_seq = None
    mode = 0
    if rotation_pos is not None:
        if rotation is not None:
            raise ValueError("rotation and rotation_pos are exclusive")
        mode = 2
        perms = _t(rotation_pos[0], dev, I32).contiguous()
        oid_seq = np.asarray(_host(rotation_pos[1]), dtype=np.int64)
    elif rotation is not None:
        mode = 1
        perms = _t(rotation[0], dev, I32).contiguous()
        inv_perms = _t(rotation[1], dev, I32).contiguous()
        oid_seq = np.asarray(_host(rotation[2]), dtype=np.int64)
    carry_spread = spread0 is not None or (
        carry_in is not None and carry_in[1] is not None)
    if carry_in is not None:
        mut0, s0 = carry_in
    else:
        mut0, s0 = {k: nodes[k] for k in _MUTABLE}, spread0
    s0 = _t(s0, dev, I64) if carry_spread else None
    if wtab is not None:
        wtab = _t(wtab, dev, I64)
    return stack, mode, perms, inv_perms, oid_seq, carry_spread, mut0, s0, \
        wtab


def _rotation_at(mode, perms, inv_perms, oid_seq, k):
    """(perm, inv_perm, pos) of the k-th consumed enumeration."""
    if mode == 0:
        return None, None, None
    oid = oid_seq[min(max(k, 0), len(oid_seq) - 1)]
    if mode == 2:
        return None, None, _row_at(perms, oid)
    return _row_at(perms, oid), _row_at(inv_perms, oid), None


def _skip_cycle(li: int, lni: int, n_real: int) -> dict:
    """The cycle of a pod that consumes nothing (bucket padding, a member
    behind its gang's failure): no node is feasible, so JAX's cycle gives
    sel -1, found/evaluated/max_score 0, li reduced mod n, lni unchanged.
    The scans take this without running the O(N) cycle."""
    return {"selected": -1, "found": 0, "evaluated": 0, "max_score": 0,
            "next_last_index": li % max(n_real, 1),
            "next_last_node_index": lni}


def _batch_core_plain(nodes, stack, mut0, s0, last_index, last_node_index,
                      num_to_find, n_real, mode, perms, inv_perms, oid_seq,
                      carry_spread, z_pad, weights, wtab):
    """`_batch_core` (kernels.py:569): the scan over the window's pods, one
    K2 cycle each, each hit folded before the next pod's cycle."""
    dev = nodes["valid"].device
    static = {k: v for k, v in nodes.items() if k not in _MUTABLE}
    state = {k: mut0[k].clone() for k in _MUTABLE}
    spread = s0.clone() if carry_spread else None
    li, lni = int(last_index), int(last_node_index)
    lni0 = lni
    B = len(stack)
    cols = {k: [] for k in ("selected", "found", "evaluated", "max_score",
                            "li_after", "lni_after")}
    for b in range(B):
        pod = stack.pod(b)
        perm, inv_perm, pos = _rotation_at(mode, perms, inv_perms, oid_seq,
                                           b)
        if carry_spread:
            pod["spread_counts"] = spread
        if bool(pod["skip"]):
            out = _skip_cycle(li, lni, n_real)
        else:
            out = _cycle_core_plain({**static, **state}, pod, li, lni,
                                    num_to_find, n_real, weights, z_pad,
                                    perm=perm, inv_perm=inv_perm, pos=pos,
                                    wtab=wtab)
        sel, found = int(out["selected"]), int(out["found"])
        if found > 0:
            _fold_state_plain(state, pod, sel)
            if carry_spread and not bool(pod["skip"]):
                spread[sel] += 1
        li = int(out["next_last_index"])
        lni = int(out["next_last_node_index"])
        cols["selected"].append(sel)
        cols["found"].append(found)
        cols["evaluated"].append(int(out["evaluated"]))
        cols["max_score"].append(int(out["max_score"]))
        cols["li_after"].append(li)
        cols["lni_after"].append(lni)
    outs = {k: torch.tensor(v, dtype=I32 if k == "li_after" else I64,
                            device=dev) for k, v in cols.items()}
    outs["packed"] = torch.tensor(
        cols["selected"] + cols["li_after"]
        + [_wrap32(x - lni0) for x in cols["lni_after"]],
        dtype=I32, device=dev)
    spread_out = spread if carry_spread else torch.zeros((), dtype=I64,
                                                         device=dev)
    return (state, torch.tensor(li, dtype=I64, device=dev),
            torch.tensor(lni, dtype=I64, device=dev), spread_out, outs)


def schedule_batch_plain(nodes, pods, last_index, last_node_index,
                         num_to_find, n_real, z_pad, weights=None,
                         rotation=None, spread0=None, rotation_pos=None,
                         carry_in=None, wtab=None):
    """Plain version of K5, the JAX `schedule_batch` entry point (kernels.py
    :668, `mesh=` left out): (state, li, lni, spread, outs) with
    outs["packed"] the [3B] int32 block selected | li after each pod |
    lni delta after each pod."""
    stack, mode, perms, inv_perms, oid_seq, carry_spread, mut0, s0, wtab = \
        _scan_setup(nodes, pods, rotation, rotation_pos, spread0, carry_in,
                    wtab)
    return _batch_core_plain(
        nodes, stack, mut0, s0, _host(last_index), _host(last_node_index),
        int(num_to_find), int(n_real), mode, perms, inv_perms, oid_seq,
        carry_spread, z_pad, weights or DEFAULT_WEIGHTS, wtab)


def _segments_core_plain(nodes, stack, seg_start, gang, n_pods, s0,
                         last_index, last_node_index, num_to_find, n_real,
                         mode, perms, inv_perms, oid_seq, carry_spread,
                         z_pad, weights, wtab, gang_score):
    """`_segments_core` (kernels.py:785): the K5 step over the first
    `n_pods` pods, with a checkpoint of the live carry at every segment
    start and an in-scan rewind when a gang member finds no node."""
    dev = nodes["valid"].device
    static = {k: v for k, v in nodes.items() if k not in _MUTABLE}
    zone_id = static["zone_id"]
    B = len(stack)

    def snapshot(c):
        return {"state": {k: v.clone() for k, v in c["state"].items()},
                "li": c["li"], "lni": c["lni"],
                "spread": None if c["spread"] is None
                else c["spread"].clone(),
                "gz": None if c["gz"] is None else c["gz"].clone()}

    cur = {"state": {k: nodes[k] for k in _MUTABLE},
           "li": int(last_index), "lni": int(last_node_index),
           "spread": s0 if carry_spread else None,
           "gz": torch.zeros(z_pad, dtype=I64, device=dev)
           if gang_score else None}
    cur = snapshot(cur)
    chk = snapshot(cur)
    lni0 = cur["lni"]
    t = chk_t = 0
    failed = False
    out = torch.full((4, B), -1, dtype=I32, device=dev)
    for i in range(int(n_pods)):
        pod = stack.pod(i)
        sflag, gflag = bool(seg_start[i]), bool(gang[i])
        if gang_score and sflag:
            # the gang zone counts reset BEFORE the checkpoint is taken
            cur["gz"] = torch.zeros(z_pad, dtype=I64, device=dev)
        if sflag:
            chk = snapshot(cur)
            chk_t = t
            failed = False
        eskip = bool(pod["skip"]) or (gflag and failed)
        perm, inv_perm, pos = _rotation_at(mode, perms, inv_perms, oid_seq,
                                           t)
        if carry_spread:
            pod["spread_counts"] = cur["spread"]
        if eskip:
            out_c = _skip_cycle(cur["li"], cur["lni"], n_real)
        else:
            out_c = _cycle_core_plain(
                {**static, **cur["state"]}, pod, cur["li"], cur["lni"],
                num_to_find, n_real, weights, z_pad, perm=perm,
                inv_perm=inv_perm, pos=pos, wtab=wtab,
                gang=(cur["gz"], torch.tensor(gflag, device=dev))
                if gang_score else None)
        sel, hit = int(out_c["selected"]), int(out_c["found"]) > 0
        if hit:
            _fold_state_plain(cur["state"], pod, sel)
            if carry_spread and not eskip:
                cur["spread"][sel] += 1
            if gang_score and not eskip and gflag:
                z = int(zone_id[sel])
                if 0 < z < z_pad:
                    cur["gz"][z] += 1
        cur["li"] = int(out_c["next_last_index"])
        cur["lni"] = int(out_c["next_last_node_index"])
        t = t + (0 if eskip else 1)
        fail_now = gflag and not hit and not eskip
        if fail_now:
            # the in-scan gang_rewind: back to the segment checkpoint
            cur = snapshot(chk)
            t = chk_t
        failed = failed or fail_now
        out[:, i] = torch.tensor(
            [sel if (hit and not eskip) else -1, cur["li"],
             _wrap32(cur["lni"] - lni0), t], dtype=I32)
    spread_out = cur["spread"] if carry_spread \
        else torch.zeros((), dtype=I64, device=dev)
    return (cur["state"], torch.tensor(cur["li"], dtype=I64, device=dev),
            torch.tensor(cur["lni"], dtype=I64, device=dev), spread_out,
            out.reshape(4 * B))


def schedule_batch_segments_plain(nodes, pods, seg_start, gang, n_pods,
                                  last_index, last_node_index, num_to_find,
                                  n_real, z_pad, weights=None, rotation=None,
                                  rotation_pos=None, spread0=None, wtab=None,
                                  gang_score=False):
    """Plain version of K6, the JAX `schedule_batch_segments` entry point
    (kernels.py:949, `mesh=` left out): (state, li, lni, spread, packed)
    with packed the [4B] int32 block selected | li_after | lni delta |
    consumed enumerations t, -1 past `n_pods`. The rotation order of a
    cycle is `oid_seq[t]`, t the enumerations consumed so far."""
    stack, mode, perms, inv_perms, oid_seq, carry_spread, _mut0, s0, wtab = \
        _scan_setup(nodes, pods, rotation, rotation_pos, spread0, None, wtab)
    if int(n_pods) > len(stack):
        raise ValueError("n_pods exceeds the stacked window")
    return _segments_core_plain(
        nodes, stack, np.asarray(_host(seg_start), bool),
        np.asarray(_host(gang), bool), int(n_pods), s0,
        _host(last_index), _host(last_node_index), int(num_to_find),
        int(n_real), mode, perms, inv_perms, oid_seq, carry_spread, z_pad,
        weights or DEFAULT_WEIGHTS, wtab, bool(gang_score))


# scalar and pointer slots of the scan kernels' launch (csrc/cycle.cuh
# `ScanArgs`): both lists are copied into the kernel's argument struct
_SCAN_INTS = ("n_pad", "S", "n_real", "z_pad", "B", "num_to_find",
              "last_index", "lni0", "mode", "L", "n_oid", "carry_spread",
              "gate", "P", "ipa_on", "ic_inert", "tr_inert", "n_pods",
              "gang_score", "U")
_SCAN_PTRS = (_NODE_STATIC + _MUTABLE
              + ("scal", "req_scalar_p", "upd_scalar_p") + _CYCLE_MASKS
              + ("interpod_code",) + _CYCLE_COUNTS
              + ("interpod_tracked", "row", "profile_id", "w", "wtab",
                 "perms", "inv_perms", "oid_seq", "spread",
                 "total", "kept", "flags", "zs", "stats", "packed",
                 "carry_out", "seg_start", "gang", "gz", "log_node",
                 "log_row"))


def _scan_launch(name, nodes, stack, last_index, last_node_index,
                 num_to_find, n_real, z_pad, weights, mode, perms, inv_perms,
                 oid_seq, carry_spread, mut0, s0, wtab, n_steps,
                 segments=None, gang_score=False):
    """Launch K5 (`schedule_batch`) or K6 (`schedule_segments`). Returns
    (state, li, lni, spread, stats[5, B] int64, packed int32)."""
    dev = nodes["valid"].device
    n_pad = int(nodes["valid"].shape[0])
    s_count = int(nodes["alloc_scalar"].shape[1])
    B = len(stack)
    tab = stack.table
    static = [nodes[k] for k in _NODE_STATIC]
    _require_cuda(name, *static)
    if nodes["zone_id"].dtype != I32 or nodes["valid"].dtype != torch.bool:
        raise ValueError(f"{name}: zone_id must be int32, valid bool")
    # the folds land in fresh rows: the resident matrix stays as it was
    state = {k: mut0[k].to(I64).clone().contiguous() for k in _MUTABLE}
    spread = s0.clone().contiguous() if carry_spread else None
    U = int(tab["skip"].shape[0])
    scal = torch.stack(
        [tab[k].reshape(U).to(I64) if k != "profile_id"
         else torch.zeros(U, dtype=I64, device=dev)
         for k in _SCAN_SCALARS], dim=1).contiguous()
    req_scalar = tab["req_scalar"].to(I64).reshape(U, s_count).contiguous()
    upd_scalar = tab["upd_scalar"].to(I64).reshape(U, s_count).contiguous()

    def dense(key, dtype):
        v = tab.get(key)
        if v is None or _inert(v):
            return None
        v = v.to(dtype).contiguous()
        if v.shape != (U, n_pad):
            raise ValueError(f"{name}: {key} is not [U, n_pad]")
        return v
    masks = [dense(k, torch.bool) for k in _CYCLE_MASKS]
    code = dense("interpod_code", torch.int8)
    counts = [dense(k, I64) for k in _CYCLE_COUNTS]
    tracked = dense("interpod_tracked", torch.bool)
    ic_inert, tr_inert = counts[3] is None, tracked is None
    ipa_on = not (ic_inert and tr_inert)
    if ipa_on and ic_inert:
        counts[3] = tab["interpod_counts"].to(I64).reshape(U, 1).contiguous()
    if ipa_on and tr_inert:
        tracked = tab["interpod_tracked"].to(torch.bool).reshape(
            U, 1).contiguous()
    if carry_spread:
        counts[2] = None     # the carried vector replaces the field
    row = torch.as_tensor(stack.row.astype(np.int32)).to(dev)
    prof = None
    if wtab is not None:
        pid = stack.profile_id if stack.profile_id is not None \
            else np.zeros(B, np.int64)
        prof = torch.as_tensor(pid).to(dev)
    w = _weight_row(weights, None, dev)
    oid = None if oid_seq is None \
        else torch.as_tensor(oid_seq.astype(np.int32)).to(dev)
    total = torch.empty(n_pad, dtype=I64, device=dev)
    kept = torch.empty(n_pad, dtype=torch.uint8, device=dev)
    flags = torch.empty(2 * n_pad, dtype=I32, device=dev)
    zs = torch.empty(2 * int(z_pad), dtype=I64, device=dev)
    stats = torch.empty((5, B), dtype=I64, device=dev)
    packed = torch.empty((4 if segments else 3) * B, dtype=I32, device=dev)
    carry_out = torch.empty(2, dtype=I64, device=dev)
    seg = {}
    if segments is not None:
        seg = {"seg_start": _t(segments[0], dev, torch.bool).contiguous(),
               "gang": _t(segments[1], dev, torch.bool).contiguous(),
               "gz": torch.empty(int(z_pad), dtype=I64, device=dev),
               "log_node": torch.empty(B, dtype=I32, device=dev),
               "log_row": torch.empty(B, dtype=I32, device=dev)}
        if seg["seg_start"].shape[0] != B or seg["gang"].shape[0] != B:
            raise ValueError(f"{name}: seg_start/gang are not [B]")
    ptrs = dict(zip(_NODE_STATIC, static))
    ptrs.update(state)
    ptrs.update({"scal": scal, "req_scalar_p": req_scalar,
                 "upd_scalar_p": upd_scalar, "interpod_code": code,
                 "interpod_tracked": tracked, "row": row,
                 "profile_id": prof, "w": w, "wtab": wtab, "perms": perms,
                 "inv_perms": inv_perms, "oid_seq": oid, "spread": spread,
                 "total": total, "kept": kept, "flags": flags, "zs": zs,
                 "stats": stats, "packed": packed, "carry_out": carry_out})
    ptrs.update(zip(_CYCLE_MASKS, masks))
    ptrs.update(zip(_CYCLE_COUNTS, counts))
    ptrs.update(seg)
    _require_cuda(name, *[v for v in ptrs.values() if v is not None])
    ints = {"n_pad": n_pad, "S": s_count, "n_real": int(n_real),
            "z_pad": int(z_pad), "B": B, "num_to_find": int(num_to_find),
            "last_index": int(np.asarray(_host(last_index))),
            "lni0": int(np.asarray(_host(last_node_index))), "mode": mode,
            "L": 0 if perms is None else int(perms.shape[0]),
            "n_oid": 0 if oid_seq is None else len(oid_seq),
            "carry_spread": int(carry_spread), "gate": _gate(weights),
            "P": 0 if wtab is None else int(wtab.shape[0]),
            "ipa_on": int(ipa_on), "ic_inert": int(ic_inert),
            "tr_inert": int(tr_inert), "n_pods": int(n_steps),
            "gang_score": int(bool(gang_score)), "U": U}
    if perms is not None and perms.shape[1] != n_pad:
        raise ValueError(f"{name}: rotation rows must be n_pad wide")
    iargs = (ctypes.c_longlong * len(_SCAN_INTS))(
        *[ints[k] for k in _SCAN_INTS])
    parr = (ctypes.c_void_p * len(_SCAN_PTRS))(
        *[_ptr(ptrs.get(k)) for k in _SCAN_PTRS])
    lib = _build.load(name)
    obs.inc("launch." + name)
    _check(getattr(lib, name + "_launch")(iargs, parr, _stream()), name)
    spread_out = spread if carry_spread \
        else torch.zeros((), dtype=I64, device=dev)
    return state, carry_out[0], carry_out[1], spread_out, stats, packed


def schedule_batch(nodes, pods, last_index, last_node_index, num_to_find,
                   n_real, z_pad, weights=None, rotation=None, spread0=None,
                   rotation_pos=None, carry_in=None, wtab=None):
    """K5: the generic burst scan — one K2 cycle per pod, in order, each
    hit folded into the carried rows before the next pod. `pods` is a
    `PodStack` or the JAX [B, ...] dict; `rotation` = (perms[L, n_pad],
    inv_perms, oid_seq[B]) and `rotation_pos` = (pos[L, n_pad],
    oid_seq[B]) give each cycle's enumeration; `spread0` [n_pad] carries
    selector-spread counts; `carry_in` = (state, spread) chains a previous
    window's device carry; `wtab` [P, K] with the stack's profile ids
    scores each pod with its own row. Returns (state, li, lni, spread,
    outs) as the JAX entry point; outs["packed"] is the [3B] int32 block
    selected | li after each pod | lni delta after each pod."""
    weights = weights or DEFAULT_WEIGHTS
    if not nodes["valid"].is_cuda:
        return schedule_batch_plain(
            nodes, pods, last_index, last_node_index, num_to_find, n_real,
            z_pad, weights=weights, rotation=rotation, spread0=spread0,
            rotation_pos=rotation_pos, carry_in=carry_in, wtab=wtab)
    stack, mode, perms, inv_perms, oid_seq, carry_spread, mut0, s0, wtab = \
        _scan_setup(nodes, pods, rotation, rotation_pos, spread0, carry_in,
                    wtab)
    state, li, lni, spread, stats, packed = _scan_launch(
        "schedule_batch", nodes, stack, last_index, last_node_index,
        num_to_find, n_real, z_pad, weights, mode, perms, inv_perms,
        oid_seq, carry_spread, mut0, s0, wtab, len(stack))
    B = len(stack)
    outs = {"selected": stats[0], "found": stats[1], "evaluated": stats[2],
            "max_score": stats[3], "li_after": packed[B: 2 * B],
            "lni_after": stats[4], "packed": packed}
    return state, li, lni, spread, outs


def schedule_batch_segments(nodes, pods, seg_start, gang, n_pods,
                            last_index, last_node_index, num_to_find,
                            n_real, z_pad, weights=None, rotation=None,
                            rotation_pos=None, spread0=None, wtab=None,
                            gang_score=False):
    """K6: the fused drain window — K5's step over the first `n_pods` pods
    with a checkpoint of the live carry at each `seg_start` and an
    in-kernel rewind when a `gang` member finds no node (the rest of its
    segment is skipped). `gang_score` carries the rank-aware zone counts
    of the current gang. Returns (state, li, lni, spread, packed[4B]) as
    the JAX entry point: selected | li_after | lni delta | consumed
    enumerations t, -1 past n_pods."""
    weights = weights or DEFAULT_WEIGHTS
    if not nodes["valid"].is_cuda:
        return schedule_batch_segments_plain(
            nodes, pods, seg_start, gang, n_pods, last_index,
            last_node_index, num_to_find, n_real, z_pad, weights=weights,
            rotation=rotation, rotation_pos=rotation_pos, spread0=spread0,
            wtab=wtab, gang_score=gang_score)
    stack, mode, perms, inv_perms, oid_seq, carry_spread, mut0, s0, wtab = \
        _scan_setup(nodes, pods, rotation, rotation_pos, spread0, None, wtab)
    if int(n_pods) > len(stack):
        raise ValueError("n_pods exceeds the stacked window")
    state, li, lni, spread, _stats, packed = _scan_launch(
        "schedule_segments", nodes, stack, last_index, last_node_index,
        num_to_find, n_real, z_pad, weights, mode, perms, inv_perms,
        oid_seq, carry_spread, mut0, s0, wtab, int(n_pods),
        segments=(seg_start, gang), gang_score=gang_score)
    return state, li, lni, spread, packed
