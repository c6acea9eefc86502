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
and nowhere else; the mesh steps' and passes' wrappers (K9c/d, K10a/b,
K11a/b, K13a/b) also return the launch bound as a `Relaunch`, whose C
launch function adds one to the Relaunch's count at every launch it
makes; the window's (burst's) later steps re-enqueue it, and the count is
booked once after the window.

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
| preempt_scan   | `_victim_select` :1494, `_pick_one_node` :1570,    |
|                | `_preempt_scan_core` :1598 -> `preemption_scan`    |
|                | :1627                                              |
| pressure_batch | `_resolvable_candidates` :1675 + `_pressure_core`  |
|                | :1690 -> `pressure_batch` :1768                    |
| shard_cycle_local, shard_cycle_select (K9a, K9b)                    |
|                | `parallel/sharding.py` `sharded_cycle_fn` :115     |
| shard_uniform_sweep, shard_uniform_select (K9c, K9d)                |
|                | `parallel/sharding.py` `sharded_uniform_fn` :151   |
| shard_scan_local, shard_scan_select (K10a, K10b)                    |
|                | `parallel/sharding.py` `sharded_scan_fn` :233      |
| shard_segments_local, shard_segments_select (K11a, K11b)            |
|                | `parallel/sharding.py` `sharded_segments_fn` :279  |
| shard_preempt_local, shard_preempt_select (K14a, K14b)              |
|                | `parallel/sharding.py` `sharded_preempt_fn` :354   |
| shard_pressure_local, shard_pressure_select (K13a, K13b)            |
|                | `parallel/sharding.py` `sharded_pressure_fn` :330  |

Numeric contract: int64 resource math and scores, float64 exactly where
JAX uses it, floor division as JAX `//` (torch `//` on integer tensors
floors too; the CUDA side uses `floordiv` from `csrc/common.cuh`),
first-index argmax (bool masks are cast before `torch.argmax`), and JAX's
clamping of out-of-range gathers/slices. Python ints stay exact.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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
           "schedule_batch", "schedule_segments", "preempt_scan",
           "pressure_batch", "shard_cycle_local", "shard_cycle_select",
           "shard_uniform_sweep", "shard_uniform_select", "shard_scan_local",
           "shard_scan_select", "shard_segments_local",
           "shard_segments_select", "shard_preempt_local",
           "shard_preempt_select", "shard_pressure_local",
           "shard_pressure_select")


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


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`. To a card the copy goes through pinned
    memory and does not wait: a blocking copy from pageable memory would
    first wait for every kernel already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _weight_row(weights, wrow, device) -> torch.Tensor:
    """The [K] int64 weight row the CUDA kernels read: the pod's gathered
    table row in tensor mode, else the static weights in axis order."""
    if wrow is not None:
        return _t(wrow, device, I64).contiguous()
    return _upload(np.asarray([int(weights.get(n, 0)) for n in PRIORITY_AXIS],
                              dtype=np.int64), device)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_arrays(ints: dict, int_slots, ptrs: dict, ptr_slots, name):
    unknown = (set(ints) - set(int_slots)) | (set(ptrs) - set(ptr_slots))
    if unknown:
        raise ValueError(f"{name}: unknown launch slots {sorted(unknown)}")
    iargs = (ctypes.c_longlong * len(int_slots))(
        *[int(ints.get(k, 0)) for k in int_slots])
    parr = (ctypes.c_void_p * len(ptr_slots))(
        *[_ptr(ptrs.get(k)) for k in ptr_slots])
    return iargs, parr


def _launch(name: str, iargs, parr, *extra) -> None:
    lib = _build.load(name)
    obs.inc("launch." + name)
    _check(getattr(lib, name + "_launch")(iargs, parr, *extra, _stream()),
           name)


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
                      wrow=None, add_cpu: int = 0, add_mem: int = 0):
    """The four row-local resource priorities, exact integer/float formulas
    (`_local_total`, kernels.py:110), of `req + add` against `alloc`.
    Elementwise on [N] tensors or scalars."""
    req_cpu = torch.as_tensor(req_cpu) + add_cpu
    req_mem = torch.as_tensor(req_mem) + add_mem
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


def local_total(weights, req_cpu, req_mem, alloc_cpu, alloc_mem, wrow=None,
                add_cpu: int = 0, add_mem: int = 0):
    """K1 of `req + add` against `alloc`. CPU tensors ->
    `local_total_plain`; CUDA [N] tensors -> the kernel
    (`csrc/local_total.cu`), which adds the two scalars itself."""
    if not (isinstance(alloc_cpu, torch.Tensor) and alloc_cpu.is_cuda):
        return local_total_plain(weights, req_cpu, req_mem, alloc_cpu,
                                 alloc_mem, wrow=wrow, add_cpu=add_cpu,
                                 add_mem=add_mem)
    return _local_total_launch(weights, req_cpu, req_mem, alloc_cpu,
                               alloc_mem, wrow, add_cpu=add_cpu,
                               add_mem=add_mem)


# ---------------------------------------------------------------------------
# K2 schedule_cycle — feasibility, rotation walk, scores, k-th tie select
# ---------------------------------------------------------------------------
def _local_scores_plain(nodes, pod, weights, wrow=None):
    """The row-local part of `_fit_scores` (kernels.py:157): the K1
    resource families, image locality and prefer-avoid (its constant when
    inert). No family here reads another node, so a shard computes it over
    its own rows (K9a)."""
    alloc_cpu, alloc_mem = nodes["alloc_cpu"], nodes["alloc_mem"]
    req_cpu = pod["nz_cpu"] + nodes["nz_cpu"]
    req_mem = pod["nz_mem"] + nodes["nz_mem"]
    total = torch.zeros(nodes["valid"].shape, dtype=I64,
                        device=alloc_cpu.device) + local_total_plain(
        weights, req_cpu, req_mem, alloc_cpu, alloc_mem, wrow=wrow)

    if weights["image_locality"]:
        s = pod["image_sums"]
        if not _inert(s):
            scl = torch.clamp(s, IMAGE_MIN, IMAGE_MAX)
            total = total + _wsel(weights, wrow, "image_locality") * (
                MAX_PRIORITY * (scl - IMAGE_MIN) // (IMAGE_MAX - IMAGE_MIN))

    if weights["prefer_avoid"]:
        pa = pod["prefer_avoid"]
        if _inert(pa):
            total = total + _wsel(weights, wrow, "prefer_avoid") \
                * MAX_PRIORITY
        else:
            total = total + _wsel(weights, wrow, "prefer_avoid") * pa
    return total


def _kept_scores_plain(pod, kept, zone_id, weights, z_pad, wrow=None,
                       gang=None):
    """The part of `_fit_scores` normalized over the kept set: gang
    locality, node affinity, taint toleration, selector spread and
    inter-pod affinity (taint and spread constants when inert). It needs
    every kept node, so under a mesh it runs after the gather (K9b)."""
    const = 0
    total = torch.zeros(kept.shape, dtype=I64, device=kept.device)

    if gang is not None and weights.get("gang_locality"):
        gz, gmember = gang
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
    return total + const


def _fit_scores_plain(nodes, pod, kept, weights, z_pad, wrow=None,
                      gang=None):
    """Enabled priorities, masked-normalized over `kept` (`_fit_scores`,
    kernels.py:157). Returns total[N] int64. `gang` = (gz[z_pad], member)
    is the rank-aware gang input: a member scores each node by
    min(members already placed in its zone, 10) times the gang weight.
    The sum of the row-local and the kept-normalized parts; integer
    addition is exact in any order."""
    return _local_scores_plain(nodes, pod, weights, wrow=wrow) \
        + _kept_scores_plain(pod, kept, nodes["zone_id"], weights, z_pad,
                             wrow=wrow, gang=gang)


def _feasibility_plain(nodes, pod, ghost=None):
    """(feasible[N], fail_first[N] int8, general_bits[N] int64) —
    `_feasibility`, kernels.py:296. `ghost` ({cpu, mem, eph, cnt} [N] or
    None) adds the nominated pods' load to the rows the filter reads, as
    `_cycle_core` does before it calls `_feasibility` (kernels.py:402-413)."""
    if ghost is not None:
        nodes = {**nodes,
                 "req_cpu": nodes["req_cpu"] + ghost["cpu"],
                 "req_mem": nodes["req_mem"] + ghost["mem"],
                 "req_eph": nodes["req_eph"] + ghost["eph"],
                 "pod_count": nodes["pod_count"] + ghost["cnt"]}
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


def _walk_plain(feas, skip, last_index, num_to_find, n_real, perm=None,
                inv_perm=None, pos=None):
    """The rotation walk of `_cycle_core` (kernels.py:359) over the
    in-range feasible mask `feas`: (kept, found, evaluated)."""
    n_pad = feas.shape[0]
    i = torch.arange(n_pad, dtype=I64, device=feas.device)
    nr = int(n_real)
    li = int(last_index) % max(nr, 1)
    ntf = int(num_to_find)
    if pos is not None:
        F = int(torch.sum(feas.to(I64)))
        return feas, min(F, ntf), 0 if skip else nr
    feas_p = feas if perm is None else feas[perm.long()]
    S = torch.cumsum(feas_p.to(I64), 0)
    F = int(S[-1])
    pre = int(S[max(li - 1, 0)]) if li > 0 else 0
    rank_p = torch.where(i >= li, S - pre, F - pre + S)
    kept_p = feas_p & (rank_p <= ntf)
    kept = kept_p if perm is None else kept_p[inv_perm.long()]
    pstar = int(_first_true(kept_p & (rank_p == ntf)))
    stop_pos = pstar - li if pstar >= li else nr - li + pstar
    evaluated = stop_pos + 1 if F >= ntf else nr
    return kept, min(F, ntf), 0 if skip else evaluated


def _select_plain(kept, total, found, evaluated, last_index, last_node_index,
                  n_real, perm=None, pos=None) -> dict:
    """The round-robin k-th tie select of `_cycle_core` and its scalar
    outputs (selected, found, evaluated, max_score, next_last_index,
    next_last_node_index) as int64 device scalars."""
    dev = kept.device
    n_pad = kept.shape[0]
    nr = int(n_real)
    n_safe = max(nr, 1)
    li = int(last_index) % n_safe
    lni = int(last_node_index)
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
        after = torch.arange(n_pad, dtype=I64, device=dev) >= li
        trank = torch.where(after, T - preT, T[-1] - preT + T)
        sel = int(_first_true(tie_p & (trank == k + 1)))
        if perm is not None:
            sel = int(perm[sel])

    def s64(v):
        return torch.tensor(v, dtype=I64, device=dev)
    return {
        "selected": s64(sel if found > 0 else -1),
        "found": s64(found),
        "evaluated": s64(evaluated),
        "max_score": s64(max_score if found > 0 else 0),
        "next_last_index": s64((int(last_index) + evaluated) % n_safe),
        "next_last_node_index": s64(lni + (1 if found > 1 else 0)),
    }


def _cycle_core_plain(nodes, pod, last_index, last_node_index, num_to_find,
                      n_real, weights, z_pad, perm=None, inv_perm=None,
                      pos=None, wtab=None, gang=None, ghost=None):
    """One fused cycle (`_cycle_core`, kernels.py:359): identity walk, the
    `perm`/`inv_perm` rotated walk, or the gather-free `pos` mode. `ghost`
    (the pressure scan's carried nominated load) enters the filter only;
    the scores read the raw rows."""
    n_pad = nodes["valid"].shape[0]
    in_range = torch.arange(n_pad, device=nodes["valid"].device) \
        < int(n_real)
    feasible, fail_first, general_bits = _feasibility_plain(nodes, pod,
                                                            ghost=ghost)
    kept, found, evaluated = _walk_plain(
        feasible & in_range, bool(pod["skip"]), last_index, num_to_find,
        n_real, perm=perm, inv_perm=inv_perm, pos=pos)
    wrow = None
    if wtab is not None:
        wrow = _row_at(wtab, pod["profile_id"])
    total = _fit_scores_plain(nodes, pod, kept, weights, z_pad, wrow=wrow,
                              gang=gang)
    return {**_select_plain(kept, total, found, evaluated, last_index,
                            last_node_index, n_real, perm=perm, pos=pos),
            "total": total, "kept": kept, "feasible": feasible,
            "fail_first": fail_first, "general_bits": general_bits}


def _ghost_tensors(ghost, device) -> Optional[dict]:
    """A nominated-ghost load ({cpu, mem, eph, cnt}, numpy or tensors) as
    int64 tensors on `device`; None stays None."""
    if ghost is None:
        return None
    return {k: _t(ghost[k], device, I64).contiguous() for k in GHOST_FIELDS}


def schedule_cycle_plain(nodes, pod, last_index, last_node_index,
                         num_to_find, n_real, z_pad, weights=None, wtab=None,
                         perm=None, inv_perm=None, pos=None, ghost=None):
    """Plain version of K2 (the JAX `schedule_cycle` entry point, plus the
    `perm`/`inv_perm` and `pos` rotation modes its burst scans use).
    `ghost` ({cpu, mem, eph, cnt} [n_pad], or None) is the nominated pods'
    load the filter adds (`_cycle_core`'s ghost, kernels.py:402-413)."""
    dev = nodes["valid"].device
    pod = {k: _t(v, dev) for k, v in pod.items()}
    if wtab is not None:
        wtab = _t(wtab, dev, I64)
    return _cycle_core_plain(nodes, pod, last_index, last_node_index,
                             num_to_find, n_real, weights or DEFAULT_WEIGHTS,
                             z_pad, perm=perm, inv_perm=inv_perm, pos=pos,
                             wtab=wtab, ghost=_ghost_tensors(ghost, dev))


# pod scalar slots of K2's packed int64 input (csrc/schedule_cycle.cu)
_CYCLE_SCALARS = ("req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem",
                  "has_request", "check_resources", "unknown_scalar", "skip",
                  "profile_id")
# per-node pod fields of K2, in argument order; None/inert -> NULL pointer
_CYCLE_MASKS = ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
                "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok")
_CYCLE_COUNTS = ("node_aff_counts", "taint_counts", "spread_counts",
                 "interpod_counts", "image_sums", "prefer_avoid")
# the node rows K2 reads, and its per-node outputs
_CYCLE_NODES = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
                "allowed_pods", "req_cpu", "req_mem", "req_eph", "nz_cpu",
                "nz_mem", "pod_count", "alloc_scalar", "req_scalar",
                "zone_id")
_CYCLE_OUTS = ("total", "kept", "feasible", "fail_first", "general_bits")
#: scalar and pointer slots of K2's launch (csrc/schedule_cycle.cu
#: `CycleArgs`, the `CYI_*` / `CYP_*` enums)
_CYCLE_INTS = ("n_pad", "S", "n_real", "z_pad", "last_index", "lni",
               "num_to_find", "mode", "gate", "ipa_on", "ic_inert",
               "tr_inert")
_CYCLE_PTRS = (_CYCLE_NODES + ("scal", "req_scalar_p") + _CYCLE_MASKS
               + ("interpod_code",) + _CYCLE_COUNTS
               + ("interpod_tracked", "w", "perm", "inv_perm", "pos",
                  "ghost_cpu", "ghost_mem", "ghost_eph", "ghost_cnt")
               + _CYCLE_OUTS + ("out", "workspace"))
#: the six scalar outputs, in the kernel's `CO_*` order
_CYCLE_RESULTS = ("selected", "found", "evaluated", "max_score",
                  "next_last_index", "next_last_node_index")


def _pack_scalars(vals: list, dev) -> torch.Tensor:
    """One int64 vector of per-call scalars, one host-to-device copy."""
    return torch.tensor([int(np.asarray(_host(v))) for v in vals],
                        dtype=I64).to(dev)


def _cycle_outputs(n_pad: int, dev) -> dict:
    """K2's outputs, carved from one allocation: total and general_bits
    [n_pad] int64, the six scalars, then kept, feasible [n_pad] bool and
    fail_first [n_pad] int8."""
    words = 2 * n_pad + len(_CYCLE_RESULTS)
    buf = torch.empty(8 * words + 3 * n_pad, dtype=torch.uint8, device=dev)
    i64s = buf[:8 * words].view(I64)
    u8 = buf[8 * words:]
    return {"total": i64s[:n_pad], "general_bits": i64s[n_pad:2 * n_pad],
            "out": i64s[2 * n_pad:],
            "kept": u8[:n_pad].view(torch.bool),
            "feasible": u8[n_pad:2 * n_pad].view(torch.bool),
            "fail_first": u8[2 * n_pad:].view(torch.int8)}


def _schedule_cycle_launch(nodes, pod, last_index, last_node_index,
                           num_to_find, n_real, z_pad, weights, wtab,
                           perm, inv_perm, pos, ghost):
    """Launch K2: one thread-block cluster (`cycle_plan`) over the node
    rows in place. The pod's scalars, its scalar requests and (without a
    weight table) the static weight row go up in one copy; the outputs
    are views of one allocation."""
    dev = nodes["valid"].device
    n_pad = int(nodes["valid"].shape[0])
    s_count = int(nodes["alloc_scalar"].shape[1])
    fields = {k: nodes[k] for k in _CYCLE_NODES}
    _require_cuda("schedule_cycle", *fields.values())
    if nodes["zone_id"].dtype != I32 or nodes["valid"].dtype != torch.bool:
        raise ValueError("schedule_cycle: zone_id must be int32, valid bool")
    pid = int(np.asarray(_host(pod.get("profile_id", 0))))
    req_scalar = np.asarray(_host(pod["req_scalar"]), np.int64).reshape(-1)
    if req_scalar.size != s_count:
        raise ValueError("schedule_cycle: req_scalar width != node scalars")
    vals = [int(np.asarray(_host(pod[k]))) for k in _CYCLE_SCALARS[:-1]]
    vals += [pid] + req_scalar.tolist()
    if wtab is None:
        vals += [int(weights.get(k, 0)) for k in PRIORITY_AXIS]
    packed = _upload(np.asarray(vals, np.int64), dev)
    nsc = len(_CYCLE_SCALARS)
    if wtab is None:
        w = packed[nsc + s_count:]
    else:
        w = _t(_row_at(_t(wtab, dev, I64), pid), dev, I64).contiguous()

    def dense(key, dtype):
        v = pod.get(key)
        if v is None or _inert(v):
            return None
        v = _t(v, dev, dtype).contiguous()
        if v.shape[-1] != n_pad:
            raise ValueError(f"schedule_cycle: {key} is not [n_pad]")
        return v
    masks = [dense(k, torch.bool) for k in _CYCLE_MASKS]
    counts = [dense(k, I64) for k in _CYCLE_COUNTS]
    tracked = dense("interpod_tracked", torch.bool)
    # interpod runs unless BOTH of its fields are inert; an inert side
    # broadcasts its single element
    ic_inert = counts[3] is None
    tr_inert = tracked is None
    ipa_on = not (ic_inert and tr_inert)
    if ipa_on and ic_inert:
        counts[3] = _t(pod["interpod_counts"], dev, I64).reshape(-1)[:1]
    if ipa_on and tr_inert:
        tracked = _t(pod["interpod_tracked"], dev,
                     torch.bool).reshape(-1)[:1]
    mode = 0
    if pos is not None:
        mode = 2
        pos = _t(pos, dev, I32).contiguous()
    elif perm is not None:
        mode = 1
        perm = _t(perm, dev, I32).contiguous()
        inv_perm = _t(inv_perm, dev, I32).contiguous()
    ghost = _ghost_tensors(ghost, dev)
    if ghost is not None and any(g.shape != (n_pad,)
                                 for g in ghost.values()):
        raise ValueError("schedule_cycle: ghost fields are not [n_pad]")
    plan = _cluster_geometry("schedule_cycle", lambda blocks: cycle_plan(
        n_pad, s_count, int(z_pad), blocks))
    outs = _cycle_outputs(n_pad, dev)
    ptrs = dict(fields)
    ptrs.update(zip(_CYCLE_MASKS, masks))
    ptrs.update(zip(_CYCLE_COUNTS, counts))
    ptrs.update({"scal": packed[:nsc], "req_scalar_p": packed[nsc:],
                 "interpod_code": dense("interpod_code", torch.int8),
                 "interpod_tracked": tracked, "w": w, "perm": perm,
                 "inv_perm": inv_perm, "pos": pos,
                 "workspace": plan.workspace(dev), **outs})
    if ghost is not None:
        ptrs.update({"ghost_" + k: v for k, v in ghost.items()})
    _require_cuda("schedule_cycle",
                  *[v for v in ptrs.values() if v is not None])
    ints = {"n_pad": n_pad, "S": s_count, "n_real": int(n_real),
            "z_pad": int(z_pad), "last_index": int(last_index),
            "lni": int(last_node_index), "num_to_find": int(num_to_find),
            "mode": mode, "gate": _gate(weights), "ipa_on": int(ipa_on),
            "ic_inert": int(ic_inert), "tr_inert": int(tr_inert)}
    _launch("schedule_cycle", *_launch_arrays(
        ints, _CYCLE_INTS, ptrs, _CYCLE_PTRS, "schedule_cycle"),
        plan.geometry())
    res = {k: outs[k] for k in _CYCLE_OUTS}
    res.update({k: outs["out"][i] for i, k in enumerate(_CYCLE_RESULTS)})
    return res


def schedule_cycle(nodes, pod, last_index, last_node_index, num_to_find,
                   n_real, z_pad, weights=None, wtab=None, perm=None,
                   inv_perm=None, pos=None, ghost=None, mesh=None):
    """K2: one scheduling cycle. `nodes` is the dict of node tensors, `pod`
    the dict of pod fields (inert per-node fields are shape [1]); the
    output dict has the JAX entry point's keys. `perm`/`inv_perm` select
    the rotated walk and `pos` the gather-free full-scan mode. `wtab` is
    the [P, K] weight table, `pod["profile_id"]` picks its row. `ghost`
    ({cpu, mem, eph, cnt} [n_pad] int64, or None) is the load of the
    nominated pods the filter counts on each node (the two-pass fit of
    podFitsOnNode for resource-only nominees); the scores never read it.
    With a `mesh` (parallel.sharding.Mesh) the node axis is split over its
    devices (`nodes`: the per-shard dicts of `shard_node_arrays`, or one
    whole dict) and the cycle runs as K9a on every shard, an all-gather
    and K9b on every device (`parallel.sharding.sharded_cycle`)."""
    weights = weights or DEFAULT_WEIGHTS
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_cycle(mesh, nodes, pod, last_index,
                               last_node_index, num_to_find, n_real, z_pad,
                               weights=weights, wtab=wtab, perm=perm,
                               inv_perm=inv_perm, pos=pos, ghost=ghost)
    if not nodes["valid"].is_cuda:
        return schedule_cycle_plain(nodes, pod, last_index, last_node_index,
                                    num_to_find, n_real, z_pad,
                                    weights=weights, wtab=wtab, perm=perm,
                                    inv_perm=inv_perm, pos=pos, ghost=ghost)
    return _schedule_cycle_launch(nodes, pod, last_index, last_node_index,
                                  num_to_find, n_real, z_pad, weights, wtab,
                                  perm, inv_perm, pos, ghost)


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


def _uniform_rows(nodes, flags):
    """The node rows of a uniform burst: the carried fold rows (the five
    fixed ones, then ephemeral storage and the carried scalars), the
    allocatable of each carried row past the fifth, and the (allocatable,
    used) rows of the resource families that cannot change in-burst."""
    check_res, has_req, carry_eph, static_eph, carried_s, static_s = flags
    rows = [nodes["req_cpu"], nodes["req_mem"], nodes["nz_cpu"],
            nodes["nz_mem"], nodes["pod_count"]]
    xalloc, salloc, sused = [], [], []
    if carry_eph:
        rows.append(nodes["req_eph"])
        xalloc.append(nodes["alloc_eph"])
    for s in carried_s:
        rows.append(nodes["req_scalar"][:, s])
        xalloc.append(nodes["alloc_scalar"][:, s])
    if check_res and has_req:
        if static_eph:
            salloc.append(nodes["alloc_eph"])
            sused.append(nodes["req_eph"])
        for s in static_s:
            salloc.append(nodes["alloc_scalar"][:, s])
            sused.append(nodes["req_scalar"][:, s])
    return rows, xalloc, salloc, sused


def _uniform_out_rows(st, nodes, flags) -> dict:
    """The folded node rows of a uniform burst from its carried rows `st`
    [R, n] (`_uniform_rows` order): views of `st`, and a copy of the
    node's scalar matrix with the carried columns replaced."""
    carry_eph, carried_s = flags[2], flags[4]
    out = {"req_cpu": st[0], "req_mem": st[1], "nz_cpu": st[2],
           "nz_mem": st[3], "pod_count": st[4]}
    r = 5
    if carry_eph:
        out["req_eph"] = st[r]
        r += 1
    if carried_s:
        rs = nodes["req_scalar"].clone()
        for jj, s in enumerate(carried_s):
            rs[:, s] = st[r + jj]
        out["req_scalar"] = rs
    return out


def _uniform_cls_vec(cls, flags) -> list:
    """The uniform kernels' class vector: req_cpu, req_mem, nz_cpu,
    nz_mem, delta[R], xreq[R-5], sreq[NS], in `_uniform_rows`' order."""
    check_res, has_req, carry_eph, static_eph, carried_s, static_s = flags
    req_scalar = np.asarray(cls["req_scalar"]).reshape(-1)
    upd_scalar = np.asarray(cls["upd_scalar"]).reshape(-1)
    delta = [int(cls["upd_cpu"]), int(cls["upd_mem"]), int(cls["nz_cpu"]),
             int(cls["nz_mem"]), 1]
    xreq = []
    if carry_eph:
        delta.append(int(cls["upd_eph"]))
        xreq.append(int(cls["req_eph"]))
    for s in carried_s:
        delta.append(int(upd_scalar[s]))
        xreq.append(int(req_scalar[s]))
    sreq = []
    if check_res and has_req:
        if static_eph:
            sreq.append(int(cls["req_eph"]))
        for s in static_s:
            sreq.append(int(req_scalar[s]))
    return [int(cls["req_cpu"]), int(cls["req_mem"]), int(cls["nz_cpu"]),
            int(cls["nz_mem"])] + delta + xreq + sreq


#: scalar and pointer slots of K3's launch (csrc/uniform_burst.cu `UArgs`,
#: the `UBI_*` / `UBP_*` enums)
_UNIFORM_INTS = ("n_pad", "n_real", "n_pods", "cap", "K", "R", "NS",
                 "check_res", "has_req", "L", "n_oid", "ban", "gate")
_UNIFORM_PTRS = ("w", "valid", "extra", "alloc_cpu", "alloc_mem", "allowed",
                 "xalloc", "salloc", "sused", "clsv", "st", "tot0", "perm",
                 "oid_seq", "lni_in", "out", "lni_out", "owner", "workspace")


def _uniform_launch(nodes, cls, n_pods, last_node_index, n_real,
                    check_resources, weights, rotation, extra_ok, ban, cap,
                    wtab, pid):
    """Launch K3: one thread-block cluster (`uniform_plan`) runs the whole
    burst. A plan with its scratch in global memory takes a fresh
    workspace."""
    cap, flags, wrow, perm, oid_seq, extra = _uniform_args(
        nodes, cls, n_pods, cap, rotation, extra_ok, wtab, pid,
        check_resources)
    check_res, has_req = flags[:2]
    dev = nodes["valid"].device
    n_pad = int(nodes["valid"].shape[0])
    _require_cuda("uniform_burst", nodes["valid"], nodes["alloc_cpu"],
                  nodes["alloc_mem"], nodes["allowed_pods"], perm, oid_seq,
                  extra)
    # the carried fold rows, stacked [R, n_pad] (a fresh copy: the kernel
    # folds into it, the resident matrix stays as it was), their
    # allocatable rows, and the static (alloc, used) rows of the resource
    # families that cannot change in-burst, merged into the feasibility
    # mask at kernel start
    rows, xalloc, salloc, sused = _uniform_rows(nodes, flags)
    st = torch.stack(rows).contiguous()
    R = st.shape[0]
    if R > UNIFORM_ROWS_MAX:
        raise ValueError(f"uniform_burst: {R} carried rows, over "
                         f"{UNIFORM_ROWS_MAX}")
    xa = torch.stack(xalloc).contiguous() if xalloc else None
    sa = torch.stack(salloc).contiguous() if salloc else None
    su = torch.stack(sused).contiguous() if sused else None
    clsv = torch.tensor(_uniform_cls_vec(cls, flags), dtype=I64).to(dev)
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
    plan = _cluster_geometry("uniform_burst", lambda blocks: uniform_plan(
        n_pad, R, len(salloc), L, blocks))
    out = torch.empty(cap + K_BATCH, dtype=I32, device=dev)
    lni_out = torch.empty(1, dtype=I64, device=dev)
    ptrs = {"w": _weight_row(weights, wrow, dev), "valid": nodes["valid"],
            "extra": extra, "alloc_cpu": nodes["alloc_cpu"],
            "alloc_mem": nodes["alloc_mem"],
            "allowed": nodes["allowed_pods"], "xalloc": xa, "salloc": sa,
            "sused": su, "clsv": clsv, "st": st, "tot0": tot0, "perm": perm,
            "oid_seq": oid_seq,
            "lni_in": _t(last_node_index, dev, I64).reshape(1).contiguous(),
            "out": out, "lni_out": lni_out,
            # the lanes' scatter-min on the node axis and its scratch column
            "owner": torch.empty(n_pad + 1, dtype=I32, device=dev),
            "workspace": plan.workspace(dev)}
    ints = {"n_pad": n_pad, "n_real": int(n_real), "n_pods": int(n_pods),
            "cap": cap, "K": K_BATCH, "R": R, "NS": len(salloc),
            "check_res": int(check_res), "has_req": int(has_req), "L": L,
            "n_oid": n_oid, "ban": int(bool(ban)), "gate": _gate(weights)}
    _launch("uniform_burst", *_launch_arrays(
        ints, _UNIFORM_INTS, ptrs, _UNIFORM_PTRS, "uniform_burst"),
        plan.geometry())
    return _uniform_out_rows(st, nodes, flags), out[: cap + 1], lni_out[0]


def schedule_batch_uniform(nodes, cls, n_pods, last_node_index, n_real,
                           check_resources, weights=None, rotation=None,
                           extra_ok=None, ban=False, mesh=None, cap=None,
                           wtab=None, pid=0):
    """K3: the uniform-class burst. `cls` holds the shared per-pod scalars
    (req_cpu/req_mem/req_eph, req_scalar[S], nz_cpu/nz_mem, upd_cpu/
    upd_mem/upd_eph, upd_scalar[S], has_request). Returns (folded_state_
    rows, packed[cap+1] int32, lni) where packed[:n_pods] are node indices
    (-1 = unschedulable) and packed[cap] the lastNodeIndex advance — one
    array, one device-to-host copy. `rotation` = (perm[L, n_pad+1] int32,
    oid_seq[cap + K_BATCH] int32) when per-cycle enumerations rotate;
    `extra_ok` [n_pad] bool merges burst-static masks; `ban` makes each
    placement ban its own node. With a `mesh` the node-axis state is
    split over its devices (`nodes`: per-shard dicts, or one whole dict):
    every pass runs K9c on each shard, an all-gather and K9d on every
    device (`parallel.sharding.sharded_uniform`); the folded rows come
    back as one dict per shard."""
    weights = weights or DEFAULT_WEIGHTS
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_uniform(mesh, nodes, cls, n_pods, last_node_index,
                                 n_real, check_resources, weights=weights,
                                 rotation=rotation, extra_ok=extra_ok,
                                 ban=ban, cap=cap, wtab=wtab, pid=pid)
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

    def __init__(self, table: dict, row, profile_id=None, skip=None):
        self.table = table
        self.row = np.asarray(row, dtype=np.int64)
        self.profile_id = None if profile_id is None \
            else np.asarray(profile_id, dtype=np.int64)
        self._skip = None if skip is None else np.asarray(skip, dtype=bool)

    def skip_flags(self) -> np.ndarray:
        """Each table row's skip flag on the host (read off the table
        once when the stack was not built from host specs)."""
        if self._skip is None:
            self._skip = np.asarray(_host(self.table["skip"]),
                                    dtype=bool).reshape(-1)
        return self._skip

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
        skip = [bool(np.asarray(d["skip"])) for d in specs]
        return cls(table, row, profile_id, skip=skip)

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


# ---------------------------------------------------------------------------
# The cluster geometry of K5 / K6 / K8 (csrc/cluster_cycle.cuh) and of the
# mesh selects K10b / K11b (csrc/cluster_select.cuh)
# ---------------------------------------------------------------------------
#: blocks of a cluster (H100's non-portable maximum), threads of a block,
#: and the dynamic shared memory a block may take after the opt-in
CLUSTER_BLOCKS = 16
CLUSTER_THREADS = 1024
SMEM_CAP = 232448
#: the kernels that run as one cluster a window (K5, K6), a chunk (K8), a
#: cycle (K2, and the sharded cycle's select K9b), a burst (K3) or a
#: sharded uniform pass (K9d)
CLUSTER_KERNELS = ("schedule_batch", "schedule_segments", "pressure_batch",
                   "schedule_cycle", "uniform_burst", "shard_cycle_select",
                   "shard_uniform_select")
#: the mesh selects that run as one cluster a step
SELECT_CLUSTER_KERNELS = ("shard_scan_select", "shard_segments_select",
                          "shard_pressure_select")
#: slots of a launch's geometry array (`CG_*`, csrc/cluster_cycle.cuh)
CLUSTER_GEOM = ("blocks", "npt", "resident", "smem", "scratch")
_NWARPS = CLUSTER_THREADS // 32
_PR_N = 8              # fields of a round's partial record (`PR_*`)
_ROWS_I64 = 10         # resident int64 rows besides the carried spread
_RP_N = 5              # a select's staged int64 record planes (`RP_*`)
#: bytes a node slot of a select's records staged in global memory: the
#: int64 planes, the zone, the tracked byte and the feasible bit
_REC_SLOT_BYTES = 8 * _RP_N + 4 + 2
#: bytes K8 keeps a node slot beside K5's resident rows: the ghost load
#: (four int64) and the victim scan's aggregates (four int64, one float64,
#: the candidate byte)
_PRESSURE_SLOT_BYTES = 8 * 4 + 8 * 5 + 1
#: bytes of a node slot's cluster scratch: the score (TOT, int64), the
#: prefix (A), the flags (FL) and the tie slot (JA), int32 each; in shared
#: memory, or in a global workspace of blocks x span slots (`scratch_bytes`
#: in csrc/cluster_cycle.cuh)
SCRATCH_SLOT_BYTES = 8 + 3 * 4


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The geometry of one cluster launch (K5 / K6, a K8 chunk, a K2 or
    K9b cycle, a K3 burst, or a K10b / K11b / K13b step): `blocks` blocks
    of CLUSTER_THREADS threads, each thread `nodes_per_thread` consecutive
    node slots (block q owns [q * span, (q + 1) * span)), the node rows
    (a select: the step's gathered records) `resident` in shared memory
    or left in global memory, `smem_bytes` of dynamic shared memory a
    block, and the per-slot scratch in shared memory or,
    `global_scratch`, in a global workspace of `workspace_bytes` that the
    wrapper allocates."""
    blocks: int
    nodes_per_thread: int
    resident: bool
    smem_bytes: int
    global_scratch: bool = False
    #: bytes a node slot takes in the global workspace (K3's: its scores,
    #: bytes and tie lists, `uniform_plan`)
    scratch_slot_bytes: int = SCRATCH_SLOT_BYTES

    @property
    def span(self) -> int:
        return self.nodes_per_thread * CLUSTER_THREADS

    @property
    def workspace_bytes(self) -> int:
        """Bytes of the launch's global scratch workspace (0: none)."""
        if not self.global_scratch:
            return 0
        return self.blocks * self.span * self.scratch_slot_bytes

    def workspace(self, device) -> Optional[torch.Tensor]:
        """A fresh workspace for this plan's launches on `device`, or None
        when the scratch lives in shared memory."""
        if not self.global_scratch:
            return None
        return torch.empty(self.workspace_bytes, dtype=torch.uint8,
                           device=device)

    def geometry(self):
        """The launch's `ClusterGeom` array (csrc/cluster_cycle.cuh), in
        CLUSTER_GEOM order."""
        return (ctypes.c_longlong * len(CLUSTER_GEOM))(
            self.blocks, self.nodes_per_thread, int(self.resident),
            self.smem_bytes, int(self.global_scratch))


def cluster_smem_bytes(span: int, S: int, z_pad: int, carry_spread: bool,
                       resident: bool, records: bool = False,
                       pressure: bool = False,
                       global_scratch: bool = False) -> int:
    """A block's dynamic shared memory, as `cluster_layout`
    (csrc/cluster_cycle.cuh) lays it out: a fixed part (the weight row,
    the warp slots of the block scans and of the rounds, two partial
    records with their zone table, a round's results, the cluster's zone
    table, the gang's, the per-block counts and offsets) and per node slot
    the score, the prefix, the flags and the tie slot, plus, with the rows
    resident, ten int64 rows, the carried spread, two int64 planes of S
    scalars, the zone and the valid byte. `records` (a select): no rows,
    the step state, and, resident, per slot the staged record's zone, five
    int64 planes (local, na, tt, sc, ic), tracked byte and feasible
    bit. `pressure` (K8): with the rows resident also the ghost load and
    the victim scan's aggregates a slot. `global_scratch`: the score, the
    prefix, the flags and the tie slot live in the global workspace."""
    fixed = (16 * 8 + _NWARPS * (4 + 8) + _PR_N * _NWARPS * 8
             + 2 * (_PR_N + 2 * z_pad) * 8 + 16 * 8 + 3 * z_pad * 8
             + 16 * (4 + 8 + 8) + 8 * 4)
    per_node = 0 if global_scratch else SCRATCH_SLOT_BYTES
    if records:
        fixed += 16 * 8
        if resident:
            per_node += _REC_SLOT_BYTES
    elif resident:
        per_node += 8 * (_ROWS_I64 + int(bool(carry_spread))) + 16 * S + 5
        if pressure:
            per_node += _PRESSURE_SLOT_BYTES
    return fixed + span * per_node


#: where a cluster keeps its rows (a select: its staged records) and its
#: per-slot scratch, (resident, global_scratch) in the order a planner
#: tries them
_PLACEMENTS = ((True, False), (False, False), (False, True))


def _first_placement(blocks: int, npt: int, what: str, n_pad: int,
                     z_pad: int, nbytes_at,
                     placements=_PLACEMENTS) -> ClusterPlan:
    """The plan of the first of `placements` whose shared memory
    (`nbytes_at(resident, global_scratch)`) fits in SMEM_CAP; raises when
    not even the fixed part fits (z_pad too large)."""
    for resident, gscr in placements:
        nbytes = nbytes_at(resident, gscr)
        if nbytes <= SMEM_CAP:
            return ClusterPlan(blocks, npt, resident, nbytes, gscr)
    raise ValueError(f"cluster {what}: n_pad {n_pad} (z_pad {z_pad}) needs "
                     f"{nbytes} B of shared memory a block, over "
                     f"{SMEM_CAP}")


def cluster_plan(n_pad: int, S: int, z_pad: int, carry_spread: bool,
                 blocks: int = CLUSTER_BLOCKS,
                 records: bool = False) -> ClusterPlan:
    """The geometry of K5 / K6 over `n_pad` node slots (`records`: of a
    K10b / K11b step): `blocks` blocks, the fewest slots a thread that
    cover the axis, the rows (the step's records) resident in shared
    memory when they fit in SMEM_CAP beside the scratch, else in global
    memory, and past that the scratch in a global workspace too. Raises
    only when the fixed part alone passes the cap."""
    if not 1 <= blocks <= CLUSTER_BLOCKS:
        raise ValueError(f"a cluster holds 1 to {CLUSTER_BLOCKS} blocks")
    npt = max(1, -(-int(n_pad) // (blocks * CLUSTER_THREADS)))
    span = npt * CLUSTER_THREADS
    return _first_placement(
        blocks, npt, "select" if records else "scan", n_pad, z_pad,
        lambda resident, gscr: cluster_smem_bytes(
            span, S, z_pad, carry_spread, resident, records,
            global_scratch=gscr))


def pressure_plan(n_pad: int, S: int, z_pad: int,
                  blocks: int = CLUSTER_BLOCKS) -> ClusterPlan:
    """The geometry of a K8 chunk over `n_pad` node slots: the fewest
    node slots a thread that cover the axis with `blocks` blocks, then
    only the blocks that own a node at that span (a block that owns none
    would only take part in the rounds), and the rows, the ghost load and
    the victim scan's aggregates resident in shared memory when they fit
    in SMEM_CAP, else in global memory, and past that the scratch in a
    global workspace too. Raises only when the fixed part alone passes
    the cap."""
    if not 1 <= blocks <= CLUSTER_BLOCKS:
        raise ValueError(f"a cluster holds 1 to {CLUSTER_BLOCKS} blocks")
    npt = max(1, -(-int(n_pad) // (blocks * CLUSTER_THREADS)))
    span = npt * CLUSTER_THREADS
    blocks = max(1, -(-int(n_pad) // span))
    return _first_placement(
        blocks, npt, "pressure scan", n_pad, z_pad,
        lambda resident, gscr: cluster_smem_bytes(
            span, S, z_pad, False, resident, pressure=True,
            global_scratch=gscr))


def select_plan(n_pad: int, z_pad: int,
                blocks: int = CLUSTER_BLOCKS) -> ClusterPlan:
    """The geometry of a K10b / K11b / K13b step over `n_pad` node slots
    (no rows; the step's gathered records staged in shared memory when
    they fit, else in global memory, and past that the scratch in a
    global workspace too)."""
    return cluster_plan(n_pad, 0, z_pad, False, blocks, records=True)


def cycle_plan(n_pad: int, S: int, z_pad: int,
               blocks: int = CLUSTER_BLOCKS) -> ClusterPlan:
    """The geometry of a K2 cycle over `n_pad` node slots: the fewest
    node slots a thread that cover the axis with `blocks` blocks, then
    only the blocks that own a node at that span, as `pressure_plan`. One
    pod reads each row once, so the rows stay in global memory; the
    per-slot scratch lives in shared memory while it fits in SMEM_CAP
    (180,224 slots on 16 blocks), past that in a global workspace. Raises
    only when the fixed part alone passes the cap."""
    if not 1 <= blocks <= CLUSTER_BLOCKS:
        raise ValueError(f"a cluster holds 1 to {CLUSTER_BLOCKS} blocks")
    npt = max(1, -(-int(n_pad) // (blocks * CLUSTER_THREADS)))
    span = npt * CLUSTER_THREADS
    blocks = max(1, -(-int(n_pad) // span))
    return _first_placement(
        blocks, npt, "cycle", n_pad, z_pad,
        lambda resident, gscr: cluster_smem_bytes(
            span, S, z_pad, False, resident, global_scratch=gscr),
        placements=_PLACEMENTS[1:])


#: carried rows a K3 lane holds in registers (`UR_MAX`,
#: csrc/uniform_burst.cu): the five fixed rows, ephemeral storage and the
#: carried scalar resources
UNIFORM_ROWS_MAX = 16
#: the blocks a cluster holds at most (`CLUSTER_MAX`, csrc/cluster_cycle.cuh;
#: CLUSTER_BLOCKS may plan fewer)
_CLUSTER_MAX = 16
#: lanes of a K3 pass at most, one a thread of block 0 (`UK_MAX`)
_UNIFORM_LANES_MAX = CLUSTER_THREADS
#: int64 words of a K3 block's control block (`UC_N`)
_UNIFORM_CTL = 8


def uniform_smem_bytes(span: int, R: int, L: int, resident: bool,
                       global_scratch: bool = False) -> int:
    """A K3 block's dynamic shared memory, as `uniform_layout`
    (csrc/uniform_burst.cu) lays it out: a fixed part (the weight row,
    the warp slots of the block reductions and scans, the block's record
    of the pass, its control block, block 0's tie offsets of every order
    and accepted lanes, the block's list length an order) and per node
    slot the R carried int64 rows when `resident`, and, unless
    `global_scratch`, the int32 score, the ok / banned / feasible bytes
    and one int32 tie-list slot an order (one without rotation)."""
    lm = max(int(L), 1)
    fixed = (16 * 8 + _NWARPS * 8 + 4 * 8 + _UNIFORM_CTL * 8 + _NWARPS * 4
             + _CLUSTER_MAX * 4 * lm + 4 * lm + _UNIFORM_LANES_MAX * 4)
    per_node = 8 * int(R) if resident else 0
    if not global_scratch:
        per_node += _uniform_slot_bytes(L)
    return fixed + span * per_node


def _uniform_slot_bytes(L: int) -> int:
    """Bytes of a node slot's K3 scratch: its score, three bytes and one
    tie-list slot an order (`uniform_scratch_bytes`)."""
    return 4 + 3 + 4 * max(int(L), 1)


def uniform_plan(n_pad: int, R: int, NS: int, L: int,
                 blocks: int = CLUSTER_BLOCKS) -> ClusterPlan:
    """The geometry of a K3 burst over `n_pad` node slots with R carried
    rows, NS static resource rows and L rotation orders: the fewest node
    slots a thread that cover the axis with `blocks` blocks, then only the
    blocks that own a node at that span, as `cycle_plan`; the carried rows
    resident in shared memory for the whole burst when they fit in
    SMEM_CAP beside the scratch, else in global memory, and past that the
    scores, bytes and tie lists in a global workspace too. The static rows
    (NS, and the allocatable rows) stay in global memory and take no
    shared memory. Raises only when the fixed part alone passes the
    cap."""
    del NS
    if not 1 <= blocks <= CLUSTER_BLOCKS:
        raise ValueError(f"a cluster holds 1 to {CLUSTER_BLOCKS} blocks")
    npt = max(1, -(-int(n_pad) // (blocks * CLUSTER_THREADS)))
    span = npt * CLUSTER_THREADS
    blocks = max(1, -(-int(n_pad) // span))
    plan = _first_placement(
        blocks, npt, "uniform burst", n_pad, 0,
        lambda resident, gscr: uniform_smem_bytes(span, R, L, resident,
                                                  gscr))
    return dataclasses.replace(plan,
                               scratch_slot_bytes=_uniform_slot_bytes(L))


#: clusters the card holds at once, by (kernel, plan, device); and each
#: cluster kernel's last geometry with that count (what chip_smoke.py
#: prints)
_CLUSTER_FIT: dict = {}
last_geometry: dict = {}


def _cluster_geometry(name: str, plan_for) -> ClusterPlan:
    """The plan a launch takes on the current device: `plan_for(blocks)`
    at CLUSTER_BLOCKS blocks, or half as many when the card cannot place
    a cluster of that many at that shared memory
    (`cudaOccupancyMaxActiveClusters` gives 0). The query, once per
    kernel, plan and device, also sets the kernel's launch attributes on
    the device, the same for every plan (the most shared memory the device
    allows), so a launch of any plan queried there fits. Raises with the
    counts when it can place neither."""
    query = getattr(_build.load(name), name + "_clusters")
    dev = torch.cuda.current_device()
    tried = []
    for blocks in (CLUSTER_BLOCKS, CLUSTER_BLOCKS // 2):
        plan = plan_for(blocks)
        fit = _CLUSTER_FIT.get((name, plan, dev))
        if fit is None:
            out = ctypes.c_int(0)
            _check(query(plan.geometry(), ctypes.byref(out)),
                   name + "_clusters")
            fit = _CLUSTER_FIT[(name, plan, dev)] = out.value
        tried.append((plan, fit))
        if fit > 0:
            last_geometry[name] = (plan, fit)
            return plan
    raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters places no "
                       f"cluster of these geometries: {tried}")


# scalar and pointer slots of the scan kernels' launch (csrc/cycle.cuh
# `ScanArgs`): both lists are copied into the kernel's argument struct.
# The slots after `log_row` serve the pressure scan (K8) only; K5 and K6
# leave them 0 / NULL.
_SCAN_INTS = ("n_pad", "S", "n_real", "z_pad", "B", "num_to_find",
              "last_index", "lni0", "mode", "L", "n_oid", "carry_spread",
              "gate", "P", "ipa_on", "ic_inert", "tr_inert", "n_pods",
              "gang_score", "U", "vic_P")
_SCAN_PTRS = (_NODE_STATIC + _MUTABLE
              + ("scal", "req_scalar_p", "upd_scalar_p") + _CYCLE_MASKS
              + ("interpod_code",) + _CYCLE_COUNTS
              + ("interpod_tracked", "row", "profile_id", "w", "wtab",
                 "perms", "inv_perms", "oid_seq", "spread", "stats", "packed",
                 "carry_out", "seg_start", "gang", "gz", "log_node",
                 "log_row", "ghost_cpu", "ghost_mem", "ghost_eph",
                 "ghost_cnt", "vic_cpu", "vic_mem", "vic_eph", "vic_prio",
                 "vic_start", "vic_valid", "vic_violating", "pprio",
                 "carry_in", "agg_i64", "agg_f64", "agg_u8", "workspace"))


def _scan_launch(name, nodes, stack, last_index, last_node_index,
                 num_to_find, n_real, z_pad, weights, mode, perms, inv_perms,
                 oid_seq, carry_spread, mut0, s0, wtab, n_steps,
                 segments=None, gang_score=False, pressure=None, work=None):
    """Launch K5 (`schedule_batch`), K6 (`schedule_segments`) or K8
    (`pressure_batch`, whose extra pointers and packed output come in
    `pressure`), one thread-block cluster (`cluster_plan`, K8
    `pressure_plan`). A plan with its scratch in global memory takes the
    workspace kept in `work` under the plan (K8: one for a wave's chain of
    chunks), or a fresh one (K5 / K6: one a window). Returns (state, li,
    lni, spread, stats[5, B] int64, packed int32)."""
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
    row = _upload(stack.row.astype(np.int32), dev)
    prof = None
    if wtab is not None:
        pid = stack.profile_id if stack.profile_id is not None \
            else np.zeros(B, np.int64)
        prof = _upload(np.asarray(pid, np.int64), dev)
    w = _weight_row(weights, None, dev)
    oid = None if oid_seq is None \
        else _upload(oid_seq.astype(np.int32), dev)
    stats = torch.empty((5, B), dtype=I64, device=dev)
    if pressure is not None:
        packed = pressure["packed"]
    else:
        packed = torch.empty((4 if segments else 3) * B, dtype=I32,
                             device=dev)
    carry_out = torch.empty(2, dtype=I64, device=dev)
    if pressure is not None:
        plan = _cluster_geometry(name, lambda blocks: pressure_plan(
            n_pad, s_count, int(z_pad), blocks))
    else:
        plan = _cluster_geometry(name, lambda blocks: cluster_plan(
            n_pad, s_count, int(z_pad), carry_spread, blocks))
    workspace = None if work is None else work.get(plan)
    if workspace is None:
        workspace = plan.workspace(dev)
        if work is not None:
            work[plan] = workspace
    seg = {}
    if segments is not None:
        # one undo log of B entries for every block of the cluster (the
        # gang zone counts live in each block's shared memory)
        seg = {"seg_start": _t(segments[0], dev, torch.bool).contiguous(),
               "gang": _t(segments[1], dev, torch.bool).contiguous(),
               "log_node": torch.empty(plan.blocks * B, dtype=I32,
                                       device=dev),
               "log_row": torch.empty(plan.blocks * B, dtype=I32,
                                      device=dev)}
        if seg["seg_start"].shape[0] != B or seg["gang"].shape[0] != B:
            raise ValueError(f"{name}: seg_start/gang are not [B]")
    ptrs = dict(zip(_NODE_STATIC, static))
    ptrs.update(state)
    ptrs.update({"scal": scal, "req_scalar_p": req_scalar,
                 "upd_scalar_p": upd_scalar, "interpod_code": code,
                 "interpod_tracked": tracked, "row": row,
                 "profile_id": prof, "w": w, "wtab": wtab, "perms": perms,
                 "inv_perms": inv_perms, "oid_seq": oid, "spread": spread,
                 "stats": stats, "packed": packed, "carry_out": carry_out,
                 "workspace": workspace})
    ptrs.update(zip(_CYCLE_MASKS, masks))
    ptrs.update(zip(_CYCLE_COUNTS, counts))
    ptrs.update(seg)
    if pressure is not None:
        ptrs.update({k: v for k, v in pressure.items() if k != "vic_P"})
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
            "gang_score": int(bool(gang_score)), "U": U,
            "vic_P": 0 if pressure is None else int(pressure["vic_P"])}
    if perms is not None and perms.shape[1] != n_pad:
        raise ValueError(f"{name}: rotation rows must be n_pad wide")
    _launch(name, *_launch_arrays(ints, _SCAN_INTS, ptrs, _SCAN_PTRS, name),
            plan.geometry())
    spread_out = spread if carry_spread \
        else torch.zeros((), dtype=I64, device=dev)
    return state, carry_out[0], carry_out[1], spread_out, stats, packed


def schedule_batch(nodes, pods, last_index, last_node_index, num_to_find,
                   n_real, z_pad, weights=None, rotation=None, spread0=None,
                   rotation_pos=None, carry_in=None, wtab=None, mesh=None):
    """K5: the generic burst scan — one K2 cycle per pod, in order, each
    hit folded into the carried rows before the next pod. `pods` is a
    `PodStack` or the JAX [B, ...] dict; `rotation` = (perms[L, n_pad],
    inv_perms, oid_seq[B]) and `rotation_pos` = (pos[L, n_pad],
    oid_seq[B]) give each cycle's enumeration; `spread0` [n_pad] carries
    selector-spread counts; `carry_in` = (state, spread) chains a previous
    window's device carry; `wtab` [P, K] with the stack's profile ids
    scores each pod with its own row. Returns (state, li, lni, spread,
    outs) as the JAX entry point; outs["packed"] is the [3B] int32 block
    selected | li after each pod | lni delta after each pod. With a
    `mesh` the node axis is split over its devices (`nodes`: per-shard
    dicts, or one whole dict): each live pod is a step of K10a on every
    shard, an all-gather and K10b on every device
    (`parallel.sharding.sharded_scan`); state and spread come back per
    shard."""
    weights = weights or DEFAULT_WEIGHTS
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_scan(mesh, nodes, pods, last_index,
                              last_node_index, num_to_find, n_real, z_pad,
                              weights=weights, rotation=rotation,
                              spread0=spread0, rotation_pos=rotation_pos,
                              carry_in=carry_in, wtab=wtab)
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
                            gang_score=False, mesh=None):
    """K6: the fused drain window — K5's step over the first `n_pods` pods
    with a checkpoint of the live carry at each `seg_start` and an
    in-kernel rewind when a `gang` member finds no node (the rest of its
    segment is skipped). `gang_score` carries the rank-aware zone counts
    of the current gang. Returns (state, li, lni, spread, packed[4B]) as
    the JAX entry point: selected | li_after | lni delta | consumed
    enumerations t, -1 past n_pods. With a `mesh`: K11a on every shard,
    an all-gather and K11b on every device per pod
    (`parallel.sharding.sharded_segments`), the gang checkpoint per
    shard; state and spread come back per shard."""
    weights = weights or DEFAULT_WEIGHTS
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_segments(
            mesh, nodes, pods, seg_start, gang, n_pods, last_index,
            last_node_index, num_to_find, n_real, z_pad, weights=weights,
            rotation=rotation, rotation_pos=rotation_pos, spread0=spread0,
            wtab=wtab, gang_score=gang_score)
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


# ---------------------------------------------------------------------------
# K7 preempt_scan — victim selection on every node at once + the node pick
# ---------------------------------------------------------------------------
#: victim slots per node (>= the AllowedPodNumber cap of 110)
PREEMPT_P = 128
#: the pick's mask fill: larger than any order rank
_BIGR = 1 << 60
#: the victim planes, in the order the kernels take them
VICTIM_PLANES = ("cpu", "mem", "eph", "prio", "start", "valid", "violating")


def _victim_select_plain(nodes, vic, valid_v, req_cpu, req_mem, req_eph,
                         ghost, feas_static, check_res, has_req):
    """selectVictimsOnNode over every node at once (`_victim_select`,
    kernels.py:1494): remove every masked victim (`valid_v` [N, P]), check
    the fit, then re-add the slots in order and keep each one that still
    fits (the reprieve loop). `ghost` ({cpu, mem, eph, cnt} [N] or None)
    adds nominated load that no removal frees. Returns (feas0[N],
    victims[N, P], aggregates for the pick)."""
    cr = bool(_host(check_res))
    hr = bool(_host(has_req)) and cr
    req_cpu, req_mem, req_eph = (int(np.asarray(_host(v)))
                                 for v in (req_cpu, req_mem, req_eph))
    nvic_all = torch.sum(valid_v.to(I64), dim=1)
    base_cpu = nodes["req_cpu"] - torch.sum(
        torch.where(valid_v, vic["cpu"], 0), dim=1)
    base_mem = nodes["req_mem"] - torch.sum(
        torch.where(valid_v, vic["mem"], 0), dim=1)
    base_eph = nodes["req_eph"] - torch.sum(
        torch.where(valid_v, vic["eph"], 0), dim=1)
    base_cnt = nodes["pod_count"] - nvic_all
    if ghost is not None:
        base_cpu = base_cpu + ghost["cpu"]
        base_mem = base_mem + ghost["mem"]
        base_eph = base_eph + ghost["eph"]
        base_cnt = base_cnt + ghost["cnt"]

    def fits(rc, rm, re, pc):
        f = torch.ones(rc.shape, dtype=torch.bool, device=rc.device)
        if cr:
            f &= pc + 1 <= nodes["allowed_pods"]
        if hr:
            f &= ((nodes["alloc_cpu"] >= req_cpu + rc)
                  & (nodes["alloc_mem"] >= req_mem + rm)
                  & (nodes["alloc_eph"] >= req_eph + re))
        return f

    feas0 = feas_static & fits(base_cpu, base_mem, base_eph, base_cnt)
    rc, rm, re, pc = base_cpu, base_mem, base_eph, base_cnt
    cols = []
    for s in range(valid_v.shape[1]):
        vval = valid_v[:, s]
        nrc, nrm, nre = (rc + vic["cpu"][:, s], rm + vic["mem"][:, s],
                         re + vic["eph"][:, s])
        npc = pc + vval.to(I64)
        keep = fits(nrc, nrm, nre, npc) & vval & feas0
        rc, rm, re, pc = (torch.where(keep, nrc, rc),
                          torch.where(keep, nrm, rm),
                          torch.where(keep, nre, re),
                          torch.where(keep, npc, pc))
        cols.append(vval & ~keep)
    victims = torch.stack(cols, dim=1) & feas0[:, None]
    prio = vic["prio"]
    nv = torch.sum(victims.to(I64), dim=1)
    viol_ct = torch.sum((victims & vic["violating"]).to(I64), dim=1)
    first_idx = torch.argmax(victims.to(torch.uint8), dim=1)
    first_prio = torch.gather(prio, 1, first_idx[:, None])[:, 0]
    sum_prio = torch.sum(torch.where(victims, prio + (1 << 31), 0), dim=1)
    high = torch.amax(torch.where(victims, prio, I64_MIN), dim=1)
    earliest_high = torch.amin(
        torch.where(victims & (prio == high[:, None]), vic["start"],
                    float("inf")), dim=1)
    return feas0, victims, {"nv": nv, "viol_ct": viol_ct,
                            "first_prio": first_prio, "sum_prio": sum_prio,
                            "earliest_high": earliest_high}


def _pick_one_node_plain(feas0, agg, order_rank) -> int:
    """pickOneNodeForPreemption (`_pick_one_node`, kernels.py:1570): a
    zero-victim candidate wins at once; else the staged minimum of PDB
    violations, first victim's priority, sum of (priority + 2**31),
    victim count and -(earliest start among the highest-priority
    victims), each compared in float64 as JAX does; ties go to the lowest
    `order_rank`. -1 when no node is a candidate."""
    rank = order_rank.to(I64)

    def argmin_rank(mask):
        return int(torch.argmin(torch.where(mask, rank, _BIGR)))

    zerov = feas0 & (agg["nv"] == 0)
    m = _staged_filter_plain(feas0, agg)
    winner = argmin_rank(zerov) if bool(zerov.any()) else argmin_rank(m)
    return winner if bool(feas0.any()) else -1


def _pick_criteria(agg) -> list:
    """The five criteria of the pick, as JAX converts them to float64:
    PDB violations, first victim's priority, sum of (priority + 2**31),
    victim count, -(earliest start among the highest-priority victims)."""
    return [agg["viol_ct"].double(), agg["first_prio"].double(),
            agg["sum_prio"].double(), agg["nv"].double(),
            -agg["earliest_high"]]


def _staged_filter_plain(feas0, agg) -> torch.Tensor:
    """The rows of `feas0` tied at the staged minimum of the five
    criteria (`_pick_one_node`'s loop): their lexicographic minimum."""
    inf = float("inf")
    m = feas0.clone()
    for crit in _pick_criteria(agg):
        c = torch.where(m, crit, inf)
        m &= c == torch.min(c)
    return m


def _preempt_scan_core_plain(nodes, vic, pod, feas_static, order_rank,
                             n_real, max_prio, check_res, has_req):
    """`_preempt_scan_core` (kernels.py:1598): this preemptor's victim mask
    (slot priority < max_prio), the scan, the pick, and the packed [3+P]
    int32 block: winner, its victim count, its PDB-violation count, its
    slot flags."""
    dev = vic["prio"].device
    n_pad = vic["prio"].shape[0]
    in_range = torch.arange(n_pad, device=dev) < int(n_real)
    valid_v = vic["valid"] & (vic["prio"] < int(max_prio))
    feas0, victims, agg = _victim_select_plain(
        nodes, vic, valid_v, pod["req_cpu"], pod["req_mem"],
        pod["req_eph"], None, feas_static & in_range, check_res, has_req)
    winner = _pick_one_node_plain(feas0, agg, order_rank)
    w = max(winner, 0)
    head = torch.tensor([winner, _wrap32(int(agg["nv"][w])),
                         _wrap32(int(agg["viol_ct"][w]))], dtype=I32,
                        device=dev)
    return torch.cat([head, victims[w].to(I32)])


def _vic_tensors(vic, device) -> dict:
    """The seven victim planes as contiguous tensors on `device`, in the
    kernels' dtypes (int64, start float64, valid/violating bool)."""
    dt = {"start": torch.float64, "valid": torch.bool,
          "violating": torch.bool}
    return {k: _t(vic[k], device, dt.get(k, I64)).contiguous()
            for k in VICTIM_PLANES}


def preemption_scan_plain(nodes, vic, pod, feas_static, order_rank, n_real,
                          check_resources, has_request, max_prio):
    """Plain version of K7, the JAX `preemption_scan` entry point
    (kernels.py:1627, `mesh=` left out): the packed [3+P] int32 block."""
    dev = nodes["alloc_cpu"].device
    vic = _vic_tensors(vic, dev)
    return _preempt_scan_core_plain(
        nodes, vic, pod, _t(feas_static, dev, torch.bool),
        _t(order_rank, dev, I64), n_real, max_prio, check_resources,
        has_request)


# scalar and pointer slots of K7's launch (csrc/preempt_scan.cu
# `PreemptArgs`)
_PREEMPT_INTS = ("n_pad", "P", "n_real", "max_prio", "cr", "hr", "req_cpu",
                 "req_mem", "req_eph", "blocks")
_PREEMPT_PTRS = ("alloc_cpu", "alloc_mem", "alloc_eph", "allowed_pods",
                 "req_cpu", "req_mem", "req_eph", "pod_count") + tuple(
    "vic_" + k for k in VICTIM_PLANES) + ("feas", "rank", "records",
                                         "ticket", "out")
#: threads of a K7 block (`K7_THREADS`, csrc/preempt_scan.cu): two warps,
#: a thread a node, 32 consecutive nodes a warp at a time
PREEMPT_THREADS = 64
#: int64 words of a K7 block's record (`K7_WORDS`, csrc/preempt_scan.cu):
#: the pick (`PK_WORDS`, csrc/victim.cuh: 9), then its best node's slot
#: flags, PREEMPT_P bits
PREEMPT_RECORD_WORDS = 9 + PREEMPT_P // 64


@dataclasses.dataclass(frozen=True)
class PreemptGrid:
    """The geometry of one K7 launch: `blocks` blocks of PREEMPT_THREADS
    threads on a card of `sms` SMs that holds `per_sm` K7 blocks on each
    at once. The record array holds one record for each block the card
    holds at once (`fit`), so it serves every grid of the card."""
    blocks: int
    sms: int
    per_sm: int

    @property
    def fit(self) -> int:
        return self.sms * self.per_sm

    @property
    def records_bytes(self) -> int:
        """Bytes of the card's record array: PREEMPT_RECORD_WORDS int64
        words for each block it holds at once."""
        return 8 * PREEMPT_RECORD_WORDS * self.fit


def preempt_grid(n_pad: int, sms: int, per_sm: int) -> PreemptGrid:
    """K7's grid over `n_pad` node slots: every block the card holds at
    once (its SM count times the blocks an SM holds, from the occupancy
    query), fewer only when the nodes run out first (a warp takes 32
    consecutive nodes); the warps take such groups with a grid stride, so
    the grid never grows with n_pad. Raises when the card holds no K7
    block."""
    if int(sms) * int(per_sm) < 1:
        raise RuntimeError(f"preempt_scan: the card holds no block of "
                           f"{PREEMPT_THREADS} threads ({sms} SMs, "
                           f"{per_sm} blocks an SM)")
    warps = PREEMPT_THREADS // 32
    need = max(1, -(-int(n_pad) // (32 * warps)))
    return PreemptGrid(min(int(sms) * int(per_sm), need), int(sms),
                       int(per_sm))


#: K7's occupancy and scratch on each device: (SMs, blocks an SM holds,
#: the record array, the ticket)
_PREEMPT_CARD: dict = {}


def _preempt_occupancy() -> tuple:
    """(SMs, K7 blocks an SM holds at once) of the current device."""
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _check(_build.load("preempt_scan").preempt_scan_occupancy(
        ctypes.byref(sms), ctypes.byref(per_sm)), "preempt_scan_occupancy")
    return sms.value, per_sm.value


def _preempt_card(dev) -> tuple:
    """(SMs, blocks an SM holds, record array, ticket) of K7 on `dev`,
    made once a device: the occupancy query, the records of every block
    the card holds at once, and the ticket the blocks draw, zeroed here
    only (each launch's last block puts it back to 0; launches on one
    stream run one after another)."""
    key = str(dev)
    card = _PREEMPT_CARD.get(key)
    if card is None:
        with _on(dev):
            sms, per_sm = _preempt_occupancy()
        grid = preempt_grid(1, sms, per_sm)
        card = _PREEMPT_CARD[key] = (
            sms, per_sm,
            torch.empty(grid.records_bytes // 8, dtype=I64, device=dev),
            torch.zeros(1, dtype=I32, device=dev))
    return card


def _preempt_launch(nodes, vic, pod, feas_static, order_rank, n_real,
                    check_resources, has_request, max_prio):
    """Launch K7: one grid-wide launch (`preempt_grid`), its record array
    and ticket the device's (`_preempt_card`)."""
    dev = nodes["alloc_cpu"].device
    vic = _vic_tensors(vic, dev)
    n_pad, P = (int(x) for x in vic["prio"].shape)
    if not 1 <= P <= PREEMPT_P:
        raise ValueError(f"preempt_scan: {P} victim slots, a record's "
                         f"flags hold 1 to {PREEMPT_P}")
    ptrs = {k: nodes[k] for k in _PREEMPT_PTRS[:8]}
    ptrs.update({"vic_" + k: v for k, v in vic.items()})
    ptrs["feas"] = _t(feas_static, dev, torch.bool).contiguous()
    ptrs["rank"] = _t(order_rank, dev, I64).contiguous()
    if any(v.shape[0] != n_pad for v in ptrs.values()):
        raise ValueError("preempt_scan: node rows, victim planes, "
                         "feas_static and order_rank differ in n_pad")
    _require_cuda("preempt_scan", *ptrs.values())
    sms, per_sm, ptrs["records"], ptrs["ticket"] = _preempt_card(dev)
    grid = preempt_grid(n_pad, sms, per_sm)
    last_geometry["preempt_scan"] = (grid, grid.fit)
    out = ptrs["out"] = torch.empty(3 + P, dtype=I32, device=dev)
    cr = bool(_host(check_resources))
    ints = {"n_pad": n_pad, "P": P, "n_real": int(n_real),
            "max_prio": int(max_prio), "cr": int(cr),
            "hr": int(bool(_host(has_request)) and cr),
            "blocks": grid.blocks}
    ints.update({k: int(np.asarray(_host(pod[k])))
                 for k in ("req_cpu", "req_mem", "req_eph")})
    with _on(dev):
        _launch("preempt_scan", *_launch_arrays(
            ints, _PREEMPT_INTS, ptrs, _PREEMPT_PTRS, "preempt_scan"))
    return out


def preemption_scan(nodes, vic, pod, feas_static, order_rank, n_real,
                    check_resources, has_request, max_prio, mesh=None):
    """K7: one preemptor's victim scan over every node at once. `vic` holds
    the [N, P] slot planes of the persistent victim table (every snapshot
    pod in reprieve order; slots of priority >= `max_prio` are masked out
    on the device); `feas_static` [N] the candidate nodes that pass the
    pod's non-resource predicates; `order_rank` [N] the candidate order
    (ties of the pick go to the lowest). Returns the packed [3+P] int32
    block: winner row (-1 = no candidate), its victim count and
    PDB-violation count, its per-slot victim flags. With a `mesh` the
    node rows, victim planes, `feas_static` and `order_rank` split on the
    node axis (`nodes` / `vic`: per-shard dicts, or whole ones): K14a on
    every shard, an all-gather of the shards' candidate records and K14b
    on every device (`parallel.sharding.sharded_preempt`)."""
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_preempt(mesh, nodes, vic, pod, feas_static,
                                 order_rank, n_real, check_resources,
                                 has_request, max_prio)
    if not nodes["alloc_cpu"].is_cuda:
        return preemption_scan_plain(nodes, vic, pod, feas_static,
                                     order_rank, n_real, check_resources,
                                     has_request, max_prio)
    return _preempt_launch(nodes, vic, pod, feas_static, order_rank, n_real,
                           check_resources, has_request, max_prio)


# ---------------------------------------------------------------------------
# K8 pressure_batch — schedule-else-preempt over a failed burst tail
# ---------------------------------------------------------------------------
#: the nine per-node masks a preemption winner must pass outright
_PRESSURE_MASKS = ("sel_ok", "taints_ok", "unsched_ok", "host_ok",
                   "ports_ok", "disk_ok", "maxvol_ok", "volbind_ok",
                   "volzone_ok")
#: the nominated-ghost load the pressure scan carries
GHOST_FIELDS = ("cpu", "mem", "eph", "cnt")
#: head columns of a pod's row of the packed [B, 5+P] int32 block; the
#: winner's P slot flags follow
PRESSURE_HEAD = ("selected", "winner", "any_cand", "li_after", "lni_delta")


def _resolvable_candidates_plain(fail_first, general_bits):
    """nodesWherePreemptionMightHelp from the cycle's fail codes
    (`_resolvable_candidates`, kernels.py:1675): a node is no candidate
    when its FIRST failing predicate is unresolvable; GENERAL counts as
    unresolvable when it carries the host-name or selector bit."""
    ff = fail_first.to(I64)
    gb = general_bits.to(I64)
    unresolv = ((ff == FAIL_UNSCHEDULABLE) | (ff == FAIL_TAINTS)
                | (ff == FAIL_VOLZONE) | (ff == FAIL_VOLBIND)
                | ((ff == FAIL_GENERAL)
                   & ((((gb >> BIT_HOST) & 1) | ((gb >> BIT_SELECTOR) & 1))
                      != 0)))
    return ~unresolv


def _pressure_core_plain(nodes, stack, mut0, ghost0, vic, last_index,
                         last_node_index, num_to_find, n_real, z_pad,
                         weights):
    """`_pressure_core` (kernels.py:1690), identity walk: per pod, the K2
    cycle with the carried ghost in the filter; the fold of a hit; the
    victim scan of every node on the rows BEFORE this pod's fold, with
    this pod's mask (slot priority < pprio), the ghost and the pod's
    static masks; the pick by axis index; the ghost fold of a
    preemption. Every pod, bound and skip ones too, emits the victim
    flags of row max(winner_raw, 0), as JAX does."""
    dev = nodes["valid"].device
    static = {k: v for k, v in nodes.items() if k not in _MUTABLE}
    mut = {k: mut0[k].clone() for k in _MUTABLE}
    ghost = {k: _t(ghost0[k], dev, I64).clone() for k in GHOST_FIELDS}
    n_pad = static["valid"].shape[0]
    in_range = torch.arange(n_pad, device=dev) < int(n_real)
    axis_rank = torch.arange(n_pad, dtype=I64, device=dev)
    li, lni = int(last_index), int(last_node_index)
    B = len(stack)
    P = int(vic["prio"].shape[1])
    packed = torch.zeros((B, len(PRESSURE_HEAD) + P), dtype=I32,
                         device=dev)
    for b in range(B):
        pod = stack.pod(b)
        skip = bool(pod["skip"])
        full = {**static, **mut}
        if skip:
            out = _skip_cycle(li, lni, n_real)
            resolvable = False
        else:
            out = _cycle_core_plain(full, pod, li, lni, num_to_find, n_real,
                                    weights, z_pad, ghost=ghost)
            resolvable = bool((in_range & _resolvable_candidates_plain(
                out["fail_first"], out["general_bits"])).any())
        sel, hit = int(out["selected"]), int(out["found"]) > 0
        feas_stat = in_range & static["valid"]
        for key in _PRESSURE_MASKS:
            feas_stat = feas_stat & pod[key].to(torch.bool)
        feas_stat = feas_stat & (pod["interpod_code"] == 0)
        valid_k = vic["valid"] & (vic["prio"] < int(pod["pprio"]))
        feas0, victims, agg = _victim_select_plain(
            full, vic, valid_k, pod["req_cpu"], pod["req_mem"],
            pod["req_eph"], ghost, feas_stat, pod["check_resources"],
            pod["has_request"])
        winner_raw = _pick_one_node_plain(feas0, agg, axis_rank)
        any_cand = resolvable and not hit and not skip
        preempted = not hit and not skip and winner_raw >= 0
        winner = -2 if hit else (-1 if skip else winner_raw)
        w = max(winner_raw, 0)
        if hit:
            _fold_state_plain(mut, pod, sel)
        if preempted:
            ghost["cpu"][w] += pod["upd_cpu"]
            ghost["mem"][w] += pod["upd_mem"]
            ghost["eph"][w] += pod["upd_eph"]
            ghost["cnt"][w] += 1
        nli, nlni = int(out["next_last_index"]), \
            int(out["next_last_node_index"])
        packed[b, :len(PRESSURE_HEAD)] = torch.tensor(
            [sel if hit else -1, winner, int(any_cand), _wrap32(nli),
             _wrap32(nlni - lni)], dtype=I32)
        packed[b, len(PRESSURE_HEAD):] = victims[w].to(I32)
        li, lni = nli, nlni
    return (mut, ghost, torch.tensor(li, dtype=I64, device=dev),
            torch.tensor(lni, dtype=I64, device=dev), _pressure_outs(packed))


def _pressure_outs(packed: torch.Tensor) -> dict:
    """The JAX entry point's per-pod outputs, in its dtypes, read off the
    packed [B, 5+P] block (which they keep as "packed")."""
    return {"selected": packed[:, 0].to(I64), "winner": packed[:, 1],
            "any_cand": packed[:, 2].to(torch.bool),
            "victims": packed[:, len(PRESSURE_HEAD):].to(torch.int8),
            "packed": packed}


def pressure_batch_plain(nodes, mut0, ghost0, pods, vic, last_index,
                         last_node_index, num_to_find, n_real, z_pad,
                         weights=None, out=None, work=None):
    """Plain version of K8, the JAX `pressure_batch` entry point
    (kernels.py:1768, `mesh=` left out): (mut, ghost, li, lni, outs) with
    outs per pod: selected (>= 0 bound row, -1 not bound), winner (-2
    bound, -1 no preemption, >= 0 nominated row), any_cand, victims [P]
    int8, and "packed", the [B, 5+P] int32 block of the same (see
    PRESSURE_HEAD). `pods` is a `PodStack` or the JAX [B, ...] dict, with
    `pprio` the preemptor priorities; `out`, a [B, 5+P] int32 tensor,
    receives the packed block. `work` (the kernel's workspace cache, as
    `pressure_batch` takes it) is unused: the plain version needs none."""
    dev = nodes["valid"].device
    stack = pods if isinstance(pods, PodStack) \
        else PodStack.from_dense(pods, dev)
    res = _pressure_core_plain(
        nodes, stack, mut0, ghost0, _vic_tensors(vic, dev),
        int(np.asarray(_host(last_index))),
        int(np.asarray(_host(last_node_index))), int(num_to_find),
        int(n_real), z_pad, weights or DEFAULT_WEIGHTS)
    if out is not None:
        out.copy_(res[4]["packed"])
        res = res[:4] + (_pressure_outs(out),)
    return res


def _pressure_launch(nodes, mut0, ghost0, stack, vic, last_index,
                     last_node_index, num_to_find, n_real, z_pad, weights,
                     out, work):
    dev = nodes["valid"].device
    vic = _vic_tensors(vic, dev)
    n_pad, P = (int(x) for x in vic["prio"].shape)
    B = len(stack)
    if out is None:
        out = torch.empty((B, len(PRESSURE_HEAD) + P), dtype=I32,
                          device=dev)
    if tuple(out.shape) != (B, len(PRESSURE_HEAD) + P) \
            or out.dtype != I32 or not out.is_contiguous():
        raise ValueError("pressure_batch: out must be a contiguous "
                         f"[{B}, {len(PRESSURE_HEAD) + P}] int32 tensor")
    if "pprio" not in stack.table:
        raise ValueError("pressure_batch: the pods carry no pprio")
    if isinstance(last_index, torch.Tensor) \
            and isinstance(last_node_index, torch.Tensor):
        carry_in = torch.stack([last_index.to(I64).reshape(()),
                                last_node_index.to(I64).reshape(())])
    else:
        carry_in = _upload(np.asarray(
            [int(np.asarray(_host(last_index))),
             int(np.asarray(_host(last_node_index)))], np.int64), dev)
    # the ghost folds land in fresh vectors, as the rows do
    ghost = {k: _t(ghost0[k], dev, I64).clone().contiguous()
             for k in GHOST_FIELDS}
    U = int(stack.table["skip"].shape[0])
    extra = {"ghost_" + k: v for k, v in ghost.items()}
    extra.update({"vic_" + k: v for k, v in vic.items()})
    extra.update({
        "pprio": stack.table["pprio"].to(I64).reshape(U).contiguous(),
        "carry_in": carry_in,
        "packed": out, "vic_P": P})
    # the victim scan's aggregates, where the plan keeps them in global
    # memory (i64 [4, n_pad], f64 [n_pad], the candidate byte [n_pad])
    extra.update(zip(("agg_i64", "agg_f64", "agg_u8"),
                     _agg_planes(n_pad, dev, 1)))
    state, li, lni, _spread, _stats, _packed = _scan_launch(
        "pressure_batch", nodes, stack, 0, 0, num_to_find, n_real, z_pad,
        weights, 0, None, None, None, False, mut0, None, None, B,
        pressure=extra, work=work)
    return state, ghost, li, lni, _pressure_outs(out)


def pressure_batch(nodes, mut0, ghost0, pods, vic, last_index,
                   last_node_index, num_to_find, n_real, z_pad,
                   weights=None, out=None, mesh=None, work=None):
    """K8: schedule-else-preempt a failed burst tail in one launch. `nodes`
    is the resident matrix, `mut0` the carried mutable rows, `ghost0` the
    carried nominated load ({cpu, mem, eph, cnt} [n_pad]), `pods` a
    `PodStack` or the JAX [B, ...] dict (with `pprio` and the fold
    deltas), `vic` the victim planes. last_index / last_node_index may be
    ints or the previous chunk's device scalars, so chunks chain on the
    card without a host round trip. Returns (mut, ghost, li, lni, outs) as
    the plain version; `out` receives the packed [B, 5+P] block. With a
    `mesh` the mutable rows, the ghost load and the victim planes split on
    the node axis (per-shard lists, or whole dicts): one step per pod of
    K13a on every shard, the all-gather and K13b on every device
    (`parallel.sharding.sharded_pressure`); mut and ghost come back per
    shard. `work` (a dict the caller keeps for a wave's chunks) holds the
    cluster's global scratch workspace across the chain, where the plan
    needs one."""
    weights = weights or DEFAULT_WEIGHTS
    if mesh is not None:
        from kubernetes_tpu_torch.parallel import sharding as S
        return S.sharded_pressure(mesh, nodes, mut0, ghost0, pods, vic,
                                  last_index, last_node_index, num_to_find,
                                  n_real, z_pad, weights=weights, out=out)
    dev = nodes["valid"].device
    stack = pods if isinstance(pods, PodStack) \
        else PodStack.from_dense(pods, dev)
    if not nodes["valid"].is_cuda:
        return pressure_batch_plain(nodes, mut0, ghost0, stack, vic,
                                    last_index, last_node_index,
                                    num_to_find, n_real, z_pad,
                                    weights=weights, out=out)
    return _pressure_launch(nodes, mut0, ghost0, stack, vic, last_index,
                            last_node_index, num_to_find, n_real, z_pad,
                            weights, out, work)


# ---------------------------------------------------------------------------
# K9 node-axis sharding: shard-local passes and replicated selects
# ---------------------------------------------------------------------------
# `parallel/sharding.py` drives these: each shard runs K9a (cycle) or K9c
# (uniform pass) on the rows it owns, on its own device; the small
# per-row records ride an all-gather; every device runs K9b or K9d on the
# gathered records, so all of them reach the same decision.

#: planes of K9a's per-row record, in layout order: the row-local score and
#: the raw inputs the kept-set normalizations need (a plane is present only
#: when its family runs dense), the in-range feasible bit, the tracked bit
_REC_PLANES = (("local", I64), ("na", I64), ("tt", I64), ("sc", I64),
               ("ic", I64), ("zone", I32), ("feas", torch.uint8),
               ("tracked", torch.uint8))
#: pod field of each raw-input plane
_REC_FIELD = {"na": "node_aff_counts", "tt": "taint_counts",
              "sc": "spread_counts", "ic": "interpod_counts",
              "tracked": "interpod_tracked"}
# slots of the uniform pass state each device keeps (K9d writes it, the
# shards on that device read it): done, lni, pass, lanes to fold, lni0,
# then the K lanes' nodes
ST_DONE, ST_LNI, ST_PASS, ST_VFOLD, ST_LNI0, ST_LANES = range(6)


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def cycle_record_planes(pod, weights) -> tuple:
    """The planes of the cycle record for `pod` (the whole, unsharded
    host dict: a shard's slice of a dense field can look inert)."""
    on = {"na": weights["node_affinity"], "tt": weights["taint_toleration"],
          "sc": weights["selector_spread"]}
    dense = {k: not _inert(pod[f] if hasattr(pod[f], "ndim")
                           else np.asarray(pod[f]))
             for k, f in _REC_FIELD.items()}
    ipa_on = bool(weights["interpod"]) and cycle_ipa_on(pod)
    planes = ["local"] + [k for k in ("na", "tt", "sc") if on[k] and dense[k]]
    if ipa_on and dense["ic"]:
        planes.append("ic")
    if on["sc"] and dense["sc"]:
        planes.append("zone")
    planes.append("feas")
    if ipa_on and dense["tracked"]:
        planes.append("tracked")
    return tuple(planes)


def cycle_ipa_on(pod) -> bool:
    """Whether the inter-pod family's fields are not both inert (the
    family then runs, an inert side broadcasting its one element)."""
    return any(not _inert(pod[f] if hasattr(pod[f], "ndim")
                          else np.asarray(pod[f]))
               for f in ("interpod_counts", "interpod_tracked"))


def record_layout(planes, rows: int):
    """({plane: byte offset in a shard's record}, record bytes) for `rows`
    rows; i64 planes first, so every plane is aligned."""
    off, o = {}, 0
    for name, dt in _REC_PLANES:
        if name in planes:
            off[name] = o
            o += rows * torch.empty((), dtype=dt).element_size()
    return off, _round8(o)


def _pack_record(vals: dict, planes, rows: int, dev) -> torch.Tensor:
    off, nbytes = record_layout(planes, rows)
    rec = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    dts = dict(_REC_PLANES)
    for name, o in off.items():
        v = vals[name].to(dts[name]).reshape(rows).contiguous()
        b = v.view(torch.uint8)
        rec[o: o + b.numel()] = b
    return rec


def unpack_records(gathered: torch.Tensor, planes, rows: int) -> dict:
    """The flat [D * rows] tensor of every plane of a gathered [D, bytes]
    record buffer."""
    off, _ = record_layout(planes, rows)
    dts = dict(_REC_PLANES)
    out = {}
    for name, o in off.items():
        size = torch.empty((), dtype=dts[name]).element_size()
        b = gathered[:, o: o + rows * size].contiguous()
        out[name] = b.view(dts[name]).reshape(-1)
    return out


def _require_on(name: str, device, *tensors) -> None:
    """Every tensor argument of a shard launch lives on the device that
    launches it: a kernel launched for another card's tensors would read
    them over NVLink (or fault) instead of running where they live."""
    device = torch.device(device)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(f"{name}: a tensor on {t.device} given to a "
                             f"launch on {device}")


def _on(device):
    """The device guard of a launch (a no-op off CUDA)."""
    import contextlib
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---- K9a shard_cycle_local --------------------------------------------------
def shard_cycle_local_plain(nodes, pod, offset, n_real, weights, planes,
                            wrow=None, ghost=None):
    """K9a plain: the shard-local part of `sharded_cycle_fn` (sharding.py
    :115) over one shard's rows — `_feasibility` (kernels.py:296), with
    the shard's slice of the nominated `ghost` load when given, and the
    row-local `_fit_scores` families (:157). Returns (feasible,
    fail_first, general_bits) of the shard's rows and its record (uint8:
    the `planes` of `cycle_record_planes`, `record_layout`)."""
    dev = nodes["valid"].device
    rows = nodes["valid"].shape[0]
    pod = {k: _t(v, dev) for k, v in pod.items()}
    feasible, fail_first, general_bits = _feasibility_plain(
        nodes, pod, ghost=_ghost_tensors(ghost, dev))
    in_range = torch.arange(rows, device=dev) + int(offset) < int(n_real)
    vals = {"local": _local_scores_plain(nodes, pod, weights, wrow=wrow),
            "zone": nodes["zone_id"], "feas": feasible & in_range}
    for k, f in _REC_FIELD.items():
        if k in planes:
            vals[k] = pod[f]
    return feasible, fail_first, general_bits, _pack_record(
        vals, planes, rows, dev)


_SCL_INTS = ("rows", "S", "offset", "n_real", "gate") + tuple(
    "off_" + n for n, _ in _REC_PLANES)
_SCL_PTRS = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
             "allowed_pods", "req_cpu", "req_mem", "req_eph", "nz_cpu",
             "nz_mem", "pod_count", "alloc_scalar", "req_scalar", "zone_id",
             "scal", "req_scalar_p") + _CYCLE_MASKS + ("interpod_code",) \
    + _CYCLE_COUNTS + ("interpod_tracked", "w", "feasible", "fail_first",
                       "general_bits", "rec") + tuple(
        "ghost_" + k for k in ("cpu", "mem", "eph", "cnt"))


def _shard_cycle_local_launch(nodes, pod, offset, n_real, weights, planes,
                              wrow, ghost):
    dev = nodes["valid"].device
    rows = int(nodes["valid"].shape[0])
    s_count = int(nodes["alloc_scalar"].shape[1])
    fields = {k: nodes[k] for k in _SCL_PTRS[:14]}
    _require_cuda("shard_cycle_local", *fields.values())
    if nodes["zone_id"].dtype != I32 or nodes["valid"].dtype != torch.bool:
        raise ValueError("shard_cycle_local: zone_id must be int32, "
                         "valid bool")
    pid = pod.get("profile_id", 0)
    scal = _pack_scalars([pod[k] for k in _CYCLE_SCALARS[:-1]] + [pid], dev)
    req_scalar = _t(pod["req_scalar"], dev, I64).contiguous()
    if req_scalar.numel() != s_count:
        raise ValueError("shard_cycle_local: req_scalar width != node "
                         "scalars")

    def dense(key, dtype):
        v = pod.get(key)
        if v is None or _inert(v):
            return None
        v = _t(v, dev, dtype).contiguous()
        if v.shape[-1] != rows:
            raise ValueError(f"shard_cycle_local: {key} is not the "
                             f"shard's [{rows}] slice")
        return v
    ptrs = dict(fields)
    ptrs.update({"scal": scal, "req_scalar_p": req_scalar,
                 "interpod_code": dense("interpod_code", torch.int8),
                 "interpod_tracked": dense("interpod_tracked", torch.bool),
                 "w": _weight_row(weights, wrow, dev)})
    ptrs.update({k: dense(k, torch.bool) for k in _CYCLE_MASKS})
    ptrs.update({k: dense(k, I64) for k in _CYCLE_COUNTS})
    for k, f in _REC_FIELD.items():
        if k in planes and ptrs[f] is None:
            raise ValueError(f"shard_cycle_local: plane {k} of an inert "
                             f"field")
    off, nbytes = record_layout(planes, rows)
    feasible = ptrs["feasible"] = torch.empty(rows, dtype=torch.bool,
                                              device=dev)
    fail_first = ptrs["fail_first"] = torch.empty(rows, dtype=torch.int8,
                                                  device=dev)
    general_bits = ptrs["general_bits"] = torch.empty(rows, dtype=I64,
                                                      device=dev)
    rec = ptrs["rec"] = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    ghost = _ghost_tensors(ghost, dev)
    if ghost is not None:
        if any(g.shape != (rows,) for g in ghost.values()):
            raise ValueError(f"shard_cycle_local: ghost is not the shard's "
                             f"[{rows}] slice")
        ptrs.update({"ghost_" + k: v for k, v in ghost.items()})
    _require_cuda("shard_cycle_local",
                  *[v for v in ptrs.values() if v is not None])
    _require_on("shard_cycle_local", dev, *ptrs.values())
    ints = {"rows": rows, "S": s_count, "offset": int(offset),
            "n_real": int(n_real), "gate": _gate(weights)}
    ints.update({"off_" + n: off.get(n, -1) for n, _ in _REC_PLANES})
    _launch("shard_cycle_local",
            *_launch_arrays(ints, _SCL_INTS, ptrs, _SCL_PTRS,
                            "shard_cycle_local"))
    return feasible, fail_first, general_bits, rec


def shard_cycle_local(nodes, pod, offset, n_real, weights, planes,
                      wrow=None, ghost=None):
    """K9a on one shard (`nodes`: its node dict, `pod`: its slice of the
    pod's per-node fields plus the replicated scalars; `offset`: the
    global index of its first row; `ghost`: its slice of the nominated
    load, or None). CPU tensors -> the plain version; CUDA tensors ->
    `csrc/shard_cycle_local.cu` on their device."""
    dev = nodes["valid"].device
    _require_on("shard_cycle_local", dev, *nodes.values(),
                *[v for v in pod.values() if isinstance(v, torch.Tensor)
                  and v.dim() and v.shape[-1] > 1], wrow,
                *(ghost or {}).values())
    if not nodes["valid"].is_cuda:
        return shard_cycle_local_plain(nodes, pod, offset, n_real, weights,
                                       planes, wrow=wrow, ghost=ghost)
    with _on(dev):
        return _shard_cycle_local_launch(nodes, pod, offset, n_real,
                                         weights, planes, wrow, ghost)


# ---- K9b shard_cycle_select -------------------------------------------------
def _select_pod(pod, dev) -> dict:
    """The replicated pod inputs of K9b: skip and the first element of
    each inter-pod field (what an inert field broadcasts; a dense one
    rides the gathered records)."""
    def first(v, dtype):
        return _t(np.asarray(_host(v)).reshape(-1)[:1], dev, dtype)
    return {"skip": bool(np.asarray(_host(pod["skip"]))),
            "interpod_counts": first(pod["interpod_counts"], I64),
            "interpod_tracked": first(pod["interpod_tracked"], torch.bool)}


def shard_cycle_select_plain(gathered, planes, rows, n_real, pod,
                             last_index, last_node_index, num_to_find,
                             weights, z_pad, wrow=None, perm=None,
                             inv_perm=None, pos=None, gang=None):
    """K9b plain: the replicated epilogue of `_cycle_core` (kernels.py
    :359) over the gathered records of every shard — the rotation walk,
    the normalizations over the evaluated (kept) set, the first-index
    argmax and the round-robin tie pick. `gang` = (gz, member) adds the
    rank-aware gang scores (the sharded fused window; the zone plane must
    be gathered). Returns (out[6] int64: selected, found, evaluated,
    max_score, next_last_index, next_last_node_index; total[n_pad];
    kept[n_pad])."""
    dev = gathered.device
    sp = _select_pod(pod, dev)
    vals = unpack_records(gathered, planes, rows)
    n_pad = vals["local"].shape[0]
    kept, found, evaluated = _walk_plain(
        vals["feas"] != 0, sp["skip"], last_index, num_to_find, n_real,
        perm=perm, inv_perm=inv_perm, pos=pos)
    inert = torch.zeros(1, dtype=I64, device=dev)
    kpod = {f: vals[k] if k in vals else inert
            for k, f in _REC_FIELD.items()}
    kpod["interpod_counts"] = vals["ic"] if "ic" in vals \
        else sp["interpod_counts"]
    kpod["interpod_tracked"] = vals["tracked"] != 0 if "tracked" in vals \
        else sp["interpod_tracked"]
    zone = vals["zone"] if "zone" in vals \
        else torch.zeros(n_pad, dtype=I32, device=dev)
    total = vals["local"] + _kept_scores_plain(kpod, kept, zone, weights,
                                               z_pad, wrow=wrow, gang=gang)
    r = _select_plain(kept, total, found, evaluated, last_index,
                      last_node_index, n_real, perm=perm, pos=pos)
    out = torch.stack([r[k] for k in (
        "selected", "found", "evaluated", "max_score", "next_last_index",
        "next_last_node_index")])
    return out, total, kept


_SCS_INTS = ("n_pad", "rows", "D", "chunk", "n_real", "z_pad",
             "last_index", "lni", "num_to_find", "mode", "gate", "skip",
             "ipa_on", "ic_inert", "tr_inert") + tuple(
    "off_" + n for n, _ in _REC_PLANES)
_SCS_PTRS = ("gathered", "w", "ic_b", "tr_b", "perm", "inv_perm", "pos",
             "total", "kept", "out", "recs", "workspace")


def _shard_cycle_select_launch(gathered, planes, rows, n_real, pod,
                               last_index, last_node_index, num_to_find,
                               weights, z_pad, wrow, perm, inv_perm, pos):
    """Launch K9b: one thread-block cluster (`select_plan`, as K10b) over
    the gathered records; records staged in global memory take a fresh
    staging area, scratch in global memory a fresh workspace."""
    dev = gathered.device
    D, chunk = (int(x) for x in gathered.shape)
    n_pad = D * int(rows)
    off, nbytes = record_layout(planes, rows)
    if nbytes != chunk:
        raise ValueError("shard_cycle_select: record size != layout")
    sp = _select_pod(pod, dev)
    ipa_on = bool(weights["interpod"]) and cycle_ipa_on(pod)
    mode = 0
    ptrs = {"gathered": gathered, "w": _weight_row(weights, wrow, dev)}
    if pos is not None:
        mode = 2
        ptrs["pos"] = _t(pos, dev, I32).contiguous()
    elif perm is not None:
        mode = 1
        ptrs["perm"] = _t(perm, dev, I32).contiguous()
        ptrs["inv_perm"] = _t(inv_perm, dev, I32).contiguous()
    if ipa_on and "ic" not in planes:
        ptrs["ic_b"] = sp["interpod_counts"].reshape(-1)[:1].contiguous()
    if ipa_on and "tracked" not in planes:
        ptrs["tr_b"] = sp["interpod_tracked"].reshape(-1)[:1].contiguous()
    plan = _cluster_geometry("shard_cycle_select", lambda blocks: select_plan(
        n_pad, int(z_pad), blocks))
    total = ptrs["total"] = torch.empty(n_pad, dtype=I64, device=dev)
    kept = ptrs["kept"] = torch.empty(n_pad, dtype=torch.bool, device=dev)
    out = ptrs["out"] = torch.empty(6, dtype=I64, device=dev)
    ptrs["recs"] = None if plan.resident else torch.empty(
        n_pad * _REC_SLOT_BYTES, dtype=torch.uint8, device=dev)
    ptrs["workspace"] = plan.workspace(dev)
    _require_cuda("shard_cycle_select", gathered)
    _require_on("shard_cycle_select", dev, *ptrs.values())
    ints = {"n_pad": n_pad, "rows": int(rows), "D": D, "chunk": chunk,
            "n_real": int(n_real), "z_pad": int(z_pad),
            "last_index": int(np.asarray(_host(last_index))),
            "lni": int(np.asarray(_host(last_node_index))),
            "num_to_find": int(num_to_find), "mode": mode,
            "gate": _gate(weights), "skip": int(sp["skip"]),
            "ipa_on": int(ipa_on), "ic_inert": int("ic" not in planes),
            "tr_inert": int("tracked" not in planes)}
    ints.update({"off_" + n: off.get(n, -1) for n, _ in _REC_PLANES})
    _launch("shard_cycle_select",
            *_launch_arrays(ints, _SCS_INTS, ptrs, _SCS_PTRS,
                            "shard_cycle_select"), plan.geometry())
    return out, total, kept


def shard_cycle_select(gathered, planes, rows, n_real, pod, last_index,
                       last_node_index, num_to_find, weights, z_pad,
                       wrow=None, perm=None, inv_perm=None, pos=None):
    """K9b on one device, over the [D, record bytes] gathered records.
    CPU -> the plain version; CUDA -> `csrc/shard_cycle_select.cu`, one
    thread-block cluster a cycle."""
    dev = gathered.device
    _require_on("shard_cycle_select", dev, wrow, perm, inv_perm, pos)
    if not gathered.is_cuda:
        return shard_cycle_select_plain(
            gathered, planes, rows, n_real, pod, last_index,
            last_node_index, num_to_find, weights, z_pad, wrow=wrow,
            perm=perm, inv_perm=inv_perm, pos=pos)
    with _on(dev):
        return _shard_cycle_select_launch(
            gathered, planes, rows, n_real, pod, last_index,
            last_node_index, num_to_find, weights, z_pad, wrow, perm,
            inv_perm, pos)


# ---- K9c shard_uniform_sweep ------------------------------------------------
class UniformShard:
    """One shard's state of a sharded uniform burst: its node slices, the
    carried fold rows `st` [R, width] (a fresh copy, folded in place),
    int32 scores `tot`, the ok / banned / feasible bytes `flags` [3,
    width], the last pass it folded, and its record `rec` (`rows` tie /
    stay bytes, then the int32 shard max and feasible count at `hoff`):
    `rec` when given (row s of its device's gathered buffer, where K9c
    writes it in place), else a buffer of its own. The last shard's width
    carries the n_pad scratch column, as the JAX program pads it onto the
    last shard: nothing is ever folded there."""

    def __init__(self, offset, rows, width, nodes, st, xa, sa, su, extra,
                 tot0, rec=None):
        dev = nodes["valid"].device
        self.offset, self.rows, self.width = int(offset), int(rows), \
            int(width)
        self.nodes = nodes
        self.st, self.xa, self.sa, self.su, self.extra = st, xa, sa, su, \
            extra
        self.tot0 = tot0
        self.tot = torch.zeros(width, dtype=I32, device=dev)
        self.flags = torch.zeros((3, width), dtype=torch.uint8, device=dev)
        self.folded = torch.zeros(1, dtype=I64, device=dev)
        self.hoff = _round8(rows)
        if rec is None:
            rec = torch.zeros(self.record_bytes(rows), dtype=torch.uint8,
                              device=dev)
        if rec.numel() != self.record_bytes(rows) or rec.device != dev:
            raise ValueError("UniformShard: rec is not the shard's record")
        self.rec = rec

    @staticmethod
    def record_bytes(rows: int) -> int:
        """Bytes of a shard's record: the tie / stay bytes, then the max
        and the feasible count (int32) at `hoff`."""
        return _round8(rows) + 8

    @property
    def device(self):
        return self.st.device

    def tensors(self) -> list:
        return [self.st, self.xa, self.sa, self.su, self.extra, self.tot0,
                self.tot, self.flags, self.folded, self.rec] + [
            self.nodes[k] for k in ("valid", "alloc_cpu", "alloc_mem",
                                    "allowed_pods")]


def _sweep_fold_plain(sh: UniformShard, state, clsv, R, NS, check_res,
                      has_req, ban, weights, wrow, n_real, init):
    """What both plain K9c versions do before the sweep: with `init`, the
    ok mask and the scores of the burst's first pass; then, once per pass
    (by the pass counter), the fold of the previous pass's accepted lanes
    that land on the shard (rows, score, ban). Returns (fit(plus, cols),
    score(plus, cols), the pass state's scalars)."""
    dev = sh.device
    rows, wd = sh.rows, sh.width
    cv = [int(x) for x in clsv.tolist()] if isinstance(clsv, torch.Tensor) \
        else list(clsv)
    req_cpu, req_mem, nz_cpu, nz_mem = cv[:4]
    delta = torch.tensor(cv[4: 4 + R], dtype=I64, device=dev)
    xreq = cv[4 + R: 4 + R + (R - 5)]
    sreq = cv[4 + R + (R - 5):]
    nd = sh.nodes

    def pad(v):
        return torch.cat([v, torch.zeros(wd - rows, dtype=v.dtype,
                                         device=dev)])
    a_cpu, a_mem, allowed = pad(nd["alloc_cpu"]), pad(nd["alloc_mem"]), \
        pad(nd["allowed_pods"])
    ok, banned = sh.flags[0], sh.flags[1]
    st = sh.st

    def fit(plus, cols):
        f = ok[cols] != 0
        if check_res:
            rv = st[:, cols]
            f = f & (rv[4] + plus * delta[4] + 1 <= allowed[cols])
            if has_req:
                f = f & (a_cpu[cols] >= req_cpu + rv[0] + plus * delta[0]) \
                    & (a_mem[cols] >= req_mem + rv[1] + plus * delta[1])
                for r in range(5, R):
                    f = f & (sh.xa[r - 5][cols] >= xreq[r - 5] + rv[r]
                             + plus * delta[r])
        return f

    def score(plus, cols):
        rv = st[:, cols]
        return local_total_plain(weights, nz_cpu + rv[2] + plus * delta[2],
                                 nz_mem + rv[3] + plus * delta[3],
                                 a_cpu[cols], a_mem[cols],
                                 wrow=wrow).to(I32)

    if init:
        o = nd["valid"] & (torch.arange(rows, device=dev) + sh.offset
                           < int(n_real))
        if sh.extra is not None:
            o = o & sh.extra
        for s in range(NS):
            o = o & ~(sh.sa[s, :rows] < sreq[s] + sh.su[s, :rows])
        ok.copy_(pad(o).to(torch.uint8))
        banned.zero_()
        sh.tot.copy_(pad(sh.tot0).to(I32))
    st_h = [int(x) for x in state[:ST_LANES].tolist()]
    if st_h[ST_PASS] > int(sh.folded[0]):
        lanes = state[ST_LANES: ST_LANES + st_h[ST_VFOLD]] - sh.offset
        loc = lanes[(lanes >= 0) & (lanes < rows)]
        st[:, loc] += delta[:, None]
        sh.tot[loc] = score(0, loc)
        if ban:
            banned[loc] = 1
        sh.folded[0] = st_h[ST_PASS]
    return fit, score, st_h


def shard_uniform_sweep_plain(sh: UniformShard, state, clsv, R, NS,
                              check_res, has_req, ban, weights, wrow,
                              n_real, n_pods, init):
    """K9c plain: one pass of `_uniform_core` (kernels.py:1097-1320) over
    one shard's rows. First the accepted lanes of the previous pass that
    land on this shard fold (rows, score, ban), once per pass; then, while
    the burst is not done, the sweep: the feasible rows, the shard's max
    score and feasible count, and per row a tie bit (feasible at the shard
    max) and a stay bit (after one more fold it still fits and keeps that
    score). A shard whose max is not the global one has no ties; every
    tie of the global max is a tie of its own shard's max. `init` builds
    the ok mask and the scores first (the burst's first pass). Updates
    the shard state in place."""
    fit, score, st_h = _sweep_fold_plain(sh, state, clsv, R, NS, check_res,
                                         has_req, ban, weights, wrow, n_real,
                                         init)
    if st_h[ST_DONE] >= int(n_pods):
        return
    rows = sh.rows
    cols = torch.arange(rows, device=sh.device)
    f = fit(0, cols)
    if ban:
        f = f & (sh.flags[1, :rows] == 0)
    sh.flags[2, :rows] = f.to(torch.uint8)
    tm = torch.where(f, sh.tot[:rows], I32_MIN)
    lmax = int(torch.max(tm))
    tie = f & (sh.tot[:rows] == lmax)
    stay = tie & (fit(1, cols) & (score(1, cols) == lmax)) if not ban \
        else torch.zeros_like(tie)
    sh.rec[:rows] = (tie.to(torch.uint8) | (stay.to(torch.uint8) << 1))
    sh.rec[sh.hoff:] = torch.tensor([lmax, int(f.sum())], dtype=I32,
                                    device=sh.device).view(torch.uint8)


#: blocks of a shard's K9c cluster, threads a block, shards a launch
#: (csrc/shard_uniform_sweep.cu `SWEEP_BLOCKS`, `SWEEP_THREADS`,
#: `SWEEP_GROUP`)
SWEEP_BLOCKS = 8
SWEEP_THREADS = 512
SWEEP_GROUP = 4


def sweep_chunk(width: int) -> int:
    """Columns of one block's slice of a shard's K9c cluster: block b owns
    [b * chunk, (b + 1) * chunk) of the shard's `width` columns, the last
    slices short or empty."""
    return -(-int(width) // SWEEP_BLOCKS)


def shard_uniform_sweep_group_plain(shards: list, state, clsv, R, NS,
                                    check_res, has_req, ban, weights, wrow,
                                    n_real, n_pods) -> None:
    """K9c plain over every shard of one device, as the kernel splits it:
    the burst's first pass (init) read from the pass state (ST_PASS 0);
    each shard's columns in SWEEP_BLOCKS slices (`sweep_chunk`; every
    lane lands in one, so the fold is the per-shard one), each slice's
    rows reduced to a max and a feasible count, the shard's max and count
    the combination of its slices'; every feasible row's stay bit asked
    against its own score (on a tie, the shard max's test), kept on the
    ties. Each record is written into `rec` of its shard (row s of the
    device's gathered buffer). Equal to `shard_uniform_sweep_plain` on
    each shard."""
    init = int(state[ST_PASS]) == 0
    for sh in shards:
        fit, score, st_h = _sweep_fold_plain(sh, state, clsv, R, NS,
                                             check_res, has_req, ban,
                                             weights, wrow, n_real, init)
        if st_h[ST_DONE] >= int(n_pods):
            continue
        rows = sh.rows
        cols = torch.arange(rows, device=sh.device)
        f = fit(0, cols)
        if ban:
            f = f & (sh.flags[1, :rows] == 0)
        sh.flags[2, :rows] = f.to(torch.uint8)
        t = sh.tot[:rows]
        stay = torch.zeros_like(f) if ban \
            else f & (score(1, cols) == t) & fit(1, cols)
        # each block's max and feasible count, then the shard's
        block = cols // sweep_chunk(sh.width)
        bmax = torch.full((SWEEP_BLOCKS,), I32_MIN, dtype=I32,
                          device=sh.device)
        bmax.scatter_reduce_(0, block, torch.where(f, t, I32_MIN), "amax")
        bcnt = torch.zeros(SWEEP_BLOCKS, dtype=I64, device=sh.device)
        bcnt.index_add_(0, block, f.to(I64))
        mx, F = bmax.max(), bcnt.sum()
        tie = f & (t == mx)
        sh.rec[:rows] = (tie.to(torch.uint8)
                         | ((tie & stay).to(torch.uint8) << 1))
        sh.rec[sh.hoff:] = torch.stack([mx, F.to(I32)]).view(torch.uint8)


_SUS_INTS = ("width", "rows", "offset", "n_real", "R", "NS", "check_res",
             "has_req", "ban", "gate", "B", "K", "hoff")
_SUS_PTRS = ("w", "valid", "extra", "alloc_cpu", "alloc_mem", "allowed",
             "xalloc", "salloc", "sused", "clsv", "st", "tot0", "tot",
             "flags", "state", "folded", "rec")


def _sweep_words(sh: UniformShard, state, clsv, R, NS, check_res, has_req,
                 ban, w, gate, n_real, n_pods):
    """(pointer tensors, words) of one shard's K9c struct: its
    `_SUS_INTS`, then its `_SUS_PTRS`."""
    nd = sh.nodes
    ptrs = {"w": w, "valid": nd["valid"], "extra": sh.extra,
            "alloc_cpu": nd["alloc_cpu"], "alloc_mem": nd["alloc_mem"],
            "allowed": nd["allowed_pods"], "xalloc": sh.xa,
            "salloc": sh.sa, "sused": sh.su, "clsv": clsv, "st": sh.st,
            "tot0": sh.tot0, "tot": sh.tot, "flags": sh.flags,
            "state": state, "folded": sh.folded, "rec": sh.rec}
    _require_cuda("shard_uniform_sweep", *ptrs.values())
    _require_on("shard_uniform_sweep", sh.device, *ptrs.values())
    ints = {"width": sh.width, "rows": sh.rows, "offset": sh.offset,
            "n_real": int(n_real), "R": R, "NS": NS,
            "check_res": int(check_res), "has_req": int(has_req),
            "ban": int(bool(ban)), "gate": gate, "B": int(n_pods),
            "K": K_BATCH, "hoff": sh.hoff}
    iargs, parr = _launch_arrays(ints, _SUS_INTS, ptrs, _SUS_PTRS,
                                 "shard_uniform_sweep")
    return ptrs, list(iargs) + [p or 0 for p in parr]


def shard_uniform_sweep(shards: list, state, clsv, R, NS, check_res,
                        has_req, ban, weights, wrow, n_real,
                        n_pods) -> Optional[Relaunch]:
    """K9c: one uniform pass over every shard of `shards`, all on one
    device (`state`: the pass state there; the burst's first pass is the
    one at ST_PASS 0), each record into its shard's `rec`. CPU -> the
    plain version (returns None); CUDA -> ONE launch of
    `csrc/shard_uniform_sweep.cu` over them (per SWEEP_GROUP shards),
    returning its `Relaunch` for the burst's next passes: the arguments
    are the same every pass."""
    dev = state.device
    for sh in shards:
        _require_on("shard_uniform_sweep", dev, *sh.tensors(), clsv, wrow)
    if not state.is_cuda:
        return shard_uniform_sweep_group_plain(
            shards, state, clsv, R, NS, check_res, has_req, ban, weights,
            wrow, n_real, n_pods)
    w = _weight_row(weights, wrow, dev)
    words, keep = [], [w]
    for sh in shards:
        ptrs, wd = _sweep_words(sh, state, clsv, R, NS, check_res, has_req,
                                ban, w, _gate(weights), n_real, n_pods)
        keep.append(ptrs)
        words += wd
    table = (ctypes.c_longlong * len(words))(*words)
    fn = getattr(_build.load("shard_uniform_sweep"),
                 "shard_uniform_sweep_launch")
    rel = Relaunch("shard_uniform_sweep", fn, (
        table, len(shards), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), (keep, table))
    _check(rel.fn(), "shard_uniform_sweep")
    rel.book()
    return rel


# ---- K9d shard_uniform_select -----------------------------------------------
def shard_uniform_select_plain(gathered, rows, hoff, state, out, lni_out,
                               owner, n_pods, cap, ban, perm=None,
                               oid_seq=None):
    """K9d plain: the replicated epilogue of one `_uniform_core` pass
    (kernels.py:1097-1320) over the gathered shard records: the global
    max (the largest shard max) and feasible count, the tie set (the tie
    bits of the shards at that max), the tie walk (`searchsorted` /
    `C_all[oid]` in each rotation order), the lane-0 STAY/ELIM probe, the
    K lanes' nodes, `first_bad`, the duplicate cut `first_dup` on the
    whole lane set, the accept cut `v`, and the emitted block. The lanes'
    fit and score after one more fold are the stay bits of their nodes'
    shards. Updates `state` (the lanes for the shards to fold), `out`
    [cap + K] and `lni_out` in place; a no-op once the burst is done.
    `owner` is the kernel's scatter-min scratch (unused here)."""
    dev = gathered.device
    k_batch = K_BATCH
    st_h = [int(x) for x in state[:ST_LANES].tolist()]
    done, lni = st_h[ST_DONE], st_h[ST_LNI]
    B = int(n_pods)
    if done >= B:
        return
    D = gathered.shape[0]
    n_pad = D * int(rows)
    n1 = n_pad + 1
    hdr = gathered[:, hoff: hoff + 8].contiguous().view(I32).reshape(D, 2)
    mx = int(hdr[:, 0].max())
    F = int(hdr[:, 1].to(I64).sum())
    bits = gathered[:, :rows]
    z1 = torch.zeros(1, dtype=torch.bool, device=dev)
    tie = torch.cat([(((bits & 1) != 0) & (hdr[:, 0] == mx)[:, None])
                     .reshape(-1), z1])
    stay = torch.cat([((bits >> 1) & 1).reshape(-1) != 0, z1])
    T = int(tie.sum())
    remaining = B - done
    kbig = (T >= 2) and (F > 1)
    jlane = torch.arange(k_batch, dtype=I64, device=dev)
    rotate = perm is not None

    def clamp_idx(idx):
        return torch.clamp(idx.long(), 0, n1 - 1)

    if rotate:
        perm_l = perm.long()
        start = min(max(done, 0), max(oid_seq.shape[0] - k_batch, 0))
        oid = oid_seq[start: start + k_batch].long()
        C_all = torch.cumsum(tie[perm_l].to(I64), 1)
    else:
        C = torch.cumsum(tie.to(I64), 0)
    if ban:
        elim = kbig
    else:
        pos0 = lni % max(T, 1)
        if rotate:
            p0 = int(torch.sum((C_all[oid[0]] < pos0 + 1).to(I64)))
            sel0 = perm_l[oid[0], min(p0, n_pad)]
        else:
            sel0 = torch.searchsorted(
                C, torch.tensor([pos0 + 1], dtype=I64, device=dev))[0]
        elim = (not bool(stay[clamp_idx(sel0)])) and kbig
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
        sel = torch.where(active, torch.searchsorted(C, pos + 1), n_pad)
    else:
        posp = torch.sum((C_all[oid] < (pos + 1)[:, None]).to(I64), dim=1)
        sel = torch.where(active,
                          perm_l[oid, torch.clamp(posp, max=n_pad)], n_pad)
    sel = clamp_idx(sel)
    leaves = torch.ones(k_batch, dtype=torch.bool, device=dev) if ban \
        else ~stay[sel]
    fail = (~leaves if elim else leaves) & active
    first_bad = int(_first_true(fail)) if bool(torch.any(fail)) else k_batch
    v = m if F == 0 else min(first_bad + 1, m)
    if rotate:
        own = torch.full((n1,), k_batch, dtype=I64, device=dev)
        own.scatter_reduce_(0, sel, torch.where(active, jlane, k_batch),
                            reduce="amin")
        dup = active & (own[sel] != jlane)
        first_dup = int(_first_true(dup)) if bool(torch.any(dup)) \
            else k_batch
        v = min(v, first_dup)
        v = m if F == 0 else max(v, 1)
    out[done: done + k_batch] = torch.where((jlane < v) & (F > 0), sel,
                                            -1).to(I32)
    lni = lni + (v if F > 1 else 0)
    done = done + v
    state[ST_DONE] = done
    state[ST_LNI] = lni
    state[ST_PASS] = st_h[ST_PASS] + 1
    state[ST_VFOLD] = v if F > 0 else 0
    state[ST_LANES: ST_LANES + k_batch] = sel
    out[cap] = _wrap32(lni - st_h[ST_LNI0])
    lni_out[0] = lni


_SUD_INTS = ("n_pad", "rows", "D", "stride", "hoff", "B", "K", "cap", "L",
             "n_oid", "ban")
_SUD_PTRS = ("gathered", "perm", "oid_seq", "state", "out", "lni_out",
             "owner", "workspace")


def _shard_uniform_select_bind(gathered, rows, hoff, state, out, lni_out,
                               owner, n_pods, cap, ban, perm,
                               oid_seq) -> Relaunch:
    """K9d's launch for a burst on `gathered`'s device, bound once: K3's
    `uniform_plan` at R = 0 over the node axis and the rotation orders
    (16 blocks, or 8 when the card cannot place 16) and, for lists and
    bits past what shared memory holds, the workspace, allocated here
    once a burst. The burst's passes re-enqueue it (`Relaunch.fn`)."""
    dev = gathered.device
    D, stride = (int(x) for x in gathered.shape)
    n_pad = D * int(rows)
    L = 0 if perm is None else int(perm.shape[0])
    if perm is not None and perm.shape[1] != n_pad + 1:
        raise ValueError("shard_uniform_select: perm rows must be n_pad+1 "
                         "wide")
    n_oid = 0 if oid_seq is None else int(oid_seq.shape[0])
    if oid_seq is not None and n_oid < K_BATCH:
        raise ValueError("shard_uniform_select: oid_seq shorter than "
                         "K_BATCH")
    plan = _cluster_geometry("shard_uniform_select",
                             lambda blocks: uniform_plan(n_pad, 0, 0, L,
                                                         blocks))
    ptrs = {"gathered": gathered, "perm": perm, "oid_seq": oid_seq,
            "state": state, "out": out, "lni_out": lni_out,
            "owner": owner, "workspace": plan.workspace(dev)}
    _require_cuda("shard_uniform_select", *ptrs.values())
    _require_on("shard_uniform_select", dev, *ptrs.values())
    ints = {"n_pad": n_pad, "rows": int(rows), "D": D, "stride": stride,
            "hoff": int(hoff), "B": int(n_pods), "K": K_BATCH,
            "cap": int(cap), "L": L, "n_oid": n_oid, "ban": int(bool(ban))}
    iargs, parr = _launch_arrays(ints, _SUD_INTS, ptrs, _SUD_PTRS,
                                 "shard_uniform_select")
    fn = getattr(_build.load("shard_uniform_select"),
                 "shard_uniform_select_launch")
    return Relaunch("shard_uniform_select", fn, (
        iargs, parr, plan.geometry(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), ptrs)


def shard_uniform_select(gathered, rows, hoff, state, out, lni_out, owner,
                         n_pods, cap, ban, perm=None,
                         oid_seq=None) -> Optional[Relaunch]:
    """K9d on one device over the [D, record bytes] gathered shard
    records: one pass. CPU -> the plain version (returns None); CUDA ->
    `csrc/shard_uniform_select.cu`, one thread-block cluster a pass,
    returning its `Relaunch` for the burst's next passes: the arguments
    are the same every pass (the pass lives in `state`)."""
    dev = gathered.device
    _require_on("shard_uniform_select", dev, state, out, lni_out, owner,
                perm, oid_seq)
    if not gathered.is_cuda:
        return shard_uniform_select_plain(gathered, rows, hoff, state, out,
                                          lni_out, owner, n_pods, cap, ban,
                                          perm=perm, oid_seq=oid_seq)
    with _on(dev):
        rel = _shard_uniform_select_bind(gathered, rows, hoff, state, out,
                                         lni_out, owner, n_pods, cap, ban,
                                         perm, oid_seq)
    _check(rel.fn(), "shard_uniform_select")
    rel.book()
    return rel


# ---------------------------------------------------------------------------
# K10a/K10b, K11a/K11b — one step of the sharded generic scan and of the
# sharded fused window (parallel/sharding.py `sharded_scan`,
# `sharded_segments`). The host enqueues, per step, the local kernel on
# every shard, the all-gather and the select on every distinct device,
# always with the same arguments: the step index, li / lni and the fold
# the shards owe live in a step state on each device, written by that
# device's select only.
# ---------------------------------------------------------------------------
#: slots of a sharded scan's step state (csrc/shard_scan.cuh)
(SS_STEP, SS_NEXT, SS_LI, SS_LNI, SS_LNI0, SS_FOLD_SEL, SS_FOLD_ROW,
 SS_REWIND, SS_T, SS_CHK_T, SS_CHK_LI, SS_CHK_LNI, SS_FAILED, SS_GHOST_SEL,
 SS_COUNT) = range(15)
#: the exchange round after the step state proper (csrc/shard_scan.cuh
#: `SS_ROUND`): the steps this window's selects have taken on the device,
#: advanced by the select only; step i writes and reads the record half
#: i & 1 and waits for stamp `stamp_base + i + 1`
SS_ROUND = SS_COUNT
#: int64 words of a device's step state
SS_WORDS = SS_COUNT + 1
#: the other cards a local step writes its records to, at most (an
#: 8-card host; `MAX_PEERS` in csrc/shard_scan.cuh)
MAX_PEERS = 7
#: the skip flag's slot in a row of the [U, 13] scalar table
_SC_SKIP = _SCAN_SCALARS.index("skip")


def scan_scalars(tab: dict) -> torch.Tensor:
    """The [U, 13] int64 scalar table of a window's pod tables (K5's
    layout: K2's scalars, the profile-id slot unused, the fold deltas)."""
    U = int(tab["skip"].shape[0])
    dev = tab["skip"].device
    return torch.stack(
        [tab[k].reshape(U).to(I64) if k != "profile_id"
         else torch.zeros(U, dtype=I64, device=dev)
         for k in _SCAN_SCALARS], dim=1).contiguous()


@dataclasses.dataclass
class ScanPlan:
    """What every step of one sharded scan or segments window shares: the
    shapes (n_pad, rows per shard, D shards, S scalars, U specs, B pods,
    n_steps the window runs), the walk (num_to_find, n_real, rotation
    mode 0 / 1 / 2 with L orders and n_oid order ids), z_pad, P weight
    rows, whether the spread vector is carried, the gang score and the
    inter-pod family are on, the record planes (fixed per window from
    the whole table, `cycle_record_planes`), and the static weights (the
    gate). A pressure wave (K13, `pressure`) carries P victim slots and
    appends each shard's candidate record to its cycle record."""
    n_pad: int
    rows: int
    D: int
    S: int
    U: int
    B: int
    n_steps: int
    num_to_find: int
    n_real: int
    z_pad: int
    mode: int
    L: int
    n_oid: int
    P: int
    carry_spread: bool
    gang_score: bool
    ipa_on: bool
    planes: tuple
    weights: dict
    pressure: bool = False
    vic_P: int = 0
    #: the stamps of this window are stamp_base + i + 1 for its step i
    #: (and the last fold's): the mesh's stamps count up over its life
    stamp_base: int = 0

    @property
    def cand_off(self) -> int:
        """Byte offset of the candidate record in a shard's record: the
        cycle record's size."""
        return record_layout(self.planes, self.rows)[1]

    @property
    def record_bytes(self) -> int:
        return self.cand_off + (cand_record_bytes(self.vic_P)
                                if self.pressure else 0)


class ScanShard:
    """Shard `index` of a sharded scan or segments window (K10a / K11a):
    its node fields (the static ones shared with the resident matrix, the
    seven mutable rows a fresh copy folded in place), its slice of the
    carried spread, its slices of the window's pod tables (`[U, rows]`
    when dense, `[U, 1]` inert fields and per-spec scalars replicated),
    the K11 checkpoint (copies of the live rows and spread slice, or
    None), and its record `rec`: row `index` of its device's gathered
    buffer (a view), where the local step writes it. A pressure wave's
    shard (K13a) also holds its slice of the nominated-ghost load (a fresh
    copy, folded in place), its victim planes, and `partials`, the
    kernel's scratch: one partial candidate record a row block, then the
    ticket counter that finds the last row block (zeros). `ticket` is the
    K10a / K11a launch's: its last row block publishes the shard's
    stamps."""

    def __init__(self, index, offset, nodes, spread, tab, chk, rec,
                 ghost=None, vic=None):
        dev = nodes["valid"].device
        self.index = int(index)
        self.offset, self.rows = int(offset), int(nodes["valid"].shape[0])
        self.nodes, self.spread, self.tab, self.chk = nodes, spread, tab, chk
        self.scal = scan_scalars(tab)
        self.rec = rec
        self.ghost, self.vic, self.partials = ghost, vic, None
        self.ticket = torch.zeros(1, dtype=I64, device=dev)
        if vic is not None:
            blocks = -(-self.rows // LOCAL_GROUP_THREADS)
            self.partials = torch.zeros(blocks * PARTIAL_WORDS + 1,
                                        dtype=I64, device=dev)
        self._args: dict = {}    # launch arrays, built once per window

    @property
    def device(self):
        return self.nodes["valid"].device


@dataclasses.dataclass
class ScanSide:
    """The replicated half of a sharded scan, segments window or pressure
    wave on one device (K10b / K11b / K13b): the step state `st`
    [SS_COUNT], the pod rows `row` [B] int32, the profile ids `prof` [B]
    and weight table `wtab` (or None), the static weight row `w`, the [U,
    13] scalar table `scal`, the first column of the inter-pod tables
    `ic_b` / `tr_b` [U, 1] (what an inert field broadcasts), the rotation
    tables and order ids (or None), `seg_start` / `gang` [B] and the gang
    zone counts `gz` [z_pad] (K11), the gathered records in two halves
    `halves` [2, D, bytes] (step i writes and reads half i & 1, so no
    local step overwrites a record a select on another card still
    reads), the packed block and (K10) the stats [5, B]. The exchange
    (`Mesh.exchange` "peer"): `stamps` [2, D] int64, the mesh's stamps on
    this device (a shard's local step publishes stamp[i & 1, s] after its
    record, the select waits for all D of its half), and `peers`, the
    (halves, stamps) of every other distinct device, which the local
    steps here write into; "copy": no stamps and no peers, the records of
    other devices copied in by the host."""
    st: torch.Tensor
    row: torch.Tensor
    prof: Optional[torch.Tensor]
    wtab: Optional[torch.Tensor]
    w: torch.Tensor
    scal: torch.Tensor
    ic_b: torch.Tensor
    tr_b: torch.Tensor
    perms: Optional[torch.Tensor]
    inv_perms: Optional[torch.Tensor]
    oid: Optional[torch.Tensor]
    seg_start: Optional[torch.Tensor]
    gang: Optional[torch.Tensor]
    gz: Optional[torch.Tensor]
    halves: torch.Tensor
    packed: torch.Tensor
    stats: Optional[torch.Tensor]
    stamps: Optional[torch.Tensor] = None
    peers: tuple = ()
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self):
        return self.st.device

    @property
    def gathered(self) -> torch.Tensor:
        """The records' first half [D, bytes]: the one a window's first
        step writes and reads."""
        return self.halves[0]

    def records(self) -> torch.Tensor:
        """The half [D, bytes] of the step the step state is at."""
        return self.halves[int(self.st[SS_ROUND]) & 1]


def stamp_value(base: int, step: int) -> int:
    """The stamp a shard publishes at step `step` of a window whose stamps
    start after `base` (`Mesh.reserve_stamps`), in half step & 1."""
    return int(base) + int(step) + 1


def _publish_plain(shards: list, side: ScanSide, plan: ScanPlan,
                   wrote: list) -> None:
    """The end of a plain local step on `side`'s device: each shard's
    record (where the step `wrote` one) copied into the same row and half
    of every peer's buffer, then the shards' stamps of this round
    published here and on every peer (`plan.stamp_base` + round + 1), as
    the kernels' last row block does."""
    if side.stamps is None:
        return
    r = int(side.st[SS_ROUND])
    h = r & 1
    for sh, w in zip(shards, wrote):
        if w:
            for halves, _stamps in side.peers:
                halves[h][sh.index].copy_(side.halves[h][sh.index])
    for sh in shards:
        for stamps in (side.stamps,) + tuple(p[1] for p in side.peers):
            stamps[h, sh.index] = stamp_value(plan.stamp_base, r)


def _await_stamps_plain(side: ScanSide, plan: ScanPlan) -> torch.Tensor:
    """The start of a plain select step: the D stamps of this round's
    half must read `plan.stamp_base` + round + 1 (a lost stamp raises, as
    the kernel's bounded wait traps). Returns the half the step reads."""
    if side.stamps is not None:
        r = int(side.st[SS_ROUND])
        want = stamp_value(plan.stamp_base, r)
        got = side.stamps[r & 1]
        if bool((got < want).any()):
            raise RuntimeError(f"select at round {r}: stamps {got.tolist()}"
                               f" of half {r & 1}, not {want}: a local step "
                               f"did not publish its record")
    return side.records()


def _next_round(side: ScanSide) -> None:
    side.st[SS_ROUND] += 1


# ---- K10a / K11a: the local step ---------------------------------------------
def _scan_local_plain(sh: ScanShard, side: ScanSide, plan: ScanPlan,
                      segments: bool, rec: torch.Tensor) -> bool:
    """One shard's local step, its record written into `rec`. Returns
    whether it wrote one."""
    nodes, st, tab = sh.nodes, side.st, sh.tab
    dev, rows = sh.device, sh.rows
    t = int(st[SS_NEXT])
    fold = int(st[SS_FOLD_SEL]) - sh.offset
    if 0 <= fold < rows:
        fr = int(st[SS_FOLD_ROW])
        _fold_state_plain(nodes, {k: tab[k][fr] for k in (
            "upd_cpu", "upd_mem", "upd_eph", "upd_scalar", "nz_cpu",
            "nz_mem")}, fold)
        if sh.spread is not None:
            sh.spread[fold] += 1
    live = t < plan.n_steps
    if segments:
        live_rows = [(nodes[k], sh.chk[k]) for k in _MUTABLE]
        if sh.spread is not None:
            live_rows.append((sh.spread, sh.chk["spread"]))
        if int(st[SS_REWIND]):
            for cur, chk in live_rows:
                cur.copy_(chk)
        if live and bool(side.seg_start[t]):
            for cur, chk in live_rows:
                chk.copy_(cur)
    if not live:
        return False
    r = int(side.row[t])
    if int(sh.scal[r, _SC_SKIP]):
        return False
    if segments and bool(side.gang[t]) and not bool(side.seg_start[t]) \
            and int(st[SS_FAILED]):
        return False    # behind its gang's failure: the record is not read
    pod = {k: v[r] for k, v in tab.items()}
    if sh.spread is not None:
        pod["spread_counts"] = sh.spread
    wrow = None if side.wtab is None else _row_at(side.wtab, side.prof[t])
    feasible, _ff, _bits = _feasibility_plain(nodes, pod)
    in_range = torch.arange(rows, device=dev) + sh.offset < plan.n_real
    vals = {"local": _local_scores_plain(nodes, pod, plan.weights,
                                         wrow=wrow),
            "zone": nodes["zone_id"], "feas": feasible & in_range}
    for k, f in _REC_FIELD.items():
        if k in plan.planes:
            vals[k] = pod[f]
    rec.copy_(_pack_record(vals, plan.planes, rows, dev))
    return True


def shard_scan_local_plain(shards: list, side: ScanSide,
                           plan: ScanPlan) -> None:
    """K10a plain: the local step of `sharded_scan_fn` (sharding.py:233)
    on every shard of `shards` (the shards of `side`'s device). Each folds
    the winner the step state names into the row it owns (`_fold_state`,
    kernels.py:549, +1 on the carried spread), then, unless the step is
    past the window or a skip pod, writes K9a's record for pod row[t]
    over its rows (`_feasibility` :296 and the row-local `_fit_scores`
    :157, with its wtab row) into row `index` of the step's half of
    `side.halves`, and of every peer's (`_publish_plain`), then the
    shards' stamps."""
    _publish_plain(shards, side, plan, [
        _scan_local_plain(sh, side, plan, False, side.records()[sh.index])
        for sh in shards])


def shard_segments_local_plain(shards: list, side: ScanSide,
                               plan: ScanPlan) -> None:
    """K11a plain: K10a plus each shard's slice of `_segments_core`'s gang
    checkpoint (kernels.py:785): after the fold, the live rows and spread
    slice are restored from the checkpoint when the step state says
    rewind, and copied into it at a segment start; a member behind its
    gang's failure writes no record. Records and stamps as K10a."""
    _publish_plain(shards, side, plan, [
        _scan_local_plain(sh, side, plan, True, side.records()[sh.index])
        for sh in shards])


_SSL_INTS = ("rows", "S", "offset", "n_real", "gate", "n_steps", "P",
             "carry_spread") + tuple("off_" + n for n, _ in _REC_PLANES) \
    + ("vic_P", "cand_off", "index", "D", "half", "stamp_base", "n_peers")
_SSL_PTRS = ("valid", "alloc_cpu", "alloc_mem", "alloc_eph",
             "allowed_pods", "req_cpu", "req_mem", "req_eph", "nz_cpu",
             "nz_mem", "pod_count", "alloc_scalar", "req_scalar", "zone_id",
             "spread") + tuple("chk_" + k for k in _MUTABLE) \
    + ("chk_spread", "scal", "req_scalar_p", "upd_scalar_p") + _CYCLE_MASKS \
    + ("interpod_code",) + _CYCLE_COUNTS + (
        "interpod_tracked", "row", "profile_id", "w", "wtab", "state",
        "seg_start", "gang", "rec", "stamps", "ticket") + tuple(
    f"peer_rec{k}" for k in range(MAX_PEERS)) + tuple(
    f"peer_stamps{k}" for k in range(MAX_PEERS)) + tuple(
    "ghost_" + k for k in ("cpu", "mem", "eph", "cnt")) + tuple(
    "vic_" + k for k in ("cpu", "mem", "eph", "prio", "start", "valid",
                         "violating")) + ("pprio", "partials")


def _scan_local_args(name, sh: ScanShard, side: ScanSide, plan: ScanPlan,
                     rec: torch.Tensor):
    """(pointer tensors, scalar array, pointer array) of one shard's local
    launches, its record written into `rec` (row s of the first half of
    its device's buffer; the kernel adds the step's half) and into the
    same row of every peer's buffer, its stamps published here and on
    every peer: the same for every step of the window."""
    dev, tab, U, rows = sh.device, sh.tab, plan.U, sh.rows
    nodes = sh.nodes
    if nodes["zone_id"].dtype != I32 or nodes["valid"].dtype != torch.bool:
        raise ValueError(f"{name}: zone_id must be int32, valid bool")

    def dense(key, dtype):
        v = tab.get(key)
        if v is None or _inert(v):
            return None
        v = v.to(dtype).contiguous()
        if tuple(v.shape) != (U, rows):
            raise ValueError(f"{name}: {key} is not the shard's [U, rows]")
        return v
    ptrs = {k: nodes[k] for k in _SSL_PTRS[:14]}
    ptrs.update({"spread": sh.spread, "scal": sh.scal,
                 "req_scalar_p": tab["req_scalar"].to(I64).reshape(
                     U, plan.S).contiguous(),
                 "upd_scalar_p": tab["upd_scalar"].to(I64).reshape(
                     U, plan.S).contiguous(),
                 "interpod_code": dense("interpod_code", torch.int8),
                 "interpod_tracked": dense("interpod_tracked", torch.bool),
                 "row": side.row, "profile_id": side.prof, "w": side.w,
                 "wtab": side.wtab, "state": side.st, "rec": rec,
                 "stamps": side.stamps,
                 "ticket": sh.ticket if side.stamps is not None else None})
    if len(side.peers) > MAX_PEERS:
        raise ValueError(f"{name}: {len(side.peers)} peers, at most "
                         f"{MAX_PEERS}")
    for k, (halves, stamps) in enumerate(side.peers):
        ptrs[f"peer_rec{k}"] = halves[0][sh.index]
        ptrs[f"peer_stamps{k}"] = stamps
    ptrs.update({k: dense(k, torch.bool) for k in _CYCLE_MASKS})
    ptrs.update({k: dense(k, I64) for k in _CYCLE_COUNTS})
    if plan.carry_spread:
        ptrs["spread_counts"] = None     # the carried slice replaces it
    if sh.chk is not None:
        ptrs.update({"chk_" + k: sh.chk[k] for k in _MUTABLE})
        ptrs.update({"chk_spread": sh.chk.get("spread"),
                     "seg_start": side.seg_start, "gang": side.gang})
    if sh.vic is not None:
        ptrs.update({"ghost_" + k: sh.ghost[k] for k in GHOST_FIELDS})
        ptrs.update({"vic_" + k: sh.vic[k] for k in VICTIM_PLANES})
        ptrs.update({"pprio": tab["pprio"].to(I64).reshape(U).contiguous(),
                     "partials": sh.partials})
        if any(sh.vic[k].shape[0] != rows for k in VICTIM_PLANES) \
                or any(g.shape != (rows,) for g in sh.ghost.values()):
            raise ValueError(f"{name}: victim planes or ghost are not the "
                             f"shard's {rows} rows")
    for k, f in _REC_FIELD.items():
        if k in plan.planes and ptrs[f] is None and not (
                k == "sc" and plan.carry_spread):
            raise ValueError(f"{name}: plane {k} of an inert field")
    _require_cuda(name, *[v for v in ptrs.values() if v is not None])
    _require_on(name, dev, *[v for k, v in ptrs.items()
                             if not k.startswith("peer_")])
    off, _nbytes = record_layout(plan.planes, rows)
    if plan.record_bytes != rec.numel():
        raise ValueError(f"{name}: record size != layout")
    ints = {"rows": rows, "S": plan.S, "offset": sh.offset,
            "n_real": plan.n_real, "gate": _gate(plan.weights),
            "n_steps": plan.n_steps, "P": plan.P,
            "carry_spread": int(plan.carry_spread), "vic_P": plan.vic_P,
            "cand_off": plan.cand_off if plan.pressure else 0,
            "index": sh.index, "D": plan.D,
            "half": plan.D * plan.record_bytes,
            "stamp_base": plan.stamp_base, "n_peers": len(side.peers)}
    ints.update({"off_" + n: off.get(n, -1) for n, _ in _REC_PLANES})
    return (ptrs,) + _launch_arrays(ints, _SSL_INTS, ptrs, _SSL_PTRS, name)


#: shards a grouped local launch covers (csrc/shard_scan.cuh
#: `LOCAL_GROUP_SHARDS`); a device holding more takes one launch per as many
LOCAL_GROUP_SHARDS = 4
#: threads of a grouped local launch's row block (`LOCAL_GROUP_THREADS`)
LOCAL_GROUP_THREADS = 128
#: int64 words of a K13a row block's partial candidate record
#: (csrc/shard_pressure_local.cu `PARTIAL_WORDS`: the candidate's seven,
#: then the OR of the resolvable flags)
PARTIAL_WORDS = 8


class Relaunch:
    """The launch a mesh step's wrapper (K10a / K11a / K13a over a
    device's shards, K10b / K11b / K13b) just enqueued, bound for the
    window's next steps: `fn()` enqueues the same launch again with
    nothing else on the host (the ctypes function `cfn` on `args`, its
    argument arrays, device and stream, all fixed at the window's first
    step) and returns its CUDA error code. The C function adds one to
    `count` at every kernel launch it makes; `book()` moves that count to
    `launch.<name>` and returns it. `keep` holds the tensors the arrays
    point at."""

    def __init__(self, name: str, cfn, args: tuple, keep):
        self.name, self.keep = name, keep
        self.count = ctypes.c_int(0)
        self.fn = functools.partial(cfn, *args, ctypes.byref(self.count))

    def book(self) -> int:
        n, self.count.value = self.count.value, 0
        obs.inc("launch." + self.name, n)
        return n


def enable_peers(cards) -> None:
    """Peer access for every ordered pair of the CUDA devices `cards`
    (indices), once a mesh, by `mesh_enable_peers` of K10a's library
    (`cudaDeviceEnablePeerAccess`; one already enabled is accepted). A
    pair that cannot reach each other, or any other failure, raises."""
    arr = (ctypes.c_int * len(cards))(*[int(c) for c in cards])
    _check(_build.load("shard_scan_local").mesh_enable_peers(
        arr, len(cards)), "mesh_enable_peers")


def _local_group_launch(name, shards: list, side: ScanSide,
                        plan: ScanPlan) -> Relaunch:
    """Launch grouped local kernel `name` over `shards`, all on `side`'s
    device (one launch per LOCAL_GROUP_SHARDS of them), each record into
    row `index` of `side.gathered`, and book the launches the C function
    counted. The argument words, stream and bound function are built at
    the window's first launch and cached on `side`."""
    key = (name,) + tuple(sh.index for sh in shards)
    rel = side._args.get(key)
    if rel is None:
        dev = side.device
        if any(sh.device != dev for sh in shards):
            raise ValueError(f"{name}: a shard not on {dev}")
        words, keep = [], []
        for sh in shards:
            ptrs, iargs, parr = _scan_local_args(
                name, sh, side, plan, side.gathered[sh.index])
            keep.append(ptrs)
            words += list(iargs) + [p or 0 for p in parr]
        table = (ctypes.c_longlong * len(words))(*words)
        fn = getattr(_build.load(name), name + "_launch")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rel = side._args[key] = Relaunch(
            name, fn, (table, len(shards), dev.index, stream), (keep, table))
    _check(rel.fn(), name)
    rel.book()
    return rel


def shard_scan_local(shards: list, side: ScanSide,
                     plan: ScanPlan) -> Optional[Relaunch]:
    """K10a over every shard of `shards`, all on `side`'s device (the
    window's replicated half there), each record into row `index` of
    `side.gathered`. CPU tensors -> the plain version (returns None);
    CUDA tensors -> ONE launch of `csrc/shard_scan_local.cu` over them,
    returning its `Relaunch` for the window's next steps."""
    if not side.st.is_cuda:
        return shard_scan_local_plain(shards, side, plan)
    return _local_group_launch("shard_scan_local", shards, side, plan)


def shard_segments_local(shards: list, side: ScanSide,
                         plan: ScanPlan) -> Optional[Relaunch]:
    """K11a over every shard of `shards`, as K10a. CPU -> the plain
    version; CUDA -> one launch of `csrc/shard_segments_local.cu`."""
    if not side.st.is_cuda:
        return shard_segments_local_plain(shards, side, plan)
    return _local_group_launch("shard_segments_local", shards, side, plan)


# ---- K10b / K11b: the select step ---------------------------------------------
def _select_cycle_plain(side: ScanSide, plan: ScanPlan, i: int, r: int,
                        li: int, lni: int, k: int, gang=None) -> dict:
    """K9b's cycle of live step i (pod-table row r, enumeration k) over
    the gathered records, as `_cycle_core`'s scalar outputs."""
    perm = inv_perm = pos = None
    if plan.mode:
        oid = int(side.oid[min(max(k, 0), plan.n_oid - 1)])
        if plan.mode == 2:
            pos = _row_at(side.perms, oid)
        else:
            perm = _row_at(side.perms, oid)
            inv_perm = _row_at(side.inv_perms, oid)
    wrow = None if side.wtab is None else _row_at(side.wtab, side.prof[i])
    pod = {"skip": np.bool_(False), "interpod_counts": side.ic_b[r],
           "interpod_tracked": side.tr_b[r]}
    out, _total, _kept = shard_cycle_select_plain(
        side.records(), plan.planes, plan.rows, plan.n_real, pod, li, lni,
        plan.num_to_find, plan.weights, plan.z_pad, wrow=wrow, perm=perm,
        inv_perm=inv_perm, pos=pos, gang=gang)
    return dict(zip(("selected", "found", "evaluated", "max_score",
                     "next_last_index", "next_last_node_index"),
                    (int(x) for x in out.tolist())))


def shard_scan_select_plain(side: ScanSide, plan: ScanPlan) -> None:
    """K10b plain: the replicated select of `sharded_scan_fn` (sharding.py
    :233) for one step on one device: the skip pods up to the next live
    step take `_skip_cycle`'s result, the live step K9b's cycle (walk by
    its order id oid_seq[b], its wtab row), then the skip pods after it.
    Writes the packed [3B] block and stats [5, B] of each step it
    decides, and the step state (li, lni, the fold, the next step, the
    exchange round)."""
    _await_stamps_plain(side, plan)
    st, B, n = side.st, plan.B, plan.n_real
    i, li, lni = int(st[SS_STEP]), int(st[SS_LI]), int(st[SS_LNI])
    lni0 = int(st[SS_LNI0])

    def write(b, out):
        side.packed[b] = _wrap32(out["selected"])
        side.packed[B + b] = _wrap32(out["next_last_index"])
        side.packed[2 * B + b] = _wrap32(out["next_last_node_index"] - lni0)
        side.stats[:, b] = torch.tensor(
            [out[k] for k in ("selected", "found", "evaluated", "max_score",
                              "next_last_node_index")], dtype=I64)

    def skip_run(b, li):
        while b < plan.n_steps and int(side.scal[int(side.row[b]),
                                                 _SC_SKIP]):
            out = _skip_cycle(li, lni, n)
            li = out["next_last_index"]
            write(b, out)
            b += 1
        return b, li
    i, li = skip_run(i, li)
    fold, r = -1, 0
    if i < plan.n_steps:
        r = int(side.row[i])
        out = _select_cycle_plain(side, plan, i, r, li, lni, i)
        write(i, out)
        fold = out["selected"] if out["found"] > 0 else -1
        li, lni = out["next_last_index"], out["next_last_node_index"]
        i, li = skip_run(i + 1, li)
    st[SS_STEP] = st[SS_NEXT] = i
    st[SS_LI], st[SS_LNI] = li, lni
    st[SS_FOLD_SEL], st[SS_FOLD_ROW] = fold, r
    _next_round(side)


def shard_segments_select_plain(side: ScanSide, plan: ScanPlan) -> None:
    """K11b plain: one step of `_segments_core` (kernels.py:785) in the
    replicated state of `sharded_segments_fn` (sharding.py:279): at a
    segment start gz resets and li / lni / t are checkpointed; the
    effective skip `skip | (gang & failed)`; the cycle at enumeration t
    with the gang zone counts; a placed gang member's zone into gz; a gang
    member that finds no node rewinds li / lni / t / gz and sets the flag
    the shards restore their checkpoint by. Writes column i of the packed
    [4B] block and the step state."""
    gathered = _await_stamps_plain(side, plan)
    st, B = side.st, plan.B
    i = int(st[SS_STEP])
    if i >= plan.n_steps:
        _next_round(side)
        return
    li, lni, lni0, t = (int(st[k]) for k in (SS_LI, SS_LNI, SS_LNI0, SS_T))
    chk_li, chk_lni, chk_t = (int(st[k]) for k in (SS_CHK_LI, SS_CHK_LNI,
                                                   SS_CHK_T))
    failed = bool(int(st[SS_FAILED]))
    r = int(side.row[i])
    sflag, gflag = bool(side.seg_start[i]), bool(side.gang[i])
    if sflag:
        if plan.gang_score:
            side.gz.zero_()     # BEFORE the checkpoint: a rewind -> zeros
        chk_li, chk_lni, chk_t, failed = li, lni, t, False
    eskip = bool(int(side.scal[r, _SC_SKIP])) or (gflag and failed)
    if eskip:
        out = _skip_cycle(li, lni, plan.n_real)
    else:
        gang = None
        if plan.gang_score:
            gang = (side.gz, torch.tensor(gflag, device=side.device))
        out = _select_cycle_plain(side, plan, i, r, li, lni, t, gang=gang)
    sel, hit = out["selected"], out["found"] > 0
    if plan.gang_score and hit and gflag:
        zone = unpack_records(gathered, plan.planes, plan.rows)["zone"]
        z = int(zone[sel])
        if 0 < z < plan.z_pad:
            side.gz[z] += 1
    fail_now = gflag and not hit and not eskip
    if fail_now:
        li, lni, t = chk_li, chk_lni, chk_t
        if plan.gang_score:
            side.gz.zero_()
    else:
        li, lni = out["next_last_index"], out["next_last_node_index"]
        t += 0 if eskip else 1
    failed = failed or fail_now
    side.packed[i] = sel if hit else -1
    side.packed[B + i] = _wrap32(li)
    side.packed[2 * B + i] = _wrap32(lni - lni0)
    side.packed[3 * B + i] = _wrap32(t)
    vals = {SS_STEP: i + 1, SS_NEXT: i + 1, SS_LI: li, SS_LNI: lni,
            SS_FOLD_SEL: sel if hit else -1, SS_FOLD_ROW: r,
            SS_REWIND: int(fail_now), SS_T: t, SS_CHK_T: chk_t,
            SS_CHK_LI: chk_li, SS_CHK_LNI: chk_lni, SS_FAILED: int(failed)}
    for k, v in vals.items():
        st[k] = v
    _next_round(side)


_SSS_INTS = ("n_pad", "rows", "D", "chunk", "n_real", "z_pad", "B",
             "n_steps", "num_to_find", "mode", "L", "n_oid", "gate", "P",
             "ipa_on", "ic_inert", "tr_inert", "gang_score") + tuple(
    "off_" + n for n, _ in _REC_PLANES) + ("vic_P", "cand_off",
                                          "stamp_base")
_SSS_PTRS = ("gathered", "w", "wtab", "profile_id", "row", "scal", "ic_b",
             "tr_b", "perms", "inv_perms", "oid_seq", "seg_start", "gang",
             "gz", "state", "packed", "stats", "recs", "workspace", "stamps")


def _scan_select_args(name, side: ScanSide, plan: ScanPlan, recs=None,
                      workspace=None):
    dev = side.device
    D, chunk = (int(x) for x in side.gathered.shape)
    off, _nbytes = record_layout(plan.planes, plan.rows)
    if plan.record_bytes != chunk or D * plan.rows != plan.n_pad:
        raise ValueError(f"{name}: gathered records != layout")
    if plan.mode and side.perms.shape[1] != plan.n_pad:
        raise ValueError(f"{name}: rotation rows must be n_pad wide")
    # both halves: the kernel reads the one of the step's round
    ptrs = {"gathered": side.halves, "w": side.w, "wtab": side.wtab,
            "profile_id": side.prof, "row": side.row, "scal": side.scal,
            "ic_b": side.ic_b, "tr_b": side.tr_b, "perms": side.perms,
            "inv_perms": side.inv_perms, "oid_seq": side.oid,
            "seg_start": side.seg_start, "gang": side.gang, "gz": side.gz,
            "state": side.st, "packed": side.packed, "stats": side.stats,
            "recs": recs, "workspace": workspace, "stamps": side.stamps}
    _require_cuda(name, *[v for v in ptrs.values() if v is not None])
    _require_on(name, dev, *ptrs.values())
    ints = {"n_pad": plan.n_pad, "rows": plan.rows, "D": D, "chunk": chunk,
            "n_real": plan.n_real, "z_pad": plan.z_pad, "B": plan.B,
            "n_steps": plan.n_steps, "num_to_find": plan.num_to_find,
            "mode": plan.mode, "L": plan.L, "n_oid": plan.n_oid,
            "gate": _gate(plan.weights), "P": plan.P,
            "ipa_on": int(plan.ipa_on),
            "ic_inert": int("ic" not in plan.planes),
            "tr_inert": int("tracked" not in plan.planes),
            "gang_score": int(plan.gang_score), "vic_P": plan.vic_P,
            "cand_off": plan.cand_off if plan.pressure else 0,
            "stamp_base": plan.stamp_base}
    ints.update({"off_" + n: off.get(n, -1) for n, _ in _REC_PLANES})
    return (ptrs,) + _launch_arrays(ints, _SSS_INTS, ptrs, _SSS_PTRS, name)


def _select_cluster_launch(name, side: ScanSide,
                           plan: ScanPlan) -> Relaunch:
    """One step of cluster select `name` (K10b / K11b / K13b) on `side`'s
    device.
    At the window's first step the argument arrays and the geometry are
    built and bound, with the device and its stream, into the `Relaunch`
    cached on `side`: `select_plan` at 16 blocks, or 8 when the card
    cannot place 16, and, for records staged in global memory, the
    staging area, for scratch in global memory, the workspace: both
    allocated once a window, here, and bound into the arguments."""
    rel = side._args.get(name)
    if rel is None:
        dev = side.device
        with _on(dev):
            geo = _cluster_geometry(name, lambda blocks: select_plan(
                plan.n_pad, plan.z_pad, blocks))
        recs = None if geo.resident else torch.empty(
            plan.n_pad * _REC_SLOT_BYTES, dtype=torch.uint8, device=dev)
        workspace = geo.workspace(dev)
        ptrs, iargs, parr = _scan_select_args(name, side, plan, recs,
                                              workspace)
        fn = getattr(_build.load(name), name + "_launch")
        rel = side._args[name] = Relaunch(name, fn, (
            iargs, parr, geo.geometry(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream), ptrs)
    _check(rel.fn(), name)
    rel.book()
    return rel


def shard_scan_select(side: ScanSide, plan: ScanPlan) -> Optional[Relaunch]:
    """K10b on one device over its gathered records. CPU -> the plain
    version (returns None); CUDA -> `csrc/shard_scan_select.cu`, one
    thread-block cluster a step, returning its `Relaunch` for the
    window's next steps."""
    if not side.gathered.is_cuda:
        return shard_scan_select_plain(side, plan)
    return _select_cluster_launch("shard_scan_select", side, plan)


def shard_segments_select(side: ScanSide,
                          plan: ScanPlan) -> Optional[Relaunch]:
    """K11b on one device over its gathered records. CPU -> the plain
    version; CUDA -> `csrc/shard_segments_select.cu`, one thread-block
    cluster a step, returning its `Relaunch`."""
    if not side.gathered.is_cuda:
        return shard_segments_select_plain(side, plan)
    return _select_cluster_launch("shard_segments_select", side, plan)


# ---------------------------------------------------------------------------
# The sharded pick: K14a/K13a reduce a shard's rows to a candidate record,
# K14b/K13b pick among the D gathered records (csrc/victim.cuh)
# ---------------------------------------------------------------------------
#: the int64 slots that open a shard's candidate record (`CR_*`); the five
#: criteria (float64) and the best row's P slot flags (int32) follow
CAND_SLOTS = ("any_feas", "any_zero", "zkey", "zidx", "bkey", "bidx", "nv",
              "viol", "any_res")
_CAND_CRIT = 8 * len(CAND_SLOTS)
_CAND_FLAGS = _CAND_CRIT + 8 * 5


def cand_record_bytes(P: int) -> int:
    """Bytes of one shard's candidate record for P victim slots. The
    kernels read the gathered records' int64 and float64 slots in place,
    so P must be even (the victim table's width is a power of two >= 8)."""
    if int(P) % 2:
        raise ValueError(f"candidate records need an even slot count, "
                         f"not P={P}")
    return _CAND_FLAGS + 4 * int(P)


def _agg_planes(rows: int, device, u8_planes: int) -> tuple:
    """Scratch planes of a victim scan's per-row aggregates: i64 [4,
    rows], f64 [rows], u8 [u8_planes, rows]."""
    return (torch.empty((4, rows), dtype=I64, device=device),
            torch.empty(rows, dtype=torch.float64, device=device),
            torch.empty((u8_planes, rows), dtype=torch.uint8, device=device))


def _shard_candidate_plain(feas0, victims, agg, key, offset,
                           any_res=False) -> torch.Tensor:
    """A shard's candidate record (uint8) from its rows' victim scan
    (`shard_candidate`, csrc/victim.cuh): whether a row is a candidate,
    the zero-victim row of lowest (key, row), the rows tied at the
    lexicographic minimum of the five criteria and among them the one of
    lowest (key, row), with its counts, criteria and slot flags. Rows are
    global (`offset` + local row); `key` [rows] is the candidate order
    (order_rank, or the global row for the pick by axis order)."""
    dev = feas0.device
    P = int(victims.shape[1])

    def lowest(mask):
        if not bool(mask.any()):
            return None
        k = int(torch.min(key[mask]))
        return k, int(_first_true(mask & (key == k)))
    zero = lowest(feas0 & (agg["nv"] == 0))
    best = lowest(_staged_filter_plain(feas0, agg))
    j = None if best is None else best[1]
    head = [int(bool(feas0.any())), int(zero is not None),
            I64_MAX if zero is None else zero[0],
            -1 if zero is None else offset + zero[1],
            I64_MAX if best is None else best[0],
            -1 if best is None else offset + j,
            0 if j is None else int(agg["nv"][j]),
            0 if j is None else int(agg["viol_ct"][j]), int(any_res)]
    crit = [0.0] * 5 if j is None else [float(c[j])
                                        for c in _pick_criteria(agg)]
    flags = torch.zeros(P, dtype=I32, device=dev) if j is None \
        else victims[j].to(I32)
    return torch.cat([torch.tensor(head, dtype=I64, device=dev).view(
        torch.uint8), torch.tensor(crit, dtype=torch.float64,
                                   device=dev).view(torch.uint8),
        flags.contiguous().view(torch.uint8)])


def _pick_records_plain(gathered, off: int, P: int):
    """pickOneNodeForPreemption over the D candidate records of a
    gathered [D, bytes] buffer, each at byte `off` (`pick_records`,
    csrc/victim.cuh): (winner row or -1, its victim count, its
    PDB-violation count, its [P] int32 flags, the OR of the shards'
    resolvable flags)."""
    g = gathered[:, off: off + cand_record_bytes(P)].cpu()
    D = int(g.shape[0])
    head = g[:, :_CAND_CRIT].contiguous().view(I64).reshape(D, -1)
    crit = g[:, _CAND_CRIT:_CAND_FLAGS].contiguous().view(
        torch.float64).reshape(D, 5)
    flags = g[:, _CAND_FLAGS:].contiguous().view(I32).reshape(D, P)
    h = {k: [int(x) for x in head[:, i].tolist()]
         for i, k in enumerate(CAND_SLOTS)}
    any_res = any(h["any_res"])
    none = torch.zeros(P, dtype=I32)
    if not any(h["any_feas"]):
        return -1, 0, 0, none, any_res
    if any(h["any_zero"]):
        s = min((h["zkey"][s], h["zidx"][s], s) for s in range(D)
                if h["any_zero"][s])[2]
        return h["zidx"][s], 0, 0, none, any_res
    best = None
    for s in range(D):
        if not h["any_feas"][s]:
            continue
        c = crit[s].tolist()
        if best is None:
            best = s
            continue
        b = crit[best].tolist()
        # the lexicographic order with IEEE < and == (-0.0 == 0.0)
        order = 0
        for x, y in zip(c, b):
            if x < y:
                order = -1
                break
            if not x == y:
                order = 1
                break
        if order < 0 or (order == 0 and (h["bkey"][s], h["bidx"][s])
                         < (h["bkey"][best], h["bidx"][best])):
            best = s
    return (h["bidx"][best], h["nv"][best], h["viol"][best], flags[best],
            any_res)


# ---- K14a shard_preempt_local ------------------------------------------------
def shard_preempt_local_plain(nodes, vic, pod, feas_static, order_rank,
                              offset, n_real, check_resources, has_request,
                              max_prio) -> torch.Tensor:
    """K14a plain: the shard-local half of `sharded_preempt_fn`
    (sharding.py:354) over one shard's rows — `_victim_select`
    (kernels.py:1494) with this preemptor's slot mask (priority below
    `max_prio`) and the reprieve walk, reduced to the shard's candidate
    record (`_shard_candidate_plain`, keyed by `order_rank`)."""
    dev = vic["prio"].device
    rows = int(vic["prio"].shape[0])
    in_range = torch.arange(rows, device=dev) + int(offset) < int(n_real)
    valid_v = vic["valid"] & (vic["prio"] < int(max_prio))
    feas0, victims, agg = _victim_select_plain(
        nodes, vic, valid_v, pod["req_cpu"], pod["req_mem"],
        pod["req_eph"], None, _t(feas_static, dev, torch.bool) & in_range,
        check_resources, has_request)
    return _shard_candidate_plain(feas0, victims, agg,
                                  _t(order_rank, dev, I64), int(offset))


_SPL_INTS = ("rows", "P", "offset", "n_real", "max_prio", "cr", "hr",
             "req_cpu", "req_mem", "req_eph")
_SPL_PTRS = _PREEMPT_PTRS[:8] + tuple("vic_" + k for k in VICTIM_PLANES) \
    + ("feas", "rank", "agg_i64", "agg_f64", "agg_u8", "rec")


def _shard_preempt_local_launch(nodes, vic, pod, feas_static, order_rank,
                                offset, n_real, check_resources, has_request,
                                max_prio):
    dev = vic["prio"].device
    rows, P = (int(x) for x in vic["prio"].shape)
    ptrs = {k: nodes[k] for k in _PREEMPT_PTRS[:8]}
    ptrs.update({"vic_" + k: vic[k] for k in VICTIM_PLANES})
    ptrs["feas"] = _t(feas_static, dev, torch.bool).contiguous()
    ptrs["rank"] = _t(order_rank, dev, I64).contiguous()
    if any(v.shape[0] != rows for v in ptrs.values()):
        raise ValueError("shard_preempt_local: node rows, victim planes, "
                         "feas_static and order_rank differ in rows")
    ptrs["agg_i64"], ptrs["agg_f64"], ptrs["agg_u8"] = _agg_planes(
        rows, dev, 2)
    rec = ptrs["rec"] = torch.empty(cand_record_bytes(P), dtype=torch.uint8,
                                    device=dev)
    _require_cuda("shard_preempt_local", *ptrs.values())
    _require_on("shard_preempt_local", dev, *ptrs.values())
    cr = bool(_host(check_resources))
    ints = {"rows": rows, "P": P, "offset": int(offset),
            "n_real": int(n_real), "max_prio": int(max_prio), "cr": int(cr),
            "hr": int(bool(_host(has_request)) and cr)}
    ints.update({k: int(np.asarray(_host(pod[k])))
                 for k in ("req_cpu", "req_mem", "req_eph")})
    _launch("shard_preempt_local",
            *_launch_arrays(ints, _SPL_INTS, ptrs, _SPL_PTRS,
                            "shard_preempt_local"))
    return rec


def shard_preempt_local(nodes, vic, pod, feas_static, order_rank, offset,
                        n_real, check_resources, has_request, max_prio):
    """K14a on one shard (`nodes` / `vic`: its node rows and victim
    planes; `feas_static` / `order_rank`: its slices; `offset`: the global
    row of its first row). Returns its candidate record (uint8, on its
    device). CPU -> the plain version; CUDA ->
    `csrc/shard_preempt_local.cu`."""
    dev = vic["prio"].device
    if not vic["prio"].is_cuda:
        return shard_preempt_local_plain(
            nodes, vic, pod, feas_static, order_rank, offset, n_real,
            check_resources, has_request, max_prio)
    with _on(dev):
        return _shard_preempt_local_launch(
            nodes, vic, pod, feas_static, order_rank, offset, n_real,
            check_resources, has_request, max_prio)


# ---- K14b shard_preempt_select -----------------------------------------------
def shard_preempt_select_plain(gathered, P: int) -> torch.Tensor:
    """K14b plain: the replicated pick of `sharded_preempt_fn`
    (sharding.py:354) over the gathered [D, bytes] candidate records —
    `_pick_one_node` (kernels.py:1570) and `_preempt_scan_core`'s packing
    (:1598): [winner, its victim count, its PDB-violation count, its P
    slot flags] int32."""
    winner, nv, viol, flags, _res = _pick_records_plain(gathered, 0, P)
    head = torch.tensor([winner, _wrap32(nv), _wrap32(viol)], dtype=I32)
    return torch.cat([head, flags]).to(gathered.device)


_SPS_INTS = ("D", "chunk", "P")
_SPS_PTRS = ("gathered", "out")


def shard_preempt_select(gathered, P: int) -> torch.Tensor:
    """K14b on one device, over its [D, bytes] gathered records. CPU ->
    the plain version; CUDA -> `csrc/shard_preempt_select.cu`."""
    if not gathered.is_cuda:
        return shard_preempt_select_plain(gathered, P)
    dev = gathered.device
    D, chunk = (int(x) for x in gathered.shape)
    if chunk != cand_record_bytes(P) or gathered.dtype != torch.uint8:
        raise ValueError("shard_preempt_select: records are not "
                         f"[D, {cand_record_bytes(P)}] uint8")
    with _on(dev):
        out = torch.empty(3 + int(P), dtype=I32, device=dev)
        ptrs = {"gathered": gathered.contiguous(), "out": out}
        _launch("shard_preempt_select",
                *_launch_arrays({"D": D, "chunk": chunk, "P": int(P)},
                                _SPS_INTS, ptrs, _SPS_PTRS,
                                "shard_preempt_select"))
    return out


# ---- K13a shard_pressure_local ----------------------------------------------
def shard_pressure_local_plain(sh: ScanShard, side: ScanSide,
                               plan: ScanPlan) -> None:
    """K13a plain: the local step of `sharded_pressure_fn` (sharding.py
    :330) on one shard. Folds the previous step's outcome the shard owns
    (a bind into its rows, `_fold_state`, kernels.py:549; a nomination
    into its ghost load); then, unless past the window, for pod row[t]:
    the ghost-aware filter and row-local scores into K9a's record and
    whether an in-range row's first failure is resolvable (not for a skip
    pod), and on the same rows the victim walk with the pod's slot mask,
    the ghost and its static masks (`_pressure_core`, :1690), reduced to
    the candidate record (keyed by the global row)."""
    nodes, st, tab = sh.nodes, side.st, sh.tab
    dev, rows = sh.device, sh.rows
    t = int(st[SS_NEXT])
    fr = int(st[SS_FOLD_ROW])
    delta = {k: tab[k][fr] for k in ("upd_cpu", "upd_mem", "upd_eph",
                                     "upd_scalar", "nz_cpu", "nz_mem")}
    fold = int(st[SS_FOLD_SEL]) - sh.offset
    if 0 <= fold < rows:
        _fold_state_plain(nodes, delta, fold)
    g = int(st[SS_GHOST_SEL]) - sh.offset
    if 0 <= g < rows:
        for k in ("cpu", "mem", "eph"):
            sh.ghost[k][g] += delta["upd_" + k]
        sh.ghost["cnt"][g] += 1
    if t >= plan.n_steps:
        return
    r = int(side.row[t])
    pod = {k: v[r] for k, v in tab.items()}
    idx = torch.arange(rows, dtype=I64, device=dev) + sh.offset
    in_range = idx < plan.n_real
    any_res = False
    if not int(sh.scal[r, _SC_SKIP]):
        feasible, ff, bits = _feasibility_plain(nodes, pod, ghost=sh.ghost)
        vals = {"local": _local_scores_plain(nodes, pod, plan.weights),
                "zone": nodes["zone_id"], "feas": feasible & in_range}
        for k, f in _REC_FIELD.items():
            if k in plan.planes:
                vals[k] = pod[f]
        sh.rec[: plan.cand_off].copy_(
            _pack_record(vals, plan.planes, rows, dev))
        any_res = bool((in_range & _resolvable_candidates_plain(
            ff, bits)).any())
    feas_stat = in_range & nodes["valid"]
    for key in _PRESSURE_MASKS:
        feas_stat = feas_stat & pod[key].to(torch.bool)
    feas_stat = feas_stat & (pod["interpod_code"] == 0)
    valid_k = sh.vic["valid"] & (sh.vic["prio"] < int(tab["pprio"][r]))
    feas0, victims, agg = _victim_select_plain(
        nodes, sh.vic, valid_k, pod["req_cpu"], pod["req_mem"],
        pod["req_eph"], sh.ghost, feas_stat, pod["check_resources"],
        pod["has_request"])
    sh.rec[plan.cand_off:].copy_(_shard_candidate_plain(
        feas0, victims, agg, idx, sh.offset, any_res))


def shard_pressure_group_plain(shards: list, side: ScanSide,
                               plan: ScanPlan) -> None:
    """K13a plain over every shard of `shards` (the shards of `side`'s
    device): `shard_pressure_local_plain` on each, its record `rec` row
    `index` of the step's half of `side.halves`, then into every peer's
    and the stamps, as K10a (`_publish_plain`); the fold past the wave
    writes no record and publishes nothing, as the kernel's blocks return
    before their ticket."""
    live = int(side.st[SS_NEXT]) < plan.n_steps
    for sh in shards:
        sh.rec = side.records()[sh.index]
        shard_pressure_local_plain(sh, side, plan)
    if live:
        _publish_plain(shards, side, plan, [True] * len(shards))


def shard_pressure_local(shards: list, side: ScanSide,
                         plan: ScanPlan) -> Optional[Relaunch]:
    """K13a over every shard of `shards`, all on `side`'s device (the
    wave's replicated half there), each record into row `index` of
    `side.gathered`. CPU tensors -> the plain version on each shard
    (returns None); CUDA tensors -> ONE launch of
    `csrc/shard_pressure_local.cu` over them, returning its `Relaunch`
    for the wave's next steps."""
    if not side.st.is_cuda:
        return shard_pressure_group_plain(shards, side, plan)
    return _local_group_launch("shard_pressure_local", shards, side, plan)


# ---- K13b shard_pressure_select ---------------------------------------------
def shard_pressure_select_plain(side: ScanSide, plan: ScanPlan) -> None:
    """K13b plain: one step of `_pressure_core` (kernels.py:1690) in the
    replicated state of `sharded_pressure_fn` (sharding.py:330): K9b's
    cycle of pod b over the gathered records (a skip pod takes
    `_skip_cycle`), the pick over the D candidate records by axis order,
    `any_cand`, the packed [5+P] row b, and the step state (li, lni, the
    bind or ghost fold the shards owe)."""
    gathered = _await_stamps_plain(side, plan)
    st = side.st
    b = int(st[SS_STEP])
    if b >= plan.n_steps:
        _next_round(side)
        return
    li, lni = int(st[SS_LI]), int(st[SS_LNI])
    r = int(side.row[b])
    skip = bool(int(side.scal[r, _SC_SKIP]))
    if skip:
        out = _skip_cycle(li, lni, plan.n_real)
    else:
        out = _select_cycle_plain(side, plan, b, r, li, lni, b)
    winner, _nv, _viol, flags, any_res = _pick_records_plain(
        gathered, plan.cand_off, plan.vic_P)
    sel, hit = out["selected"], out["found"] > 0
    preempted = not hit and not skip and winner >= 0
    nli, nlni = out["next_last_index"], out["next_last_node_index"]
    head = [sel if hit else -1, -2 if hit else (-1 if skip else winner),
            int(any_res and not hit and not skip), _wrap32(nli),
            _wrap32(nlni - lni)]
    side.packed[b, :len(PRESSURE_HEAD)] = torch.tensor(head, dtype=I32)
    side.packed[b, len(PRESSURE_HEAD):] = flags
    vals = {SS_STEP: b + 1, SS_NEXT: b + 1, SS_LI: nli, SS_LNI: nlni,
            SS_FOLD_SEL: sel if hit else -1, SS_FOLD_ROW: r,
            SS_GHOST_SEL: winner if preempted else -1}
    for k, v in vals.items():
        st[k] = v
    _next_round(side)


def shard_pressure_select(side: ScanSide,
                          plan: ScanPlan) -> Optional[Relaunch]:
    """K13b on one device over its gathered records. CPU -> the plain
    version (returns None); CUDA -> `csrc/shard_pressure_select.cu`, one
    thread-block cluster a step (`select_plan`, as K10b), returning its
    `Relaunch` for the wave's next steps."""
    if not side.gathered.is_cuda:
        return shard_pressure_select_plain(side, plan)
    return _select_cluster_launch("shard_pressure_select", side, plan)
