"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` (plus the shared headers `csrc/*.cuh`) compiles on
its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

into `build/kernels/` at the repository root (listed in .gitignore), at
first use. The file name carries a hash of the sources, so an edited
kernel rebuilds and a stale library is never loaded. Each source exposes a
plain C function `<name>_launch(...)` that launches on the stream it is
given and returns `cudaGetLastError()`; the library is loaded with ctypes.

`build_all()` starts one nvcc per source at once and waits for all of
them: the whole build costs about one compile, not twenty.

Threads of one process (the fleet's instances, each on its own thread
over one card) may reach a kernel's first use together: one lock guards
the build and the load, so a library is compiled once, into a temporary
file of its own, and loaded once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NAMES = ("local_total", "schedule_cycle", "uniform_burst", "scatter_rows",
         "schedule_batch", "schedule_segments", "preempt_scan",
         "pressure_batch", "shard_cycle_local", "shard_cycle_select",
         "shard_uniform_sweep", "shard_uniform_select", "shard_scan_local",
         "shard_scan_select", "shard_segments_local",
         "shard_segments_select", "shard_preempt_local",
         "shard_preempt_select", "shard_pressure_local",
         "shard_pressure_select")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: argument types of each library's `<name>_launch` (ctypes passes an
#: untyped python int as a 32-bit int, which would cut a pointer)
SIGNATURES = {
    "local_total": [_I, _P, _P, _L, _L, _P, _P, _I, _P, _P, _P],
    # K4: the call's host words, the device's field table, the staged
    # buffer on the device, the stream
    "scatter_rows": [ctypes.POINTER(_L), _P, _P, _P],
    # the scan kernels take host arrays of scalars and of pointers
    # the cluster kernels (K2, K3, K5, K6, K8, K9b) also take their
    # geometry (`kernels.cycle_plan` / `uniform_plan` / `cluster_plan` /
    # `pressure_plan` / `select_plan`: blocks, node slots a thread,
    # resident, bytes, scratch)
    "uniform_burst": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                      ctypes.POINTER(_L), _P],
    "schedule_cycle": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                       ctypes.POINTER(_L), _P],
    "schedule_batch": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                       ctypes.POINTER(_L), _P],
    "schedule_segments": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                          ctypes.POINTER(_L), _P],
    "preempt_scan": [ctypes.POINTER(_L), ctypes.POINTER(_P), _P],
    "pressure_batch": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                       ctypes.POINTER(_L), _P],
    # K9a takes every shard of one device, as the grouped locals below
    "shard_cycle_local": [ctypes.POINTER(_L), _I, _I, _P,
                          ctypes.POINTER(_I)],
    "shard_cycle_select": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                           ctypes.POINTER(_L), _P],
    # K9c takes every shard of one device, as the grouped locals below
    "shard_uniform_sweep": [ctypes.POINTER(_L), _I, _I, _P,
                            ctypes.POINTER(_I)],
    # K9d, one cluster a pass, is bound once a burst as the selects below
    "shard_uniform_select": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                             ctypes.POINTER(_L), _I, _P,
                             ctypes.POINTER(_I)],
    # the grouped locals (K10a, K11a, K13a) take every shard of one
    # device: the shards' argument words, their count, the device index,
    # the stream, and the count each launch made adds one to
    "shard_scan_local": [ctypes.POINTER(_L), _I, _I, _P,
                         ctypes.POINTER(_I)],
    # the cluster selects (K10b, K11b, K13b) also take their geometry
    # (`kernels.select_plan`) and the device index, and count as the locals
    "shard_scan_select": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                          ctypes.POINTER(_L), _I, _P, ctypes.POINTER(_I)],
    "shard_segments_local": [ctypes.POINTER(_L), _I, _I, _P,
                             ctypes.POINTER(_I)],
    "shard_segments_select": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                              ctypes.POINTER(_L), _I, _P,
                              ctypes.POINTER(_I)],
    # K14a takes every shard of one device, as the grouped locals
    "shard_preempt_local": [ctypes.POINTER(_L), _I, _I, _P,
                            ctypes.POINTER(_I)],
    "shard_preempt_select": [ctypes.POINTER(_L), ctypes.POINTER(_P), _P],
    "shard_pressure_local": [ctypes.POINTER(_L), _I, _I, _P,
                             ctypes.POINTER(_I)],
    "shard_pressure_select": [ctypes.POINTER(_L), ctypes.POINTER(_P),
                              ctypes.POINTER(_L), _I, _P,
                              ctypes.POINTER(_I)],
}

#: other C functions of a library: `<name>_clusters(geometry, *clusters)`
#: asks the card how many clusters of a geometry it can hold at once (and
#: sets the geometry's launch attributes on the current device);
#: `mesh_enable_peers(devices, n)` (K10a's library) enables peer access
#: for every ordered pair of a mesh's cards; `preempt_scan_occupancy(sms,
#: per_sm)` (K7's) gives the card's SM count and the K7 blocks an SM holds,
#: `shard_preempt_local_occupancy(sms, per_sm)` (K14a's) the K14a blocks
QUERIES = {name: {name + "_clusters": [ctypes.POINTER(_L),
                                       ctypes.POINTER(_I)]}
           for name in ("schedule_cycle", "uniform_burst", "schedule_batch",
                        "schedule_segments", "pressure_batch",
                        "shard_cycle_select", "shard_uniform_select",
                        "shard_scan_select",
                        "shard_segments_select", "shard_pressure_select")}
QUERIES["shard_scan_local"] = {"mesh_enable_peers": [ctypes.POINTER(_I),
                                                     _I]}
QUERIES["preempt_scan"] = {"preempt_scan_occupancy": [ctypes.POINTER(_I),
                                                      ctypes.POINTER(_I)]}
QUERIES["shard_preempt_local"] = {
    "shard_preempt_local_occupancy": [ctypes.POINTER(_I),
                                      ctypes.POINTER(_I)]}

_LIBS: dict[str, ctypes.CDLL] = {}
#: guards `build_all` and `load` (re-entrant: `load` builds under it)
_LOCK = threading.RLock()


def nvcc() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cand:
        p = Path(home) / "bin" / "nvcc"
        if home and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=NAMES, verbose: bool = False) -> dict[str, float]:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: seconds} for the libraries it built."""
    with _LOCK:
        return _build_locked(names, verbose)


def _build_locked(names, verbose: bool) -> dict[str, float]:
    import time
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    took = {}
    try:
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            if verbose:
                print(f"[build] {name}: {log.strip()}")
            os.replace(tmp, out)
            took[name] = time.perf_counter() - t0
    finally:
        # a failed build leaves no compiler running behind it
        for proc, _tmp, _out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        return _load_locked(name)


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        for qname, argtypes in QUERIES.get(name, {}).items():
            q = getattr(lib, qname)
            q.argtypes = argtypes
            q.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
