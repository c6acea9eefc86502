"""Time the mesh scan's and the mesh fused window's steps on one card, or
on a host's cards.

    python3 scripts/mesh_step_time.py [--tree DIR] [--reps 50] [--cards]
                                      [--wave]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of
`DIR` (default: this checkout; an older checkout unpacked with `git
archive` gives the before side of a comparison), the mesh-scan-default
window (10,000 pods, 15,000 nodes, 50 % of the nodes to find) and the
mesh-fused window (10,064 pods in 201 segments) through
`TorchScheduler(mesh=Mesh(["cuda:0"] * 4))`, four shards of the card
(`--cards`: one shard per card of the host, `make_mesh()`), and prints
the mesh's exchange (`peer`: the locals write every card's records and
stamps, the selects wait for the stamps on the device; `copy`: the host
copies other cards' records between them, as every tree before the
exchange did), then for each window its dispatch (the host's enqueue of
every step, host clock), its wall time, steps and host calls a step
(local launches, selects and record copies enqueued, over the steps; an
older tree that books no `copies.<op>` copied every record). Then it times the window's four step kernels on
their first captured call: K10a / K11a over what that call covers (one
shard in an older tree, every shard of the card in a tree with the
grouped locals), K10b / K11b on the gathered records, each `--reps`
times, as

  - `ms`: CUDA events around the loop of wrapper calls (the host's
    enqueue through ctypes included; a select's call also restores its
    step state with a device copy first), as chip_smoke.py's kernels line;
  - `host_ms`: the host's clock around the same loop, before the sync:
    what a call costs the host that enqueues it;
  - `device_ms`: the kernel's own device time a launch, from
    torch.profiler's kernel events over the same calls (the `device_time`
    of this checkout's chip_smoke.py, whatever DIR is). For K10a / K11a
    the same profiler run also times two empty kernels built here from
    this script: at the grid and parameter size of the grouped local over
    four shards (32 x 4 blocks of 128 threads, four shards' argument
    words) and of one shard's launch before the grouping (16 blocks of
    256, one shard's words; the words a shard are DIR's): the
    floor of a launch's device time.

`--wave` first times the mesh-preempt-wave cell on the same mesh: the
preempt-wave world (15,000 nodes, 149,700 victims) and its 1,024
preemptors in 8 chunks, one step of K13a and K13b a pod: its scan
(enqueue, device time and the one fetch) and dispatch a step, the host
calls a step (K13a launches, K13b launches and record copies, over the
steps; an older tree that books no `copies.pressure` copied every
record), and the two step kernels on their first captured call as
above: K13a over what that call covers (one shard, two kernels, in an
older tree; every shard of the card, one kernel, in a tree with the
grouped K13a), K13b on the gathered records.

The last line is one JSON object with every number and the card's name
and power limit. Needs one CUDA card (`--cards`: several); exits non-zero
without one.

To compare two trees on the same cards, run them in one call in turns,
parent, change, change, parent, e.g.

    for t in P C C P; do python3 scripts/mesh_step_time.py --cards --wave \
        --tree $([ $t = P ] && echo build/parent || echo .); done
"""
import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
EMPTY_SRC = r"""
// empty kernels whose parameter is a launch's table of shard arguments
// (WORDS words a shard): four shards (the grouped local) or one
struct Table4 { long long w[4 * WORDS]; };
struct Table1 { long long w[WORDS]; };
__global__ void empty_grouped_kernel(const __grid_constant__ Table4 t) {}
__global__ void empty_shard_kernel(const __grid_constant__ Table1 t) {}
extern "C" int empty_step_launch(int which, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) {
    Table4 t = {};
    empty_grouped_kernel<<<dim3(32, 4), 128, 0, s>>>(t);
  } else {
    Table1 t = {};
    empty_shard_kernel<<<16, 256, 0, s>>>(t);
  }
  return (int)cudaGetLastError();
}
"""
#: the empty kernels' names
EMPTY_KERNELS = ("empty_grouped_kernel", "empty_shard_kernel")


def build_empty(nvcc: str, words: int):
    """The empty kernels' library for `words` words a shard, built into
    build/mesh_step_time/; returns it and each kernel's launch."""
    out = HERE / "build" / "mesh_step_time"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_SRC.replace("WORDS", str(words)))
    lib_path = out / "empty.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(out / "empty.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.empty_step_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_step_launch.restype = ctypes.c_int
    return lib, (f"32 x 4 blocks of 128 threads, {4 * 8 * words:,} B",
                 f"16 blocks of 256 threads, {8 * words} B")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cards", action="store_true")
    ap.add_argument("--wave", action="store_true")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("mesh_step_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    if not K.__file__.startswith(tree):
        raise SystemExit(f"imported {K.__file__}, not the package of {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = ("\n".join(smi if opt.cards else smi[:1]) if smi
            else "nvidia-smi: no answer")
    t = time.perf_counter()
    _build.build_all()
    empty, empty_launches = build_empty(
        _build.nvcc(), len(K._SSL_INTS) + len(K._SSL_PTRS))
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    from kubernetes_tpu_torch import obs
    dev = torch.device("cuda")
    mesh = S.make_mesh() if opt.cards else S.Mesh([dev] * 4)
    exchange = getattr(mesh, "exchange", "copy")
    print(f"[mesh] {mesh.size} shards on {len(mesh.distinct)} distinct "
          f"devices; exchange {exchange}", flush=True)

    def sync():
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
    out = {"tree": tree, "card": card, "shards": [str(d) for d in
                                                   mesh.devices],
           "exchange": exchange, "windows": {}, "kernels": {}}

    # the profiler helper of this checkout's chip_smoke.py, whatever DIR is
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    device_time = mod.device_time

    def time_step(name, call, select, kernels=None):
        """`kernels`: the device kernels of one call (default: the
        entry point's `<name>_kernel`), their device times summed."""
        args, kw = cs._full(call)
        base = cs._clone(args)
        a = cs._clone(base)
        fn = getattr(K, name)

        def one():
            if select:
                a[0].st.copy_(base[0].st)
                if a[0].gz is not None:
                    a[0].gz.copy_(base[0].gz)
            fn(*a, **kw)
        ms = cs.cuda_time(one, sync, opt.reps)
        t0 = time.perf_counter()
        for _ in range(opt.reps):
            one()
        host_ms = (time.perf_counter() - t0) * 1e3 / opt.reps
        sync()
        entry = {"ms": ms, "host_ms": host_ms}
        names = kernels or (name + "_kernel",)
        if select:
            found = [r for r in device_time(one, sync, opt.reps, names)
                     if r[0] is not None]
            dev_ms = sum(r[0] for r in found) if found else None
            seen = sum(r[1] for r in found)
        else:
            # the local and the empty kernel in one profiler run
            stream = torch.cuda.current_stream().cuda_stream

            def both():
                one()
                for which in range(len(EMPTY_KERNELS)):
                    K._check(empty.empty_step_launch(which, stream),
                             "empty")
            res = device_time(both, sync, opt.reps, names + EMPTY_KERNELS)
            found = [r for r in res[:len(names)] if r[0] is not None]
            dev_ms = sum(r[0] for r in found) if found else None
            seen = sum(r[1] for r in found)
            empties = res[len(names):]
            entry["shards"] = len(args[0]) if isinstance(args[0], list) \
                else 1
            entry["empty_device_ms"] = {
                k: ms for k, (ms, _n) in zip(EMPTY_KERNELS, empties)}
        entry.update(device_ms=dev_ms, launches_timed=seen)
        out["kernels"][name] = entry
        print(f"[kernel] {name}: ms {ms:.4f} host_ms {host_ms:.4f} "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
              f"over {seen} launches"
              + ("" if select else
                 f" over {entry['shards']} shard(s) a launch; empty kernels "
                 f"in the same profiler run: " + "; ".join(
                     f"{g}: " + ("not measured" if entry["empty_device_ms"][k]
                                 is None else
                                 f"{entry['empty_device_ms'][k]:.4f}")
                     for k, g in zip(EMPTY_KERNELS, empty_launches))),
              flush=True)

    def window(label, op, names, run, local_kernels=None):
        caps = [cs.capture(k) for k in names]
        for c in caps:
            c.__enter__()
        obs.reset()
        try:
            r = run()
        finally:
            for c in reversed(caps):
                c.__exit__(None, None, None)
        ph = r["phases"]
        steps = ph["steps"]
        launches = {k: obs.get("launch." + k) for k in names}
        copies = obs.get(f"copies.{op}") if op in obs.family("copies") \
            else steps * mesh.size * len(mesh.distinct)
        if "dispatch" in ph:
            entry = {"wall_ms": r["t_burst"] * 1e3,
                     "dispatch_ms": ph["dispatch"] * 1e3}
            dispatch = ph["dispatch"]
        else:
            dispatch = ph["scan"] - ph["fetch"]
            entry = {"wave_ms": r["t_wave"] * 1e3, "scan_ms": ph["scan"] * 1e3,
                     "dispatch_ms": dispatch * 1e3}
        entry.update({"fetch_ms": ph["fetch"] * 1e3, "steps": steps,
                      "dispatch_ms_a_step": dispatch * 1e3 / steps,
                      "launches": launches, "copies": copies,
                      "host_calls_a_step":
                          (sum(launches.values()) + copies) / steps})
        out["windows"][label] = entry
        print(f"[window] {label}: {json.dumps(entry)}", flush=True)
        for c, select in zip(caps, (False, True)):
            time_step(c.fn_name, c.call, select,
                      None if select else local_kernels)

    if opt.wave:
        infos, tree_, pdbs = cs.preempt_world(cs.N_NODES)
        # an older tree's K13a ran two kernels a shard
        window("mesh-preempt-wave", "pressure", cs.PRESSURE_MESH_KERNELS,
               lambda: cs.run_wave(infos, tree_, pdbs, cs.wave_pods(), dev,
                                   sync, mesh=mesh),
               ("shard_pressure_local_kernel", "rows_kernel",
                "reduce_kernel"))
        del infos, tree_, pdbs
    cfg, n_nodes, window_fn = cs.scan_cells()[0]
    window("mesh-scan-default", "burst_scan", cs.SCAN_MESH_KERNELS,
           lambda: cs.run_scan(cfg, n_nodes, window_fn(cs.N_PODS), 0, dev,
                               sync, mesh=mesh))
    window("mesh-fused", "burst_segments", cs.SEG_MESH_KERNELS,
           lambda: cs.run_fused(cs.FUSED_CELL, cs.N_NODES,
                                cs.fused_window(), dev, sync, mesh=mesh))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
