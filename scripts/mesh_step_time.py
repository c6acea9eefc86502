"""Time the mesh scan's and the mesh fused window's steps on one card, or
on a host's cards.

    python3 scripts/mesh_step_time.py [--tree DIR] [--reps 50] [--cards]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of
`DIR` (default: this checkout; an older checkout unpacked with `git
archive` gives the before side of a comparison), the mesh-scan-default
window (10,000 pods, 15,000 nodes, 50 % of the nodes to find) and the
mesh-fused window (10,064 pods in 201 segments) through
`TorchScheduler(mesh=Mesh(["cuda:0"] * 4))`, four shards of the card
(`--cards`: one shard per card of the host, `make_mesh()`), and prints
for each its dispatch (the host's enqueue of every step, host clock) and
steps. Then it times the window's four step kernels on their first
captured call: K10a / K11a on shard 0, K10b / K11b on the gathered
records, each `--reps` times, as

  - `ms`: CUDA events around the loop of wrapper calls (the host's
    enqueue through ctypes included; a select's call also restores its
    step state with a device copy first), as chip_smoke.py's kernels line;
  - `host_ms`: the host's clock around the same loop, before the sync:
    what a call costs the host that enqueues it;
  - `device_ms`: the kernel's own device time a launch, from
    torch.profiler's kernel events over the same calls (chip_smoke.py's
    `device_time`, of DIR's chip_smoke.py or, where that has none, of this
    checkout's).

The last line is one JSON object with every number and the card's name
and power limit. Needs one CUDA card (`--cards`: several); exits non-zero
without one.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cards", action="store_true")
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
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    dev = torch.device("cuda")
    mesh = S.make_mesh() if opt.cards else S.Mesh([dev] * 4)

    def sync():
        for d in mesh.distinct:
            torch.cuda.synchronize(d)
    out = {"tree": tree, "card": card, "shards": [str(d) for d in
                                                   mesh.devices],
           "windows": {}, "kernels": {}}

    device_time = getattr(cs, "device_time", None)
    if device_time is None:
        here = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                      here)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        device_time = mod.device_time

    def time_step(name, call, select):
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
        dev_ms, seen = device_time(one, sync, opt.reps, name + "_kernel")
        out["kernels"][name] = {"ms": ms, "host_ms": host_ms,
                                "device_ms": dev_ms, "launches_timed": seen}
        print(f"[kernel] {name}: ms {ms:.4f} host_ms {host_ms:.4f} "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
              f"over {seen} launches", flush=True)

    def window(label, names, run):
        caps = [cs.capture(k) for k in names]
        for c in caps:
            c.__enter__()
        try:
            r = run()
        finally:
            for c in reversed(caps):
                c.__exit__(None, None, None)
        ph = r["phases"]
        out["windows"][label] = {"wall_ms": r["t_burst"] * 1e3,
                                 "dispatch_ms": ph["dispatch"] * 1e3,
                                 "fetch_ms": ph["fetch"] * 1e3,
                                 "steps": ph["steps"],
                                 "dispatch_ms_a_step":
                                     ph["dispatch"] * 1e3 / ph["steps"]}
        print(f"[window] {label}: {json.dumps(out['windows'][label])}",
              flush=True)
        for c, select in zip(caps, (False, True)):
            time_step(c.fn_name, c.call, select)

    cfg, n_nodes, window_fn = cs.scan_cells()[0]
    window("mesh-scan-default", cs.SCAN_MESH_KERNELS,
           lambda: cs.run_scan(cfg, n_nodes, window_fn(cs.N_PODS), 0, dev,
                               sync, mesh=mesh))
    window("mesh-fused", cs.SEG_MESH_KERNELS,
           lambda: cs.run_fused(cs.FUSED_CELL, cs.N_NODES,
                                cs.fused_window(), dev, sync, mesh=mesh))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
