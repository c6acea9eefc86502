"""Time K3 (`uniform_burst`), K9b (`shard_cycle_select`), K9c
(`shard_uniform_sweep`) and K9d (`shard_uniform_select`) on one card.

    python3 scripts/uniform_time.py [--tree DIR] [--reps 20]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of `DIR`
(default: this checkout; an older checkout unpacked with `git archive`
gives the before side of a comparison), on bench.py's cluster:

  - K3 `schedule_batch_uniform` on the headline burst's own inputs
    (10,000 pods of 100m / 500 Mi, cap 16,384): `empty` (15,000 empty
    nodes, lastNodeIndex 0), `filled` (3 pods on every 7th node, lni 7:
    STAY batches cut about every 7 pods) and `rotated` (15,001 nodes,
    uneven zones: each cycle's enumeration order from `_burst_rotation`);
  - K9b `shard_cycle_select` on the mesh-uniform cell's serial cycle: a
    100m pod on the filled 15,000-node cluster split over 4 shards of the
    card (`Mesh(["cuda"] * 4)`), the select's own call captured from
    `schedule_cycle(mesh=)`;
  - K9d `shard_uniform_select` on the mesh-uniform cell's burst: the
    empty and the rotated burst split over 4 shards of the card, the
    first pass's call captured from `schedule_batch_uniform(mesh=)`, each
    timed call after the copies that restore its pass state and
    decisions, as chip_smoke.py times it;
  - K9c `shard_uniform_sweep` on the same bursts: its first pass (the
    burst's set-up: the ok mask and the pass-start scores, then the
    sweep) over the card's 4 shards in one launch, captured from the same
    call; the pass reads and writes only the shard state it sets up, so
    every timed call repeats it.

For each: `ms`, the wrapper call's mean over `--reps` calls by CUDA events,
and `device_ms`, the kernel's own device time a call (torch.profiler);
for K9d also `device_ms_copies`, the kernel and the restore copies
together, and, where the wrapper returns the bound launch (a `Relaunch`),
`relaunch_ms`: the restore copies and the bound launch's re-enqueue, as
the burst's later passes take it.
The last line is one JSON object with every time and the card's name and
power limit. Needs one CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("uniform_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.ops.node_state import PodEncoder
    from kubernetes_tpu_torch.parallel import sharding as S
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    out = {"tree": tree, "card": card[0] if card else None}
    probe = C.pods(1, prefix="fill")[0]
    cap = 16384

    def world(n_nodes, filled):
        infos, tree_ = C.cluster(n_nodes)
        names = tree_.list_names()
        if filled:
            for i in range(0, len(names), 7):
                for _ in range(3):
                    C.assume(infos, probe, names[i])
        sched = TorchScheduler(percentage_of_nodes_to_score=100,
                               node_tree=tree_, device=device)
        b = sched.encoder.encode(infos, names)
        f0 = PodEncoder(infos, b, state_encoder=sched.encoder).encode(probe)
        cls, extra, ban = sched._uniform_class(probe, f0, b, infos)
        return (sched, b, sched._node_arrays(b), cls, extra, ban,
                sched._pod_arrays(f0))

    def timed(label, fn, kernel):
        ms = C.cuda_time(fn, sync, args.reps)
        dev_ms, seen = C.device_time(fn, sync, args.reps, kernel)
        out[label] = {"ms": round(ms, 4), "device_ms":
                      None if dev_ms is None else round(dev_ms, 4)}
        print(f"[time] {label}: ms {ms:.4f} device_ms "
              f"{C.fmt_ms(dev_ms)} over {seen} launches")

    def k9d(label, call):
        """K9d's first pass of a mesh burst, restored before every call."""
        g, a, k = call
        base = C._clone((g,) + tuple(a))
        cur = C._clone(base)

        def restored(fn):
            def one():
                for i in (3, 4, 5):
                    cur[i].copy_(base[i])
                return fn()
            return one
        select = restored(lambda: K.shard_uniform_select(*cur, **k))
        ms = C.cuda_time(select, sync, args.reps)
        dev_ms, seen = C.device_time(select, sync, args.reps,
                                     "shard_uniform_select_kernel")
        # the kernel and the three restore copies a call, each from its
        # mean a launch (the profiler can miss events)
        (k_ms, _k), (c_ms, _c) = C.device_time(
            select, sync, args.reps,
            ("shard_uniform_select_kernel", "Memcpy DtoD"))
        both = None if k_ms is None or c_ms is None else k_ms + 3 * c_ms
        entry = {"ms": round(ms, 4),
                 "device_ms": None if dev_ms is None else round(dev_ms, 4),
                 "device_ms_copies": None if both is None
                 else round(both, 4)}
        rel = K.shard_uniform_select(*cur, **k)
        if rel is not None:
            entry["relaunch_ms"] = round(C.cuda_time(
                restored(lambda: K._check(rel.fn(), rel.name)), sync,
                args.reps), 4)
        out[label] = entry
        print(f"[time] {label}: {entry} ({seen} launches seen)")

    for label, n_nodes, filled, lni in (("empty", C.N_NODES, False, 0),
                                        ("filled", C.N_NODES, True, 7),
                                        ("rotated", C.N_NODES + 1, False,
                                         0)):
        sched, b, nodes, cls, extra, ban, pod = world(n_nodes, filled)
        kw = dict(extra_ok=extra, ban=ban, cap=cap)
        if label == "rotated":
            perms, seq = sched._burst_rotation(b, C.N_PODS)
            win = np.full(cap + K.K_BATCH, seq[-1], np.int32)
            win[: min(len(seq), len(win))] = seq[: len(win)]
            kw["rotation"] = (torch.as_tensor(perms).to(device),
                              torch.as_tensor(win).to(device))
        call = (nodes, cls, C.N_PODS, lni, b.n_real, True)
        timed(f"K3 {label}", lambda: K.schedule_batch_uniform(*call, **kw),
              "uniform_burst_kernel")
        if label != "filled":
            mesh = S.Mesh([device] * 4)
            with C.capture("shard_uniform_select") as cap_k9d, \
                    C.capture("shard_uniform_sweep") as cap_k9c:
                K.schedule_batch_uniform(S.shard_node_arrays(mesh, nodes),
                                         *call[1:], mesh=mesh, **kw)
            k9d(f"K9d mesh-uniform {label} first pass", cap_k9d.call)
            g, a, k = cap_k9c.call
            timed(f"K9c mesh-uniform {label} first pass",
                  lambda: K.shard_uniform_sweep(g, *a, **k),
                  "shard_uniform_sweep_kernel")
        if label == "filled":
            mesh = S.Mesh([device] * 4)
            shards = S.shard_node_arrays(mesh, nodes)
            with C.capture("shard_cycle_select") as cap_k9b:
                K.schedule_cycle(shards, pod, 123, 45, b.n_real, b.n_real,
                                 4, mesh=mesh)
            g, a, k = cap_k9b.call
            timed("K9b mesh-uniform serial cycle",
                  lambda: K.shard_cycle_select(g, *a, **k),
                  "shard_cycle_select_kernel")
    print(card[0] if card else "nvidia-smi: no card")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
