"""Time K7 (`preempt_scan`) and the sharded victim scan K14a + K14b
(`shard_preempt_local`, `shard_preempt_select`) on one card.

    python3 scripts/preempt_time.py [--tree DIR] [--reps 20]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of `DIR`
(default: this checkout; an older checkout unpacked with `git archive`
gives the before side of a comparison):

  - `round`: K7 on the preempt-single cell's first round, its call
    captured from `preempt`: the preempt-wave world (15,000 nodes, 10
    victims of 400m on each, P 16) after `prewarm_preempt`, a 1-CPU pod
    at priority 100 on `pool=preempt` whose `schedule` raised FitError;
  - `random P 16` and `random P 128`: K7 on chip_smoke.py's random
    victim planes at n_pad 16,384 (`_rand_victims`, `_victim_nodes`);
  - `mesh round`: the mesh-preempt-single cell's round, the same world
    and pod through a TorchScheduler on four shards of the card
    (`Mesh([card] * 4)`), its `preemption_scan(mesh=)` call (K14a, the
    records' exchange, K14b) captured from `preempt` and held against the
    single-device K7 block of the same rows.

For each: `ms`, the wrapper call's mean over `--reps` calls by CUDA
events, and `device_ms`, the device time a call of every kernel it
launches (torch.profiler: each kernel's mean a launch times its launches
a call; K7: one kernel, or the two of an older tree; the mesh round:
K14a's kernel, or the two a shard of an older tree, times the K14a
launches a call, plus K14b's, with `k14a_ms`, `k14b_ms`, and the device
copies of the call beside them, `dtod_ms` and `htod_ms` with their counts
a call as the profiler saw them). The mesh round also gives the preempt
call's host phases, encode, dispatch (the scan less its fetch) and
fetch, over the captured round. The last line is one JSON object with
every time and the card's name and power limit. Needs one CUDA card;
exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys

#: the CUDA kernels a K7 call may launch, in this tree or an older one
K7_KERNELS = ("preempt_scan_kernel", "victim_kernel", "pick_kernel")
#: the CUDA kernels of a K14a launch and of a K14b launch: this tree's
#: (first), else an older tree's (its two a shard, and its select); the
#: older names lie inside the newer ones, so a tree's own are taken alone
K14A_KERNELS = (("shard_preempt_local_kernel",),
                ("rows_kernel", "reduce_kernel"))
K14B_KERNELS = (("shard_preempt_select_kernel",), ("select_kernel",))
#: the device copies a sharded call may make (torch.profiler's names)
COPIES = ("Memcpy DtoD", "Memcpy HtoD")


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
        print("preempt_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    out = {"tree": tree, "card": card[0] if card else None}

    def timed(label, call):
        nodes, a, kw = call
        fn = lambda: K.preemption_scan(nodes, *a, **kw)   # noqa: E731
        want = K.preemption_scan_plain(nodes, *a, **kw)
        if C.max_abs_err(fn(), want) != 0:
            raise SystemExit(f"{label}: K7 disagrees with its plain version")
        ms = C.cuda_time(fn, sync, args.reps)
        # each kernel's mean device time a launch (one launch a call),
        # summed: the profiler can miss events, a mean does not mind
        found = [(k_ms, n) for k_ms, n in C.device_time(
            fn, sync, args.reps, K7_KERNELS) if k_ms is not None]
        dev_ms = sum(k_ms for k_ms, _n in found) if found else None
        seen = sum(n for _k, n in found)
        out[label] = {"ms": round(ms, 4), "device_ms":
                      None if dev_ms is None else round(dev_ms, 4)}
        print(f"[time] {label}: ms {ms:.4f} device_ms {C.fmt_ms(dev_ms)} "
              f"a call over {seen} launches")

    # the preempt-single cell's first round
    infos, tree_, pdbs = C.preempt_world(C.N_NODES)
    sched = C.make_sched(tree_, device, 50)
    names = tree_.list_names()
    sched.prewarm_preempt(infos, names, pdbs)
    pod = Pod(name="single-0", priority=100,
              node_selector={"pool": "preempt"},
              containers=(Container.make(name="c",
                                         requests={"cpu": 1000}),))
    try:
        sched.schedule(pod, infos, tree_.list_names())
        raise SystemExit("preempt_time: the pod was scheduled")
    except FitError as e:
        err = e
    with C.capture("preemption_scan") as cap:
        sched.preempt(pod, infos, names, err, pdbs)
    sync()
    timed("round", cap.call)
    # random planes at n_pad 16,384
    rng = np.random.default_rng(20261019)
    n_pad, n_real = 16384, 16000
    for P in (16, 128):
        vic = C._rand_victims(rng, n_pad, P, device)
        nodes = C._victim_nodes(rng, vic, n_pad, n_real, device)
        feas = torch.as_tensor(rng.random(n_pad) < 0.9).to(device)
        rank = torch.as_tensor(rng.permutation(n_pad)).to(device)
        pod_in = {"req_cpu": np.int64(1500), "req_mem": np.int64(2 * C.GI),
                  "req_eph": np.int64(C.GI)}
        timed(f"random P {P}", (nodes, (vic, pod_in, feas, rank, n_real,
                                        True, True, 6), {}))
    # the mesh-preempt-single cell's round: the same world and pod on four
    # shards of the card
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = S.Mesh([device] * 4)
    msched = C.make_sched(tree_, device, 50, mesh=mesh)
    msched.prewarm_preempt(infos, names, pdbs)
    try:
        msched.schedule(pod, infos, tree_.list_names())
        raise SystemExit("preempt_time: the pod was scheduled on the mesh")
    except FitError as e:
        err = e
    with C.capture("preemption_scan") as cap:
        msched.preempt(pod, infos, names, err, pdbs)
    sync()
    ph = dict(msched.last_preempt_phases)
    nodes, a, kw = cap.call
    fn = lambda: K.preemption_scan(nodes, *a, **kw)   # noqa: E731
    whole = {k: v.to(device) for k, v in C.cat_rows(nodes).items()}
    planes = {k: v.to(device) for k, v in C.cat_rows(a[0]).items()}
    if C.max_abs_err(fn(), K.preemption_scan(whole, planes, *a[1:])) != 0:
        raise SystemExit("mesh round: the sharded block differs from K7's")
    sync()
    obs.reset("launch.")
    fn()
    sync()
    n_a = obs.get("launch.shard_preempt_local")
    n_b = obs.get("launch.shard_preempt_select")
    ms = C.cuda_time(fn, sync, args.reps)
    names = tuple(k for group in K14A_KERNELS + K14B_KERNELS
                  for k in group) + COPIES
    seen = dict(zip(names, C.device_time(fn, sync, args.reps, names)))

    def per_call(groups, launches):
        # the first group whose kernels the trace holds: each kernel's mean
        # a launch, summed, times the launches a call
        for group in groups:
            found = [seen[k][0] for k in group if seen[k][0] is not None]
            if found:
                return sum(found) * launches
        return None
    k14a = per_call(K14A_KERNELS, n_a)
    k14b = per_call(K14B_KERNELS, n_b)
    copies = {}
    for name, (t, n) in zip(("dtod", "htod"), (seen[k] for k in COPIES)):
        # a copy's mean a launch times the copies a call the profiler saw
        a_call = n / args.reps
        copies[name] = (None if t is None else round(t * a_call, 4),
                        round(a_call, 2))
    dev_ms = None if k14a is None or k14b is None else k14a + k14b
    out["mesh round"] = {
        "ms": round(ms, 4),
        "device_ms": None if dev_ms is None else round(dev_ms, 4),
        "k14a_ms": None if k14a is None else round(k14a, 4),
        "k14b_ms": None if k14b is None else round(k14b, 4),
        "k14a_launches": n_a, "k14b_launches": n_b,
        "dtod_ms": copies["dtod"][0], "dtod_a_call": copies["dtod"][1],
        "htod_ms": copies["htod"][0], "htod_a_call": copies["htod"][1],
        "encode_ms": round(ph["encode"] * 1e3, 4),
        "dispatch_ms": round((ph["scan"] - ph["fetch"]) * 1e3, 4),
        "fetch_ms": round(ph["fetch"] * 1e3, 4)}
    print(f"[time] mesh round: ms {ms:.4f} device_ms {C.fmt_ms(dev_ms)} a "
          f"call (K14a {C.fmt_ms(k14a)} over {n_a} launches, K14b "
          f"{C.fmt_ms(k14b)} over {n_b}); copies a call: DtoD "
          f"{copies['dtod'][1]} ({copies['dtod'][0]} ms), HtoD "
          f"{copies['htod'][1]} ({copies['htod'][0]} ms); preempt's round: "
          f"encode {ph['encode'] * 1e3:.2f} dispatch "
          f"{(ph['scan'] - ph['fetch']) * 1e3:.2f} fetch "
          f"{ph['fetch'] * 1e3:.2f} ms")
    print(card[0] if card else "nvidia-smi: no card")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
