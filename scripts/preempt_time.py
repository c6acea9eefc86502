"""Time K7 (`preempt_scan`) on one card.

    python3 scripts/preempt_time.py [--tree DIR] [--reps 20]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of `DIR`
(default: this checkout; an older checkout unpacked with `git archive`
gives the before side of a comparison):

  - `round`: K7 on the preempt-single cell's first round, its call
    captured from `preempt`: the preempt-wave world (15,000 nodes, 10
    victims of 400m on each, P 16) after `prewarm_preempt`, a 1-CPU pod
    at priority 100 on `pool=preempt` whose `schedule` raised FitError;
  - `random P 16` and `random P 128`: K7 on chip_smoke.py's random
    victim planes at n_pad 16,384 (`_rand_victims`, `_victim_nodes`).

For each: `ms`, the wrapper call's mean over `--reps` calls by CUDA
events, and `device_ms`, the device time a call of every K7 kernel it
launches (torch.profiler: one kernel, or the two of an older tree; each
kernel's mean a launch, one launch a call each). The last line is one
JSON object with every time and the card's name and power limit. Needs
one CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys

#: the CUDA kernels a K7 call may launch, in this tree or an older one
K7_KERNELS = ("preempt_scan_kernel", "victim_kernel", "pick_kernel")


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
    print(card[0] if card else "nvidia-smi: no card")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
