"""Time `TorchScheduler.schedule`, one pod's serial cycle (K2), on one card.

    python3 scripts/schedule_time.py [--tree DIR] [--cycles 10]

Runs, with the `kubernetes_tpu_torch` package and `chip_smoke.py` of `DIR`
(default: this checkout; an older checkout unpacked with `git archive`
gives the before side of a comparison), `--cycles` serial cycles of 2.5-CPU
pods at priorities 50, 200, 10, 50, ... on bench.py's 15,000-node cluster
at the default 50 % of the nodes to find, each pod assumed on its host
before the next:

  - `nominated`: with chip_smoke's nominees (a 2-CPU pod of priority 100
    nominated on two nodes of three, a 1-CPU one of priority 10 on every
    fifth), so the cycles that count them run K2 with the nominated ghost
    (the mesh-nominated-serial cell's single-device side);
  - `plain`: with no nominee (the serial tails of the uniform and scan
    cells).

Each cycle's time is the host's clock around `schedule` and a
`torch.cuda.synchronize()`: the encode, the pod's upload, K2, and the
fetch and decode of its outputs. The first cycle also uploads the node
matrix. The last line is one JSON object with every time and the card's
name and power limit. Needs one CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--cycles", type=int, default=10)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("schedule_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.ops import _build
    _build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    device = torch.device("cuda")
    out = {"tree": tree, "card": card[0] if card else None}
    for label in ("nominated", "plain"):
        infos, tree_, nom = C.nominated_world(C.N_NODES)
        sched = C.make_sched(tree_, device, 50)
        if label == "nominated":
            sched.nominated = nom
        ms = []
        for r in range(args.cycles):
            pod = Pod(name=f"timed-{r}", priority=(50, 200, 10, 50)[r % 4],
                      containers=(Container.make(name="c", requests={
                          "cpu": 2500}),))
            t0 = time.perf_counter()
            res = sched.schedule(pod, infos, tree_.list_names())
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 2))
            C.assume(infos, pod, res.suggested_host)
        out[label] = ms
        print(f"[schedule] {label}: ms a cycle {ms}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
