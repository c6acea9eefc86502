"""Time `TorchScheduler.schedule`, one pod's serial cycle (K2), on one card;
with `--mesh D`, also the sharded cycle (K9a + K9b) on D shards of the
card, the dirty-row scatter K4 on its own, and K1.

    python3 scripts/schedule_time.py [--tree DIR] [--cycles 10] [--mesh 4]

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
matrix.

With `--mesh D` it goes on with:

  - `mesh cycle`: the same `plain` cycles through a TorchScheduler on
    `Mesh(["cuda:0"] * D)` (K9a on the shards, the records' exchange,
    K9b): the host's ms a cycle (each cycle ends in a synchronize), then,
    over `--reps` more cycles, K9a's and K9b's device time a launch
    (torch.profiler), their launches a cycle (the `obs` counters), the
    device copies a cycle the profiler saw (HtoD, DtoD) and the
    `copies.cycle` counter where the tree books it;
  - `scatter serial`, `scatter victims`, `scatter mesh`: K4 through
    `TorchScheduler._scatter_dirty`, the caller both trees share: 16
    dirty rows of the node matrix on one device (the serial cycle's
    bucket), 16 dirty rows of the preempt-single cell's victim planes
    (chip_smoke's preempt world, P 16, after `prewarm_preempt`), and 16
    dirty rows spread over the D shards of the mesh scheduler's node
    matrix. For each: the host's ms a call (`--reps` calls, then one
    synchronize), K4's device time a launch (torch.profiler), its
    launches a call (`obs`) and the HtoD copies a call the profiler saw;
  - `local_total`: K1 over the 15,000-node matrix (chip_smoke's K1
    entry): the wrapper's ms a call by CUDA events and its device time a
    launch.

The last line is one JSON object with every figure and the card's name
and power limit. Needs one CUDA card; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys
import time

#: the device copies the profiler names
COPIES = ("Memcpy HtoD", "Memcpy DtoD")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
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
    count = [0]

    def cycle(sched, infos, tree_):
        r = count[0]
        count[0] += 1
        pod = Pod(name=f"timed-{r}", priority=(50, 200, 10, 50)[r % 4],
                  containers=(Container.make(name="c", requests={
                      "cpu": 2500}),))
        res = sched.schedule(pod, infos, tree_.list_names())
        C.assume(infos, pod, res.suggested_host)

    for label in ("nominated", "plain"):
        infos, tree_, nom = C.nominated_world(C.N_NODES)
        sched = C.make_sched(tree_, device, 50)
        if label == "nominated":
            sched.nominated = nom
        ms = []
        for _ in range(args.cycles):
            t0 = time.perf_counter()
            cycle(sched, infos, tree_)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 2))
        out[label] = ms
        print(f"[schedule] {label}: ms a cycle {ms}")
    if args.mesh:
        mesh_figures(args, C, device, out, cycle)
    print(card[0] if card else "nvidia-smi: no card")
    print(json.dumps(out))
    return 0


def mesh_figures(args, C, device, out, cycle) -> None:
    """The `--mesh D` figures (the module's docstring) into `out`."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    sync = torch.cuda.synchronize
    reps = args.reps

    def profile(fn, kernels):
        """{name: (device ms a launch, launches seen)} of `kernels` and the
        copies over `reps` runs of `fn` (torch.profiler)."""
        names = tuple(kernels) + COPIES
        return dict(zip(names, C.device_time(fn, sync, reps, names)))

    def copies(seen):
        return {k.split()[-1].lower(): round(seen[k][1] / reps, 2)
                for k in COPIES}

    # the sharded cycle
    infos, tree_, _nom = C.nominated_world(C.N_NODES)
    mesh = S.Mesh([device] * args.mesh)
    sched = C.make_sched(tree_, device, 50, mesh=mesh)
    ms = []
    for _ in range(args.cycles):
        t0 = time.perf_counter()
        cycle(sched, infos, tree_)
        sync()
        ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    keys = ("launch.shard_cycle_local", "launch.shard_cycle_select",
            "copies.cycle", "gather.cycle")
    before = {k: obs.get(k) for k in keys}
    for _ in range(reps):
        cycle(sched, infos, tree_)
    sync()
    per = {k: (obs.get(k) - before[k]) / reps for k in keys}
    seen = profile(lambda: cycle(sched, infos, tree_),
                   ("shard_cycle_local_kernel", "shard_cycle_select_kernel"))
    k9a, k9b = (seen[k][0] for k in ("shard_cycle_local_kernel",
                                     "shard_cycle_select_kernel"))
    out["mesh cycle"] = {
        "shards": mesh.size, "ms": ms,
        "k9a_device_ms": k9a, "k9b_device_ms": k9b,
        "k9a_launches": per["launch.shard_cycle_local"],
        "k9b_launches": per["launch.shard_cycle_select"],
        "copies_cycle": per["copies.cycle"],
        "gather_bytes": per["gather.cycle"], "copies": copies(seen)}
    print(f"[schedule] mesh cycle on {mesh.size} shards: ms a cycle {ms}; "
          f"K9a device_ms {C.fmt_ms(k9a)} a launch, "
          f"{per['launch.shard_cycle_local']} launches a cycle; K9b "
          f"{C.fmt_ms(k9b)}, {per['launch.shard_cycle_select']}; "
          f"copies.cycle {per['copies.cycle']}; profiler copies a cycle "
          f"{copies(seen)}")

    # K4 through the scheduler's dirty-row scatter
    def scatter(label, sched, dev, n_rows, src, fields, rows):
        fn = lambda: sched._scatter_dirty(   # noqa: E731
            dev(), list(rows), n_rows, src, fields)
        fn()
        sync()
        before = obs.get("launch.scatter_rows")
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        launches = (obs.get("launch.scatter_rows") - before) / reps
        seen = profile(fn, ("scatter_rows_kernel",))
        dev_ms = seen["scatter_rows_kernel"][0]
        out[label] = {"ms": round(wall, 4), "device_ms": dev_ms,
                      "launches": launches, "copies": copies(seen)}
        print(f"[scatter] {label}: ms a call {wall:.4f}, device_ms "
              f"{C.fmt_ms(dev_ms)} a launch, {launches} launches and "
              f"{copies(seen)} copies a call")

    single = C.make_sched(tree_, device, 50)
    cycle(single, infos, tree_)
    b = single.encoder.encode(infos, tree_.list_names())
    single._node_arrays(b)
    node_fields = [(k, k) for k in single._NODE_FIELDS]
    rows16 = np.arange(0, 16 * 97, 97)
    scatter("scatter serial", single, lambda: single._dev_nodes, b.n_pad, b,
            node_fields, rows16)
    per_shard = b.n_pad // mesh.size
    spread = np.concatenate([s * per_shard + np.arange(0, 4 * 89, 89)
                             for s in range(mesh.size)])[:16]
    mb = sched.encoder.encode(infos, tree_.list_names())
    sched._node_arrays(mb)
    scatter("scatter mesh", sched, lambda: sched._dev_nodes, mb.n_pad, mb,
            node_fields, spread)
    pinfos, ptree, pdbs = C.preempt_world(C.N_NODES)
    psched = C.make_sched(ptree, device, 50)
    psched.prewarm_preempt(pinfos, ptree.list_names(), pdbs)
    vt = psched.encoder._vt
    scatter("scatter victims", psched, lambda: psched._dev_vic,
            vt.valid.shape[0], vt, psched._VIC_FIELDS, rows16)

    # K1 over the node matrix
    nodes = single._dev_nodes
    w = dict(K.DEFAULT_WEIGHTS)
    k1 = (w, nodes["nz_cpu"] + 100, nodes["nz_mem"] + 500 * C.MI,
          nodes["alloc_cpu"], nodes["alloc_mem"])
    fn = lambda: K.local_total(*k1)   # noqa: E731
    ms1 = C.cuda_time(fn, sync, 200)
    dev1, seen1 = C.device_time(fn, sync, 200, "local_total_kernel")
    out["local_total"] = {"ms": round(ms1, 4), "device_ms": dev1,
                          "launches_seen": seen1}
    print(f"[kernel] local_total: ms a call {ms1:.4f}, device_ms "
          f"{C.fmt_ms(dev1)} a launch over {seen1} launches")


if __name__ == "__main__":
    sys.exit(main())
