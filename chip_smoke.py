"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one card: every kernel and path
    python3 chip_smoke.py --cards    # a host's cards: the mesh phase only,
                                     # one shard per card

1. Builds the port's CUDA kernels (one nvcc per source, all at once).
2. Holds each kernel (K1 local_total, K2 schedule_cycle, K3 uniform_burst,
   K4 scatter_rows, K5 schedule_batch, K6 schedule_segments, K7
   preempt_scan, K8 pressure_batch, and the mesh kernels K9a
   shard_cycle_local, K9b shard_cycle_select, K9c shard_uniform_sweep,
   K9d shard_uniform_select, K10a shard_scan_local, K10b
   shard_scan_select, K11a shard_segments_local, K11b
   shard_segments_select, K13a shard_pressure_local, K13b
   shard_pressure_select, K14a shard_preempt_local, K14b
   shard_preempt_select) equal to its plain PyTorch version on the
   card, at the main paths' shapes (n_pad 16,384; K5 and K6 on a
   window's first 1,024 pods, K8 on a 128-pod chunk of preempt-wave, K7
   on a preempt-single round, K9a-d on their first call of the mesh
   path, K10a/b, K11a/b and K13a/b on the first step of
   mesh-scan-default, mesh-fused and mesh-preempt-wave, K14a/b on the
   first mesh-preempt-single round), times both, and holds every kernel
   mode against the plain version on random inputs (K5 and K6, each one
   thread-block cluster a window, in every mode on seven cluster
   geometries: blocks that own no node, a node axis that is not a
   multiple of the cluster's span, li, winners and ties in different
   blocks, S > 0, the rows in global memory, and the rows and the
   per-slot scratch in global memory at 262,144 slots on 16 blocks and
   131,072 on 8; K7 (one launch over the whole card) at P 16 and 128 in
   every case, duplicate ranks and a ragged n_real among them, and at
   262,144 slots, K8 at P 16 and
   128, K4 on the victim planes, K9a-d on 1, 2 and 4 shards with every
   cycle mode and every K3 case, K9d (one thread-block cluster a pass)
   at 262,144 slots on 16 blocks and 131,072 on 8 (rotated: the lists
   and bits in a global workspace), K10a-K11b on 1, 2 and 4 shards in every
   scan and segments mode on nine geometries of the cluster selects
   K10b / K11b (one thread-block cluster a step: select blocks that own
   no node, an 8-block cluster, 20,000 slots at two a thread, li, winners
   and ties in different blocks; on 4 shards, the records staged in
   global memory at 32,768 slots on 8 blocks and 50,000 on 16, the
   20,000-slot plan launched again after smaller plans, and the records
   and the scratch in global memory at 262,144 slots on 16 blocks and
   131,072 on 8), K8 (one thread-block cluster a chunk) on five
   geometries (16 blocks with the rows, ghost load and victim aggregates
   resident in shared memory, 8 blocks with them in global memory, n_pad
   1,024 on one block, each at P 16 and 128; the rows and the scratch in
   global memory at 262,144 slots on 16 blocks and 131,072 on 8, at P
   16), ghost off and carried in, on one spec run (the victim
   scan reused pod after pod) and on alternating specs, K13a-K14b on 1,
   2 and 4 shards at P 16 and 128 (K14 also at 24, each K14a record in
   place on every device), the grouped K13a on 8, 4, 2 and 1
   shards of the card in every step state of a wave, K2 and K9a/b with a
   nominated ghost; K2, one thread-block cluster a cycle, on six
   geometries of `cycle_plan`: n_pad 16,384 on 16 blocks and on the
   8-block fallback, a ragged axis at two slots a thread, li, ties and
   winners in different blocks, the scratch in a global workspace at
   262,144 slots on 16 blocks and 131,072 on 8, each in the identity,
   perm and pos walks with and without a nominated ghost, a skip pod and
   a weight table; K13b, one thread-block cluster a step, at 262,144
   slots on 16 blocks and 131,072 on 8: a sharded 16-pod chunk against
   the sharded plain wave and the single-device plain K8). The K2 / K5 /
   K6 / K8 / K10b / K11b / K13b `[kernel]` and `[variants]` lines print
   each launch's geometry: blocks of the cluster, node slots a thread,
   rows (a select: its step's records) in shared memory or not, the
   per-slot scratch in shared memory or in a global workspace (with its
   bytes), shared bytes a block, and how many such clusters the card
   holds; K2's, K3's and K13b's plans are on the kernels line too
   (`plan`). K3, one thread-block cluster a burst, is held on the
   headline burst (the empty 15,000-node cluster), the filled cluster
   (STAY batches cut about every 7 pods), the rotated burst of the
   15,001-node world, and on four `uniform_plan` geometries in every
   case of its random inputs (the 8-block fallback, a ragged axis, and
   the rows in global memory at 262,144 slots on 16 blocks and 131,072
   on 8, with rotation the scratch too); K9b, one cluster a cycle, on its
   mesh calls and at 262,144 slots on 16 blocks and 131,072 on 8 (the
   records and the scratch in global memory). K1, K2, K3, K4, K7, K8,
   K9a-d, K10a/b, K11a/b, K13a/b, K14a and K14b also get `device_ms` on
   the kernels line: the kernel's own device time a launch
   (torch.profiler; K9d: with the
   copies that restore its pass state, its own time `device_ms_kernel`
   beside it, and `relaunch_ms`, the bound launch's re-enqueue) beside
   `ms`, the wrapper call's (K9a also on mesh-scan-default's first
   serial cycle, `device_ms_scan_default`; K3 also on the filled and
   rotated bursts, `device_ms_filled`, `device_ms_rotated`; K7's `grid`,
   its blocks and the blocks the card holds at once).
   K9a, K9c, K10a, K11a, K13a and K14a run one launch a device over every
   shard it holds, each record written into the device's gathered buffer:
   their
   check captures that launch over the card's four shards (bound, `ms`
   and `device_ms` for the four together; `shards` on the kernels line;
   K9a / K10a / K11a / K13a / K14a also write every other card's buffer
   and publish the call's or step's stamps; K9b and K14b read the records
   in place after them; K9a's `htod_a_call` and `record_copies_a_call`,
   a serial cycle's pod uploads and record copies, must be 1 a card and
   0), K4 runs one staged copy and one launch a device (`htod_a_call` on
   the kernels line; held on the serial bucket, the victim planes and a
   4-shard mesh scatter), and
   `[variants]
   grouped locals` holds both against their plain versions on 4, 2 and 1
   shards of the card in the step states of a window (folds on a shard's
   first and last row, a skip pod, the fold past the window, a segment
   checkpoint, a gang rewound across every shard, a member behind its
   gang's failure).
3. Drives the paths through TorchScheduler, each on 15,000 or 15,001 nodes
   (bench.py's node shape: 4 CPU, 32 Gi, 110 pods, zone i % 3):
   - the uniform burst (K3): 10,000 identical pods (100m / 500 Mi), the
     assume loop, then serial cycles; on 15,000 and 15,001 nodes; K1 is
     inline in K3 (and K9c): the path fails if K1 launches;
   - scan-default (K5): the same pods at the default
     percentageOfNodesToScore (50: 7,500 nodes to find), identity and
     perm walks, then four serial cycles at the carried last_index;
   - scan-mixed (K5): four Deployment shapes interleaved, two profiles,
     full scan on 15,001 nodes (the gather-free position walk);
   - scan-spread (K5): identical pods one Service selects (the carried
     selector-spread vector);
   - fused-gang (K6): one drain window of 100 gangs of 64 and singleton
     runs, under a rank-aware profile, with one gang that cannot all fit
     and rewinds mid-window;
   - preempt-wave (K8): 10 victims of 400m on each of 15,000 nodes (9 on
     every 50th), a PDB over a quarter of them, and 1,024 preemptors
     (512 at priority 100, 384 at 50, 128 at 1) in 8 chunks and one
     fetch: bound, nominated and failed outcomes;
   - preempt-baseline (K8): BASELINE.json configs[3], 1,000 nodes x
     10,000 victims and 128 preemptors, after prewarm_preempt;
   - preempt-single (K7, with K2 and K4): 12 rounds of schedule ->
     FitError -> preempt on the preempt-wave world, the shell's evictions
     in between; rounds 2-12 scatter the victim planes' dirty rows;
   - mesh-uniform (K9a-d, with K4 a card; no K1 launch): the uniform burst
     and four serial cycles through TorchScheduler(mesh=Mesh(["cuda"] *
     4)), four shards on the one card, on 15,000 and 15,001 nodes, held
     against the single-device K3/K2 run of the same world: decisions,
     the packed block, lni, the folded rows gathered back and the
     resident matrix;
   - mesh-scan-default (15,000 and 15,001 nodes), mesh-scan-mixed,
     mesh-scan-spread (K10a/b, with K9a/b and K4 in the serial tail) and
     mesh-fused (K11a/b): the scan and fused cells' windows through
     TorchScheduler(mesh=Mesh(["cuda"] * 4)), one step per pod, each
     whole window held against the single-device K5/K6 run of the same
     world in the same call: every decision, the serial tail, the walk
     counters, the packed block, li, lni and the folded rows; each prints
     a `[mesh-step]` line (host calls a step: local launches, selects and
     record copies enqueued over the steps, as the launch functions and
     the all-gather counted them; on one card two, the grouped local and
     the select, with no copy) and fails unless the local ran
     once a device and step (plus the last fold), the select once a
     device and step, and only other devices' records were copied;
   - mesh-preempt-wave (K13a/b): the preempt-wave world and queue on
     four shards of the card, held against the single-device K8 wave of
     the same call (outcomes, victims, counters, folded rows, and every
     chunk's ghost, li, lni and packed block), with a `[mesh-step]` line
     (K13a launches, K13b launches and record copies, checked: one K13a
     launch a device and step plus one a chunk for its last fold);
   - mesh-preempt-single (K14a/b, with K9a/b and K4): 4 more rounds on
     the world preempt-single leaves, each K14 block held against the
     single-device K7 block of the same rows and planes; it fails unless
     K14a (one launch over the card's shards) and K14b ran once a device
     and round with no record copy, over the "peer" exchange;
   - mesh-nominated-serial (C1: K9a/b with each shard's ghost slice): 8
     serial cycles while 13,000 nominees hold nodes, held against the
     single-device K2 run with the same ghost;
   - scan-200k (K5 with its rows and scratch in global memory): the
     largest cell of the JAX harness's shard matrix, 200,000 nodes and a
     1,000-pod window at the default 50 % on one card, its first 64 pods
     held against the plain path;
   - commit: the shell's wave commit on the uniform and scan-default
     bursts (15,000 nodes, wave_size 1,024): with a commit callback the
     windows tile the decisions and decisions, walk counters and folded
     rows equal the bursts without one; a commit that answers False at
     the third window leaves the first three windows, the walk counters
     at that prefix (the uniform one also against the plain path) and no
     resident folds; a stale_scan drill raises StaleNodeRefusal before
     any window commits; a `[commit]` line gives the windows and the host
     ms a commit;
   - twin: the serial cycle's host twin on a CUDA TorchScheduler at
     15,000 nodes: a nominee with a host port sends a cycle to the twin,
     the next cycle (resource-only nominees) runs on K2 with the ghost,
     both equal to a device="cpu" run of the same sequence; prints the
     twin's count and host ms;
   - shell uniform: bench.py's default cell through the port's scheduler
     shell (`kubernetes_tpu_torch.scheduler.Scheduler(store)`, its defaults),
     from the store to the bind: a Store of 15,000 nodes, sync, a 64-pod
     warm-up burst, then 10,000 pods of 100m / 500 Mi created in the
     store and `schedule_burst(max_pods=10000)` until it returns 0, then
     a pump. Every pod must be bound in the store, on the host a direct
     TorchScheduler.schedule_burst gives for the same two bursts on a
     fresh snapshot (run_path's helpers), K3 must have launched, and no
     twin, refusal or breaker fault may be counted; a `[shell]` line
     gives the wall time, pods/s, the burst's phases (encode, of which
     the node mirror; dispatch; fetch) and the shell's commit ms;
   - shell preempt-baseline: BASELINE.json configs[3]'s world (1,000
     nodes x 10 bound victims of 400m, 128 preemptors of 400m at priority
     10) through the shell, serial cycles on K2: the burst fails, the
     pressure tail runs K8, victims are evicted and the preemptors bind
     over rounds of a fake clock; bindings, nominations and evictions
     must equal the same shell on device="cpu" (the plain versions);
   - serve: the serve cell (`kubernetes_tpu/perf/harness.py`
     run_serve_cell) through the port's ServeLoop over the shell on the
     card: 1,000 nodes, a 64-pod warm-up, then the BackpressureGate at
     max(4 x window, 2 x rate) (Retry-After base 0.25 s) and 2,000
     arrivals/s for 10 s (the cell's 30 s cut), window 2,048, depth 3,
     the completion reaper past half the cell's capacity, the cyclic GC
     frozen over the timed window; then the drain, the
     all-admitted-or-429'd audit and 3 windows of 256 fresh arrivals
     recorded by the flight recorder in replay mode and replayed through
     the oracle with no violation; a `[serve]` line gives the sustained
     pods/s, startup p50 / p99 (the LEDGER), windows cut, idle ticks,
     the most launches in flight, sheds and the launches of the timed
     window (K3 must have run);
   - fleet: the fleet cell (run_fleet_cell): 2 FleetInstances, each on a
     thread of its own with its own TorchScheduler on the card, over one
     store of 1,000 nodes in 8 shards and one fleet gate,
     namespace-spread arrivals at 4,000/s for 10 s (the cell's 20 s
     cut; its windows mix namespaces, so they run on K5): no double bind
     (BindAuditor), all admitted or 429'd, claims disjoint at every
     probe, K5 launched; an error on a drive thread stops the run;
     then a FleetManager(record=True) run on a fake clock, 3 instances
     with mixed pods (scan windows), one killed mid-run, each survivor
     replayed on the card (replay_instance) bit for bit; two `[fleet]`
     lines;
   - cmd: the port's kube-scheduler command (`kubernetes_tpu_torch.cmd.
     scheduler.main`) from files written to a temporary directory, three
     ways: (a) a SchedulerConfiguration (DefaultProvider, 100 %) and a
     cluster spec of bench.py's cluster as hollow nodes (15,000 nodes of 4
     CPU / 32 Gi / 110 pods in 3 zones, 10,000 pods of 100m / 500 Mi),
     `--once --burst 10000`; (b) the same with `--algorithm-provider
     ClusterAutoscalerProvider`; (c) a Policy file (the DefaultProvider's
     predicates and priorities, LeastRequested 1, NodeAffinity 2) on
     15,001 nodes, a third labelled disktype=ssd, and 2,048 pods of
     scan-mixed's four shapes (the third with required node affinity
     disktype in (ssd)), `--once --burst 2048`: one window of four specs
     on K5. Each must print all pods scheduled, none unschedulable or in
     error, on a TorchScheduler on cuda with its kernel launched; (a) and
     (b) must bind every pod where a Scheduler built directly with the
     arguments create_scheduler resolved binds it, (c) where the same
     command with `--device cpu` (the plain versions) binds it. Then
     serve_http over (c)'s scheduler on port 0 must answer /healthz,
     /metrics (with scheduler_schedule_attempts_total and
     process_resident_memory_bytes), /debug/timeseries and /configz;
     `[cmd]` lines give each run's loop time, pods/s and route;
   - scraper: the time-series scraper's overhead floor (the JAX package's
     tests/test_timeseries.py:471-510, on the card): the shell uniform
     cell with the process-global SCRAPER sampling the whole registry
     every 0.05 s and without it, ABAB, best of 3 each, the cyclic GC
     frozen over each timed loop; it holds when the best rate with the
     scraper is >= 0.95 x the best without, or when the sampling duty
     cycle (20 samples' wall over the interval) is under 1 %; at 5,000
     nodes x 3,000 pods when the first pair promises more than 90 s for
     the six runs;
   - tuner: the tuner cell (`kubernetes_tpu_torch.tuner.cell.
     run_tuner_cell`, the JAX harness's run_tuner_cell) at its defaults:
     worlds recorded on the card, the seeded search run twice (the same
     winner), two FleetInstance lanes at 250 arrivals/s for 12 s with
     the searched row written into the shadow profile at 30 % of the run
     (set_row + reload_profiles), every recorded burst replayed through
     the oracle across the write with 0 violations, no double bind,
     every arrival bound, K5 launched; a `[tuner]` line gives the search
     seconds, the rewards, each lane's windowed p99, utilization and
     pods/s, the gate's decision and the K5 / K3 launches;
   - extender: (a) bench.py's world (15,000 nodes, each with
     example.com/gpu: 4) with a callable binder extender that manages
     example.com/gpu, 9,000 plain pods then 1,000 that request one, each
     block a K3 burst: all bound, the binder called exactly 1,000 times,
     the bindings equal to the same world without the extender; (b) the
     binder on preempt-baseline's world, the 128 preemptors arriving one
     at a time: K7 and no K8, victims, bindings and nominations equal to
     the run without it (one-pod K8 waves); then all 128 queued at once,
     as preempt-baseline queues them: K7 for the first, and the device
     victim scan refuses each later one while a nominee is pending
     (`refusal.preempt-nominated-ghosts`, at most 127, printed; the host
     preemptor decides those, as the reference's refusal sends them),
     no K8, victims, bindings and nominations equal to the queued run
     without the extender (one K8 wave); (c) a filter + prioritize +
     preempt extender over real HTTP on 1,000 nodes x 200 pods: the
     generic scheduler with the reference's warning, no kernel launched,
     the verbs' choices obeyed; `[extender]` lines give the binder's cost
     a pod, the route and the extender's calls;
   - http: (a) `cmd.scheduler.main --server URL --token T --once --burst
     10000` against an APIServer (bearer token for system:kube-scheduler,
     RBAC) over bench.py's cell of hollow nodes and pods: a TorchScheduler
     on cuda, K3, all bound in the server's store, equal to `[cmd]
     default`; the wall, the initial lists, the wave commits over HTTP and
     pods/s; (b) `main --api-port` on a free port: a list, a create and a
     watch resumed from a resourceVersion that delivers the command's
     bind; (c) arrivals POSTed through RemoteStore at 1,000/s for 5 s on
     5,000 nodes behind a gate that sheds, the serve loop on the card:
     429s, every created pod bound, no double bind; sheds and p99;
   - cluster: the cluster-in-a-process (`cmd/cluster.py`): (a) the
     components `Cluster` builds pumped by hand (`ClusterSteps`) on
     15,000 hollow nodes: a Deployment of 10,000 replicas with a Service
     and a PDB (K5: selector spread) and a 1,000-pod Job (K3), the
     rollout to 250m / 1 Gi, then the kubelets of two nodes a zone stop
     and a FakeClock runs until their pods are evicted, replaced and
     bound; run on the card and on device="cpu", each in a spawned
     process with one PYTHONHASHSEED (the two started after `[http]`,
     with only the scan and mesh variant checks, which time nothing,
     beside them), and equal in every pod's node and phase, the ReplicaSets, the
     Endpoints and every proxier's table after each stage, with K3
     launched, no twin or refusal count and no double bind; (b)
     `Cluster(...).start()` at 5,000 nodes, the same Deployment created
     by kubectl over HTTP: pods/s and startup p50 / p99 against the 5 s
     SLO, then one `kubectl delete pods` and its replacement;
   - degrade drill: on the 15,000-node world, a DeviceFault at the
     `device.fetch` point of a uniform burst with a commit callback (the
     undecided tail then decided by serial cycles, as the shell does) and
     one at `device.dispatch` of a serial cycle, through the port's chaos
     plan, then three faults in a row that open the circuit breaker until
     a probe closes it; every decision must equal the undisturbed run,
     and `twin.device-fault`, `twin.circuit-open` and the breaker's
     faults, trips and promotions must show the injections; the drill
     resets its counts afterwards.
   Launch counts are zeroed just before each path and read just after;
   each path's kernels must have run and no window may be refused; every
   phase but the twin's must leave `twin.*` at zero (no path hides the
   device behind the host twin), and every phase but the drill must
   count no device fault: no `twin.device-fault`, `twin.circuit-open`,
   `refusal.device-fault` or `refusal.circuit-open`, and no fault booked
   by a breaker.
   Decisions, walk counters and folded rows must equal the plain path on
   the card (whole window for the uniform burst, the first >= 1,024 pods
   of the scan and fused windows, whole waves with their ghost load for
   the pressure paths, every K7 block of preempt-single).
4. Checks the burst against the serial cycle on a small world: a burst
   must decide exactly what one schedule() per pod decides.

With `--cards` (a host of several cards) it builds the kernels and runs
only the mesh phase, one shard per card, so the all-gather's copies are
peer copies between the cards: K13a-K14b, K9a-d and K10a-K11b against
their plain versions on meshes of all the cards and of the first two
(the grouped locals, K13a's too, in every step state), K13b, K9b and
K9d at their two C3 geometries over every card, K2's cluster geometries
on the first card, mesh-preempt-wave, four mesh-preempt-single rounds,
mesh-uniform at 15,000 and 15,001 nodes, mesh-scan-default at 15,000
nodes and mesh-fused, each held against the single-device run on the
first card; its kernels line holds the mesh kernels K9a-K14b only.

Any mismatch or exception exits non-zero. Without a CUDA device it exits
non-zero before printing any result. The last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import dataclasses
import faulthandler
import json
import subprocess
import sys
import time

N_NODES, N_PODS, N_SERIAL = 15000, 10000, 4
#: seconds after which a run still going dumps its threads' stacks
RUN_LIMIT_S = 1140
PREFIX = 1024                   # pods of a window held against the plain path
UNIFORM_KERNELS = ("schedule_cycle", "uniform_burst", "scatter_rows")
# the fused window: gangs of GANG_SIZE interleaved with singleton runs of
# RUN_SIZE, plus one gang on the RACK_NODES nodes labelled rack=r0
N_GANGS, GANG_SIZE, RUN_SIZE, RACK_NODES = 100, 64, 36, 40
GI, MI = 1024 ** 3, 1024 ** 2
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# non-tensor-core peak (fp32, H100 SXM data sheet); integer ops run no
# faster, so it bounds the scans' per-node integer work from below
H100_OPS_PER_S = 67e12
# integer operations per node of one cycle at the default families, a
# floor: feasibility 8, walk 5, LeastRequested 12, BalancedAllocation 7
OPS_PER_NODE_CYCLE = 32

SOURCES = {
    "local_total": ("kubernetes_tpu_torch/ops/csrc/local_total.cu",
                    "kubernetes_tpu/ops/kernels.py:110"),
    "schedule_cycle": ("kubernetes_tpu_torch/ops/csrc/schedule_cycle.cu",
                       "kubernetes_tpu/ops/kernels.py:359"),
    "uniform_burst": ("kubernetes_tpu_torch/ops/csrc/uniform_burst.cu",
                      "kubernetes_tpu/ops/kernels.py:1097"),
    "scatter_rows": ("kubernetes_tpu_torch/ops/csrc/scatter_rows.cu",
                     "kubernetes_tpu/core/tpu_scheduler.py:158"),
    "schedule_batch": ("kubernetes_tpu_torch/ops/csrc/schedule_batch.cu",
                       "kubernetes_tpu/ops/kernels.py:569"),
    "schedule_segments": (
        "kubernetes_tpu_torch/ops/csrc/schedule_segments.cu",
        "kubernetes_tpu/ops/kernels.py:785"),
    "preempt_scan": ("kubernetes_tpu_torch/ops/csrc/preempt_scan.cu",
                     "kubernetes_tpu/ops/kernels.py:1598"),
    "pressure_batch": ("kubernetes_tpu_torch/ops/csrc/pressure_batch.cu",
                       "kubernetes_tpu/ops/kernels.py:1690"),
}


def cluster(n_nodes, labels=None):
    """bench.py's cluster (build_cluster) as the port's objects; `labels(i)`
    adds labels to node i."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    from kubernetes_tpu_torch.cache.node_tree import NodeTree
    nodes = [Node(name=f"node-{i}", labels={
        "failure-domain.beta.kubernetes.io/zone": f"zone-{i % 3}",
        "failure-domain.beta.kubernetes.io/region": "r1",
        "kubernetes.io/hostname": f"node-{i}",
        **(labels(i) if labels else {})},
        allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110})
        for i in range(n_nodes)]
    infos = {n.name: NodeInfo(n) for n in nodes}
    tree = NodeTree()
    for n in nodes:
        tree.add_node(n)
    return infos, tree


def pods(n_pods, prefix="pod", cpu=100, mem=500 * MI, app="density",
         **kw):
    """bench.py's density pods (make_pods); other shapes by keyword."""
    from kubernetes_tpu_torch.api.types import Pod, Container
    return [Pod(name=f"{prefix}-{j}", labels={"app": app},
                containers=(Container.make(
                    name="c", requests={"cpu": cpu, "memory": mem}),), **kw)
            for j in range(n_pods)]


def assume(infos, pod, host):
    placed = dataclasses.replace(pod, node_name=host)
    infos[host].add_pod(placed)
    return infos[host].generation


#: the outputs of a scheduling cycle (K2 and the sharded K9a/K9b)
CYCLE_KEYS = ("selected", "found", "evaluated", "max_score", "total",
              "kept", "feasible", "fail_first", "general_bits",
              "next_last_index", "next_last_node_index")
#: the kernel entry points `plain_versions` swaps by default
KERNEL_ENTRIES = ("schedule_cycle", "schedule_batch_uniform",
                  "scatter_staged", "schedule_batch", "schedule_batch_segments",
                  "preemption_scan", "pressure_batch")
#: the kernels of the mesh-uniform path (K9a-d)
UNIFORM_MESH_KERNELS = ("shard_cycle_local", "shard_cycle_select",
                        "shard_uniform_sweep", "shard_uniform_select")
#: the kernels of the mesh scan paths (K10a/b)
SCAN_MESH_KERNELS = ("shard_scan_local", "shard_scan_select")
#: the kernels of the mesh fused path (K11a/b)
SEG_MESH_KERNELS = ("shard_segments_local", "shard_segments_select")
#: the kernels of the mesh preemption paths (K14a/b, K13a/b)
PREEMPT_MESH_KERNELS = ("shard_preempt_local", "shard_preempt_select")
PRESSURE_MESH_KERNELS = ("shard_pressure_local", "shard_pressure_select")
MESH_KERNELS = UNIFORM_MESH_KERNELS + SCAN_MESH_KERNELS + SEG_MESH_KERNELS \
    + PREEMPT_MESH_KERNELS + PRESSURE_MESH_KERNELS
#: the mesh kernels, and K4, which a mesh path also launches a card
MESH_ENTRIES = MESH_KERNELS + ("scatter_staged",)


#: entry points whose plain version is not `<name>_plain`: K13a's, K9c's,
#: K14a's and K9a's wrappers take a device's shards, their per-shard plain
#: versions one shard
PLAIN_NAMES = {"shard_pressure_local": "shard_pressure_group_plain",
               "shard_uniform_sweep": "shard_uniform_sweep_group_plain",
               "shard_preempt_local": "shard_preempt_group_plain",
               "shard_cycle_local": "shard_cycle_group_plain"}


def plain_of(name):
    """The plain version of kernel entry point `name`."""
    from kubernetes_tpu_torch.ops import kernels as K
    return getattr(K, PLAIN_NAMES.get(name, name + "_plain"))


@contextlib.contextmanager
def plain_versions(names=KERNEL_ENTRIES):
    """Route the port's kernel entry points `names` to their plain
    versions (the reference run of the same path on the card)."""
    from kubernetes_tpu_torch.ops import kernels as K
    saved = {k: getattr(K, k) for k in names}
    for k in names:
        setattr(K, k, plain_of(k))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(K, k, v)


def run_path(n_nodes, n_pods, n_serial, device, sync, mesh=None):
    """The main path once: burst, assume loop, serial cycles (the node
    axis split over `mesh` when given). Returns the decisions, the
    scheduler, and host seconds by phase."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    infos, tree = cluster(n_nodes)
    burst = pods(n_pods)
    sched = TorchScheduler(percentage_of_nodes_to_score=100,
                           node_tree=tree, device=device, mesh=mesh)
    t0 = time.perf_counter()
    names = tree.list_names()
    hosts = sched.schedule_burst(burst, infos, names)
    sync()
    t_burst = time.perf_counter() - t0
    if hosts is None:
        raise SystemExit("main path: the burst was refused")
    kf = hosts.index(None) if None in hosts else len(hosts)
    t1 = time.perf_counter()
    gens = [assume(infos, p, h) for p, h in zip(burst[:kf], hosts[:kf])]
    sched.note_burst_assumed_many(burst[:kf], hosts[:kf], gens)
    if kf:
        tree.advance_enumerations(kf - 1)
    t_assume = time.perf_counter() - t1
    serial = []
    t2 = time.perf_counter()
    for p in pods(n_serial, prefix="serial"):
        r = sched.schedule(p, infos, tree.list_names())
        serial.append((r.suggested_host, r.evaluated_nodes,
                       r.feasible_nodes, tuple(r.host_priority)))
        assume(infos, p, r.suggested_host)
    sync()
    t_serial = time.perf_counter() - t2
    return {"hosts": hosts, "serial": serial, "sched": sched,
            "t_burst": t_burst, "t_assume": t_assume, "t_serial": t_serial,
            "phases": dict(sched.last_burst_phases or {})}


def cuda_time(fn, sync, reps):
    """Mean ms of `fn` over `reps` runs, by CUDA events after a warm-up."""
    import torch
    fn()
    sync()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_time(fn, sync, reps, kernel):
    """(mean device ms a launch, launches seen) of the CUDA kernels whose
    name holds `kernel`, over `reps` runs of `fn` after a warm-up, from
    torch.profiler's kernel events; (None, 0) when it records none. With a
    tuple of names, a list of one such pair a name, from the one run."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _attempt in range(3):
        # a run whose trace holds none of the kernels is taken again
        # (seen once a few runs: a cold CUPTI buffer), twice at most
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        events = prof.key_averages()
        if any(n in ev.key for ev in events for n in names):
            break
    else:
        print(f"[profiler] no event of {names} in 3 runs; events seen: "
              f"{sorted(ev.key for ev in events)[:12]}")
    out = []
    for name in names:
        total, count = 0.0, 0
        for ev in events:
            if name in ev.key:
                # the attribute's name differs between torch versions
                total += max(getattr(ev, k, 0) or 0 for k in (
                    "device_time_total", "self_device_time_total",
                    "cuda_time_total", "self_cuda_time_total"))
                count += ev.count
        out.append((total / count / 1e3, count) if count else (None, 0))
    return out[0] if isinstance(kernel, str) else out


def device_ms_a_call(fn, sync, reps, kernels, per_call=None):
    """(device ms a call of `fn`, and the launches seen) from one profiler
    run of `reps` calls (`device_time`): for each CUDA kernel (or copy)
    named in `kernels`, its mean device time a launch times its launches
    a call (`per_call`, one each by default), summed; (None, 0) when it
    records none of them. The profiler can miss some of a run's events:
    a mean a launch does not depend on how many it saw, a sum would."""
    per_call = per_call or (1,) * len(kernels)
    found = [(ms * k, n) for (ms, n), k in zip(
        device_time(fn, sync, reps, tuple(kernels)), per_call)
        if ms is not None]
    if not found:
        return None, 0
    return sum(t for t, _n in found), sum(n for _t, n in found)


def max_abs_err(a, b):
    """Max |a - b| over two (nested dicts of) tensors; exact equality
    means 0. Bool and int tensors compare as int64."""
    import torch
    if isinstance(a, dict):
        return max(max_abs_err(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def first_diff(a, b, path=""):
    """Where two (nested) results first differ: (path, index, a, b)."""
    import torch
    if isinstance(a, dict):
        for k in a:
            d = first_diff(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    a, b = torch.as_tensor(a).reshape(-1), torch.as_tensor(b).reshape(-1)
    bad = (a.to(torch.int64) != b.to(torch.int64)).nonzero()
    if len(bad) == 0:
        return None
    i = int(bad[0])
    return path, i, int(a[i]), int(b[i]), len(bad)


def kernel_checks(device, sync):
    """Each kernel against its plain version on the card at the main
    path's shapes; returns the per-kernel report entries."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.ops import kernels as K
    infos, tree = cluster(N_NODES)
    sched = TorchScheduler(percentage_of_nodes_to_score=100, node_tree=tree,
                           device=device)
    names = tree.list_names()
    # a partly filled cluster (3 pods on every 7th node), so scores and
    # ties are not all equal
    probe = pods(1, prefix="fill")[0]
    for i in range(0, len(names), 7):
        for _ in range(3):
            assume(infos, probe, names[i])
    b = sched.encoder.encode(infos, names)
    nodes = sched._node_arrays(b)
    n_pad = b.n_pad
    w = dict(K.DEFAULT_WEIGHTS)
    out = {}

    def entry(name, got, want, fn, plain, reps, plain_reps, nbytes,
              library_ms=None, label=None, dev_kernels=None, key=None):
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"(path, index, kernel, plain, count): "
                             f"{first_diff(got, want)})")
        ms = cuda_time(fn, sync, reps)
        plain_ms = cuda_time(plain, sync, plain_reps)
        if label is not None:
            # another input of a kernel already on the line: its device
            # time goes there as `device_ms_<key>`
            note = ""
            if dev_kernels:
                dev_ms, seen = device_ms_a_call(fn, sync, reps, dev_kernels)
                out[name][f"device_ms_{key}"] = dev_ms
                note = (f" device_ms {fmt_ms(dev_ms)} a call over {seen} "
                        f"launches (torch.profiler)")
            print(f"[kernel] {name} ({label}): equal to plain "
                  f"(max_abs_err 0), kernel_ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f}" + note)
            return
        out[name] = {"name": name, "route": "cuda",
                     "source": SOURCES[name][0],
                     "replaces": SOURCES[name][1], "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": library_ms}
        note = ""
        if dev_kernels:
            dev_ms, seen = device_ms_a_call(fn, sync, reps, dev_kernels)
            out[name]["device_ms"] = dev_ms
            note = (f" device_ms {fmt_ms(dev_ms)} a call over {seen} "
                    f"launches (torch.profiler)")
        print(f"[kernel] {name}: equal to plain (max_abs_err 0), "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"bound_ms {out[name]['bound_ms']:.6f}"
              + ("" if library_ms is None
                 else f" library_ms {library_ms:.4f}") + note)

    # K1 local_total over [n_pad]
    args = (w, nodes["nz_cpu"] + 100, nodes["nz_mem"] + 500 * MI,
            nodes["alloc_cpu"], nodes["alloc_mem"])
    entry("local_total", K.local_total(*args), K.local_total_plain(*args),
          lambda: K.local_total(*args), lambda: K.local_total_plain(*args),
          200, 20, n_pad * (4 * 8 + 8), dev_kernels=("local_total_kernel",))

    # K2 schedule_cycle: one density pod against the filled cluster
    from kubernetes_tpu_torch.ops.node_state import PodEncoder
    feats = PodEncoder(infos, b, state_encoder=sched.encoder).encode(probe)
    pod_in = sched._pod_arrays(feats)
    cargs = (nodes, pod_in, 123, 45, b.n_real, b.n_real, 4)
    keys = CYCLE_KEYS

    def pick(o):
        return {k: o[k] for k in keys}
    node_bytes = sum(v.numel() * v.element_size() for v in nodes.values())
    entry("schedule_cycle", pick(K.schedule_cycle(*cargs)),
          pick(K.schedule_cycle_plain(*cargs)),
          lambda: K.schedule_cycle(*cargs),
          lambda: K.schedule_cycle_plain(*cargs), 50, 5,
          node_bytes + n_pad * (8 + 1 + 1 + 1 + 8))
    dev_ms, seen = device_time(lambda: K.schedule_cycle(*cargs), sync, 50,
                               "schedule_cycle_kernel")
    out["schedule_cycle"].update(device_ms=dev_ms,
                                 plan=plan_entry("schedule_cycle"))
    print(f"[kernel] schedule_cycle: device_ms "
          f"{fmt_ms(dev_ms)} over {seen} launches (torch.profiler; "
          f"kernel_ms is the wrapper call's); "
          f"{describe_geometry(*K.last_geometry['schedule_cycle'])}")

    # K3 uniform_burst: the headline burst's one launch, on the main
    # path's own input (the empty cluster, lastNodeIndex 0) ...
    cap = 16384
    state_bytes = n_pad * (1 + 3 * 8 + 8 + 5 * 8 * 2)   # valid, alloc x3,
    #   K1 scores, five carried rows read and written
    e_infos, e_tree = cluster(N_NODES)
    e_sched = TorchScheduler(percentage_of_nodes_to_score=100,
                             node_tree=e_tree, device=device)
    e_names = e_tree.list_names()
    eb = e_sched.encoder.encode(e_infos, e_names)
    e_nodes = e_sched._node_arrays(eb)
    f0 = PodEncoder(e_infos, eb, state_encoder=e_sched.encoder).encode(probe)
    cls, extra_ok, ban = e_sched._uniform_class(probe, f0, eb, e_infos)
    ukw = dict(extra_ok=extra_ok, ban=ban, cap=cap)
    uargs = (e_nodes, cls, N_PODS, 0, eb.n_real, True)
    entry("uniform_burst", K.schedule_batch_uniform(*uargs, **ukw),
          K.schedule_batch_uniform_plain(*uargs, **ukw),
          lambda: K.schedule_batch_uniform(*uargs, **ukw),
          lambda: K.schedule_batch_uniform_plain(*uargs, **ukw), 20, 2,
          state_bytes + (cap + 1) * 4, dev_kernels=("uniform_burst_kernel",))
    out["uniform_burst"]["plan"] = plan_entry("uniform_burst")
    print(f"[kernel] uniform_burst: "
          f"{describe_geometry(*K.last_geometry['uniform_burst'])}")
    # ... on the filled cluster, where every 7th node leaves the tie set
    # after one more pod: STAY batches cut every ~7 pods ...
    sargs = (nodes, cls, N_PODS, 7, b.n_real, True)
    entry("uniform_burst", K.schedule_batch_uniform(*sargs, **ukw),
          K.schedule_batch_uniform_plain(*sargs, **ukw),
          lambda: K.schedule_batch_uniform(*sargs, **ukw),
          lambda: K.schedule_batch_uniform_plain(*sargs, **ukw), 5, 1,
          state_bytes + (cap + 1) * 4,
          label="filled cluster: 3 pods on every 7th node, lni 7",
          dev_kernels=("uniform_burst_kernel",), key="filled")
    # ... and on the rotated burst of the 15,001-node world (uneven zones:
    # each cycle's enumeration starts at another zone, `_burst_rotation`)
    r_infos, r_tree = cluster(N_NODES + 1)
    r_sched = TorchScheduler(percentage_of_nodes_to_score=100,
                             node_tree=r_tree, device=device)
    rb = r_sched.encoder.encode(r_infos, r_tree.list_names())
    r_nodes = r_sched._node_arrays(rb)
    fr = PodEncoder(r_infos, rb, state_encoder=r_sched.encoder).encode(probe)
    r_cls, r_extra, r_ban = r_sched._uniform_class(probe, fr, rb, r_infos)
    rot = r_sched._burst_rotation(rb, N_PODS)
    if rot is None:
        raise SystemExit("uniform_burst: the 15,001-node world does not "
                         "rotate")
    seq = np.full(cap + K.K_BATCH, rot[1][-1], np.int32)
    seq[: min(len(rot[1]), len(seq))] = rot[1][: len(seq)]
    rotation = (torch.as_tensor(rot[0]).to(device),
                torch.as_tensor(seq).to(device))
    rkw = dict(extra_ok=r_extra, ban=r_ban, cap=cap, rotation=rotation)
    rargs = (r_nodes, r_cls, N_PODS, 0, rb.n_real, True)
    entry("uniform_burst", K.schedule_batch_uniform(*rargs, **rkw),
          K.schedule_batch_uniform_plain(*rargs, **rkw),
          lambda: K.schedule_batch_uniform(*rargs, **rkw),
          lambda: K.schedule_batch_uniform_plain(*rargs, **rkw), 10, 1,
          state_bytes + (cap + 1) * 4,
          label=f"rotated burst, {N_NODES + 1} nodes, "
                f"{rot[0].shape[0]} orders",
          dev_kernels=("uniform_burst_kernel",), key="rotated")
    print(f"[kernel] uniform_burst (rotated): "
          f"{describe_geometry(*K.last_geometry['uniform_burst'])}")

    # K4 scatter_rows: 16 dirty rows (the serial path's bucket) of every
    # field, from the host table as `_scatter_dirty` sends them: the rows
    # packed into one staged buffer, one copy, one launch (the wrapper's
    # ms is the whole call)
    rows = np.arange(0, 16 * 97, 97, dtype=np.int64)
    keys = tuple(nodes)
    host = {k: np.asarray(getattr(b, k)).copy() for k in keys}
    for k, v in host.items():
        if v.dtype == np.int64:
            v += 1
    upd = {k: host[k][rows] for k in keys}
    dev_a = {k: v.clone() for k, v in nodes.items()}
    dev_b = {k: v.clone() for k, v in nodes.items()}
    table = K.scatter_table([dev_a], keys)
    sources = [host[k] for k in keys]

    def k4():
        K.scatter_dirty(table, [(0, rows, 0)], sources)
    k4()
    K.scatter_rows_plain(dev_b, rows, upd)
    rows_l = torch.as_tensor(rows).to(device)
    upd_t = {k: torch.as_tensor(v).to(device) for k, v in upd.items()}

    def library():
        for k, v in upd_t.items():
            dev_b[k].index_copy_(0, rows_l, v)
    library_ms = cuda_time(library, sync, 200)
    row_bytes = sum(v.element_size() * (v.numel() // v.shape[0])
                    for v in nodes.values())
    entry("scatter_rows", dev_a, dev_b, k4,
          lambda: K.scatter_rows_plain(dev_b, rows, upd), 200, 50,
          len(rows) * (2 * row_bytes + 4), library_ms=library_ms,
          dev_kernels=("scatter_rows_kernel",))
    from kubernetes_tpu_torch import obs
    before = obs.get("htod.scatter"), obs.get("launch.scatter_rows")
    t = time.perf_counter()
    for _ in range(200):
        K.scatter_prepare(table, [(0, rows, 0)], sources)
    pack_ms = (time.perf_counter() - t) * 1e3 / 200
    for _ in range(10):
        k4()
    sync()
    htod = (obs.get("htod.scatter") - before[0]) / 10
    launches = (obs.get("launch.scatter_rows") - before[1]) / 10
    out["scatter_rows"].update(htod_a_call=htod, pack_ms=pack_ms)
    if (htod, launches) != (1, 1):
        raise SystemExit(f"scatter_rows: {htod} HtoD copies and {launches} "
                         f"launches a call, one each wanted")
    print(f"[kernel] scatter_rows: {htod:.0f} HtoD copy and {launches:.0f} "
          f"launch a call (obs; 16 copies before the staged path); the "
          f"packing alone {pack_ms:.4f} ms of the call (`pack_ms`)")
    return out


def _rand_nodes(rng, n_pad, n_real, s_count, zones, device):
    """A random node matrix: mixed capacities, some rows over capacity."""
    import numpy as np
    import torch
    i64 = np.int64
    alloc_cpu = rng.choice([0, 2000, 4000, 8000], n_pad).astype(i64)
    alloc_mem = rng.choice([0, 8, 16, 32], n_pad).astype(i64) * GI
    host = {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": alloc_cpu, "alloc_mem": alloc_mem,
        "alloc_eph": rng.choice([0, 10, 50], n_pad).astype(i64) * GI,
        "allowed_pods": rng.choice([4, 8, 110], n_pad).astype(i64),
        "req_cpu": (alloc_cpu * rng.random(n_pad) * 1.1).astype(i64),
        "req_mem": (alloc_mem * rng.random(n_pad) * 1.1).astype(i64),
        "req_eph": rng.integers(0, 20, n_pad).astype(i64) * GI,
        "nz_cpu": rng.integers(0, 4000, n_pad).astype(i64),
        "nz_mem": rng.integers(0, 16, n_pad).astype(i64) * GI,
        "pod_count": rng.integers(0, 9, n_pad).astype(i64),
        "alloc_scalar": rng.integers(0, 8, (n_pad, s_count)).astype(i64),
        "req_scalar": rng.integers(0, 6, (n_pad, s_count)).astype(i64),
        "zone_id": rng.integers(0, zones, n_pad).astype(np.int32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def _rand_pod(rng, n_pad, s_count, dense):
    """A random pod input of K2: each per-node family dense or inert."""
    import numpy as np
    pod = {"req_cpu": np.int64(500), "req_mem": np.int64(GI),
           "req_eph": np.int64(GI),
           "req_scalar": rng.integers(0, 2, s_count).astype(np.int64),
           "has_request": np.bool_(True), "unknown_scalar": np.bool_(False),
           "skip": np.bool_(False), "check_resources": np.bool_(True),
           "nz_cpu": np.int64(500), "nz_mem": np.int64(GI)}
    for k in ("sel_ok", "taints_ok", "unsched_ok", "ports_ok", "host_ok",
              "disk_ok", "maxvol_ok", "volbind_ok", "volzone_ok"):
        pod[k] = (rng.random(n_pad) < 0.9) if dense else np.ones(1, bool)
    pod["interpod_code"] = rng.choice([0, 0, 0, 1, 2, 3], n_pad).astype(
        np.int8) if dense else np.zeros(1, np.int8)
    for k, hi in (("node_aff_counts", 200), ("taint_counts", 5),
                  ("spread_counts", 7), ("interpod_counts", 9)):
        pod[k] = rng.integers(0, hi, n_pad).astype(np.int64) if dense \
            else np.zeros(1, np.int64)
    if dense:
        pod["interpod_counts"] -= 4
    pod["interpod_tracked"] = (rng.random(n_pad) < 0.7) if dense \
        else np.zeros(1, bool)
    pod["image_sums"] = rng.integers(0, 1200, n_pad).astype(np.int64) * MI \
        if dense else np.zeros(1, np.int64)
    pod["prefer_avoid"] = np.where(rng.random(n_pad) < 0.2, 0, 10).astype(
        np.int64) if dense else np.full(1, 10, np.int64)
    return pod


def uniform_cases(rng, nodes, n_pad, n_real, s_count, wtab, union, device):
    """K3's random-input cases: a fresh, roomy copy of `nodes` and
    (name, class, pods, lni, kwargs) for the plain, lni, rotate, ban +
    extra_ok, carried rows, weight table and saturated cases, and the
    packed block's cap."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    fresh = {k: v.clone() for k, v in nodes.items()}
    for k in ("req_cpu", "req_mem", "req_eph", "nz_cpu", "nz_mem",
              "pod_count", "req_scalar"):
        fresh[k].zero_()
    fresh["alloc_cpu"].fill_(4000)
    fresh["alloc_mem"].fill_(32 * GI)
    fresh["allowed_pods"].fill_(110)
    fresh["alloc_scalar"].fill_(40)
    base = {"req_cpu": 100, "req_mem": 500 * MI, "req_eph": 0,
            "req_scalar": np.zeros(s_count, np.int64), "nz_cpu": 100,
            "nz_mem": 500 * MI, "upd_cpu": 100, "upd_mem": 500 * MI,
            "upd_eph": 0, "upd_scalar": np.zeros(s_count, np.int64),
            "has_request": True}
    carried = dict(base, req_eph=GI, upd_eph=GI,
                   req_scalar=np.array([1, 2], np.int64),
                   upd_scalar=np.array([1, 0], np.int64))
    rows = [np.concatenate([np.arange(n_real), np.full(n_pad + 1 - n_real,
                                                       n_pad)])]
    for _ in range(3):
        rows.append(np.concatenate([rng.permutation(n_real),
                                    np.full(n_pad + 1 - n_real, n_pad)]))
    perms = torch.as_tensor(np.stack(rows).astype(np.int32)).to(device)
    cap = 4096
    seq = np.zeros(cap + K.K_BATCH, np.int32)
    seq[1:700] = 2
    seq[700:] = rng.integers(0, 4, len(seq) - 700)
    seq_t = torch.as_tensor(seq).to(device)
    extra = torch.as_tensor(rng.random(n_pad) < 0.8).to(device)
    cases = [
        ("plain", base, 3000, 0, {}),
        ("lni", base, 3000, 2 ** 31 - 9, {}),
        ("rotate", base, 3000, 5, dict(rotation=(perms, seq_t))),
        ("ban+extra_ok", base, 3000, 1, dict(ban=True, extra_ok=extra)),
        ("carried rows", carried, 3000, 3, {}),
        ("weight table", base, 3000, 2, dict(weights=union, wtab=wtab,
                                             pid=1)),
        ("saturated", dict(base, req_cpu=3000, upd_cpu=3000, nz_cpu=3000),
         4096, 4, {}),
    ]
    return fresh, cases, cap


def variant_checks(device, sync):
    """Every mode and score family of the kernels against the plain
    versions on random inputs (the main path exercises only the plain
    density burst): K1 per weight family and weight row, K2 with every
    per-node family dense or inert in the identity, perm and pos walks
    and with a weight table, K3 with rotation, ban + extra_ok, carried
    ephemeral/scalar rows, a weight table and a saturated tail, K4 with
    duplicate and out-of-range rows."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261017)
    n_pad, n_real, s_count, zones = 4096, 4000, 2, 6
    axis = K.PRIORITY_AXIS
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    weight_cases = [
        dict(K.DEFAULT_WEIGHTS),
        {**K.DEFAULT_WEIGHTS, "least_requested": 0, "most_requested": 2},
        {**K.DEFAULT_WEIGHTS, "least_requested": 0, "rtcr": 3},
        {**K.DEFAULT_WEIGHTS, "balanced": 5, "least_requested": 2},
    ]
    nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(axis)))).to(device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(axis)}
    # K1
    for w in weight_cases:
        args = (w, nodes["req_cpu"], nodes["req_mem"], nodes["alloc_cpu"],
                nodes["alloc_mem"])
        same("local_total", K.local_total(*args), K.local_total_plain(*args))
        same("local_total/wrow", K.local_total(*args, wrow=wtab[1]),
             K.local_total_plain(*args, wrow=wtab[1]))
    # K2
    perm = np.concatenate([rng.permutation(n_real),
                           np.arange(n_real, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    perm_t = torch.as_tensor(perm).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    keys = CYCLE_KEYS
    for dense in (False, True):
        pod = _rand_pod(rng, n_pad, s_count, dense)
        for w in weight_cases:
            for li, lni, ntf in ((0, 0, n_real), (37, 11, 900),
                                 (3999, 2 ** 33 + 7, 50)):
                for mode in ("identity", "perm", "pos"):
                    kw = {}
                    if mode == "perm":
                        kw = dict(perm=perm_t, inv_perm=inv_t)
                    elif mode == "pos":
                        kw = dict(pos=inv_t)
                        ntf = n_real
                    args = (nodes, pod, li, lni, ntf, n_real, 8)
                    got = K.schedule_cycle(*args, weights=w, **kw)
                    want = K.schedule_cycle_plain(*args, weights=w, **kw)
                    same(f"schedule_cycle/{mode}",
                         {k: got[k] for k in keys},
                         {k: want[k] for k in keys})
        for pid in (0, 2, 7):
            p = dict(pod, profile_id=np.int64(pid))
            args = (nodes, p, 5, 3, n_real, n_real, 8)
            got = K.schedule_cycle(*args, weights=union, wtab=wtab)
            want = K.schedule_cycle_plain(*args, weights=union, wtab=wtab)
            same("schedule_cycle/wtab", {k: got[k] for k in keys},
                 {k: want[k] for k in keys})
    # K3: a fresh, roomy cluster and a class with every carried row kind
    fresh, cases, cap = uniform_cases(rng, nodes, n_pad, n_real, s_count,
                                      wtab, union, device)
    for name, cls, n_pods, lni, kw in cases:
        args = (fresh, cls, n_pods, lni, n_real, True)
        got = K.schedule_batch_uniform(*args, cap=cap, **kw)
        want = K.schedule_batch_uniform_plain(*args, cap=cap, **kw)
        same(f"uniform_burst/{name}", got, want)
    # K4: duplicates repeat row 0's values; out-of-range rows are dropped
    rws = np.concatenate([rng.choice(n_pad - 8, 20, replace=False),
                          [n_pad + 5, -3]]).astype(np.int32)
    rws = np.concatenate([rws, np.full(10, rws[0], np.int32)])
    upd = {k: v.cpu().numpy()[np.clip(rws, 0, n_pad - 1)].copy()
           for k, v in nodes.items()}
    for k, v in upd.items():
        if v.dtype == np.int64:
            v += rng.integers(0, 100, v.shape)
        v[22:] = v[0]
    dev_a = {k: v.clone() for k, v in nodes.items()}
    dev_b = {k: v.clone() for k, v in nodes.items()}
    same("scatter_rows", K.scatter_rows(dev_a, rws, upd),
         K.scatter_rows_plain(dev_b, rws, upd))
    sync()
    print(f"[variants] {checked} kernel calls equal to their plain "
          f"versions (every K2 family dense and inert; identity, perm and "
          f"pos walks; K3 rotate, ban + extra_ok, carried rows, weight "
          f"table, saturated tail; K4 duplicate and out-of-range rows)")


#: K2's cluster geometries (label, n_pad, n_real, blocks the planner may
#: take, build, (blocks, slots a thread, scratch in global memory)): the
#: cells' n_pad on 16 blocks and on the 8-block fallback, a ragged axis at
#: two slots a thread, li, the ties and the winners in different blocks,
#: and the scratch in the global workspace at 262,144 slots on 16 blocks
#: and 131,072 on 8
CYCLE_GEOMETRIES = (
    ("16,384 slots on 16 blocks", 16384, 15001, 16, None, (16, 1, False)),
    ("16,384 slots on an 8-block cluster", 16384, 15001, 8, None,
     (8, 2, False)),
    ("20,000 slots: two a thread, ten blocks", 20000, 19990, 16, None,
     (10, 2, False)),
    ("4,096 slots: li, the winners and the ties in different blocks",
     4096, 4090, 16, "ties", (4, 1, False)),
    ("262,144 slots: 16 a thread, the scratch in global memory", 262144,
     262000, 16, None, (16, 16, True)),
    ("131,072 slots on an 8-block cluster: 16 a thread, the scratch in "
     "global memory", 131072, 131000, 8, None, (8, 16, True)),
)


def cycle_variant_checks(device, sync):
    """K2 (one thread-block cluster a cycle, `cycle_plan`) against its
    plain version on every geometry of CYCLE_GEOMETRIES: dense and inert
    pods in the identity (a partial walk), perm and pos walks, each with
    and without a nominated ghost, a skip pod, a weight table with
    profile ids; every output compared (the six scalars and the five
    per-node outputs). Prints each geometry's plan and K2's device time a
    cycle there (the dense identity case)."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    checked = 0
    for gi, (label, n_pad, n_real, blocks, build, want) in enumerate(
            CYCLE_GEOMETRIES):
        rng = np.random.default_rng(20261101 + gi)
        if build == "ties":
            nodes = _tie_nodes(rng, n_pad, n_real, 2, device)
            li = 1600
        else:
            nodes = _rand_nodes(rng, n_pad, n_real, 2, 6, device)
            li = n_real // 3 + 37
        perm = np.concatenate([rng.permutation(n_real),
                               np.arange(n_real, n_pad)]).astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_pad, dtype=np.int32)
        walks = {"identity": {},
                 "perm": {"perm": torch.as_tensor(perm).to(device),
                          "inv_perm": torch.as_tensor(inv).to(device)},
                 "pos": {"pos": torch.as_tensor(inv).to(device)}}
        wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                               ).to(device)
        union = {k: int(wtab[:, i].max())
                 for i, k in enumerate(K.PRIORITY_AXIS)}
        ghost = _random_ghost(rng, n_pad, device)
        K.last_geometry.clear()
        with cluster_blocks(blocks):
            def same(name, args, **kw):
                nonlocal checked
                got = K.schedule_cycle(*args, **kw)
                ref = K.schedule_cycle_plain(*args, **kw)
                err = max_abs_err({k: got[k] for k in CYCLE_KEYS},
                                  {k: ref[k] for k in CYCLE_KEYS})
                if err != 0:
                    raise SystemExit(
                        f"cycle variant {name} at {label}: disagrees "
                        f"(max_abs_err {err}; first difference "
                        f"{first_diff(got, ref)})")
                checked += 1
            timed = None
            for dense in (True, False):
                pod = _rand_pod(rng, n_pad, 2, dense)
                for mode, kw in walks.items():
                    ntf = n_real // 2 if mode == "perm" else (
                        n_real if mode == "pos" else 50)
                    args = (nodes, pod, li, 2 ** 33 + 7, ntf, n_real, 8)
                    for g in (None, ghost):
                        same(f"{mode}/dense {dense}/ghost {g is not None}",
                             args, ghost=g, **kw)
                    if dense and mode == "identity":
                        timed = args
            skip = dict(_rand_pod(rng, n_pad, 2, True), skip=np.bool_(True))
            same("skip pod", (nodes, skip, li, 5, 50, n_real, 8))
            for pid in (0, 2):
                p = dict(_rand_pod(rng, n_pad, 2, True),
                         profile_id=np.int64(pid))
                same(f"wtab row {pid}", (nodes, p, li, 3, n_real, n_real, 8),
                     weights=union, wtab=wtab)
            ms = cuda_time(lambda: K.schedule_cycle(*timed), sync, 20)
            dev_ms, _n = device_time(lambda: K.schedule_cycle(*timed), sync,
                                     20, "schedule_cycle_kernel")
        plan, fit = K.last_geometry["schedule_cycle"]
        got = (plan.blocks, plan.nodes_per_thread, plan.global_scratch)
        if got != want or plan.resident:
            raise SystemExit(f"cycle variant {label}: planned {plan}, not "
                             f"{want}")
        print(f"[variants] schedule_cycle {label}: "
              f"{describe_geometry(plan, fit)}; kernel_ms {ms:.4f} "
              f"device_ms {fmt_ms(dev_ms)} a cycle")
    sync()
    print(f"[variants] {checked} K2 calls equal to their plain versions "
          f"over {len(CYCLE_GEOMETRIES)} cluster geometries (dense and "
          f"inert pods; identity, perm and pos walks with and without a "
          f"nominated ghost; a skip pod; a weight table)")


#: K3's cluster geometries (label, n_pad, n_real, blocks the planner may
#: take, the plan without rotation and with uniform_cases' four orders:
#: (blocks, slots a thread, rows resident, scratch in global memory)): the
#: cells' n_pad on the 8-block fallback, a ragged axis, and past what
#: shared memory holds the rows in global memory at 262,144 slots on 16
#: blocks, then the scores, bytes and tie lists too (four orders, or 131,072
#: slots on 8 blocks)
UNIFORM_GEOMETRIES = (
    ("16,384 slots on an 8-block cluster", 16384, 15001, 8,
     (8, 2, True, False), (8, 2, True, False)),
    ("20,000 slots: two a thread, ten blocks", 20000, 19990, 16,
     (10, 2, True, False), (10, 2, True, False)),
    ("262,144 slots: 16 a thread, the rows in global memory (rotated: "
     "the scratch too)", 262144, 262000, 16, (16, 16, False, False),
     (16, 16, False, True)),
    ("131,072 slots on an 8-block cluster: 16 a thread, the rows in "
     "global memory (rotated: the scratch too)", 131072, 131000, 8,
     (8, 16, False, False), (8, 16, False, True)),
)


def uniform_variant_checks(device, sync):
    """K3 (one thread-block cluster a burst, `uniform_plan`) against its
    plain version on every geometry of UNIFORM_GEOMETRIES, in every case
    of `uniform_cases` (plain, lni, rotate, ban + extra_ok, carried rows,
    weight table, saturated tail); every output compared (decisions, the
    packed block, lni and the folded rows). Prints each geometry's plans
    and K3's device time a burst there (the plain case)."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    checked = 0
    for gi, (label, n_pad, n_real, blocks, flat, rot) in enumerate(
            UNIFORM_GEOMETRIES):
        rng = np.random.default_rng(20261104 + gi)
        nodes = _rand_nodes(rng, n_pad, n_real, 2, 6, device)
        wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                               ).to(device)
        union = {k: int(wtab[:, i].max())
                 for i, k in enumerate(K.PRIORITY_AXIS)}
        fresh, cases, cap = uniform_cases(rng, nodes, n_pad, n_real, 2, wtab,
                                          union, device)
        plans = {}
        timed = None
        with cluster_blocks(blocks):
            for name, cls, n_pods, lni, kw in cases:
                args = (fresh, cls, n_pods, lni, n_real, True)
                K.last_geometry.pop("uniform_burst", None)
                got = K.schedule_batch_uniform(*args, cap=cap, **kw)
                want = K.schedule_batch_uniform_plain(*args, cap=cap, **kw)
                err = max_abs_err(got, want)
                if err != 0:
                    raise SystemExit(
                        f"uniform variant {name} at {label}: disagrees "
                        f"(max_abs_err {err}; first difference "
                        f"{first_diff(got, want)})")
                checked += 1
                plans[name] = K.last_geometry["uniform_burst"]
                if name == "plain":
                    timed = (args, kw)
            args, kw = timed
            dev_ms, _n = device_time(
                lambda: K.schedule_batch_uniform(*args, cap=cap, **kw), sync,
                3, "uniform_burst_kernel")
        for name, want in (("plain", flat), ("rotate", rot)):
            plan = plans[name][0]
            got = (plan.blocks, plan.nodes_per_thread, plan.resident,
                   plan.global_scratch)
            if got != want:
                raise SystemExit(f"uniform variant {label} ({name}): "
                                 f"planned {plan}, not {want}")
        print(f"[variants] uniform_burst {label}: "
              f"{describe_geometry(*plans['plain'])}; rotated: "
              f"{describe_geometry(*plans['rotate'])}; device_ms "
              f"{fmt_ms(dev_ms)} a burst ({cases[0][2]} pods)")
    sync()
    print(f"[variants] {checked} K3 calls equal to their plain versions "
          f"over {len(UNIFORM_GEOMETRIES)} cluster geometries (plain, lni, "
          f"rotate, ban + extra_ok, carried rows, weight table, saturated "
          f"tail)")


def small_world_check(device, sync):
    """A burst decides exactly what one serial cycle per pod decides."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    for n_nodes in (60, 61):
        decided = []
        for mode in ("burst", "serial"):
            infos, tree = cluster(n_nodes)
            sched = TorchScheduler(percentage_of_nodes_to_score=100,
                                   node_tree=tree, device=device)
            batch = pods(400)
            if mode == "burst":
                hosts = sched.schedule_burst(batch, infos, tree.list_names())
            else:
                hosts = []
                for p in batch:
                    h = sched.schedule(p, infos,
                                       tree.list_names()).suggested_host
                    assume(infos, p, h)
                    hosts.append(h)
            decided.append(hosts)
        if decided[0] != decided[1]:
            raise SystemExit(f"burst != serial cycles on {n_nodes} nodes")
    print("[check] burst == serial cycles on 60 and 61 nodes (400 pods)")


def _spec(req_cpu, dense, rng, n_pad, s_count):
    """A random pod-spec row of the scan kernels: `_rand_pod` plus the
    fold deltas."""
    import numpy as np
    d = _rand_pod(rng, n_pad, s_count, dense)
    d.update(req_cpu=np.int64(req_cpu), nz_cpu=np.int64(req_cpu),
             upd_cpu=np.int64(req_cpu), upd_mem=np.int64(GI),
             upd_eph=np.int64(0),
             upd_scalar=rng.integers(0, 2, s_count).astype(np.int64))
    return d


#: the geometries K5 / K6 are held against their plain versions on, in
#: every mode (name, n_pad, n_real, S, B, node set, the most blocks the
#: planner may take, the plan it must choose: blocks, node slots a thread,
#: rows resident, scratch in global memory; None: not pinned): the
#: cluster's 16 x 1024 threads cover 16,384 slots, one a thread; past
#: 180,224 (90,112 on 8 blocks) the scratch moves to the global workspace
SCAN_GEOMETRIES = (
    ("4,096 slots: blocks 4-15 own no node", 4096, 4000, 2, 256, None, 16,
     None),
    ("1,500 slots: less than one block's span", 1500, 1490, 2, 64, None, 16,
     None),
    ("20,000 slots: two a thread, not a multiple of the span", 20000,
     19990, 3, 64, None, 16, None),
    ("3,000 slots: li, the winners and the ties in different blocks", 3000,
     2990, 2, 48, "ties", 16, None),
    ("40,000 slots: the rows in global memory", 40000, 39990, 2, 48, None,
     16, None),
    ("262,144 slots: 16 a thread, the rows and the scratch in global "
     "memory", 262144, 262000, 2, 24, None, 16, (16, 16, False, True)),
    ("131,072 slots on an 8-block cluster: 16 a thread, the rows and the "
     "scratch in global memory", 131072, 131000, 2, 24, None, 8,
     (8, 16, False, True)),
)


def _tie_nodes(rng, n_pad, n_real, s_count, device):
    """Full nodes (pod_count at allowed) but two identical groups: 6
    in block 0 and 10 at the head of block 2, so that from li in block 1
    the ties and the winners lie in other blocks than the walk start."""
    import numpy as np
    import torch
    i64 = np.int64
    pod_count = np.full(n_pad, 110, i64)
    open_ = list(range(3, 9)) + list(range(2050, 2060))
    pod_count[open_] = 0
    host = {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": np.full(n_pad, 8000, i64),
        "alloc_mem": np.full(n_pad, 32 * GI, i64),
        "alloc_eph": np.full(n_pad, 50 * GI, i64),
        "allowed_pods": np.full(n_pad, 110, i64),
        "req_cpu": np.zeros(n_pad, i64), "req_mem": np.zeros(n_pad, i64),
        "req_eph": np.zeros(n_pad, i64), "nz_cpu": np.zeros(n_pad, i64),
        "nz_mem": np.zeros(n_pad, i64), "pod_count": pod_count,
        "alloc_scalar": np.full((n_pad, s_count), 40, i64),
        "req_scalar": rng.integers(0, 2, (n_pad, s_count)).astype(i64),
        "zone_id": (np.arange(n_pad) % 3 + 1).astype(np.int32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def scan_variant_checks(device, sync):
    """K5 and K6 against their plain versions on random inputs, in every
    mode, on every geometry of SCAN_GEOMETRIES (blocks that own no node, a
    node axis that is not a multiple of the cluster's span, li, winners
    and ties in different blocks, S > 0 scalar resources, the global-rows
    variant): identity, perm and pos walks, the carried spread vector with
    carry_in chaining, a weight table with per-pod profile ids, dense and
    inert fields mixed in one window, skip padding; for K6 also gang
    rewinds, a singleton failure, the rank-aware gang score and n_pods <
    B; the scratch in the global workspace past 180,224 slots on 16
    blocks and 90,112 on 8."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    checked = 0
    for gi, (label, n_pad, n_real, s_count, B, build, blocks,
             want) in enumerate(SCAN_GEOMETRIES):
        rng = np.random.default_rng(20261018 + gi)
        K.last_geometry.clear()
        with cluster_blocks(blocks):
            checked += _scan_variants(device, rng, n_pad, n_real, s_count,
                                      B, build, gi == 0)
        for k, (plan, _fit) in K.last_geometry.items():
            got = (plan.blocks, plan.nodes_per_thread, plan.resident,
                   plan.global_scratch)
            if want is not None and got != want:
                raise SystemExit(f"variant {k}, {label}: planned {plan}, "
                                 f"not {want}")
        geo = "; ".join(f"{k}: {describe_geometry(*v)}"
                        for k, v in sorted(K.last_geometry.items()))
        print(f"[variants] {label}: {geo}")
    sync()
    print(f"[variants] {checked} scan kernel calls equal to their plain "
          f"versions over {len(SCAN_GEOMETRIES)} geometries (K5 identity, "
          f"perm, pos, spread carry + carry_in, weight table; K6 axis, "
          f"perm, pos, gang score + weight table, spread carry, n_pods < "
          f"B; dense/inert mixes, skip padding, gang rewinds, a singleton "
          f"failure)")


def describe_geometry(plan, fit, select=False):
    """A cluster launch's geometry as the [kernel] and [variants] lines
    print it (K5 / K6; `select`: K10b / K11b, which stage the gathered
    records instead of keeping rows)."""
    what = "the step's records staged" if select else "rows"
    rows = f"{what} in {'shared' if plan.resident else 'global'} memory"
    if not select and plan.resident:
        rows = "rows resident in shared memory"
    scratch = (f"the scratch in a global workspace of "
               f"{plan.workspace_bytes} B" if plan.global_scratch
               else "the scratch in shared memory")
    from kubernetes_tpu_torch.ops import kernels as K
    return (f"cluster of {plan.blocks} x {K.CLUSTER_THREADS} threads, "
            f"{plan.nodes_per_thread} node slot(s) a thread, {rows}, "
            f"{scratch}, {plan.smem_bytes} B of shared memory a block, "
            f"{fit} such cluster(s) fit the card")


def describe_pass_plan(plan, fit):
    """K9d's cluster plan (K3's at R = 0: no rows) as its lines print
    it."""
    from kubernetes_tpu_torch.ops import kernels as K
    where = (f"a global workspace of {plan.workspace_bytes} B"
             if plan.global_scratch else "shared memory")
    return (f"cluster of {plan.blocks} x {K.CLUSTER_THREADS} threads, "
            f"{plan.nodes_per_thread} node slot(s) a thread, the tie / "
            f"stay bits and tie lists in {where}, {plan.smem_bytes} B of "
            f"shared memory a block, {fit} such cluster(s) fit the card")


def plan_entry(name):
    """Kernel `name`'s last cluster plan as the kernels line gives it."""
    from kubernetes_tpu_torch.ops import kernels as K
    plan, fit = K.last_geometry[name]
    return {"blocks": plan.blocks, "npt": plan.nodes_per_thread,
            "resident": plan.resident, "global_scratch": plan.global_scratch,
            "smem_bytes": plan.smem_bytes, "clusters_fit": fit}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _scan_variants(device, rng, n_pad, n_real, s_count, B, build, first):
    """One geometry's K5 / K6 cases; returns the calls checked."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    zones = 6
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name} at n_pad {n_pad}: kernel "
                             f"disagrees with plain (max_abs_err {err}; "
                             f"first difference {first_diff(got, want)})")
        checked += 1

    if build == "ties":
        nodes = _tie_nodes(rng, n_pad, n_real, s_count, device)
        li, lni = 1600, 9        # li in block 1, the 10th of 16 ties
    else:
        nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
        for k in ("req_cpu", "req_mem", "pod_count"):
            nodes[k] = nodes[k] // 3        # room for the window's pods
        li, lni = 37, 11
    perms = np.stack([np.arange(n_pad)] + [
        np.concatenate([rng.permutation(n_real), np.arange(n_real, n_pad)])
        for _ in range(3)]).astype(np.int32)
    inv = np.empty_like(perms)
    for i in range(len(perms)):
        inv[i, perms[i]] = np.arange(n_pad, dtype=np.int32)
    perms_t = torch.as_tensor(perms).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    oid = rng.integers(0, 4, B).astype(np.int32)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                           ).to(device)
    wtab[:, K.PRIORITY_AXIS.index("gang_locality")] = torch.tensor(
        [0, 3, 5], device=device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(K.PRIORITY_AXIS)}
    specs = [_spec(500, False, rng, n_pad, s_count),
             _spec(1000, True, rng, n_pad, s_count),
             _spec(2000, False, rng, n_pad, s_count),
             _spec(7000, False, rng, n_pad, s_count)]
    if build == "ties":
        # no dense mask or count: the open nodes' scores stay tied
        specs[1] = _spec(1000, False, rng, n_pad, s_count)
    n_pods = B * 25 // 32
    rows = np.concatenate([rng.integers(0, 3, n_pods),
                           np.full(B - n_pods, 4)])
    pad = dict(specs[0], skip=np.bool_(True))
    prof = rng.integers(-1, 4, B)

    def stack(spread=False, with_prof=False, rows=rows):
        sp = [dict(d) for d in specs] + [dict(pad)]
        if spread:
            for d in sp:
                d["spread_counts"] = np.zeros(1, np.int64)
        return K.PodStack.from_specs(sp, rows, prof if with_prof else None,
                                     device)
    spread0 = torch.as_tensor(rng.integers(0, 5, n_pad)).to(device)
    ntf_part = max(1, n_real * 9 // 40)
    cases = [
        ("identity", {}, ntf_part),
        ("perm", dict(rotation=(perms_t, inv_t, oid)), ntf_part * 7 // 9),
        ("pos", dict(rotation_pos=(inv_t, oid)), n_real),
        ("spread", dict(spread0=spread0), ntf_part),
        ("weight table", dict(weights=union, wtab=wtab), n_real),
    ]
    for name, kw, ntf in cases:
        st = stack(spread=name == "spread", with_prof=name == "weight table")
        args = (nodes, st, li, lni, ntf, n_real, 8)
        got = K.schedule_batch(*args, **kw)
        want = K.schedule_batch_plain(*args, **kw)
        same(f"schedule_batch/{name}", got, want)
        if name == "spread":
            # chain a second window on the first one's device carry
            args2 = (nodes, st, got[1], got[2], ntf, n_real, 8)
            same("schedule_batch/carry_in",
                 K.schedule_batch(*args2, carry_in=(got[0], got[3])),
                 K.schedule_batch_plain(*args2,
                                        carry_in=(want[0], want[3])))
    # K6: singleton runs, gangs (spec 3 asks 7 CPU: on the first geometry
    # its gang cannot all fit and rewinds), a failing 9-CPU singleton,
    # padding
    big = dict(specs[0], req_cpu=np.int64(9000), nz_cpu=np.int64(9000),
               upd_cpu=np.int64(9000))
    sp = [dict(d) for d in specs] + [dict(pad), big]
    scale = B / 256
    layout = [(0, 20, False), (1, 30, True), (3, 60, True), (2, 15, False),
              (1, 40, True), (5, 1, False), (0, 10, False)]
    seg = np.zeros(B, bool)
    gang = np.zeros(B, bool)
    rws = np.full(B, 4)
    i = 0
    for spec, length, g in layout:
        length = max(1, int(length * scale))
        seg[i] = True
        gang[i: i + length] = g
        rws[i: i + length] = spec
        i += length
    seg[i] = True
    n_seg = i
    seg_t = torch.as_tensor(seg).to(device)
    gang_t = torch.as_tensor(gang).to(device)
    for name, kw, ntf, np_ in [
            ("axis", {}, ntf_part, n_seg),
            ("perm", dict(rotation=(perms_t, inv_t, oid)), ntf_part * 7 // 9,
             n_seg),
            ("pos", dict(rotation_pos=(inv_t, oid)), n_real, n_seg),
            ("gang score + weight table",
             dict(weights=union, wtab=wtab, gang_score=True), n_real, n_seg),
            ("spread carry", dict(spread0=spread0), ntf_part, n_seg),
            ("n_pods < B, stops mid-gang", {}, ntf_part, n_seg * 4 // 7)]:
        st = K.PodStack.from_specs(sp, rws, prof if "wtab" in kw else None,
                                   device)
        args = (nodes, st, seg_t, gang_t, np_, 5 if build is None else li,
                9, ntf, n_real, 8)
        got = K.schedule_batch_segments(*args, **kw)
        want = K.schedule_batch_segments_plain(*args, **kw)
        same(f"schedule_segments/{name}", got, want)
        sel = want[4][:B].cpu().numpy()
        if name == "axis" and first:
            g = sel[50:110]
            if not ((g >= 0).any() and (g < 0).any()):
                raise SystemExit("variant schedule_segments: the 7-CPU "
                                 "gang did not rewind part way")
    if build == "ties":
        # the walk starts in another block than both groups of winners
        sel = K.schedule_batch_plain(nodes, stack(), li, lni, n_real,
                                     n_real, 8)[4]["selected"].cpu().numpy()
        span = K.cluster_plan(n_pad, s_count, 8, False).span
        blocks = {int(j) // span for j in sel if j >= 0}
        if li // span in blocks or blocks != {3 // span, 2050 // span}:
            raise SystemExit(f"variant ties: the winners' blocks {blocks}")
    return checked


MESH_SHARDS = (1, 2, 4)        # shards of one card in the mesh checks


def cat_rows(rows):
    """Per-shard rows as whole [n_pad] vectors on the first shard's
    device."""
    import torch
    return {k: torch.cat([r[k].to(rows[0][k].device) for r in rows])
            for k in rows[0]}


def mesh_variant_checks(device, sync, meshes=None):
    """The mesh kernels K9a-d against their plain versions on random
    inputs, and the sharded programs against the single-device plain K2
    and K3, on one card split into 1, 2 and 4 shards (`[device] * D`):
    every K2 family dense and inert, identity, perm and pos walks and a
    weight table for the cycle; K3's plain, lni, rotate, ban + extra_ok,
    carried rows, weight table and saturated cases for the burst; n_real
    (3,999) a multiple of no shard count. Every mesh's results are held
    against the single-device plain K2 / K3 (computed once a case); the
    sharded plain K3 runs on the 4-shard mesh only. `meshes` (lists of
    devices) replaces the shards of one card, e.g. by the cards of a
    host, and runs the sharded plain versions on each of them."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    rng = np.random.default_rng(20261019)
    n_pad, n_real, s_count, zones = 4096, 3999, 2, 6
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"mesh variant {name}: disagrees (max_abs_err "
                             f"{err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    keys = CYCLE_KEYS
    nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
    perm = np.concatenate([rng.permutation(n_real),
                           np.arange(n_real, n_pad)]).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=np.int32)
    perm_t = torch.as_tensor(perm).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                           ).to(device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(K.PRIORITY_AXIS)}
    weight_cases = [dict(K.DEFAULT_WEIGHTS),
                    {**K.DEFAULT_WEIGHTS, "least_requested": 0,
                     "most_requested": 2}]
    fresh, ucases, cap = uniform_cases(rng, nodes, n_pad, n_real, s_count,
                                       wtab, union, device)
    pods = [_rand_pod(rng, n_pad, s_count, dense) for dense in (False, True)]
    # the single-device plain K2 / K3 of a case is the same on every mesh:
    # computed once; the sharded plain K3 (the slow part) runs on the
    # 4-shard mesh of the card (on every mesh of `meshes`)
    want_cycle, want_uniform = {}, {}
    mesh_devs = meshes or [[device] * D for D in MESH_SHARDS]
    for mi, devs in enumerate(mesh_devs):
        mesh = S.Mesh(devs)
        D = mesh.size
        sharded_plain = meshes is not None or mi == len(mesh_devs) - 1
        shards = S.shard_node_arrays(mesh, nodes)
        for pod in pods:
            for w in weight_cases:
                for mode in ("identity", "perm", "pos"):
                    li, lni, ntf = 37, 11, 900
                    kw = {}
                    if mode == "perm":
                        kw = dict(perm=perm_t, inv_perm=inv_t)
                    elif mode == "pos":
                        kw = dict(pos=inv_t)
                        ntf = n_real
                    args = (pod, li, lni, ntf, n_real, 8)
                    got = K.schedule_cycle(shards, *args, weights=w,
                                           mesh=mesh, **kw)
                    with plain_versions(MESH_ENTRIES):
                        ref = K.schedule_cycle(shards, *args, weights=w,
                                               mesh=mesh, **kw)
                    case = (id(pod), id(w), mode)
                    if case not in want_cycle:
                        want_cycle[case] = K.schedule_cycle_plain(
                            nodes, *args, weights=w, **kw)
                    want = want_cycle[case]
                    for name, other in (("plain", ref), ("K2 plain", want)):
                        same(f"{D} shards/cycle/{mode} vs {name}",
                             {k: got[k] for k in keys},
                             {k: other[k] for k in keys})
            p = dict(pod, profile_id=np.int64(2))
            args = (p, 5, 3, n_real, n_real, 8)
            got = K.schedule_cycle(shards, *args, weights=union, wtab=wtab,
                                   mesh=mesh)
            want = K.schedule_cycle_plain(nodes, *args, weights=union,
                                          wtab=wtab)
            same(f"{D} shards/cycle/wtab", {k: got[k] for k in keys},
                 {k: want[k] for k in keys})
        fshards = S.shard_node_arrays(mesh, fresh)
        for name, cls, n_pods, lni, kw in ucases:
            args = (cls, n_pods, lni, n_real, True)
            got = K.schedule_batch_uniform(fshards, *args, cap=cap,
                                           mesh=mesh, **kw)
            if name not in want_uniform:
                want_uniform[name] = K.schedule_batch_uniform_plain(
                    fresh, *args, cap=cap, **kw)
            others = [(want_uniform[name], "K3 plain")]
            if sharded_plain:
                with plain_versions(MESH_ENTRIES):
                    others.append((K.schedule_batch_uniform(
                        fshards, *args, cap=cap, mesh=mesh, **kw), "plain"))
            for other, label in others:
                same(f"{D} shards/uniform/{name} vs {label}",
                     (cat_rows(got[0]), got[1], got[2]),
                     (cat_rows(other[0]) if isinstance(other[0], list)
                      else other[0], other[1], other[2]))
        # K4 over the mesh: 24 dirty rows spread over the shards, one
        # staged copy and one launch a device, against the plain scatter
        # of each shard's rows
        k4_shards = S.shard_node_arrays(mesh, nodes)
        k4_ref = _clone(k4_shards)
        host = {k: v.cpu().numpy().copy() for k, v in nodes.items()}
        for v in host.values():
            if v.dtype == np.int64:
                v += rng.integers(1, 9, v.shape)
        dirty = np.sort(rng.choice(n_pad, 24, replace=False))
        per, k4_keys = n_pad // D, tuple(nodes)
        before = obs.get("launch.scatter_rows")
        for d in mesh.distinct:
            idx = [s for s, x in enumerate(mesh.devices) if x == d]
            parts = [(k, dirty[(dirty >= s * per) & (dirty < (s + 1) * per)],
                      s * per) for k, s in enumerate(idx)]
            parts = [p for p in parts if len(p[1])]
            K.scatter_dirty(K.scatter_table([k4_shards[s] for s in idx],
                                            k4_keys), parts,
                            [host[k] for k in k4_keys])
        for s, sh in enumerate(k4_ref):
            mine = dirty[(dirty >= s * per) & (dirty < (s + 1) * per)]
            K.scatter_rows_plain(sh, mine - s * per,
                                 {k: host[k][mine] for k in k4_keys})
        launched = obs.get("launch.scatter_rows") - before
        if launched != len(mesh.distinct):
            raise SystemExit(f"mesh variant {D} shards/scatter_rows: "
                             f"{launched} launches for "
                             f"{len(mesh.distinct)} devices")
        same(f"{D} shards/scatter_rows vs plain", cat_rows(k4_shards),
             cat_rows(k4_ref))
    sync()
    print(f"[variants] {checked} mesh comparisons equal (K9a-d against "
          f"their plain versions and the sharded programs against the "
          f"single-device plain K2/K3, K4 over the mesh's shards against "
          f"the plain scatter, on meshes of "
          f"{[len(m) for m in meshes] if meshes else list(MESH_SHARDS)} "
          f"shards, n_real {n_real})")


MIXED_PROFILES = [
    {"schedulerName": "default-scheduler"},
    # MostRequested in place of LeastRequested (the ClusterAutoscaler
    # provider's vector)
    {"schedulerName": "packer", "priorities": {
        "SelectorSpreadPriority": 1, "InterPodAffinityPriority": 1,
        "MostRequestedPriority": 1, "BalancedResourceAllocation": 1,
        "NodePreferAvoidPodsPriority": 10000, "NodeAffinityPriority": 1,
        "TaintTolerationPriority": 1, "ImageLocalityPriority": 1}},
]
FUSED_PROFILES = [{"schedulerName": "default-scheduler",
                   "rankAwareGang": True, "gangWeight": 2}]


def mixed_labels(i):
    out = {}
    if i % 3 == 0:
        out["disktype"] = "ssd"
    if i % 5 == 0:
        out["tier"] = "gold"
    return out


def mixed_window(n_pods):
    """Four Deployment shapes, interleaved: (100m, 500 Mi); (250m, 1 Gi);
    (500m, 2 Gi) on disktype=ssd; (1 CPU, 4 Gi) preferring tier=gold
    (weight 50). The last two use the `packer` profile."""
    from kubernetes_tpu_torch.api import types as T
    gold = T.Affinity(node_affinity=T.NodeAffinity(preferred=(
        T.PreferredSchedulingTerm(weight=50, preference=T.NodeSelectorTerm(
            match_expressions=(T.Requirement(key="tier", op=T.IN,
                                             values=("gold",)),))),)))
    shapes = [
        pods(n_pods, prefix="web", cpu=100, mem=500 * MI, app="web"),
        pods(n_pods, prefix="api", cpu=250, mem=GI, app="api"),
        pods(n_pods, prefix="db", cpu=500, mem=2 * GI, app="db",
             node_selector={"disktype": "ssd"},
             scheduler_name="packer"),
        pods(n_pods, prefix="batch", cpu=1000, mem=4 * GI, app="batch",
             affinity=gold, scheduler_name="packer"),
    ]
    return [shapes[j % 4][j] for j in range(n_pods)]


def spread_window(n_pods):
    return pods(n_pods, prefix="spread", app="spread")


def spread_services():
    from kubernetes_tpu_torch.api.types import Service
    return [Service(name="spread", selector={"app": "spread"})]


def rack_labels(i):
    # every 375th node of 15,000: 40 nodes
    return {"rack": "r0"} if i % (N_NODES // RACK_NODES) == 0 else {}


def fused_window(with_rack=True):
    """One drain window: 100 gangs of 64 (500m / 1 Gi) interleaved with
    singleton runs of 36 (100m / 500 Mi), and after the fifth gang one gang
    of 64 x 3 CPU on rack=r0, which 40 nodes carry: 40 members place, the
    41st fails, and the gang rewinds."""
    segs = []
    for g in range(N_GANGS):
        segs.append((pods(RUN_SIZE, prefix=f"run{g}"), False))
        segs.append((pods(GANG_SIZE, prefix=f"gang{g}", cpu=500, mem=GI,
                          app=f"gang{g}"), True))
        if g == 4 and with_rack:
            segs.append((pods(GANG_SIZE, prefix="rack", cpu=3000, mem=GI,
                              app="rack", node_selector={"rack": "r0"}),
                         True))
    return segs


def prefix_segments(segs, n):
    """The leading segments holding at least `n` pods."""
    out, k = [], 0
    for seg in segs:
        if k >= n:
            break
        out.append(seg)
        k += len(seg[0])
    return out


def make_sched(tree, device, pct, services=(), profiles=None, mesh=None):
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    from kubernetes_tpu_torch.profiles import ProfileSet
    sched = TorchScheduler(percentage_of_nodes_to_score=pct, node_tree=tree,
                           device=device,
                           services_fn=lambda: list(services), mesh=mesh)
    if profiles is not None:
        sched.set_profiles(ProfileSet.from_dict({"profiles": profiles}))
    return sched


def mutable_rows(sched):
    """The resident matrix's mutable rows on the host (a mesh's shards
    gathered back into whole vectors)."""
    from kubernetes_tpu_torch.ops.kernels import _MUTABLE
    dev = sched._dev_nodes
    if dev is None:
        return None
    if isinstance(dev, list):
        dev = cat_rows(dev)
    # a copy: the serial cycles after the window scatter into these rows
    return {k: dev[k].to("cpu", copy=True) for k in _MUTABLE}


def run_scan(cfg, n_nodes, window, n_serial, device, sync, mesh=None):
    """One scan path: the window through schedule_burst, the assume loop,
    then `n_serial` serial cycles (the node axis split over `mesh` when
    given)."""
    infos, tree = cluster(n_nodes, cfg.get("labels"))
    sched = make_sched(tree, device, cfg["pct"], cfg.get("services", ()),
                       cfg.get("profiles"), mesh=mesh)
    t0 = time.perf_counter()
    hosts = sched.schedule_burst(window, infos, tree.list_names())
    sync()
    t_burst = time.perf_counter() - t0
    if hosts is None:
        raise SystemExit(f"{cfg['name']}: the window was refused")
    rows = mutable_rows(sched)
    counters = (sched.last_index, sched.last_node_index)
    kf = hosts.index(None) if None in hosts else len(hosts)
    t1 = time.perf_counter()
    gens = [assume(infos, p, h) for p, h in zip(window[:kf], hosts[:kf])]
    sched.note_burst_assumed_many(window[:kf], hosts[:kf], gens)
    if kf:
        tree.advance_enumerations(kf - 1)
    t_assume = time.perf_counter() - t1
    serial = []
    t2 = time.perf_counter()
    for p in pods(n_serial, prefix="serial"):
        r = sched.schedule(p, infos, tree.list_names())
        serial.append((r.suggested_host, r.evaluated_nodes,
                       r.feasible_nodes, tuple(r.host_priority)))
        assume(infos, p, r.suggested_host)
    sync()
    return {"hosts": hosts, "serial": serial, "sched": sched, "rows": rows,
            "counters": counters, "t_burst": t_burst, "t_assume": t_assume,
            "t_serial": time.perf_counter() - t2,
            "phases": dict(sched.last_burst_phases or {})}


def run_fused(cfg, n_nodes, segments, device, sync, mesh=None):
    """One fused drain window, committed as the shell commits it."""
    infos, tree = cluster(n_nodes, cfg.get("labels"))
    sched = make_sched(tree, device, cfg["pct"], (), cfg.get("profiles"),
                       mesh=mesh)
    t0 = time.perf_counter()
    res = sched.schedule_burst_fused(segments, infos, tree.list_names())
    sync()
    t_burst = time.perf_counter() - t0
    if res is None:
        raise SystemExit(f"{cfg['name']}: the window was refused")
    placed, hosts = [], []
    for (seg, _g), rec in zip(segments, res["segments"]):
        if rec["status"] in ("decided", "failed"):
            placed += seg[:len(rec["hosts"])]
            hosts += rec["hosts"]
    gens = [assume(infos, p, h) for p, h in zip(placed, hosts)]
    sched.note_burst_assumed_many(placed, hosts, gens)
    if res["consumed"] > 0:
        tree.advance_enumerations(res["consumed"] - 1)
    return {"res": res, "sched": sched, "rows": mutable_rows(sched),
            "counters": (sched.last_index, sched.last_node_index),
            "t_burst": t_burst, "phases": dict(sched.last_burst_phases)}


def _records(res):
    """A fused result without its numpy counter sequences."""
    return [{k: (list(map(int, v)) if k.endswith("_seq") else v)
             for k, v in r.items()} for r in res["segments"]]


def same_rows(name, a, b):
    if (a is None) != (b is None):
        raise SystemExit(f"{name}: folded rows kept on one side only")
    if a is not None and max_abs_err(a, b) != 0:
        raise SystemExit(f"{name}: folded rows differ "
                         f"({first_diff(a, b)})")


class capture:
    """Record the inputs of the first call of a kernel entry point (its
    tensors cloned, so later calls cannot change them), so the kernel
    check runs on the main path's own inputs, and the result of its last
    call (of every call with `keep_all`)."""

    def __init__(self, fn_name, keep_all=False):
        self.fn_name = fn_name
        self.call = self.last = None
        self.keep_all = keep_all
        self.all = []       # every call's result, when keep_all

    def __enter__(self):
        from kubernetes_tpu_torch.ops import kernels as K
        real = self.real = getattr(K, self.fn_name)

        def rec(nodes, *args, **kw):
            if self.call is None:
                # on several cards, what other cards' streams still owe
                # (a peer's records and stamps) lands before the copy
                _sync_cards()
                self.call = (_clone(nodes), _clone(args), _clone(kw))
            self.last = real(nodes, *args, **kw)
            if self.keep_all:
                self.all.append(self.last)
            return self.last
        setattr(K, self.fn_name, rec)
        return self

    def __exit__(self, *exc):
        from kubernetes_tpu_torch.ops import kernels as K
        setattr(K, self.fn_name, self.real)


def _sync_cards():
    """Synchronize every card of the host, when it has several."""
    import torch
    if torch.cuda.device_count() > 1:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _clone(x):
    """A copy of a kernel call's arguments that later calls cannot
    change: tensors cloned, containers and the uniform shard state copied
    through."""
    import copy
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, (K.UniformShard, K.ScanShard, K.ScanSide,
                      K.PreemptShard, K.PreemptSide, K.CycleShard,
                      K.CycleSide, K.CycleCall)):
        y = copy.copy(x)
        y.__dict__ = _clone(x.__dict__)
        for cache in ("_args", "_nodes"):
            if hasattr(y, cache):
                # launch words point at the original tensors
                setattr(y, cache, {})
        return y
    return x


def scan_bound(nodes, stack, n_cycles, n_real, out_bytes):
    """(bound_ms, bound_by) of one scan window: its bytes (node fields and
    pod tables read once, mutable rows written once, the decision block)
    over the memory rate, against its integer work (OPS_PER_NODE_CYCLE per
    node per cycle run) over the non-tensor peak."""
    nbytes = sum(v.numel() * v.element_size() for v in nodes.values())
    nbytes += sum(v.numel() * v.element_size()
                  for v in stack.table.values())
    nbytes += 8 * 7 * nodes["valid"].shape[0] + out_bytes + 12 * len(stack)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = n_cycles * n_real * OPS_PER_NODE_CYCLE / H100_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def call_entry(report, name, fn, plain, call, bound, sync, reps, label,
               dev_kernels=None):
    """Hold a kernel against its plain version on one captured call of its
    main path, time both (the plain version once), file its report entry;
    returns the kernel's ms. `dev_kernels` (CUDA kernel names): the entry
    also gets `device_ms`, their device time a call (torch.profiler)."""
    import torch
    nodes, args, kw = call
    got = fn(nodes, *args, **kw)
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    want = plain(nodes, *args, **kw)
    end.record()
    sync()
    plain_ms = start.elapsed_time(end)
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with plain (max_abs_err "
                         f"{err}; first difference {first_diff(got, want)})")
    ms = cuda_time(lambda: fn(nodes, *args, **kw), sync, reps)
    report[name] = {"name": name, "route": "cuda",
                    "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": None}
    note = ""
    if dev_kernels:
        dev_ms, seen = device_ms_a_call(lambda: fn(nodes, *args, **kw),
                                        sync, reps, dev_kernels)
        report[name]["device_ms"] = dev_ms
        note = (f"; device_ms {fmt_ms(dev_ms)} a call over {seen} "
                f"launches (torch.profiler)")
    print(f"[kernel] {name}: equal to plain on {label} (max_abs_err 0), "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound[0]:.6f} ({bound[1]}){note}")
    return ms


def prefix_call(call, n, segments=False):
    """A captured K5 / K6 call cut to the window's first `n` pods: the pod
    stack's rows (and profile ids), for K6 also seg_start, gang and
    n_pods. The kernel and its plain version are held and timed on it;
    the whole window's decisions are held against the plain path's
    prefix by scan_path / fused_path."""
    from kubernetes_tpu_torch.ops import kernels as K
    nodes, args, kw = call
    st = args[0]
    pid = None if st.profile_id is None else st.profile_id[:n]
    stack = K.PodStack(st.table, st.row[:n], pid, skip=st.skip_flags())
    if not segments:
        return nodes, (stack,) + tuple(args[1:]), kw
    return nodes, (stack, args[1][:n], args[2][:n],
                   min(int(args[3]), n)) + tuple(args[4:]), kw


def scan_kernel_entry(report, name, fn, plain, call, n_cycles, n_pods,
                      out_bytes, sync):
    """call_entry for a scan kernel on the first `n_pods` pods of its
    path's window (`call` cut by prefix_call)."""
    nodes, args, _kw = call
    bound = scan_bound(nodes, args[0], n_cycles, int(nodes["valid"].sum()),
                       out_bytes)
    ms = call_entry(report, name, fn, plain, call, bound, sync, 3,
                    f"the window's first {n_pods} pods")
    from kubernetes_tpu_torch.ops import kernels as K
    print(f"[kernel] {name}: {ms / n_pods * 1e3:.2f} us/pod; "
          f"{describe_geometry(*K.last_geometry[name])}")


def path_report(name, n_nodes, n_pods, run, counts, extra=""):
    ph = run["phases"]
    t = run["t_burst"]
    print(f"[path] {name}: {n_nodes} nodes, {n_pods} pods, "
          f"{n_pods / t:.1f} pods/s ({t * 1e3:.2f} ms: encode "
          f"{ph['encode'] * 1e3:.2f} (node mirror {ph['mirror'] * 1e3:.2f}) "
          f"dispatch {ph['dispatch'] * 1e3:.2f} fetch "
          f"{ph['fetch'] * 1e3:.2f}); launches {counts}{extra}")


def scan_path(cfg, n_nodes, window_fn, device, sync, report, check,
              n_pods=N_PODS, prefix=PREFIX):
    """A scan path: the whole window on the kernels (launches counted),
    then the first `prefix` pods on the kernels and on the plain versions,
    which must agree in decisions, walk counters, folded rows and serial
    cycles, and must be the whole run's first decisions. Returns the
    whole run and its K5 call's result (the mesh paths' reference)."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    name = cfg["name"]
    window = window_fn(n_pods)
    obs.reset()
    with capture("schedule_batch") as cap:
        run = run_scan(cfg, n_nodes, window, cfg["serial"], device, sync)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    for k in cfg["kernels"]:
        if counts[k] == 0:
            raise SystemExit(f"{name}: {k} was not launched on the path")
    placed = sum(h is not None for h in run["hosts"])
    if placed != n_pods:
        raise SystemExit(f"{name}: placed {placed} of {n_pods}")
    short = window_fn(prefix)
    kern = run_scan(cfg, n_nodes, short, cfg["serial"], device, sync)
    with plain_versions():
        ref = run_scan(cfg, n_nodes, short, cfg["serial"], device, sync)
    if kern["hosts"] != ref["hosts"] or kern["serial"] != ref["serial"] \
            or kern["counters"] != ref["counters"]:
        raise SystemExit(f"{name}: the first {prefix} pods differ from "
                         f"the plain path")
    same_rows(name, kern["rows"], ref["rows"])
    if run["hosts"][:prefix] != kern["hosts"]:
        raise SystemExit(f"{name}: the window's first {prefix} decisions "
                         f"differ from the {prefix}-pod window's")
    if check is not None:
        check(cap.call, run)
    add_launches(report, counts)
    rot = run["sched"]._tree_rotates()
    path_report(name, n_nodes, n_pods, run, counts,
                f"; rotating walk {rot}; assume loop "
                f"{run['t_assume'] * 1e3:.1f} ms; {cfg['serial']} serial "
                f"cycles {run['t_serial'] * 1e3:.1f} ms; first {prefix} "
                f"pods, counters, rows and serial cycles equal to the plain "
                f"path")
    return run, cap.last


def fused_path(cfg, device, sync, report, check):
    """The fused-gang path: the whole window on K6 (launches counted); the
    rack gang is rejected after placing 40 members, and the window without
    it ends in the same rows, counters and consumed enumerations; its
    first >= PREFIX pods agree with the plain path. Returns the whole run
    and its K6 call's result."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    name = cfg["name"]
    segs = fused_window()
    n_pods = sum(len(s) for s, _g in segs)
    obs.reset()
    with capture("schedule_batch_segments") as cap:
        run = run_fused(cfg, N_NODES, segs, device, sync)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    if counts["schedule_segments"] == 0:
        raise SystemExit(f"{name}: schedule_segments was not launched")
    recs = run["res"]["segments"]
    rack = next(i for i, (s, _g) in enumerate(segs)
                if s[0].name.startswith("rack"))
    if recs[rack]["status"] != "rejected" \
            or recs[rack]["placed"] != RACK_NODES:
        raise SystemExit(f"{name}: the rack gang was {recs[rack]}")
    others = [r for i, r in enumerate(recs) if i != rack]
    if any(r["status"] != "decided" for r in others):
        raise SystemExit(f"{name}: not every other segment was decided")
    bare = run_fused(cfg, N_NODES, fused_window(with_rack=False), device,
                     sync)
    if _records({"segments": others}) != _records(bare["res"]) \
            or run["counters"] != bare["counters"] \
            or run["res"]["consumed"] != bare["res"]["consumed"]:
        raise SystemExit(f"{name}: the window differs from one without "
                         f"the rejected gang")
    same_rows(name + " (without the rejected gang)", run["rows"],
              bare["rows"])
    short = prefix_segments(segs, PREFIX)
    kern = run_fused(cfg, N_NODES, short, device, sync)
    with plain_versions():
        ref = run_fused(cfg, N_NODES, short, device, sync)
    if _records(kern["res"]) != _records(ref["res"]) \
            or kern["counters"] != ref["counters"] \
            or kern["res"]["consumed"] != ref["res"]["consumed"]:
        raise SystemExit(f"{name}: the first segments differ from the "
                         f"plain path")
    same_rows(name, kern["rows"], ref["rows"])
    if _records(kern["res"]) != _records(run["res"])[:len(short)]:
        raise SystemExit(f"{name}: the window's first segments differ "
                         f"from the short window's")
    if check is not None:
        check(cap.call, run, n_pods)
    add_launches(report, counts)
    n_short = sum(len(s) for s, _g in short)
    path_report(name, N_NODES, n_pods, run, counts,
                f"; {len(segs)} segments, rack gang rejected after "
                f"{RACK_NODES} members, window without it equal (rows, "
                f"counters, "
                f"{run['res']['consumed']} enumerations); first "
                f"{len(short)} segments ({n_short} pods) equal to the "
                f"plain path")
    return run, cap.last


def add_launches(report, counts):
    """Add a path's launch counts to the kernels' report entries."""
    for k, v in counts.items():
        if v:
            report[k]["launches"] += v


def scan_paths(device, sync, report):
    """The K5 and K6 paths, each kernel held against its plain version on
    its main path's whole window first. Returns {cell: (run, the kernel
    call's result)}, the single-device reference of the mesh paths."""
    from kubernetes_tpu_torch.ops import kernels as K

    def k5_check(call, run):
        # every pod of the prefix runs a cycle
        scan_kernel_entry(report, "schedule_batch", K.schedule_batch,
                          K.schedule_batch_plain, prefix_call(call, PREFIX),
                          PREFIX, PREFIX, PREFIX * (3 * 4 + 5 * 8), sync)

    def k6_check(call, run, n_pods):
        # every pod of the prefix runs a cycle but the rack gang's members
        # behind its failing one (the rack gang starts at pod 500)
        n_cycles = PREFIX - (GANG_SIZE - RACK_NODES - 1)
        scan_kernel_entry(report, "schedule_segments",
                          K.schedule_batch_segments,
                          K.schedule_batch_segments_plain,
                          prefix_call(call, PREFIX, segments=True),
                          n_cycles, PREFIX, PREFIX * 4 * 4, sync)

    runs = {}
    for cfg, n_nodes, window_fn in scan_cells():
        runs[cfg["name"]] = scan_path(
            cfg, n_nodes, window_fn, device, sync, report,
            k5_check if cfg["name"] == "scan-default" else None)
    runs[FUSED_CELL["name"]] = fused_path(FUSED_CELL, device, sync, report,
                                          k6_check)
    return runs


def scan_cells():
    """The scan cells (config, nodes, window), run on one device by
    scan_paths and over a mesh by mesh_scan_paths."""
    default = {"name": "scan-default", "pct": 50, "serial": N_SERIAL,
               "kernels": ("schedule_batch", "schedule_cycle",
                           "scatter_rows")}
    return [
        (default, N_NODES, pods),
        (dict(default, name="scan-default (uneven zones, perm walk)"),
         N_NODES + 1, pods),
        ({"name": "scan-mixed", "pct": 100, "serial": 0,
          "labels": mixed_labels, "profiles": MIXED_PROFILES,
          "kernels": ("schedule_batch",)}, N_NODES + 1, mixed_window),
        ({"name": "scan-spread", "pct": 100, "serial": 0,
          "services": spread_services(), "kernels": ("schedule_batch",)},
         N_NODES, spread_window),
    ]


#: the largest cell of the JAX harness's shard matrix
#: (kubernetes_tpu/perf/harness.py:1190, `BENCHMARK_MATRIX["shard"]`):
#: 200,000 of bench.py's nodes, a 1,000-pod window at the default 50 %, on
#: one card (n_pad 262,144: K5 with its rows and scratch in global memory)
SCALE_CELL = {"name": "scan-200k", "pct": 50, "serial": 0,
              "kernels": ("schedule_batch",)}
SCALE_NODES, SCALE_PODS, SCALE_PREFIX = 200000, 1000, 64
#: one cluster round alone on an H100, us (scripts/cycle_phase_split.py;
#: PERF.md): a cycle's chain floor is 4 of them
ROUND_US = 1.279


def scale_path(device, sync, report):
    """The 200,000-node scan window (SCALE_CELL) through schedule_burst,
    its first SCALE_PREFIX pods held against the plain path; prints its
    [path] line, and K5's geometry there with its time a pod on the
    window's first SCALE_PREFIX pods (CUDA events and device time over 3
    calls) beside its bound and chain floor."""
    from kubernetes_tpu_torch.ops import kernels as K
    K.last_geometry.clear()
    calls = []
    scan_path(SCALE_CELL, SCALE_NODES, pods, device, sync, report,
              lambda call, run: calls.append(call), n_pods=SCALE_PODS,
              prefix=SCALE_PREFIX)
    plan, fit = K.last_geometry["schedule_batch"]
    if not plan.global_scratch:
        raise SystemExit(f"{SCALE_CELL['name']}: K5 planned {plan}, not the "
                         f"scratch in global memory")
    nodes, args, kw = prefix_call(calls[0], SCALE_PREFIX)

    def k5():
        return K.schedule_batch(nodes, *args, **kw)
    ms = cuda_time(k5, sync, 3)
    dev_ms, _n = device_time(k5, sync, 3, "schedule_batch_kernel")
    device = ("not measured (torch.profiler recorded no kernel event)"
              if dev_ms is None else
              f"{dev_ms / SCALE_PREFIX * 1e3:.2f} us/pod")
    bound = scan_bound(nodes, args[0], SCALE_PREFIX,
                       int(nodes["valid"].sum()),
                       SCALE_PREFIX * (3 * 4 + 5 * 8))
    print(f"[kernel] schedule_batch on {SCALE_CELL['name']}: "
          f"{ms / SCALE_PREFIX * 1e3:.2f} us/pod, device {device} "
          f"(first {SCALE_PREFIX} "
          f"pods; bound {bound[0] / SCALE_PREFIX * 1e3:.4f} us/pod "
          f"({bound[1]}), chain floor {4 * ROUND_US:.2f} us/pod); "
          f"{describe_geometry(plan, fit)}")


#: the fused cell, likewise
FUSED_CELL = {"name": "fused-gang", "pct": 50, "labels": rack_labels,
              "profiles": FUSED_PROFILES}


def no_k1_launch(name, counts):
    """K1 is inline in K3 and K9c (their pass-start scores): a uniform or
    mesh-uniform path launches it no time."""
    if counts["local_total"]:
        raise SystemExit(f"{name}: K1 local_total launched "
                         f"{counts['local_total']} times on the path")


def main_path(name, n_nodes, device, sync, report):
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    obs.reset()
    run = run_path(n_nodes, N_PODS, N_SERIAL, device, sync)
    rotates = run["sched"]._tree_rotates()
    counts = K.launches()
    refusals = obs.family("refusal")
    fetches = obs.family("fetch")
    with plain_versions():
        ref = run_path(n_nodes, N_PODS, N_SERIAL, device, sync)
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    missing = [k for k in UNIFORM_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    no_k1_launch(name, counts)
    if run["hosts"] != ref["hosts"] or run["serial"] != ref["serial"]:
        raise SystemExit(f"{name}: decisions differ from the plain path")
    placed = sum(h is not None for h in run["hosts"])
    if placed != N_PODS:
        raise SystemExit(f"{name}: placed {placed} of {N_PODS}")
    sched = run["sched"]
    if sched.last_node_index != ref["sched"].last_node_index:
        raise SystemExit(f"{name}: lastNodeIndex differs")
    ph = run["phases"]
    print(f"[path] {name}: {n_nodes} nodes (rotating walk: {rotates}), "
          f"{N_PODS} pods placed, "
          f"{N_PODS / run['t_burst']:.1f} pods/s burst "
          f"({run['t_burst'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"(node mirror {ph['mirror'] * 1e3:.2f}) "
          f"dispatch {ph['dispatch'] * 1e3:.2f} fetch "
          f"{ph['fetch'] * 1e3:.2f}); "
          f"assume loop {run['t_assume'] * 1e3:.1f} ms; {N_SERIAL} serial "
          f"cycles {run['t_serial'] * 1e3:.1f} ms; launches {counts}; "
          f"fetches {fetches}; plain path burst "
          f"{ref['t_burst'] * 1e3:.1f} ms; decisions equal")
    add_launches(report, counts)


# ---------------------------------------------------------------------------
# Node-axis sharding: K9a-d on a mesh of four shards of the one card
# ---------------------------------------------------------------------------
MESH_D = 4            # shards of the card in the mesh paths
SOURCES.update({
    "shard_cycle_local": ("kubernetes_tpu_torch/ops/csrc/shard_cycle_local.cu",
                          "kubernetes_tpu/parallel/sharding.py:115"),
    "shard_cycle_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_cycle_select.cu",
        "kubernetes_tpu/parallel/sharding.py:115"),
    "shard_uniform_sweep": (
        "kubernetes_tpu_torch/ops/csrc/shard_uniform_sweep.cu",
        "kubernetes_tpu/parallel/sharding.py:151"),
    "shard_uniform_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_uniform_select.cu",
        "kubernetes_tpu/parallel/sharding.py:151"),
    "shard_scan_local": ("kubernetes_tpu_torch/ops/csrc/shard_scan_local.cu",
                         "kubernetes_tpu/parallel/sharding.py:233"),
    "shard_scan_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_scan_select.cu",
        "kubernetes_tpu/parallel/sharding.py:233"),
    "shard_segments_local": (
        "kubernetes_tpu_torch/ops/csrc/shard_segments_local.cu",
        "kubernetes_tpu/parallel/sharding.py:279"),
    "shard_segments_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_segments_select.cu",
        "kubernetes_tpu/parallel/sharding.py:279"),
})


def nbytes(*xs):
    """Bytes of every tensor in `xs` (nested in dicts, lists, shards)."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (list, tuple)):
            total += nbytes(*x)
        elif isinstance(x, K.UniformShard):
            total += nbytes(*x.tensors())
    return total


def mesh_kernel_entry(report, name, call, reset, outputs, io_bytes, sync,
                      reps, label, note="", ops=0, on_device=False,
                      with_copies=0):
    """Hold mesh kernel `name` against its plain version on one captured
    call of the mesh path (each run on its own copy of the arguments,
    `reset(copy, base)` restoring what a call changes before each timed
    run), time both, file its report entry. `outputs(copy, result)` is
    what the two must agree on; the bound is the larger of `io_bytes`
    (each input read once, each output written once) over the memory rate
    and `ops` integer operations over the non-tensor peak. `on_device`:
    the entry also gets `device_ms`, the kernel's own device time a launch
    over the same `reps` calls (torch.profiler), beside `ms`, the CUDA-event
    time of the whole wrapper call (host enqueue and resets included); a
    tuple of CUDA kernel names instead of True: their device time a call,
    summed. `with_copies` (with `on_device` True): the device copies a
    reset makes; `device_ms` is then the kernel's device time a call
    together with theirs, and `device_ms_kernel` the kernel's own."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    args, kw = _full(call)
    fn, plain = getattr(K, name), plain_of(name)
    a_k, a_p = _clone(args), _clone(args)
    got = outputs(a_k, fn(*a_k, **kw))
    want = outputs(a_p, plain(*a_p, **kw))
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"{name}: kernel disagrees with plain (max_abs_err "
                         f"{err}; first difference {first_diff(got, want)})")
    base = _clone(args)

    def timed(f):
        a = _clone(base)

        def one():
            reset(a, base)
            f(*a, **kw)
        return one
    ms = cuda_time(timed(fn), sync, reps)
    plain_ms = cuda_time(timed(plain), sync, 2)
    dev_ms = own_ms = None
    if on_device is True:
        dev_ms, seen = device_time(timed(fn), sync, reps, name + "_kernel")
        if with_copies:
            own_ms = dev_ms
            dev_ms, seen = device_ms_a_call(
                timed(fn), sync, reps, (name + "_kernel", "Memcpy DtoD"),
                (1, with_copies))
            note += (f"; device_ms_kernel {fmt_ms(own_ms)} (the kernel "
                     f"alone)")
    elif on_device:
        dev_ms, seen = device_ms_a_call(timed(fn), sync, reps, on_device)
    if on_device:
        note += (f"; device_ms {dev_ms:.4f} over {seen} launches "
                 f"(torch.profiler)" if dev_ms is not None else
                 "; device_ms not measured (torch.profiler recorded no "
                 "kernel event)")
    bound, by = io_bytes / H100_BYTES_PER_S * 1e3, "bytes"
    if ops / H100_OPS_PER_S * 1e3 > bound:
        bound, by = ops / H100_OPS_PER_S * 1e3, "operations"
    report[name] = {"name": name, "route": "cuda",
                    "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": None}
    if on_device:
        report[name]["device_ms"] = dev_ms
    if with_copies:
        report[name]["device_ms_kernel"] = own_ms
    print(f"[kernel] {name}: equal to plain on {label} (max_abs_err 0), "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
          f"{bound:.6f} ({by}){note}")


def _full(call):
    """A captured call as (all positional arguments, keywords)."""
    first, args, kw = call
    return (first,) + tuple(args), kw


def mesh_kernel_checks(calls, report, sync):
    """K9a-d, each on its first call of the 15,000-node mesh path."""
    from kubernetes_tpu_torch.ops import kernels as K

    def no_reset(a, base):
        pass

    def reset_state(a, base):
        # K9d advances the pass state and writes the decisions: restore
        # them (device copies of 4 KB and 64 KB) before each timed call
        for i in (3, 4, 5):
            a[i].copy_(base[i])

    def result(a, r):
        return r

    args, kw = _full(calls["shard_cycle_local"])
    shards = args[0]
    mesh_kernel_entry(report, "shard_cycle_local", calls["shard_cycle_local"],
                      no_reset, cycle_local_outputs, cycle_local_bytes(*args),
                      sync, 50, f"the first serial cycle, one launch over "
                      f"the {len(shards)} shard(s) of the first device "
                      f"(bound and device_ms for them together)",
                      on_device=True)
    report["shard_cycle_local"]["shards"] = len(shards)
    args, kw = _full(calls["shard_cycle_select"])
    D, rows = int(args[0].shape[0]), int(args[2])
    mesh_kernel_entry(report, "shard_cycle_select",
                      calls["shard_cycle_select"], no_reset, result,
                      D * K.record_layout(args[1], rows)[1]
                      + D * rows * (8 + 1) + 6 * 8, sync, 50,
                      "the first serial cycle's records, in place",
                      on_device=True)
    args, kw = _full(calls["shard_uniform_sweep"])
    shards = args[0]
    mesh_kernel_entry(report, "shard_uniform_sweep",
                      calls["shard_uniform_sweep"], no_reset,
                      lambda a, r: [(sh.rec, sh.tot, sh.flags[:2])
                                    for sh in a[0]],
                      nbytes(shards, args[1], args[2])
                      + sum(nbytes(sh.rec, sh.tot, sh.flags)
                            for sh in shards), sync, 50,
                      f"the burst's first pass, one launch over the "
                      f"{len(shards)} shard(s) of the first device "
                      f"({K.SWEEP_BLOCKS}-block clusters; bound and "
                      f"device_ms for them together)", on_device=True)
    report["shard_uniform_sweep"]["shards"] = len(shards)
    args, kw = _full(calls["shard_uniform_select"])
    mesh_kernel_entry(report, "shard_uniform_select",
                      calls["shard_uniform_select"], reset_state,
                      lambda a, r: (a[3], a[4], a[5]),
                      nbytes(args[0], args[3], args[3], kw.get("perm"),
                             kw.get("oid_seq")) + 4 * K.K_BATCH, sync, 50,
                      "the first pass's gathered records",
                      "; ms and device_ms include the copies that restore "
                      "the pass state and the decisions before each call",
                      on_device=True, with_copies=3)
    # the burst's later passes re-enqueue the launch the first one bound
    a = _clone(args)
    base = _clone(args)
    rel = K.shard_uniform_select(*a, **kw)

    def relaunch():
        reset_state(a, base)
        K._check(rel.fn(), rel.name)
    ms = cuda_time(relaunch, sync, 50)
    rel.book()
    report["shard_uniform_select"]["relaunch_ms"] = ms
    plan, fit = K.last_geometry["shard_uniform_select"]
    report["shard_uniform_select"]["plan"] = plan_entry(
        "shard_uniform_select")
    print(f"[kernel] shard_uniform_select bound: relaunch_ms {ms:.4f} a "
          f"pass (the restore copies and the bound launch's re-enqueue); "
          f"{describe_pass_plan(plan, fit)}")


def cycle_mesh_check(name, mesh, counts):
    """The sharded cycles of a mesh path since the last `obs.reset()`: one
    K9a launch a distinct device and cycle (its shards together), one
    staged upload of the pod (`htod.cycle`) and one K9b, so the three
    counts are equal; under the "peer" exchange (one card, or cards with
    peer access) no record copy (`copies.cycle`). Returns the record
    copies."""
    from kubernetes_tpu_torch import obs
    copies, htod = obs.get("copies.cycle"), obs.get("htod.cycle")
    k9a, k9b = counts["shard_cycle_local"], counts["shard_cycle_select"]
    if k9a != k9b or htod != k9b \
            or (mesh.exchange == "peer" and copies != 0):
        raise SystemExit(f"{name}: K9a launched {k9a} times and uploaded "
                         f"the pod {htod} times for {k9b} K9b launches "
                         f"(one each a device and cycle wanted), {copies} "
                         f"cycle record copies under the "
                         f"{mesh.exchange!r} exchange")
    return copies


def mesh_path(name, n_nodes, device, sync, report, check_kernels,
              mesh=None):
    """The uniform burst and the serial cycles through
    TorchScheduler(mesh=Mesh([device] * MESH_D)), launches counted, held
    against the single-device K3/K2 run of the same world (which
    main_path holds against the plain path): decisions, serial results,
    lastNodeIndex, the packed block, the lni tensor, the folded rows
    gathered back and the resident matrix after the serial cycles. `mesh`
    replaces the shards of one card, e.g. by the cards of a host."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    with capture("schedule_batch_uniform") as one:
        single = run_path(n_nodes, N_PODS, N_SERIAL, device, sync)
    caps = [capture(k) for k in UNIFORM_MESH_KERNELS] if check_kernels \
        else []
    obs.reset()
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        with capture("schedule_batch_uniform") as sharded:
            run = run_path(n_nodes, N_PODS, N_SERIAL, device, sync,
                           mesh=mesh)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    missing = [k for k in UNIFORM_MESH_KERNELS + ("scatter_rows",)
               if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    no_k1_launch(name, counts)
    cycle_copies = cycle_mesh_check(name, mesh, counts)
    if run["hosts"] != single["hosts"] or run["serial"] != single["serial"]:
        raise SystemExit(f"{name}: decisions differ from the single-device "
                         f"path")
    if sum(h is not None for h in run["hosts"]) != N_PODS:
        raise SystemExit(f"{name}: not every pod was placed")
    sched, ref = run["sched"], single["sched"]
    if (sched.last_node_index, sched.last_index) != (ref.last_node_index,
                                                     ref.last_index):
        raise SystemExit(f"{name}: walk counters differ")
    rows, packed, lni = sharded.last
    srows, spacked, slni = one.last
    same_rows(f"{name} packed block", packed, spacked)
    same_rows(f"{name} lni", lni.reshape(1), slni.reshape(1))
    same_rows(f"{name} folded rows", cat_rows(rows), srows)
    same_rows(f"{name} resident matrix", cat_rows(sched._dev_nodes),
              ref._dev_nodes)
    ph = run["phases"]
    print(f"[path] mesh-uniform {name}: {n_nodes} nodes on {mesh.size} "
          f"shards ({len(mesh.distinct)} distinct devices), {N_PODS} pods "
          f"placed, "
          f"{N_PODS / run['t_burst']:.1f} pods/s burst "
          f"({run['t_burst'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"(node mirror {ph['mirror'] * 1e3:.2f}) dispatch "
          f"{ph['dispatch'] * 1e3:.2f} fetch {ph['fetch'] * 1e3:.2f}); "
          f"gather_bytes {ph['gather_bytes']} record copies "
          f"{ph['copies']} ({ph['copies'] / max(ph['passes'], 1):.2f} a "
          f"pass) passes {ph['passes']} host "
          f"reads of the pass counter {ph['syncs']}; {N_SERIAL} serial "
          f"cycles {run['t_serial'] * 1e3:.1f} ms (gather.cycle "
          f"{obs.get('gather.cycle')} bytes, {cycle_copies} cycle record "
          f"copies, {obs.get('htod.cycle')} pod uploads); launches "
          f"{counts}; single-device burst {single['t_burst'] * 1e3:.2f} "
          f"ms; decisions, packed block, lni, folded rows and matrix equal")
    if check_kernels:
        # copies a cycle of K9a's serial cycles: the pod's one staged
        # upload a card, and the records' copies (none under "peer")
        cycles = max(counts["shard_cycle_select"], 1)
        htod = obs.get("htod.cycle") / cycles
        mesh_kernel_checks({c.fn_name: c.call for c in caps}, report, sync)
        report["shard_cycle_local"].update(
            htod_a_call=htod, record_copies_a_call=cycle_copies / cycles)
    add_launches(report, counts)


# ---------------------------------------------------------------------------
# Node-axis sharding of the scans: K10a/b (the generic scan) and K11a/b
# (the fused window) on a mesh of four shards of the one card
# ---------------------------------------------------------------------------
def whole_window(r, d0):
    """A scan or segments result with its per-shard rows and spread
    slices gathered into whole vectors on `d0`."""
    import torch
    state, li, lni, spread, out = r
    if isinstance(state, list):
        state = cat_rows(state)
    if isinstance(spread, list):
        spread = torch.cat([x.to(d0) for x in spread])
    return (state, li.reshape(()), lni.reshape(()), spread, out)


#: the geometries K10b / K11b (and the sharded scan and fused window
#: around them) are held on (name, n_pad, n_real, node set, the largest
#: cluster the planner tries, the shard counts of one card, None:
#: MESH_SHARDS): the select's blocks own 1,024 slots each at one slot a
#: thread. The last three run on 4 shards and are held against the
#: single-device plain K5 / K6 only: two stage the records in global
#: memory; the very last takes the 20,000-slot plan again after smaller
#: ones were queried (a cached plan must still launch), with one scan and
#: one segments case ("again")
MESH_SCAN_GEOMETRIES = (
    ("4,096 slots: blocks 4-15 own no node", 4096, 3999, None, 16, None),
    ("4,096 slots on an 8-block cluster", 4096, 3999, None, 8, None),
    ("20,000 slots: two a thread, not a multiple of the span", 20000,
     19990, None, 16, None),
    ("4,096 slots: li, the winners and the ties in different blocks", 4096,
     4090, "ties", 16, None),
    ("32,768 slots on an 8-block cluster: the records in global memory",
     32768, 32700, None, 8, (4,)),
    ("50,000 slots: past what shared memory stages, the records in global "
     "memory", 50000, 49990, None, 16, (4,)),
    ("20,000 slots again, after smaller plans", 20000, 19990, "again", 16,
     (4,)),
    ("262,144 slots: 16 a thread, the records and the scratch in global "
     "memory", 262144, 262000, None, 16, (4,)),
    ("131,072 slots on an 8-block cluster: 16 a thread, the records and "
     "the scratch in global memory", 131072, 131000, None, 8, (4,)),
)


@contextlib.contextmanager
def cluster_blocks(n):
    """Plan every cluster launch at `n` blocks at most (the planner tries
    n, then n // 2)."""
    from kubernetes_tpu_torch.ops import kernels as K
    saved = K.CLUSTER_BLOCKS
    K.CLUSTER_BLOCKS = n
    try:
        yield
    finally:
        K.CLUSTER_BLOCKS = saved


def mesh_scan_variant_checks(device, sync, meshes=None):
    """K10a/b and K11a/b against their plain versions on random inputs,
    and the sharded scan / segments programs against the single-device
    plain K5 / K6, on one card split into 1, 2 and 4 shards, on every
    geometry of MESH_SCAN_GEOMETRIES (select blocks that own no node, an
    8-block cluster, a node axis that is not a multiple of the span, li,
    winners and ties in different blocks, the records staged in global
    memory on 8 and 16 blocks, a cached plan launched again after smaller
    plans set the kernels' attributes; the sharded plain versions run on
    the 4-shard mesh, every case of the first geometry and the first
    scan and segments case of the next three (with `meshes`: every mesh
    of the first geometry and the last mesh of the next three), the
    single-device plain K5 / K6 on all): identity, partial,
    perm and pos walks, the carried spread and carry_in, a weight table
    with per-pod profile ids, skip pods mid-window; for K11 also a gang
    whose placed members lie on every shard and in several select blocks
    when it fails (each shard rewinds on the same step), the gang score,
    a singleton failure and n_pods < B. n_real is a multiple of no shard
    count. Every comparison is exact: packed block, stats, folded rows,
    spread, li, lni. `meshes` (lists of devices) replaces the shards of
    one card. Prints each geometry's K10b / K11b launch geometry."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    checked = 0
    for gi, (label, n_pad, n_real, build, blocks, shards) in enumerate(
            MESH_SCAN_GEOMETRIES):
        rng = np.random.default_rng(20261021 + gi)
        K.last_geometry.clear()
        with cluster_blocks(blocks):
            checked += _mesh_scan_variants(
                device, rng, n_pad, n_real, build, blocks,
                meshes or [[device] * D for D in shards or MESH_SHARDS],
                ("all" if gi == 0 else "last" if shards is None else "none")
                if meshes else
                ("last" if gi == 0 else "first" if shards is None
                 else "none"),
                sync if K.select_plan(n_pad, 8, blocks).global_scratch
                else None)
        geo = "; ".join(
            f"{k}: {describe_geometry(*K.last_geometry[k], select=True)}"
            for k in SCAN_MESH_KERNELS[1:] + SEG_MESH_KERNELS[1:])
        print(f"[variants] mesh {label}: {geo}")
    sync()
    print(f"[variants] {checked} mesh scan comparisons equal over "
          f"{len(MESH_SCAN_GEOMETRIES)} geometries (K10a/b and K11a/b "
          f"against their plain versions and the sharded scan / segments "
          f"against the single-device plain K5 / K6: identity, partial, "
          f"perm and pos walks, spread carry + carry_in, weight table, "
          f"skip pods mid-window; the rack gang rewound across every shard "
          f"and several select blocks, gang score, a singleton failure, "
          f"n_pods < B; on meshes of "
          f"{[len(m) for m in meshes] if meshes else list(MESH_SHARDS)} "
          f"shards, the geometries past 20,000 slots on "
          f"{[len(m) for m in meshes] if meshes else [4]})")


def _mesh_scan_variants(device, rng, n_pad, n_real, build, blocks, meshes,
                        sharded, timed=None):
    """One geometry's mesh scan and segments cases (`blocks`: the cluster
    planned; `build` "again": the first case of each only) on the meshes
    `meshes`; returns the comparisons made. Every mesh's window is held
    against the single-device plain K5 / K6; against the sharded plain
    versions (a Python loop of steps, the slow part) on "all" meshes, the
    "last" one, the "first" scan and segments case on the last one, or
    "none". `timed` (sync): also print K10b's and K11b's
    device time a step on the last mesh's identity and axis windows."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    s_count, zones = 2, 6
    B, n_live = 64, 48
    span = K.select_plan(n_pad, 8, blocks).span
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"mesh scan variant {name} at n_pad {n_pad}: "
                             f"disagrees (max_abs_err {err}; first "
                             f"difference {first_diff(got, want)})")
        checked += 1

    if build == "ties":
        # full nodes but 6 in select block 0 and 10 in block 2, identical:
        # from li in block 1 the ties and the winners lie in other blocks
        nodes = _tie_nodes(rng, n_pad, n_real, s_count, device)
        li, li_seg = 1600, 1600
        rack = np.arange(0)
    else:
        nodes = _rand_nodes(rng, n_pad, n_real, s_count, zones, device)
        for k in ("req_cpu", "req_mem", "pod_count"):
            nodes[k] = nodes[k] // 3        # room for the window's pods
        li, li_seg = 37, 5
        # 20 rack nodes spread over every shard and several select blocks:
        # 8 CPU, empty, so each takes one member of the 5-CPU rack gang,
        # whose 21st member then fails
        rack = np.sort(rng.choice(n_real, 20, replace=False))
        rk = torch.as_tensor(rack).to(device)
        for k, v in (("alloc_cpu", 8000), ("alloc_mem", 32 * GI),
                     ("alloc_eph", 50 * GI), ("allowed_pods", 110),
                     ("alloc_scalar", 40), ("req_cpu", 0), ("req_mem", 0),
                     ("req_eph", 0), ("req_scalar", 0), ("pod_count", 0)):
            nodes[k][rk] = v
    perms = np.stack([np.arange(n_pad)] + [
        np.concatenate([rng.permutation(n_real), np.arange(n_real, n_pad)])
        for _ in range(3)]).astype(np.int32)
    inv = np.empty_like(perms)
    for i in range(len(perms)):
        inv[i, perms[i]] = np.arange(n_pad, dtype=np.int32)
    perms_t = torch.as_tensor(perms).to(device)
    inv_t = torch.as_tensor(inv).to(device)
    wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                           ).to(device)
    wtab[:, K.PRIORITY_AXIS.index("gang_locality")] = torch.tensor(
        [0, 3, 5], device=device)
    union = {k: int(wtab[:, i].max()) for i, k in enumerate(K.PRIORITY_AXIS)}
    # with ties, no dense count: the open nodes' scores stay tied
    specs = [_spec(500, False, rng, n_pad, s_count),
             _spec(1000, build != "ties", rng, n_pad, s_count),
             _spec(2000, False, rng, n_pad, s_count)]
    pad = dict(specs[0], skip=np.bool_(True))
    racked = dict(_spec(5000, False, rng, n_pad, s_count),
                  sel_ok=np.isin(np.arange(n_pad), rack))
    big = dict(specs[0], req_cpu=np.int64(9000), nz_cpu=np.int64(9000),
               upd_cpu=np.int64(9000))
    table = specs + [pad, racked, big]      # rows 0-2, pad 3, rack 4, big 5
    oid = rng.integers(0, 4, 128).astype(np.int32)
    prof = rng.integers(-1, 4, 128)
    spread0 = torch.as_tensor(rng.integers(0, 5, n_pad)).to(device)
    # the scan window: live pods of specs 0-2, skip pods mid-window and
    # padding to B
    rows = np.concatenate([rng.integers(0, 3, n_live), np.full(B - n_live, 3)])
    rows[[4, 5, 17]] = 3
    part = n_real * 9 // 40

    def stack(rws, spread=False, with_prof=False):
        sp = [dict(d) for d in table]
        if spread:
            for d in sp:
                d["spread_counts"] = np.zeros(1, np.int64)
        return K.PodStack.from_specs(sp, rws, prof[:len(rws)] if with_prof
                                     else None, device)
    scan_cases = [
        ("identity", {}, n_real),
        ("partial walk", {}, part),
        ("perm", dict(rotation=(perms_t, inv_t, oid[:B])), part * 7 // 9),
        ("pos", dict(rotation_pos=(inv_t, oid[:B])), n_real),
        ("spread", dict(spread0=spread0), part),
        ("weight table", dict(weights=union, wtab=wtab), n_real),
    ]
    # the segments window: a singleton run, the rack gang (20 placed on
    # every shard, the 21st fails: rewind), a gang that fits, a singleton
    # run, a failing 9-CPU singleton, padding
    Bs = 128
    layout = [(0, 12, False), (4, 21, True), (1, 16, True), (2, 10, False),
              (5, 1, False), (0, 8, False)]
    seg = np.zeros(Bs, bool)
    gang = np.zeros(Bs, bool)
    srows = np.full(Bs, 3)
    i = 0
    for spec, length, g in layout:
        seg[i] = True
        gang[i: i + length] = g
        srows[i: i + length] = spec
        i += length
    seg[i] = True
    n_seg = i
    seg_t = torch.as_tensor(seg).to(device)
    gang_t = torch.as_tensor(gang).to(device)
    seg_cases = [
        ("axis", {}, part, n_seg),
        ("perm", dict(rotation=(perms_t, inv_t, oid)), part * 7 // 9, n_seg),
        ("pos", dict(rotation_pos=(inv_t, oid)), n_real, n_seg),
        ("gang score + weight table",
         dict(weights=union, wtab=wtab, gang_score=True), n_real, n_seg),
        ("spread carry", dict(spread0=spread0), part, n_seg),
        ("n_pods < B, stops mid-gang", {}, part, 25),
    ]
    if build == "again":
        scan_cases, seg_cases = scan_cases[:1], seg_cases[:1]
    # the single-device plain K5 / K6 of every case, once
    want_scan, want_seg = {}, {}
    for name, kw, ntf in scan_cases:
        st = stack(rows, spread=name == "spread",
                   with_prof=name == "weight table")
        w1 = K.schedule_batch_plain(nodes, st, li, 11, ntf, n_real, 8, **kw)
        w2 = None
        if name == "spread":
            w2 = K.schedule_batch_plain(nodes, st, w1[1], w1[2], ntf,
                                        n_real, 8, carry_in=(w1[0], w1[3]))
        want_scan[name] = (st, w1, w2)
    for name, kw, ntf, np_ in seg_cases:
        st = stack(srows, with_prof="wtab" in kw)
        want = K.schedule_batch_segments_plain(
            nodes, st, seg_t, gang_t, np_, li_seg, 9, ntf, n_real, 8, **kw)
        sel = want[4][:Bs].cpu().numpy()
        if np_ == n_seg and build != "ties":
            g = sel[12: 33]
            if not ((g >= 0).sum() == 20 and g[20] < 0
                    and len({int(j) // span for j in g[:20]}) > 1):
                raise SystemExit(f"mesh scan variant segments/{name}: the "
                                 f"rack gang did not place 20 across "
                                 f"select blocks and fail")
        want_seg[name] = (st, want)
    if build == "ties":
        sel = want_scan["identity"][1][4]["selected"].cpu().numpy()
        blocks = {int(j) // span for j in sel if j >= 0}
        if li // span in blocks or blocks != {3 // span, 2050 // span}:
            raise SystemExit(f"mesh scan variant ties: the winners' select "
                             f"blocks {blocks}")
    mesh_list = meshes
    for mi, devs in enumerate(mesh_list):
        mesh = S.Mesh(devs)
        D = mesh.size
        d0 = mesh.devices[0]
        shards = S.shard_node_arrays(mesh, nodes)
        sharded_plain = sharded == "all" or (
            sharded in ("last", "first") and mi == len(mesh_list) - 1)
        for si, (name, kw, ntf) in enumerate(scan_cases):
            st, w1, w2 = want_scan[name]
            args = (st, li, 11, ntf, n_real, 8)
            got = K.schedule_batch(shards, *args, mesh=mesh, **kw)
            if sharded_plain and (sharded != "first" or si == 0):
                with plain_versions(MESH_ENTRIES):
                    ref = K.schedule_batch(shards, *args, mesh=mesh, **kw)
                same(f"{D} shards/scan/{name} vs plain",
                     whole_window(got, d0), whole_window(ref, d0))
            same(f"{D} shards/scan/{name} vs K5 plain",
                 whole_window(got, d0), whole_window(w1, d0))
            if w2 is not None:
                args2 = (st, got[1], got[2], ntf, n_real, 8)
                got2 = K.schedule_batch(shards, *args2, mesh=mesh,
                                        carry_in=(got[0], got[3]))
                same(f"{D} shards/scan/carry_in vs K5 plain",
                     whole_window(got2, d0), whole_window(w2, d0))
        for si, (name, kw, ntf, np_) in enumerate(seg_cases):
            st, want = want_seg[name]
            args = (st, seg_t, gang_t, np_, li_seg, 9, ntf, n_real, 8)
            got = K.schedule_batch_segments(shards, *args, mesh=mesh, **kw)
            if sharded_plain and (sharded != "first" or si == 0):
                with plain_versions(MESH_ENTRIES):
                    ref = K.schedule_batch_segments(shards, *args, mesh=mesh,
                                                    **kw)
                same(f"{D} shards/segments/{name} vs plain",
                     whole_window(got, d0), whole_window(ref, d0))
            same(f"{D} shards/segments/{name} vs K6 plain",
                 whole_window(got, d0), whole_window(want, d0))
        if timed is not None and mi == len(mesh_list) - 1:
            st = want_scan["identity"][0]
            k10b, n10 = device_time(lambda: K.schedule_batch(
                shards, st, li, 11, n_real, n_real, 8, mesh=mesh), timed, 3,
                "shard_scan_select")
            st, _want = want_seg["axis"]
            k11b, n11 = device_time(lambda: K.schedule_batch_segments(
                shards, st, seg_t, gang_t, n_seg, li_seg, 9, part, n_real, 8,
                mesh=mesh), timed, 3, "shard_segments_select")
            print(f"[variants] mesh at n_pad {n_pad} on {D} shards: K10b "
                  f"device {k10b:.4f} ms a step ({n10} steps), K11b device "
                  f"{k11b:.4f} ms a step ({n11} steps)")
    return checked


#: the step states the grouped locals K10a / K11a are held in (name, K11,
#: {step-state slot: value}); "first" / "last" stand for the last shard's
#: first row and the first shard's last row; a fold names a row of the
#: three specs' table. Pod 5 is a skip pod; the
#: segments run (3 singletons, gangs of 6 and 5, 4 singletons) starts
#: segments at pods 0, 3, 9 and 14.
LOCAL_STATES = (
    ("a fold on a shard's first row", False,
     {"SS_NEXT": 2, "SS_FOLD_SEL": "first", "SS_FOLD_ROW": 1}),
    ("a fold on a shard's last row", False,
     {"SS_NEXT": 7, "SS_FOLD_SEL": "last", "SS_FOLD_ROW": 0}),
    ("a skip pod after a fold", False,
     {"SS_NEXT": 5, "SS_FOLD_SEL": "last", "SS_FOLD_ROW": 2}),
    ("the fold past the window", False,
     {"SS_NEXT": 32, "SS_FOLD_SEL": "first", "SS_FOLD_ROW": 0}),
    ("a checkpoint at a segment start after a fold", True,
     {"SS_NEXT": 3, "SS_FOLD_SEL": "first", "SS_FOLD_ROW": 2}),
    ("a gang rewound across every shard", True,
     {"SS_NEXT": 6, "SS_REWIND": 1, "SS_FAILED": 1}),
    ("a rewind onto a segment start", True,
     {"SS_NEXT": 9, "SS_REWIND": 1, "SS_FAILED": 1}),
    ("a member behind its gang's failure", True,
     {"SS_NEXT": 11, "SS_FAILED": 1, "SS_FOLD_SEL": "last",
      "SS_FOLD_ROW": 0}),
    ("a gang member with a fold", True,
     {"SS_NEXT": 12, "SS_FOLD_SEL": "last", "SS_FOLD_ROW": 1}),
)


def mesh_local_checks(device, sync, meshes=None):
    """K10a and K11a, one launch over every shard of a device with each
    record written into the device's gathered buffer, against their plain
    versions on random inputs at the main path's n_pad (16,384; n_real
    15,001, a multiple of no shard count), on 8, 4, 2 and 1 shards of the
    card (8: two launches of LOCAL_GROUP_SHARDS shards a call; `meshes`:
    lists of devices instead), in every state of
    LOCAL_STATES, the carried spread on: the gathered buffer, every
    shard's live rows, spread slice and checkpoint must be equal."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    rng = np.random.default_rng(20261017)
    n_pad, n_real, s_count, B = 16384, 15001, 2, 32
    nodes = _rand_nodes(rng, n_pad, n_real, s_count, 6, device)
    specs = [_spec(500, True, rng, n_pad, s_count),
             _spec(1000, False, rng, n_pad, s_count)]
    specs.append(dict(specs[1], skip=np.bool_(True)))
    rows = rng.integers(0, 2, B)
    rows[[5] + list(range(18, B))] = 2
    stack = K.PodStack.from_specs(specs, rows, None, device)
    seg = np.zeros(B, bool)
    seg[[0, 3, 9, 14, 18]] = True
    gang = np.zeros(B, bool)
    gang[3:14] = True
    seg_t, gang_t = (torch.as_tensor(x).to(device) for x in (seg, gang))
    spread0 = torch.as_tensor(rng.integers(0, 5, n_pad)).to(device)
    checked = 0
    for devs in meshes or [[device] * d for d in (8, 4, 2, 1)]:
        mesh = S.Mesh(devs)
        shards = S.shard_node_arrays(mesh, nodes)
        for segments in (False, True):
            kw = dict(n_steps=18, segments=(seg_t, gang_t)) if segments \
                else {}
            scan, sides, plan, _steps = S._scan_window(
                mesh, shards, stack, 3, 5, n_real, n_real, 8,
                K.DEFAULT_WEIGHTS, None, None, spread0, None, None, **kw)
            for sh in scan:
                for v in (sh.chk or {}).values():
                    v += 1      # a restore shows
            name = "shard_segments_local" if segments \
                else "shard_scan_local"
            for label, seg_state, state in LOCAL_STATES:
                if seg_state != segments:
                    continue
                runs = []
                for fn in (getattr(K, name), getattr(K, name + "_plain")):
                    sc, sd = _clone(scan), _clone(sides)
                    where = {"first": (mesh.size - 1) * plan.rows,
                             "last": plan.rows - 1}
                    for side in sd.values():
                        for slot, v in state.items():
                            side.st[getattr(K, slot)] = where.get(v, v)
                    for d, group in S.device_groups(mesh, sc):
                        fn(group, sd[d], plan)
                    runs.append([local_outputs((g, sd[d], plan), None)
                                 for d, g in S.device_groups(mesh, sc)])
                err = max_abs_err(*runs)
                if err != 0:
                    raise SystemExit(
                        f"{name} on {mesh.size} shards, {label}: kernel "
                        f"disagrees with plain (max_abs_err {err}; first "
                        f"difference {first_diff(*runs)})")
                checked += 1
    sync()
    print(f"[variants] grouped locals: {checked} comparisons equal (K10a / "
          f"K11a, one launch over every shard of a device, against their "
          f"plain versions on "
          f"{[len(m) for m in meshes] if meshes else [8, 4, 2, 1]} shards, "
          f"n_pad 16,384, n_real 15,001: "
          f"{'; '.join(lbl for lbl, _s, _st in LOCAL_STATES)})")


def scan_local_bytes(shards, side, plan):
    """Bytes one grouped local launch moves over every shard of its
    device: each shard's node fields and the pod's row of each dense table
    read, its record written into the gathered buffer; K11a also writes
    each checkpoint at a segment start, and on a rewind reads it and
    writes the live rows back (the live rows' reads are the node fields
    already counted)."""
    from kubernetes_tpu_torch.ops import kernels as K
    t = int(side.st[K.SS_NEXT])
    total = 0
    for sh in shards:
        tab = sum(v[0].numel() * v.element_size() for v in sh.tab.values()
                  if v.dim() == 2 and v.shape[1] == sh.rows)
        total += nbytes(sh.nodes) + tab + plan.record_bytes + (
            nbytes(sh.spread) if plan.carry_spread else 0)
        if sh.chk is not None:
            if int(side.st[K.SS_REWIND]):
                total += 2 * nbytes(sh.chk)
            if t < plan.n_steps and bool(side.seg_start[t]):
                total += nbytes(sh.chk)
    return total


def local_outputs(a, _result):
    """What a grouped local launch writes (`a` its arguments: the
    device's shards, its replicated half, the plan): the device's gathered
    buffer, and each shard's live rows, spread slice and checkpoint."""
    from kubernetes_tpu_torch.ops import kernels as K
    shards, side = a[0], a[1]
    out = {"gathered": side.gathered}
    for sh in shards:
        out.update({f"{sh.index}/{k}": sh.nodes[k] for k in K._MUTABLE})
        if sh.spread is not None:
            out[f"{sh.index}/spread"] = sh.spread
        for k, v in (sh.chk or {}).items():
            out[f"{sh.index}/chk/{k}"] = v
    return out


def scan_select_bytes(side, plan):
    """Bytes one select step moves: the gathered records, the step's
    rotation row(s), the gang zone counts when the gang score is on, the
    step state read and written, and the step's packed (and, K10b,
    stats) column."""
    from kubernetes_tpu_torch.ops import kernels as K
    walk = plan.n_pad * 4 * (2 if plan.mode == 1 else 1) if plan.mode else 0
    gz = 2 * nbytes(side.gz) if plan.gang_score else 0
    col = side.packed.numel() // plan.B * side.packed.element_size()
    if side.stats is not None:
        col += side.stats.shape[0] * side.stats.element_size()
    return nbytes(side.gathered) + walk + gz + 2 * nbytes(side.st) + col


def scan_kernel_checks(calls, report, sync, seg):
    """K10a/b (or K11a/b), each on its first call of the mesh path: the
    local on every shard of the first device, in one launch."""
    from kubernetes_tpu_torch.ops import kernels as K
    local, select = SEG_MESH_KERNELS if seg else SCAN_MESH_KERNELS

    def no_reset(a, base):
        pass

    def reset_side(a, base):
        # the select advances the step state (and gz): restore it (a
        # device copy of ~100 B) before each timed call
        a[0].st.copy_(base[0].st)
        if a[0].gz is not None:
            a[0].gz.copy_(base[0].gz)

    args, _kw = _full(calls[local])
    n = len(args[0])
    mesh_kernel_entry(report, local, calls[local], no_reset, local_outputs,
                      scan_local_bytes(*args), sync, 50,
                      f"the window's first step, one launch over the "
                      f"{n} shard(s) of the first device (bound and "
                      f"device_ms for them together)", on_device=True)
    report[local]["shards"] = n
    args, _kw = _full(calls[select])
    mesh_kernel_entry(report, select, calls[select], reset_side,
                      lambda a, r: (a[0].st, a[0].packed,
                                    a[0].stats if a[0].stats is not None
                                    else a[0].gz),
                      scan_select_bytes(*args), sync, 50,
                      "the gathered records of the window's first step",
                      "; kernel_ms and plain_ms include the copy that "
                      "restores the step state before each call; "
                      f"{describe_geometry(*K.last_geometry[select], True)}",
                      on_device=True)


def mesh_step_line(name, mesh, ph, counts, kernels, dispatch=None, runs=1):
    """The `[mesh-step]` line of a mesh scan or fused window or pressure
    wave (`dispatch`: its seconds, when its phases book none; `runs`: the
    step loops it took, a wave's chunks): the mesh's exchange, its host
    calls a step (local launches, selects and record copies enqueued,
    over the steps), the copies and the local kernel's launches. The
    launches are those the kernels' C launch functions counted as they
    launched, the copies those `gather_in_place` enqueued. Fails unless
    the local ran once a device (per LOCAL_GROUP_SHARDS of its shards)
    and step, plus the last fold of each run, the select once a device
    and step, and the record copies were none under the "peer" exchange
    (the locals write every card's records and stamps themselves) and
    only those of other devices' records under "copy"."""
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    local, select = kernels
    steps, copies = ph["steps"], ph["copies"]
    n_dev = len(mesh.distinct)
    groups = sum(-(-sum(d == x for x in mesh.devices) //
                   K.LOCAL_GROUP_SHARDS) for d in mesh.distinct)
    foreign = 0 if mesh.exchange == "peer" \
        else steps * len(S.gather_plan(mesh.devices, in_place=True))
    want = (groups * (steps + runs), n_dev * steps, foreign)
    got = (counts[local], counts[select], copies)
    if got != want:
        raise SystemExit(f"{name}: {got} launches of {local}, of {select} "
                         f"and record copies for {steps} steps on {n_dev} "
                         f"devices under the {mesh.exchange} exchange, not "
                         f"{want}")
    calls = counts[local] + counts[select] + copies
    dispatch = ph["dispatch"] if dispatch is None else dispatch
    print(f"[mesh-step] {name}: exchange {mesh.exchange}; {steps} steps on "
          f"{mesh.size} shards ({n_dev} distinct devices); host calls a "
          f"step {calls / steps:.4f} ({counts[local]} launches of {local}, "
          f"{counts[select]} of {select}, {copies} record copies "
          f"enqueued); record copies {copies}; gather_bytes "
          f"{ph['gather_bytes']}; dispatch "
          f"{dispatch * 1e3 / steps:.4f} ms a step")


def mesh_scan_path(cfg, n_nodes, window_fn, device, sync, report, ref,
                   check_kernels, mesh=None):
    """A scan cell through TorchScheduler(mesh=Mesh([device] * MESH_D)),
    launches counted, held against the single-device K5 run of the same
    world (`ref`, which scan_paths holds against the plain path): every
    decision, the serial tail, the walk counters, the packed block, the
    stats, li, lni and the folded rows."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    name = "mesh-" + cfg["name"]
    single, single_out = ref
    caps = [capture(k) for k in SCAN_MESH_KERNELS] if check_kernels else []
    if check_kernels and cfg["serial"]:
        caps.append(capture("shard_cycle_local"))   # the serial tail's K9a
    obs.reset()
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        with capture("schedule_batch") as sharded:
            run = run_scan(cfg, n_nodes, window_fn(N_PODS), cfg["serial"],
                           device, sync, mesh=mesh)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    need = SCAN_MESH_KERNELS + (("shard_cycle_local", "shard_cycle_select",
                                 "scatter_rows") if cfg["serial"] else ())
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    cycle_mesh_check(name, mesh, counts)
    if run["hosts"] != single["hosts"] or run["serial"] != single["serial"] \
            or run["counters"] != single["counters"]:
        raise SystemExit(f"{name}: decisions or walk counters differ from "
                         f"the single-device path")
    same_rows(f"{name} folded rows", run["rows"], single["rows"])
    d0 = mesh.devices[0]
    got, want = whole_window(sharded.last, d0), whole_window(single_out, d0)
    same_rows(f"{name} packed block, stats, li, lni",
              (got[1], got[2], got[4]), (want[1], want[2], want[4]))
    ph = run["phases"]
    mesh_step_line(name, mesh, ph, counts, SCAN_MESH_KERNELS)
    print(f"[path] {name}: {n_nodes} nodes on {mesh.size} shards "
          f"({len(mesh.distinct)} distinct devices), {N_PODS} pods, "
          f"{N_PODS / run['t_burst']:.1f} pods/s "
          f"({run['t_burst'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"(node mirror {ph['mirror'] * 1e3:.2f}) dispatch "
          f"{ph['dispatch'] * 1e3:.2f} fetch {ph['fetch'] * 1e3:.2f}); "
          f"steps {ph['steps']} gather_bytes {ph['gather_bytes']}; "
          f"{cfg['serial']} serial cycles {run['t_serial'] * 1e3:.1f} ms; "
          f"launches {counts}; single-device window "
          f"{single['t_burst'] * 1e3:.2f} ms; decisions, serial cycles, "
          f"counters, packed block, stats, li, lni and folded rows equal")
    if check_kernels:
        calls = {c.fn_name: c.call for c in caps}
        scan_kernel_checks(calls, report, sync, False)
        if "shard_cycle_local" in calls:
            k9a_device_entry(calls["shard_cycle_local"], report, sync,
                             f"{name}'s first serial cycle")
    add_launches(report, counts)


def cycle_local_outputs(a, r):
    """What K9a and its plain version must agree on, for call `a` =
    (shards, side, call) and result `r`: the launch's shards' rows of the
    three per-row outputs, and their records in the call's half."""
    import torch
    shards, side, call = a
    spans = [(sh.offset, sh.offset + sh.rows) for sh in shards]
    return ([torch.cat([o[lo: hi] for lo, hi in spans]) for o in r],
            torch.stack([side.records(call)[sh.index][: call.record_bytes]
                         for sh in shards]))


def cycle_local_bytes(shards, side, call):
    """The bytes one K9a launch must move: its shards' node rows and the
    pod's dense per-node fields of those rows read once, the three
    per-row outputs and the records written once."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    rows = sum(sh.rows for sh in shards)
    dense = sum(K._POD_FIELD_BYTES[k] for k in K.POD_NODE_FIELDS
                if call.pod.get(k) is not None
                and np.shape(call.pod[k])[-1:] == (call.n_pad,))
    return (nbytes([{k: sh.nodes[k] for k in K._SCL_NODES} for sh in shards])
            + rows * (dense + 1 + 1 + 8)
            + len(shards) * call.record_bytes)


def k9a_device_entry(call, report, sync, label):
    """K9a on one captured call of a mesh scan path's serial tail (its
    launch over the first device's shards): held against its plain
    version, then its wrapper time (CUDA events) and its device time a
    launch (torch.profiler), filed as `device_ms_scan_default` beside the
    mesh-uniform call's `device_ms`."""
    from kubernetes_tpu_torch.ops import kernels as K
    args, kw = _full(call)
    a_k, a_p = _clone(args), _clone(args)
    got = cycle_local_outputs(a_k, K.shard_cycle_local(*a_k, **kw))
    want = cycle_local_outputs(a_p, K.shard_cycle_group_plain(*a_p, **kw))
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"shard_cycle_local on {label}: kernel disagrees "
                         f"with plain ({first_diff(got, want)})")
    a = _clone(args)

    def one():
        K.shard_cycle_local(*a, **kw)
    ms = cuda_time(one, sync, 50)
    dev_ms, seen = device_time(one, sync, 50, "shard_cycle_local_kernel")
    report["shard_cycle_local"]["device_ms_scan_default"] = dev_ms
    print(f"[kernel] shard_cycle_local on {label}: equal to plain "
          f"(max_abs_err 0), kernel_ms {ms:.4f} device_ms {fmt_ms(dev_ms)} "
          f"over {seen} launches (torch.profiler)")


def mesh_fused_path(device, sync, report, ref, check_kernels, mesh=None):
    """The fused-gang cell through TorchScheduler(mesh=...), held against
    the single-device K6 run of the same window: every segment record,
    the consumed enumerations, the walk counters, the packed block, li,
    lni and the folded rows; the rack gang rewinds on every shard."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    name = "mesh-fused"
    single, single_out = ref
    segs = fused_window()
    n_pods = sum(len(s) for s, _g in segs)
    caps = [capture(k) for k in SEG_MESH_KERNELS] if check_kernels else []
    obs.reset()
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        with capture("schedule_batch_segments") as sharded:
            run = run_fused(FUSED_CELL, N_NODES, segs, device, sync,
                            mesh=mesh)
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    missing = [k for k in SEG_MESH_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    if _records(run["res"]) != _records(single["res"]) \
            or run["counters"] != single["counters"] \
            or run["res"]["consumed"] != single["res"]["consumed"]:
        raise SystemExit(f"{name}: the window differs from the "
                         f"single-device path")
    same_rows(f"{name} folded rows", run["rows"], single["rows"])
    d0 = mesh.devices[0]
    got, want = whole_window(sharded.last, d0), whole_window(single_out, d0)
    same_rows(f"{name} packed block, li, lni", (got[1], got[2], got[4]),
              (want[1], want[2], want[4]))
    ph = run["phases"]
    mesh_step_line(name, mesh, ph, counts, SEG_MESH_KERNELS)
    print(f"[path] {name}: {N_NODES} nodes on {mesh.size} shards "
          f"({len(mesh.distinct)} distinct devices), {n_pods} pods in "
          f"{len(segs)} segments, {n_pods / run['t_burst']:.1f} pods/s "
          f"({run['t_burst'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"(node mirror {ph['mirror'] * 1e3:.2f}) dispatch "
          f"{ph['dispatch'] * 1e3:.2f} fetch {ph['fetch'] * 1e3:.2f}); "
          f"steps {ph['steps']} gather_bytes {ph['gather_bytes']}; "
          f"launches {counts}; single-device window "
          f"{single['t_burst'] * 1e3:.2f} ms; segment records, consumed "
          f"enumerations, counters, packed block, li, lni and folded rows "
          f"equal (the rack gang rewound on every shard)")
    if check_kernels:
        scan_kernel_checks({c.fn_name: c.call for c in caps}, report, sync,
                           True)
    add_launches(report, counts)


def mesh_scan_paths(device, sync, report, refs, mesh=None, cells=None):
    """The scan and fused cells over the mesh, each held against its
    single-device run in `refs` ({cell: (run, kernel result)}); K10a/b are
    timed on mesh-scan-default (15,000 nodes), K11a/b on mesh-fused.
    `cells` (names) restricts the scan cells run."""
    for cfg, n_nodes, window_fn in scan_cells():
        if cells is not None and cfg["name"] not in cells:
            continue
        mesh_scan_path(cfg, n_nodes, window_fn, device, sync, report,
                       refs[cfg["name"]], cfg["name"] == "scan-default",
                       mesh=mesh)
    mesh_fused_path(device, sync, report, refs[FUSED_CELL["name"]], True,
                    mesh=mesh)


# ---------------------------------------------------------------------------
# Device preemption: K7 preempt_scan, K8 pressure_batch
# ---------------------------------------------------------------------------
# integer operations per slot step of the victim scan, a floor: pass 1
# (mask compare, three adds, count) 5; pass 2 (three adds, count, the fit's
# four compares and three adds, keep, three selects, the aggregates) 15
OPS_PER_SLOT = 20
# the preempt worlds: 10 victims of 400m per node (9 on every 50th node),
# priorities 1-5 by slot and node, a quarter of them PDB-guarded
VICTIMS_PER_NODE, VICTIM_CPU = 10, 400
N_SINGLE = 12                    # preempt-single rounds


def preempt_world(n_nodes):
    """bench.py's cluster with VICTIMS_PER_NODE lower-priority pods on every
    node (one fewer on every 50th node: 400m free there), priorities 1-5
    cycling by slot and node, distinct start times, a PDB with no
    disruptions left over `app=guarded` (every fourth victim), and the
    label pool=preempt on zones 0 and 1."""
    from kubernetes_tpu_torch.api.types import (
        Pod, Container, LabelSelector, PodDisruptionBudget)
    infos, tree = cluster(n_nodes, lambda i: {"pool": "preempt"}
                          if i % 3 != 2 else {})
    uid = 0
    for i in range(n_nodes):
        name = f"node-{i}"
        k = VICTIMS_PER_NODE - (1 if i % 50 == 0 else 0)
        for s in range(k):
            uid += 1
            infos[name].add_pod(Pod(
                name=f"victim-{uid}", node_name=name,
                priority=1 + (s + i) % 5, start_time=float(uid),
                labels={"app": "guarded" if uid % 4 == 0 else "batch"},
                containers=(Container.make(
                    name="c", requests={"cpu": VICTIM_CPU}),)))
    pdbs = [PodDisruptionBudget(
        name="guard", disruptions_allowed=0,
        selector=LabelSelector(match_labels=(("app", "guarded"),)))]
    return infos, tree, pdbs


def wave_pods():
    """The preempt-wave queue, priorities non-increasing: 512 pods at 100
    (400m), 384 at 50 (800m), 128 at 1 (400m)."""
    return (pods(512, prefix="urgent", cpu=400, priority=100)
            + pods(384, prefix="mid", cpu=800, priority=50)
            + pods(128, prefix="low", cpu=400, priority=1))


def outcome_names(out):
    return [(o[0], o[1], [v.name for v in o[2]]) if o[0] == "nominated"
            else o for o in out]


def victim_bound(nodes, vic, n_real, extra_bytes, extra_ops):
    """(bound_ms, bound_by) of a victim scan: node rows and the seven
    victim planes read once plus `extra_bytes`, against OPS_PER_SLOT per
    slot step of every real node plus `extra_ops`."""
    P = int(vic["prio"].shape[1])
    nbytes = sum(v.numel() * v.element_size() for v in vic.values())
    nbytes += 8 * 8 * nodes["valid"].shape[0] + extra_bytes
    ops = n_real * P * OPS_PER_SLOT + extra_ops
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _rand_victims(rng, n_pad, P, device, fill=0.6):
    """Random victim planes in the host table's slot order per node
    (PDB-violating first, then priority descending, start ascending; empty
    slots last), some starts +inf."""
    import numpy as np
    import torch
    valid = rng.random((n_pad, P)) < fill
    prio = np.where(valid, rng.integers(0, 8, (n_pad, P)), 0)
    start = np.where(valid & (rng.random((n_pad, P)) < 0.8),
                     rng.integers(1, 500, (n_pad, P)).astype(float), np.inf)
    viol = valid & (rng.random((n_pad, P)) < 0.25)
    cpu = np.where(valid, rng.choice([100, 200, 400, 800], (n_pad, P)), 0)
    mem = np.where(valid, rng.integers(0, 4, (n_pad, P)) * GI // 4, 0)
    eph = np.where(valid, rng.integers(0, 2, (n_pad, P)) * GI, 0)
    order = np.lexsort((start, -prio, ~viol, ~valid), axis=1)
    take = lambda a: np.take_along_axis(a, order, axis=1)
    host = {"cpu": take(cpu).astype(np.int64),
            "mem": take(mem).astype(np.int64),
            "eph": take(eph).astype(np.int64),
            "prio": take(prio).astype(np.int64), "start": take(start),
            "valid": take(valid), "violating": take(viol)}
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def _victim_nodes(rng, vic, n_pad, n_real, device):
    """Node rows around the victim planes: the victims' load plus some,
    so that nodes fit 0 to several more pods after evictions."""
    import numpy as np
    import torch
    h = {k: v.cpu().numpy() for k, v in vic.items()}
    alloc_cpu = rng.choice([2000, 4000, 8000], n_pad).astype(np.int64)
    used = (h["cpu"] * h["valid"]).sum(1)
    host = {
        "valid": np.arange(n_pad) < n_real,
        "alloc_cpu": np.maximum(alloc_cpu, used),
        "alloc_mem": np.full(n_pad, 32 * GI, np.int64),
        "alloc_eph": np.full(n_pad, 50 * GI, np.int64),
        "allowed_pods": rng.choice([8, 110, 128], n_pad).astype(np.int64),
        "req_cpu": used + rng.integers(0, 800, n_pad),
        "req_mem": (h["mem"] * h["valid"]).sum(1) + rng.integers(
            0, 8, n_pad) * GI,
        "req_eph": (h["eph"] * h["valid"]).sum(1),
        "nz_cpu": used, "nz_mem": rng.integers(0, 8, n_pad) * GI,
        "pod_count": h["valid"].sum(1).astype(np.int64),
        "alloc_scalar": np.zeros((n_pad, 1), np.int64),
        "req_scalar": np.zeros((n_pad, 1), np.int64),
        "zone_id": rng.integers(0, 4, n_pad).astype(np.int32)}
    return {k: torch.as_tensor(v).to(device) for k, v in host.items()}


def k7_cases(rng, nodes, vic, pod, feas, rank, n_real):
    """K7's random-input cases over one world: (name, argument tuple) for
    the default, check_resources and has_request false, no candidate, a
    zero-victim win, ties to order_rank (every node a copy of the default
    winner's row and slots: the pick ties through all five criteria),
    duplicate ranks (with and without those ties: the lowest row among
    the candidates of the lowest rank, spread over the grid's blocks), a
    ragged n_real and no lower priority."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    n_pad = int(feas.shape[0])
    default = (nodes, vic, pod, feas, rank, n_real, True, True, 6)
    w = max(int(K.preemption_scan_plain(*default)[0]), 0)
    tie_vic = {k: v[w:w + 1].expand_as(v).contiguous()
               for k, v in vic.items()}
    tie_nodes = {k: (v[w:w + 1].expand_as(v).contiguous()
                     if k != "valid" else v) for k, v in nodes.items()}
    roomy = {**nodes, "req_cpu": nodes["req_cpu"] // 4}
    dup = torch.as_tensor(rng.integers(0, max(n_pad // 512, 2), n_pad)
                          ).to(feas.device)
    ragged = n_real - 1 - int(rng.integers(1, 97))
    return [
        ("default", default),
        ("check_resources false", (nodes, vic, pod, feas, rank, n_real,
                                   False, False, 6)),
        ("has_request false", (nodes, vic, pod, feas, rank, n_real, True,
                               False, 6)),
        ("no candidate", (nodes, vic, pod, torch.zeros_like(feas), rank,
                          n_real, True, True, 6)),
        ("zero-victim win", (roomy, vic, pod, feas, rank, n_real, True,
                             True, 6)),
        ("ties to order_rank", (tie_nodes, tie_vic, pod, feas, rank, n_real,
                                True, True, 6)),
        ("duplicate ranks", (nodes, vic, pod, feas, dup, n_real, True, True,
                             6)),
        ("ties to duplicate ranks", (tie_nodes, tie_vic, pod, feas, dup,
                                     n_real, True, True, 6)),
        (f"ragged n_real {ragged}", (nodes, vic, pod, feas, rank, ragged,
                                     True, True, 6)),
        ("no lower priority", (nodes, vic, pod, feas, rank, n_real, True,
                               True, 0)),
    ]


def describe_grid(grid):
    """K7's launch geometry as the [kernel] and [variants] lines print
    it."""
    from kubernetes_tpu_torch.ops import kernels as K
    return (f"{grid.blocks} blocks x {K.PREEMPT_THREADS} threads (a thread "
            f"a node, 32 nodes a warp; the card holds {grid.fit}: "
            f"{grid.sms} SMs x {grid.per_sm})")


#: K7's further sizes (n_pad, n_real, victim slots, the cases of
#: `k7_cases` it runs, None: every one): 24 slots (a chunk of 16 and one
#: of 8: the kernel's general slot loops), and the largest node axis
K7_MORE = ((4096, 4000, 24, None),
           (262144, 262000, 16, ("default", "no candidate",
                                 "zero-victim win",
                                 "ties to duplicate ranks")),
           (262144, 262000, 128, ("default", "no candidate",
                                  "zero-victim win",
                                  "ties to duplicate ranks")))


def preempt_variant_checks(device, sync, n_pad=16384, n_real=16000):
    """K7 and K8 against their plain versions on random inputs at n_pad
    16,384 with P 16 and 128: K7 in every case of `k7_cases`, at P 24
    and at 262,144 slots (`K7_MORE`); K8 with ghosts on and off,
    check_resources / has_request false, skip padding and an
    init-container request (the filter's request above the fold's); K4
    on the seven victim planes; K2/K5/K6 ran above with no ghost. Prints
    K7's grid and its device time a call at each size."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261019)
    checked = 0
    k7_ms = {}

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"variant {name}: kernel disagrees with plain "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    def k7_world(n_pad, n_real, P):
        vic = _rand_victims(rng, n_pad, P, device)
        nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
        feas = torch.as_tensor(rng.random(n_pad) < 0.9).to(device)
        rank = torch.as_tensor(rng.permutation(n_pad)).to(device)
        pod = {"req_cpu": np.int64(1500), "req_mem": np.int64(2 * GI),
               "req_eph": np.int64(GI)}
        return vic, nodes, feas, rank, pod

    def k7_all(n_pad, n_real, P, vic, nodes, feas, rank, pod, only=None):
        cases = k7_cases(rng, nodes, vic, pod, feas, rank, n_real)
        for name, args in cases:
            if only is None or name in only:
                same(f"preempt_scan/n_pad {n_pad}/P{P}/{name}",
                     K.preemption_scan(*args), K.preemption_scan_plain(*args))
        args = cases[0][1]
        dev_ms, _n = device_ms_a_call(lambda: K.preemption_scan(*args), sync,
                                      10, ("preempt_scan_kernel",))
        k7_ms[f"n_pad {n_pad} P {P}"] = (dev_ms, K.last_geometry[
            "preempt_scan"][0])

    for P in (16, 128):
        vic, nodes, feas, rank, pod = k7_world(n_pad, n_real, P)
        k7_all(n_pad, n_real, P, vic, nodes, feas, rank, pod)
        # K8: a chunk of 32 pods over the same planes, on a cluster with
        # room on six nodes only: pods bind, then preempt, then fail
        room = torch.zeros(n_pad, dtype=torch.bool)
        room[rng.choice(n_real, 6, replace=False)] = True
        full = {**nodes, "req_cpu": torch.where(
            room.to(device), nodes["req_cpu"], nodes["alloc_cpu"])}
        specs = []
        for j, (cpu, upd, prio) in enumerate(
                [(400, 400, 9), (1200, 800, 7), (2000, 2000, 5),
                 (9000, 9000, 3)]):
            d = _spec(cpu, j == 1, rng, n_pad, 1)
            d.update(req_mem=np.int64(GI), req_eph=np.int64(0),
                     upd_cpu=np.int64(upd), upd_mem=np.int64(GI),
                     upd_scalar=np.zeros(1, np.int64),
                     req_scalar=np.zeros(1, np.int64),
                     check_resources=np.bool_(j != 2),
                     has_request=np.bool_(True),
                     pprio=np.int64(prio))
            specs.append(d)
        specs.append(dict(specs[3], skip=np.bool_(True)))
        row = np.concatenate([np.repeat([0, 1, 2, 3], 7), [4] * 4])
        stack = K.PodStack.from_specs(specs, row, None, device)
        mut0 = {k: full[k] for k in K._MUTABLE}
        zero = {k: torch.zeros(n_pad, dtype=torch.int64, device=device)
                for k in K.GHOST_FIELDS}
        busy = {k: torch.as_tensor(rng.integers(0, hi, n_pad)).to(device)
                for k, hi in (("cpu", 600), ("mem", GI), ("eph", 2),
                              ("cnt", 3))}
        for gname, g0 in (("ghost off", zero), ("ghost on", busy)):
            args = (full, mut0, g0, stack, vic, 37, 5, 9000, n_real, 4)
            got = K.pressure_batch(*args)
            want = K.pressure_batch_plain(*args)
            same(f"pressure_batch/P{P}/{gname}", got, want)
            kinds = set(want[4]["winner"].cpu().tolist())
            if P == 16 and gname == "ghost off" and not (
                    {-2, -1} <= kinds and max(kinds) >= 0):
                raise SystemExit(f"variant pressure_batch/P{P}: the chunk "
                                 f"lacks bound, failed or nominated pods "
                                 f"({sorted(kinds)})")
        # K4 on the seven victim planes: duplicates and an out-of-range row
        rws = np.concatenate([rng.choice(n_pad - 8, 24, replace=False),
                              [n_pad + 3]]).astype(np.int32)
        rws = np.concatenate([rws, np.full(7, rws[0], np.int32)])
        fresh = _rand_victims(rng, n_pad, P, device)
        upd = {k: v.cpu().numpy()[np.clip(rws, 0, n_pad - 1)]
               for k, v in fresh.items()}
        for v in upd.values():
            v[25:] = v[0]
        dev_a = {k: v.clone() for k, v in vic.items()}
        dev_b = {k: v.clone() for k, v in vic.items()}
        same(f"scatter_rows/victim planes P{P}",
             K.scatter_rows(dev_a, rws, upd),
             K.scatter_rows_plain(dev_b, rws, upd))
    for more, more_real, P, only in K7_MORE:
        vic, nodes, feas, rank, pod = k7_world(more, more_real, P)
        k7_all(more, more_real, P, vic, nodes, feas, rank, pod, only=only)
        del vic, nodes
    sync()
    print(f"[variants] {checked} preemption kernel calls equal to their "
          f"plain versions (K7 at n_pad {n_pad}, P 16 and 128: default, "
          f"check_resources and has_request false, no candidate, "
          f"zero-victim win, ties to order_rank, duplicate ranks with and "
          f"without those ties, a ragged n_real, no lower priority; the "
          f"same at n_pad 4096, P 24; at n_pad 262144, P 16 and 128: "
          f"default, no candidate, zero-victim win, ties to duplicate "
          f"ranks; K8 32-pod chunks "
          f"with ghosts off and on, skip padding, an init-container "
          f"request; K4 on the seven victim planes)")
    for label, (dev_ms, grid) in k7_ms.items():
        print(f"[variants] preempt_scan {label}: {describe_grid(grid)}; "
              f"device_ms {fmt_ms(dev_ms)} a call")


#: the geometries K8 is held against its plain version on (name, n_pad,
#: n_real, the most blocks its planner may take, the plan it must choose:
#: blocks, node slots a thread, rows resident, scratch in global memory;
#: the victim slots P it runs at)
PRESSURE_GEOMETRIES = (
    ("16,384 slots, 16 blocks: rows resident", 16384, 16000, 16,
     (16, 1, True, False), (16, 128)),
    ("16,384 slots, 8 blocks: rows in global memory", 16384, 16000, 8,
     (8, 2, False, False), (16, 128)),
    ("1,024 slots (preempt-baseline's n_pad): one block", 1024, 1000, 16,
     (1, 1, True, False), (16, 128)),
    ("262,144 slots, 16 blocks: rows and scratch in global memory", 262144,
     262000, 16, (16, 16, False, True), (16,)),
    ("131,072 slots, 8 blocks: rows and scratch in global memory", 131072,
     131000, 8, (8, 16, False, True), (16,)),
)
#: pod-spec rows of a K8 chunk (spec 4 is the skip padding): one spec
#: throughout, and four specs alternating, each pod a new spec
PRESSURE_ORDERS = (("one spec run", [1] * 28 + [4] * 4),
                   ("alternating specs", [0, 1, 2, 3] * 7 + [4] * 4))


@contextlib.contextmanager
def pressure_blocks(blocks):
    """K8's planner held to at most `blocks` blocks."""
    from kubernetes_tpu_torch.ops import kernels as K
    real = K.pressure_plan

    def plan(n_pad, S, z_pad, b=K.CLUSTER_BLOCKS):
        return real(n_pad, S, z_pad, min(b, blocks))
    K.pressure_plan = plan
    try:
        yield
    finally:
        K.pressure_plan = real


def pressure_variant_checks(device, sync):
    """K8 against its plain version on random inputs, on every geometry of
    PRESSURE_GEOMETRIES (16 blocks with the rows, ghost and aggregates
    resident; 8 blocks with them in global memory; n_pad 1,024 on one
    block; 262,144 and 131,072 slots with the scratch in global memory
    too), at P 16 and 128 (the two largest at P 16), ghost off and
    carried in, on a chunk of one
    spec (the scan reused pod after pod: each block rescans only the node
    the pod before folded or nominated) and on alternating specs (every
    pod rescans every node): 32 pods that bind, then nominate, then fail,
    and skip padding. Prints each launch's geometry and, on each geometry
    at P 16 with the ghost carried in, the kernel's time a pod (CUDA
    events, 3 calls) on the one-spec chunk (the scan reused) and on the
    alternating one (a full scan every pod)."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    rng = np.random.default_rng(20261017)
    checked = 0
    for label, n_pad, n_real, blocks, want_plan, Ps in PRESSURE_GEOMETRIES:
        seen, times = set(), []
        for P in Ps:
            vic = _rand_victims(rng, n_pad, P, device)
            nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
            room = torch.zeros(n_pad, dtype=torch.bool)
            room[rng.choice(n_real, 6, replace=False)] = True
            full = {**nodes, "req_cpu": torch.where(
                room.to(device), nodes["req_cpu"], nodes["alloc_cpu"])}
            specs = []
            for j, (cpu, upd, prio) in enumerate(
                    [(400, 400, 9), (1200, 800, 7), (2000, 2000, 5),
                     (9000, 9000, 3)]):
                d = _spec(cpu, j == 1, rng, n_pad, 1)
                d.update(req_mem=np.int64(GI), req_eph=np.int64(0),
                         upd_cpu=np.int64(upd), upd_mem=np.int64(GI),
                         upd_scalar=np.zeros(1, np.int64),
                         req_scalar=np.zeros(1, np.int64),
                         check_resources=np.bool_(j != 2),
                         has_request=np.bool_(True), pprio=np.int64(prio))
                specs.append(d)
            specs.append(dict(specs[3], skip=np.bool_(True)))
            mut0 = {k: full[k] for k in K._MUTABLE}
            ghosts = (("ghost off", {k: torch.zeros(
                n_pad, dtype=torch.int64, device=device)
                for k in K.GHOST_FIELDS}),
                ("ghost on", _random_ghost(rng, n_pad, device)))
            for oname, rows in PRESSURE_ORDERS:
                stack = K.PodStack.from_specs(specs, np.asarray(rows), None,
                                              device)
                for gname, g0 in ghosts:
                    args = (full, mut0, g0, stack, vic, 37, 5, n_real,
                            n_real, 4)
                    with pressure_blocks(blocks):
                        got = K.pressure_batch(*args)
                    want = K.pressure_batch_plain(*args)
                    name = f"{label}/P{P}/{oname}/{gname}"
                    err = max_abs_err(got, want)
                    if err != 0:
                        raise SystemExit(
                            f"variant pressure_batch {name}: kernel "
                            f"disagrees with plain (max_abs_err {err}; "
                            f"first difference {first_diff(got, want)})")
                    kinds = set(want[4]["winner"].cpu().tolist())
                    if oname == "alternating specs" and not (
                            {-2, -1} <= kinds and max(kinds) >= 0):
                        raise SystemExit(f"variant pressure_batch {name}: "
                                         f"the chunk lacks bound, failed or "
                                         f"nominated pods ({sorted(kinds)})")
                    plan, fit = K.last_geometry["pressure_batch"]
                    if (plan.blocks, plan.nodes_per_thread, plan.resident,
                            plan.global_scratch) != want_plan:
                        raise SystemExit(f"variant pressure_batch {name}: "
                                         f"planned {plan}, not {want_plan}")
                    seen.add(describe_geometry(plan, fit))
                    checked += 1
                    if P == 16 and gname == "ghost on":
                        with pressure_blocks(blocks):
                            ms = cuda_time(lambda: K.pressure_batch(*args),
                                           sync, 3)
                        times.append(f"{oname} {ms / len(rows) * 1e3:.2f} "
                                     f"us/pod")
        print(f"[variants] pressure_batch, {label}: {'; '.join(seen)}; "
              f"P 16, ghost on: {', '.join(times)}")
    sync()
    print(f"[variants] {checked} K8 chunks equal to the plain version over "
          f"{len(PRESSURE_GEOMETRIES)} geometries (P 16 and 128, ghost off "
          f"and carried in, one spec run and alternating specs; 32 pods: "
          f"binds, nominations, failures, skip padding)")


def run_wave(infos, tree, pdbs, wave, device, sync, pct=None, mesh=None):
    """prewarm_preempt, then one pressure wave (the node axis split over
    `mesh` when given); returns its outcomes, scheduler, prewarm and wave
    seconds."""
    sched = make_sched(tree, device, 50 if pct is None else pct,
                       mesh=mesh) if tree is not None else None
    if sched is None:
        from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
        sched = TorchScheduler(percentage_of_nodes_to_score=pct,
                               device=device)
        names = sorted(infos, key=lambda s: int(s.split("-")[1]))
    else:
        names = tree.list_names()
    t0 = time.perf_counter()
    sched.prewarm_preempt(infos, names, pdbs)
    sync()
    t1 = time.perf_counter()
    out = sched.preempt_pressure_burst(wave, infos, names, pdbs)
    sync()
    return {"out": out, "sched": sched, "t_prewarm": t1 - t0,
            "t_wave": time.perf_counter() - t1,
            "rows": mutable_rows(sched),
            "counters": (sched.last_index, sched.last_node_index),
            "phases": dict(sched.last_preempt_phases or {})}


def wave_path(name, infos, tree, pdbs, wave, device, sync, report,
              pct=None, check=True):
    """One pressure-wave path: launches counted on the kernel run, then
    the same wave on the plain versions; outcomes, counters, the last
    chunk's ghost vector and the folded rows must agree."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    obs.reset()
    with capture("pressure_batch", keep_all=True) as rec:
        run = run_wave(infos, tree, pdbs, wave, device, sync, pct)
    counts = K.launches()
    refusals = obs.family("refusal")
    fetches = obs.get("fetch.pressure_batch")
    if refusals or run["out"] is None:
        raise SystemExit(f"{name}: refused ({refusals})")
    n_chunks = -(-len(wave) // 128)
    if counts["pressure_batch"] != n_chunks or fetches != 1:
        raise SystemExit(f"{name}: {counts['pressure_batch']} K8 launches "
                         f"and {fetches} fetches for {n_chunks} chunks")
    with plain_versions(), capture("pressure_batch") as rec_p:
        ref = run_wave(infos, tree, pdbs, wave, device, sync, pct)
    if outcome_names(run["out"]) != outcome_names(ref["out"]) \
            or run["counters"] != ref["counters"]:
        raise SystemExit(f"{name}: outcomes or counters differ from the "
                         f"plain path")
    same_rows(name, run["rows"], ref["rows"])
    if max_abs_err(rec.last[1], rec_p.last[1]) != 0:
        raise SystemExit(f"{name}: ghost vectors differ from the plain "
                         f"path ({first_diff(rec.last[1], rec_p.last[1])})")
    kinds = {}
    for o in run["out"]:
        key = o[0] if o[0] != "failed" else f"failed(any_cand={o[1]})"
        kinds[key] = kinds.get(key, 0) + 1
    if check:
        b = run["sched"].encoder._batch
        nodes, args, kw = rec.call
        # the check writes its own block, not the wave's fetch buffer
        call = (nodes, args, {k: v for k, v in kw.items() if k != "out"})
        n_pods = len(args[2])
        width = len(K.PRESSURE_HEAD) + int(args[3]["prio"].shape[1])
        bound = victim_bound(
            nodes, args[3], b.n_real,
            sum(v.numel() * v.element_size()
                for v in args[2].table.values()) + n_pods * 4 * width,
            n_pods * b.n_real * OPS_PER_NODE_CYCLE
            + (n_pods - 1) * b.n_real * int(args[3]["prio"].shape[1])
            * OPS_PER_SLOT)
        ms = call_entry(report, "pressure_batch", K.pressure_batch,
                        K.pressure_batch_plain, call, bound, sync, 3,
                        f"the first {n_pods}-pod chunk of {name}")
        dev_ms, seen = device_time(
            lambda: K.pressure_batch(call[0], *call[1], **call[2]), sync, 3,
            "pressure_batch_kernel")
        report["pressure_batch"]["device_ms"] = dev_ms
        skips = int(args[2].skip_flags()[args[2].row].sum())
        rounds = 4 * (n_pods - skips) + skips
        print(f"[kernel] pressure_batch: {ms / n_pods * 1e3:.2f} us/pod "
              f"(wrapper); device_ms "
              + ("not measured" if dev_ms is None else
                 f"{dev_ms:.4f} over {seen} launches, "
                 f"{dev_ms / n_pods * 1e3:.2f} us/pod")
              + f"; {rounds} cluster rounds in the chunk ({n_pods - skips} "
              f"cycles of 4, {skips} skip pods of 1); "
              f"{describe_geometry(*K.last_geometry['pressure_batch'])}")
    add_launches(report, counts)
    ph = run["phases"]
    print(f"[path] {name}: {len(infos)} nodes, "
          f"{sum(len(ni.pods) for ni in infos.values())} pods on them, "
          f"{len(wave)} preemptors in {n_chunks} chunks and 1 fetch, "
          f"{len(wave) / run['t_wave']:.1f} preemptors/s "
          f"({run['t_wave'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"scan {ph['scan'] * 1e3:.2f} of which fetch "
          f"{ph['fetch'] * 1e3:.2f}); prewarm "
          f"{run['t_prewarm'] * 1e3:.1f} ms; outcomes {kinds}; launches "
          f"{counts}; plain path wave {ref['t_wave'] * 1e3:.1f} ms; "
          f"outcomes, counters, ghost and rows equal to the plain path")
    return run, kinds, rec.all


def baseline_world():
    """BASELINE.json configs[3] as perf/harness.py:203-245 builds it: 1,000
    nodes (4 CPU, 32 Gi, 110 pods, no labels), 10 victims of 400m at
    priority 1 on each, 128 preemptors of 400m at priority 10."""
    from kubernetes_tpu_torch.api.types import Node, Pod, Container
    from kubernetes_tpu_torch.cache.node_info import NodeInfo
    infos = {}
    uid = 0
    for i in range(1000):
        node = Node(name=f"node-{i}", allocatable={
            "cpu": 4000, "memory": 32 * GI, "pods": 110})
        ni = NodeInfo(node)
        for _ in range(10):
            uid += 1
            ni.add_pod(Pod(name=f"victim-{uid}", priority=1,
                           node_name=node.name, containers=(Container.make(
                               name="c", requests={"cpu": 400}),)))
        infos[node.name] = ni
    wave = [Pod(name=f"hi-{k}", priority=10, containers=(Container.make(
        name="c", requests={"cpu": 400}),)) for k in range(128)]
    return infos, wave


def single_path(infos, tree, pdbs, device, sync, report):
    """preempt-single: N_SINGLE rounds of schedule (K2 raises FitError),
    preempt (K7), then the shell's work: the victims leave their
    NodeInfos, the pod joins the chosen node. Every K7 block is held
    against preemption_scan_plain; rounds 2.. must scatter the victim
    planes' dirty rows (K4), not upload them whole."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Pod, Container
    from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
    from kubernetes_tpu_torch.ops import kernels as K
    sched = make_sched(tree, device, 50)
    real = K.preemption_scan
    held = []

    def checked(nodes, *args):
        out = real(nodes, *args)
        want = K.preemption_scan_plain(nodes, *args)
        if max_abs_err(out, want) != 0:
            raise SystemExit(f"preempt-single: K7 block differs from plain "
                             f"({first_diff(out, want)})")
        if not held:
            # the resident planes change in place later: keep copies
            held.append(({k: v.clone() for k, v in nodes.items()},
                         ({k: v.clone() for k, v in args[0].items()},)
                         + args[1:], {}))
        return out
    names = tree.list_names()
    sched.prewarm_preempt(infos, names, pdbs)
    sync()
    obs.reset()
    uploads = []
    evicted = 0
    t_sched = t_pre = 0.0
    phases = {"encode": 0.0, "scan": 0.0, "fetch": 0.0}
    K.preemption_scan = checked
    try:
        for r in range(N_SINGLE):
            pod = Pod(name=f"single-{r}", priority=100,
                      node_selector={"pool": "preempt"},
                      containers=(Container.make(
                          name="c", requests={"cpu": 1000}),))
            t0 = time.perf_counter()
            try:
                sched.schedule(pod, infos, tree.list_names())
                raise SystemExit("preempt-single: the pod was scheduled")
            except FitError as e:
                err = e
            t1 = time.perf_counter()
            res = sched.preempt(pod, infos, names, err, pdbs)
            sync()
            t_pre += time.perf_counter() - t1
            t_sched += t1 - t0
            if res is None or res.node is None or not res.victims:
                raise SystemExit(f"preempt-single round {r}: {res}")
            for k in phases:
                phases[k] += sched.last_preempt_phases[k]
            uploads.append((obs.get("dispatch.vic_upload"),
                            obs.get("dispatch.vic_scatter")))
            for v in res.victims:
                infos[v.node_name].remove_pod(v)
            evicted += len(res.victims)
            assume(infos, pod, res.node.name)
    finally:
        K.preemption_scan = real
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"preempt-single: refusals {refusals}")
    if counts["preempt_scan"] != N_SINGLE:
        raise SystemExit(f"preempt-single: {counts['preempt_scan']} K7 "
                         f"launches for {N_SINGLE} rounds")
    if any(u != (0, r) for r, u in enumerate(uploads)):
        raise SystemExit(f"preempt-single: victim planes (uploads, "
                         f"scatters) per round {uploads}")
    b = sched.encoder._batch
    nodes, args, _kw = held[0]
    bound = victim_bound(nodes, args[0], b.n_real, b.n_pad * 9 + 4 * 19, 0)
    call_entry(report, "preempt_scan", K.preemption_scan,
               K.preemption_scan_plain, held[0], bound, sync, 20,
               "the first preempt-single round",
               dev_kernels=("preempt_scan_kernel",))
    grid = K.last_geometry["preempt_scan"][0]
    report["preempt_scan"]["grid"] = {"blocks": grid.blocks,
                                      "threads": K.PREEMPT_THREADS,
                                      "fit": grid.fit}
    print(f"[kernel] preempt_scan grid: {describe_grid(grid)}")
    add_launches(report, counts)
    print(f"[path] preempt-single: {len(infos)} nodes, {N_SINGLE} rounds "
          f"of schedule (FitError) + preempt, {N_SINGLE / t_pre:.1f} "
          f"preemptions/s (preempt {t_pre * 1e3:.1f} ms in all: encode "
          f"{phases['encode'] * 1e3:.2f} scan {phases['scan'] * 1e3:.2f} "
          f"of which fetch {phases['fetch'] * 1e3:.2f}; schedule "
          f"{t_sched * 1e3:.1f} ms in all); {evicted} victims evicted; "
          f"victim planes uploaded once (prewarm), scattered in rounds "
          f"2-{N_SINGLE}; launches {counts}; every K7 block equal to "
          f"preemption_scan_plain")


def preempt_paths(device, sync, report):
    """The preemption paths: preempt-wave (15,000 nodes, 150,000 victims,
    1,024 preemptors), preempt-baseline (BASELINE configs[3]),
    mesh-preempt-wave (the preempt-wave world on four shards, held against
    the single-device wave), preempt-single (N_SINGLE serial preemptions
    on the preempt-wave world), mesh-preempt-single (N_MESH_SINGLE more,
    on four shards) and mesh-nominated-serial; the mesh kernels K13a-K14b
    on random inputs first."""
    mesh_preempt_variant_checks(device, sync)
    mesh_pressure_local_checks(device, sync)
    pressure_select_geometry_checks(device, sync)
    t = time.perf_counter()
    infos, tree, pdbs = preempt_world(N_NODES)
    print(f"[world] preempt: {N_NODES} nodes, "
          f"{sum(len(ni.pods) for ni in infos.values())} victims built in "
          f"{time.perf_counter() - t:.1f} s")
    run, kinds, chunks = wave_path("preempt-wave", infos, tree, pdbs,
                                   wave_pods(), device, sync, report)
    for want in ("bound", "nominated", "failed(any_cand=True)"):
        if not kinds.get(want):
            raise SystemExit(f"preempt-wave: no {want} outcome ({kinds})")
    b_infos, b_wave = baseline_world()
    wave_path("preempt-baseline", b_infos, None, [], b_wave, device, sync,
              report, pct=100, check=False)
    mesh_wave_path(infos, tree, pdbs, device, sync, report, (run, chunks))
    single_path(infos, tree, pdbs, device, sync, report)
    mesh_single_path(infos, tree, pdbs, device, sync, report)
    mesh_nominated_path(device, sync)


# ---------------------------------------------------------------------------
# Node-axis sharding of device preemption: K14a/b (the victim scan) and
# K13a/b (the pressure wave), and the serial cycle's nominated ghost (C1)
# ---------------------------------------------------------------------------
SOURCES.update({
    "shard_preempt_local": (
        "kubernetes_tpu_torch/ops/csrc/shard_preempt_local.cu",
        "kubernetes_tpu/parallel/sharding.py:354"),
    "shard_preempt_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_preempt_select.cu",
        "kubernetes_tpu/parallel/sharding.py:354"),
    "shard_pressure_local": (
        "kubernetes_tpu_torch/ops/csrc/shard_pressure_local.cu",
        "kubernetes_tpu/parallel/sharding.py:330"),
    "shard_pressure_select": (
        "kubernetes_tpu_torch/ops/csrc/shard_pressure_select.cu",
        "kubernetes_tpu/parallel/sharding.py:330"),
})


def whole_wave(r, d0):
    """A pressure result with its per-shard rows and ghost gathered into
    whole vectors on `d0`: (rows, ghost, li, lni, packed)."""
    mut, ghost, li, lni, outs = r
    if isinstance(mut, list):
        mut, ghost = cat_rows(mut), cat_rows(ghost)
    return (mut, ghost, li.reshape(()).to(d0), lni.reshape(()).to(d0),
            outs["packed"])


def _random_ghost(rng, n_pad, device):
    import torch
    return {k: torch.as_tensor(rng.integers(0, hi, n_pad)).to(device)
            for k, hi in (("cpu", 600), ("mem", GI), ("eph", 2),
                          ("cnt", 3))}


def _k13_chunk(rng, nodes, n_pad, n_real, B, device):
    """A pressure chunk of B pods over `nodes` with room on six rows only:
    binds, then nominations, then failures, then skip padding. Returns
    (the full nodes, the pod stack, the mutable rows)."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    room = torch.zeros(n_pad, dtype=torch.bool)
    room[rng.choice(n_real, 6, replace=False)] = True
    full = {**nodes, "req_cpu": torch.where(
        room.to(device), nodes["req_cpu"], nodes["alloc_cpu"])}
    specs = []
    for j, (cpu, upd, prio) in enumerate(
            [(400, 400, 9), (1200, 800, 7), (2000, 2000, 5),
             (9000, 9000, 3)]):
        d = _spec(cpu, j == 1, rng, n_pad, 1)
        d.update(req_mem=np.int64(GI), req_eph=np.int64(0),
                 upd_cpu=np.int64(upd), upd_mem=np.int64(GI),
                 upd_scalar=np.zeros(1, np.int64),
                 req_scalar=np.zeros(1, np.int64),
                 check_resources=np.bool_(j != 2),
                 has_request=np.bool_(True), pprio=np.int64(prio))
        specs.append(d)
    specs.append(dict(specs[3], skip=np.bool_(True)))
    q = (B - 4) // 4
    row = np.concatenate([np.repeat([0, 1, 2, 3], q), [4] * (B - 4 * q)])
    stack = K.PodStack.from_specs(specs, row, None, device)
    return full, stack, {k: full[k] for k in K._MUTABLE}


#: K13b's C3 geometries (label, n_pad, n_real, blocks the planner may
#: take): the records and the scratch in global memory at 262,144 slots
#: on 16 blocks and 131,072 on 8
PRESSURE_SELECT_GEOMETRIES = (
    ("262,144 slots: 16 a thread, the records and the scratch in global "
     "memory", 262144, 262000, 16),
    ("131,072 slots on an 8-block cluster: 16 a thread, the records and "
     "the scratch in global memory", 131072, 131000, 8),
)


def pressure_select_geometry_checks(device, sync, devices=None):
    """K13b (one thread-block cluster a step) at the C3 geometries of
    PRESSURE_SELECT_GEOMETRIES: the sharded pressure wave on MESH_D
    shards of the card, or one shard on each of `devices` (a chunk of
    binds, nominations, failures and skip padding at P 16, the ghost
    carried in) held against the plain version of the same sharded wave
    and against the single-device plain K8; prints K13b's plan and its
    device time a step there."""
    import numpy as np
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = S.Mesh(devices or [device] * MESH_D)
    d0 = mesh.devices[0]
    for gi, (label, n_pad, n_real, blocks) in enumerate(
            PRESSURE_SELECT_GEOMETRIES):
        rng = np.random.default_rng(20261103 + gi)
        vic = _rand_victims(rng, n_pad, 16, device)
        nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
        full, stack, mut0 = _k13_chunk(rng, nodes, n_pad, n_real, 16, device)
        g0 = _random_ghost(rng, n_pad, device)
        sh = S.shard_node_arrays(mesh, full)
        vics = S.shard_victim_planes(mesh, vic)
        args = (sh, mut0, g0, stack, vics, 37, 5, 9000, n_real, 4)
        K.last_geometry.clear()
        with cluster_blocks(blocks):
            got = whole_wave(K.pressure_batch(*args, mesh=mesh), d0)
            dev_ms, seen = device_time(
                lambda: K.pressure_batch(*args, mesh=mesh), sync, 2,
                "shard_pressure_select_kernel")
        with plain_versions(MESH_ENTRIES):
            ref = whole_wave(K.pressure_batch(*args, mesh=mesh), d0)
        want = whole_wave(K.pressure_batch_plain(
            full, mut0, g0, stack, vic, 37, 5, 9000, n_real, 4), d0)
        for what, other in (("the sharded plain wave", ref),
                            ("the single-device plain K8", want)):
            err = max_abs_err(got, other)
            if err != 0:
                raise SystemExit(f"K13b at {label}: disagrees with {what} "
                                 f"({first_diff(got, other)})")
        plan, fit = K.last_geometry["shard_pressure_select"]
        if (plan.blocks, plan.resident, plan.global_scratch) != (
                blocks, False, True):
            raise SystemExit(f"K13b at {label}: planned {plan}")
        print(f"[variants] shard_pressure_select {label}, {mesh.size} "
              f"shards: "
              f"a 16-pod chunk equal to the sharded plain wave and to the "
              f"single-device plain K8; "
              f"{describe_geometry(plan, fit, select=True)}; device_ms "
              f"{fmt_ms(dev_ms)} a step over {seen} steps")


#: K9b's C3 geometries (label, n_pad, n_real, blocks the planner may
#: take): the records and the scratch in global memory at 262,144 slots on
#: 16 blocks and 131,072 on 8, as K13b's
CYCLE_SELECT_GEOMETRIES = (
    ("262,144 slots: 16 a thread, the records and the scratch in global "
     "memory", 262144, 262000, 16),
    ("131,072 slots on an 8-block cluster: 16 a thread, the records and "
     "the scratch in global memory", 131072, 131000, 8),
)


def cycle_select_geometry_checks(device, sync, devices=None):
    """K9b (one thread-block cluster a cycle, `select_plan`) at the C3
    geometries of CYCLE_SELECT_GEOMETRIES: the sharded cycle on MESH_D
    shards of the card, or one shard on each of `devices` (dense and inert
    pods in the identity, perm and pos walks) held against the plain
    version of the same sharded cycle and against the single-device plain
    K2; prints K9b's plan and its device time a cycle there."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = S.Mesh(devices or [device] * MESH_D)
    for gi, (label, n_pad, n_real, blocks) in enumerate(
            CYCLE_SELECT_GEOMETRIES):
        rng = np.random.default_rng(20261105 + gi)
        nodes = _rand_nodes(rng, n_pad, n_real, 2, 6, device)
        shards = S.shard_node_arrays(mesh, nodes)
        perm = np.concatenate([rng.permutation(n_real),
                               np.arange(n_real, n_pad)]).astype(np.int32)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_pad, dtype=np.int32)
        walks = {"identity": {},
                 "perm": {"perm": torch.as_tensor(perm).to(device),
                          "inv_perm": torch.as_tensor(inv).to(device)},
                 "pos": {"pos": torch.as_tensor(inv).to(device)}}
        K.last_geometry.clear()
        timed = None
        with cluster_blocks(blocks):
            for dense in (True, False):
                pod = _rand_pod(rng, n_pad, 2, dense)
                for mode, kw in walks.items():
                    ntf = n_real if mode == "pos" else n_real // 2
                    args = (pod, n_real // 3 + 37, 2 ** 33 + 7, ntf, n_real,
                            8)
                    got = K.schedule_cycle(shards, *args, mesh=mesh, **kw)
                    with plain_versions(MESH_ENTRIES):
                        ref = K.schedule_cycle(shards, *args, mesh=mesh,
                                               **kw)
                    want = K.schedule_cycle_plain(nodes, *args, **kw)
                    for what, other in (("the sharded plain cycle", ref),
                                        ("the single-device plain K2",
                                         want)):
                        err = max_abs_err({k: got[k] for k in CYCLE_KEYS},
                                          {k: other[k] for k in CYCLE_KEYS})
                        if err != 0:
                            raise SystemExit(
                                f"K9b at {label} ({mode}, dense {dense}): "
                                f"disagrees with {what} "
                                f"({first_diff(got, other)})")
                    if dense and mode == "identity":
                        timed = (args, kw)
            args, kw = timed
            dev_ms, seen = device_time(
                lambda: K.schedule_cycle(shards, *args, mesh=mesh, **kw),
                sync, 3, "shard_cycle_select_kernel")
        plan, fit = K.last_geometry["shard_cycle_select"]
        if (plan.blocks, plan.resident, plan.global_scratch) != (
                blocks, False, True):
            raise SystemExit(f"K9b at {label}: planned {plan}")
        print(f"[variants] shard_cycle_select {label}, {mesh.size} shards: "
              f"dense and inert pods in the identity, perm and pos walks "
              f"equal to the sharded plain cycle and to the single-device "
              f"plain K2; {describe_geometry(plan, fit, select=True)}; "
              f"device_ms {fmt_ms(dev_ms)} a cycle over {seen} launches")


#: the geometries K9d is held on (name, n_pad, n_real, the most blocks its
#: planner may take, the plan it must choose without rotation and with
#: four orders: blocks, node slots a thread, resident, lists and bits in
#: the global workspace)
UNIFORM_SELECT_GEOMETRIES = (
    ("262,144 slots: 16 a thread (rotated: the tie / stay bits and lists "
     "in a global workspace)", 262144, 262000, 16, (16, 16, True, False),
     (16, 16, False, True)),
    ("131,072 slots on an 8-block cluster: 16 a thread (rotated: the "
     "bits and lists in a global workspace)", 131072, 131000, 8,
     (8, 16, True, False), (8, 16, False, True)),
)


def uniform_select_geometry_checks(device, sync, devices=None):
    """K9d (one thread-block cluster a pass, K3's `uniform_plan` at R = 0)
    at the geometries of UNIFORM_SELECT_GEOMETRIES: the sharded uniform
    burst on MESH_D shards of the card, or one shard on each of
    `devices`, in the plain, rotate and ban + extra_ok cases of
    `uniform_cases`, held against the sharded plain burst and the
    single-device plain K3 (decisions, the packed block, lni, the folded
    rows); prints K9d's plans and its device time a pass."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = S.Mesh(devices or [device] * MESH_D)
    for gi, (label, n_pad, n_real, blocks, flat, rot) in enumerate(
            UNIFORM_SELECT_GEOMETRIES):
        rng = np.random.default_rng(20261107 + gi)
        nodes = _rand_nodes(rng, n_pad, n_real, 2, 6, device)
        wtab = torch.as_tensor(rng.integers(0, 4, (3, len(K.PRIORITY_AXIS)))
                               ).to(device)
        union = {k: int(wtab[:, i].max())
                 for i, k in enumerate(K.PRIORITY_AXIS)}
        fresh, cases, cap = uniform_cases(rng, nodes, n_pad, n_real, 2, wtab,
                                          union, device)
        fshards = S.shard_node_arrays(mesh, fresh)
        plans, dev_ms = {}, {}
        with cluster_blocks(blocks):
            for name, cls, n_pods, lni, kw in cases:
                if name not in ("plain", "rotate", "ban+extra_ok"):
                    continue
                args = (cls, n_pods, lni, n_real, True)
                K.last_geometry.pop("shard_uniform_select", None)
                got = K.schedule_batch_uniform(fshards, *args, cap=cap,
                                               mesh=mesh, **kw)
                plans[name] = K.last_geometry["shard_uniform_select"]
                with plain_versions(MESH_ENTRIES):
                    ref = K.schedule_batch_uniform(fshards, *args, cap=cap,
                                                   mesh=mesh, **kw)
                want = K.schedule_batch_uniform_plain(fresh, *args, cap=cap,
                                                      **kw)
                for what, other in (("the sharded plain burst", ref),
                                    ("the single-device plain K3", want)):
                    err = max_abs_err(
                        (cat_rows(got[0]), got[1], got[2]),
                        (cat_rows(other[0]) if isinstance(other[0], list)
                         else other[0], other[1], other[2]))
                    if err != 0:
                        raise SystemExit(
                            f"K9d at {label} ({name}): disagrees with "
                            f"{what} ({first_diff(got[1], other[1])})")
                if name in ("plain", "rotate"):
                    dev_ms[name], _n = device_time(
                        lambda: K.schedule_batch_uniform(
                            fshards, *args, cap=cap, mesh=mesh, **kw),
                        sync, 1, "shard_uniform_select_kernel")
        for name, want in (("plain", flat), ("rotate", rot)):
            plan = plans[name][0]
            if (plan.blocks, plan.nodes_per_thread, plan.resident,
                    plan.global_scratch) != want:
                raise SystemExit(f"K9d at {label} ({name}): planned {plan}, "
                                 f"not {want}")
        print(f"[variants] shard_uniform_select {label}, {mesh.size} "
              f"shards: the plain, rotate and ban + extra_ok bursts equal "
              f"to the sharded plain burst and the single-device plain K3; "
              f"{describe_pass_plan(*plans['plain'])}, device_ms "
              f"{fmt_ms(dev_ms['plain'])} a pass; rotated: "
              f"{describe_pass_plan(*plans['rotate'])}, device_ms "
              f"{fmt_ms(dev_ms['rotate'])} a pass")


def mesh_preempt_variant_checks(device, sync, meshes=None, n_pad=4096,
                                n_real=3999):
    """K14a/b and K13a/b against their plain versions on random inputs,
    and the sharded victim scan / pressure wave against the single-device
    plain K7 / K8, on one card split into 1, 2 and 4 shards, at P 16 and
    128, K14 also at 24 (n_real 3,999: a multiple of no shard count): K14
    with the K7 cases (check_resources / has_request false, no candidate,
    a zero-victim win, a zero-victim node in the last shard only, ties
    through all five criteria across every shard with a candidate order
    that is not the row order, the same ties to duplicate ranks, no lower
    priority) and each shard's record, in place in every device's buffer,
    against the per-shard plain record; K13 on a chunk of
    binds, nominations, failures and skip padding, ghosts off and carried
    in, an init-container request. Then K2 and the sharded cycle (K9a/b)
    with a nominated ghost against their plain versions. Every mesh is
    held against the single-device plain K7 / K8; the sharded plain
    versions run on the 4-shard mesh. `meshes` (lists of devices)
    replaces the shards of one card and runs the sharded plain versions
    on each of them."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    rng = np.random.default_rng(20261023)
    checked = 0

    def same(name, got, want):
        nonlocal checked
        err = max_abs_err(got, want)
        if err != 0:
            raise SystemExit(f"mesh preempt variant {name}: disagrees "
                             f"(max_abs_err {err}; first difference "
                             f"{first_diff(got, want)})")
        checked += 1

    mesh_list = [S.Mesh(devs) for devs in
                 (meshes or [[device] * D for D in MESH_SHARDS])]
    # K14 at P 16, 24 (the general slot loops) and 128; K13 (B pods a
    # chunk) at P 16 and 128
    for P, B in ((16, 32), (24, 0), (128, 16)):
        vic = _rand_victims(rng, n_pad, P, device)
        nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
        feas = torch.as_tensor(rng.random(n_pad) < 0.9).to(device)
        rank = torch.as_tensor(rng.permutation(n_pad)).to(device)
        dup = torch.as_tensor(rng.integers(0, 9, n_pad)).to(device)
        pod = {"req_cpu": np.int64(1500), "req_mem": np.int64(2 * GI),
               "req_eph": np.int64(GI)}
        w = max(int(K.preemption_scan_plain(
            nodes, vic, pod, feas, rank, n_real, True, True, 6)[0]), 0)
        tie_vic = {k: v[w:w + 1].expand_as(v).contiguous()
                   for k, v in vic.items()}
        tie_nodes = {k: (v[w:w + 1].expand_as(v).contiguous()
                         if k != "valid" else v) for k, v in nodes.items()}
        roomy = {**nodes, "req_cpu": nodes["req_cpu"] // 4}
        # every node full on cpu but one roomy node in the last shard
        last = {k: v.clone() for k, v in nodes.items()}
        last["req_cpu"] = torch.maximum(last["req_cpu"], last["alloc_cpu"])
        j = n_real - 1
        for k, v in (("req_cpu", 0), ("alloc_cpu", 64000), ("req_mem", 0),
                     ("req_eph", 0), ("pod_count", 0),
                     ("allowed_pods", 110)):
            last[k][j] = v
        feas_j = feas.clone()
        feas_j[j] = True
        vic_j = {k: v.clone() for k, v in vic.items()}
        vic_j["valid"][j] = False   # no potential victim there
        k14 = [("default", nodes, vic, feas, rank, True, True, 6),
               ("check_resources false", nodes, vic, feas, rank, False,
                False, 6),
               ("has_request false", nodes, vic, feas, rank, True, False,
                6),
               ("no candidate", nodes, vic, torch.zeros_like(feas), rank,
                True, True, 6),
               ("zero-victim win", roomy, vic, feas, rank, True, True, 6),
               ("zero victim, last shard only", last, vic_j, feas_j, rank,
                True, True, 6),
               ("ties across shards", tie_nodes, tie_vic, feas, rank, True,
                True, 6),
               ("ties to duplicate ranks", tie_nodes, tie_vic, feas, dup,
                True, True, 6),
               ("no lower priority", nodes, vic, feas, rank, True, True, 0)]
        want14 = {c[0]: K.preemption_scan_plain(c[1], c[2], pod, c[3], c[4],
                                                n_real, c[5], c[6], c[7])
                  for c in k14}
        if int(want14["zero victim, last shard only"][0]) != j:
            raise SystemExit(f"mesh preempt variant K14/P{P}: the roomy "
                             f"node {j} does not win")
        if B:
            # K13: a chunk over a cluster with room on six rows only:
            # binds, then nominations, then failures, then skip padding
            full, stack, mut0 = _k13_chunk(rng, nodes, n_pad, n_real, B,
                                           device)
            zero = {k: torch.zeros(n_pad, dtype=torch.int64, device=device)
                    for k in K.GHOST_FIELDS}
            ghosts = (("ghost off", zero),
                      ("ghost on", _random_ghost(rng, n_pad, device)))
            want13 = {}
            for gname, g0 in ghosts:
                want13[gname] = whole_wave(K.pressure_batch_plain(
                    full, mut0, g0, stack, vic, 37, 5, 9000, n_real, 4),
                    torch.device(device))
                kinds = set(want13[gname][4][:, 1].cpu().tolist())
                if P == 16 and gname == "ghost off" and not (
                        {-2, -1} <= kinds and max(kinds) >= 0):
                    raise SystemExit(f"mesh preempt variant K13/P{P}: the "
                                     f"chunk lacks bound, failed or "
                                     f"nominated pods ({sorted(kinds)})")
        for mi, mesh in enumerate(mesh_list):
            D, d0 = mesh.size, mesh.devices[0]
            sharded_plain = meshes is not None or mi == len(mesh_list) - 1
            for name, nd, vc, fs, rk, cr, hr, mp in k14:
                shards = S.shard_node_arrays(mesh, nd)
                vics = S.shard_victim_planes(mesh, vc)
                args = (shards, vics, pod, fs, rk, n_real, cr, hr, mp)
                got = K.preemption_scan(*args, mesh=mesh)
                if sharded_plain:
                    with plain_versions(MESH_ENTRIES):
                        ref = K.preemption_scan(*args, mesh=mesh)
                    same(f"{D} shards/K14/P{P}/{name} vs plain", got, ref)
                same(f"{D} shards/K14/P{P}/{name} vs K7 plain", got.to(d0),
                     want14[name].to(d0))
                if name in ("check_resources false", "has_request false",
                            "no lower priority"):
                    continue
                # K14a's records in place: every device's half holds each
                # shard's record (its own, and under "peer" the others'
                # through their stores), equal to the per-shard plain one
                groups, sides, call = S.preempt_call(mesh, *args)
                for d, shs in groups.items():
                    K.shard_preempt_local(shs, sides[d], call)
                sync()
                for d, shs in groups.items():
                    for sh in shs:
                        rec = K.shard_preempt_local_plain(
                            sh.nodes, sh.vic, pod, sh.feas, sh.rank,
                            sh.offset, n_real, cr, hr, mp)
                        for dd in mesh.distinct:
                            same(f"{D} shards/K14a record {sh.index} on "
                                 f"{dd}/P{P}/{name}",
                                 sides[dd].records(call)[sh.index],
                                 rec.to(dd))
            if not B:
                continue
            shards = S.shard_node_arrays(mesh, full)
            vics = S.shard_victim_planes(mesh, vic)
            for gname, g0 in ghosts:
                args = (shards, mut0, g0, stack, vics, 37, 5, 9000, n_real,
                        4)
                got = whole_wave(K.pressure_batch(*args, mesh=mesh), d0)
                if sharded_plain:
                    with plain_versions(MESH_ENTRIES):
                        ref = whole_wave(K.pressure_batch(*args, mesh=mesh),
                                         d0)
                    same(f"{D} shards/K13/P{P}/{gname} vs plain", got, ref)
                same(f"{D} shards/K13/P{P}/{gname} vs K8 plain", got,
                     tuple(x.to(d0) if hasattr(x, "to") else
                           {k: v.to(d0) for k, v in x.items()}
                           for x in want13[gname]))
    # C1: K2 and the sharded cycle with a nominated ghost
    cnodes = _rand_nodes(rng, n_pad, n_real, 2, 5, device)
    cpod = _rand_pod(rng, n_pad, 2, True)
    ghost = _random_ghost(rng, n_pad, device)
    args = (cnodes, cpod, 17, 5, 900, n_real, 8)
    want = K.schedule_cycle_plain(*args, ghost=ghost)
    same("K2 with ghost vs plain", {k: want[k] for k in CYCLE_KEYS},
         {k: K.schedule_cycle(*args, ghost=ghost)[k] for k in CYCLE_KEYS})
    for mesh in mesh_list:
        d0 = mesh.devices[0]
        got = K.schedule_cycle(S.shard_node_arrays(mesh, cnodes), *args[1:],
                               ghost=ghost, mesh=mesh)
        same(f"{mesh.size} shards/K9a-b with ghost vs K2 plain",
             {k: got[k].to(d0) for k in CYCLE_KEYS},
             {k: want[k].to(d0) for k in CYCLE_KEYS})
    sync()
    grid = K.last_geometry.get("shard_preempt_local")
    geometry = describe_grid(grid[0]) if grid else "not launched"
    print(f"[variants] {checked} mesh preemption comparisons equal (K14a/b "
          f"and K13a/b against their plain versions, the sharded victim "
          f"scan / pressure wave against the single-device plain K7 / K8, "
          f"K14a records per shard in place on every device: default, "
          f"check_resources and has_request false, no candidate, "
          f"zero-victim win, a zero-victim node in the last shard only, "
          f"ties across every shard, ties to duplicate ranks, no lower "
          f"priority, at P 16, 24 and 128; K13 chunks of binds, "
          f"nominations, failures and skip padding, ghosts off and "
          f"carried in at P 16 and 128; K2 and K9a/b with a nominated "
          f"ghost; on meshes of {[m.size for m in mesh_list]} shards, "
          f"n_real {n_real}; K14a {geometry} a shard)")


#: the step states the grouped K13a is held in (name, {step-state slot:
#: value}); "first" / "last" stand for the first row of the last shard and
#: the last row of the first shard
PRESSURE_LOCAL_STATES = (
    ("a bind folded on a shard's first row",
     {"SS_NEXT": 2, "SS_FOLD_SEL": "first", "SS_FOLD_ROW": 1}),
    ("a bind folded on a shard's last row",
     {"SS_NEXT": 5, "SS_FOLD_SEL": "last", "SS_FOLD_ROW": 0}),
    ("a nomination's ghost fold",
     {"SS_NEXT": 9, "SS_GHOST_SEL": "last", "SS_FOLD_ROW": 2}),
    ("a skip pod after a ghost fold",
     {"SS_NEXT": 30, "SS_GHOST_SEL": "first", "SS_FOLD_ROW": 1}),
    ("the fold past the wave",
     {"SS_NEXT": 32, "SS_FOLD_SEL": "first", "SS_FOLD_ROW": 0}),
)


def mesh_pressure_local_checks(device, sync, meshes=None):
    """K13a, one launch over every shard of a device with each record
    written into the device's gathered buffer, against its plain version
    on random inputs at the main path's n_pad (16,384; n_real 15,001, a
    multiple of no shard count; P 16; a ghost load carried in), on 8, 4,
    2 and 1 shards of the card (8: two launches of LOCAL_GROUP_SHARDS
    shards a call; `meshes`: lists of devices instead), in every state of
    PRESSURE_LOCAL_STATES: the gathered buffer (cycle and candidate
    records), every shard's live rows and ghost load must be equal."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    rng = np.random.default_rng(20261024)
    n_pad, n_real, P, B = 16384, 15001, 16, 32
    vic = _rand_victims(rng, n_pad, P, device)
    nodes = _victim_nodes(rng, vic, n_pad, n_real, device)
    specs = []
    for j, (cpu, prio) in enumerate([(400, 9), (1200, 7), (2000, 5)]):
        d = _spec(cpu, j == 1, rng, n_pad, 1)
        d.update(req_mem=np.int64(GI), req_eph=np.int64(0),
                 upd_mem=np.int64(GI), upd_scalar=np.zeros(1, np.int64),
                 req_scalar=np.zeros(1, np.int64),
                 check_resources=np.bool_(True),
                 has_request=np.bool_(True), pprio=np.int64(prio))
        specs.append(d)
    specs.append(dict(specs[2], skip=np.bool_(True)))
    rows = np.concatenate([rng.integers(0, 3, B - 4), [3] * 4])
    stack = K.PodStack.from_specs(specs, rows, None, device)
    ghost = _random_ghost(rng, n_pad, device)
    checked = 0
    for devs in meshes or [[device] * d for d in (8, 4, 2, 1)]:
        mesh = S.Mesh(devs)
        srows = mesh.rows(n_pad)
        out = torch.empty((B, len(K.PRESSURE_HEAD) + P), dtype=torch.int32,
                          device=mesh.devices[0])
        scan, sides, plan, _steps = S._scan_window(
            mesh, S.shard_node_arrays(mesh, nodes), stack, 37, 5, n_real,
            n_real, 4, K.DEFAULT_WEIGHTS, None, None, None,
            (S._row_shards(mesh, {k: nodes[k] for k in K._MUTABLE}, srows,
                           K._MUTABLE), None), None, n_steps=B,
            pressure={"ghost": S._row_shards(mesh, ghost, srows,
                                             K.GHOST_FIELDS),
                      "vic": S.shard_victim_planes(mesh, vic), "P": P,
                      "out": out})
        for label, state in PRESSURE_LOCAL_STATES:
            runs = []
            for fn in (K.shard_pressure_local, K.shard_pressure_group_plain):
                sc, sd = _clone(scan), _clone(sides)
                where = {"first": (mesh.size - 1) * srows,
                         "last": srows - 1}
                for side in sd.values():
                    for slot, v in state.items():
                        side.st[getattr(K, slot)] = where.get(v, v)
                for d, group in S.device_groups(mesh, sc):
                    fn(group, sd[d], plan)
                runs.append([pressure_local_outputs((g, sd[d], plan), None)
                             for d, g in S.device_groups(mesh, sc)])
            err = max_abs_err(*runs)
            if err != 0:
                raise SystemExit(
                    f"shard_pressure_local on {mesh.size} shards, {label}: "
                    f"kernel disagrees with plain (max_abs_err {err}; first "
                    f"difference {first_diff(*runs)})")
            checked += 1
    sync()
    print(f"[variants] grouped K13a: {checked} comparisons equal (one "
          f"launch over every shard of a device, against the plain version "
          f"on {[len(m) for m in meshes] if meshes else [8, 4, 2, 1]} "
          f"shards, n_pad 16,384, n_real 15,001, P 16, ghost carried in: "
          f"{'; '.join(lbl for lbl, _st in PRESSURE_LOCAL_STATES)})")


N_MESH_SINGLE = 4               # mesh-preempt-single rounds
N_NOMINATED = 8                 # mesh-nominated-serial cycles


def pressure_local_outputs(a, _result):
    """What a grouped K13a launch writes (`a` its arguments: the device's
    shards, its replicated half, the plan): the device's gathered buffer
    (each shard's cycle and candidate records), each shard's live rows and
    ghost load."""
    from kubernetes_tpu_torch.ops import kernels as K
    shards, side = a[0], a[1]
    out = {"gathered": side.gathered}
    for sh in shards:
        out.update({f"{sh.index}/{k}": sh.nodes[k] for k in K._MUTABLE})
        out.update({f"{sh.index}/ghost/{k}": v for k, v in sh.ghost.items()})
    return out


def pressure_kernel_checks(calls, report, sync):
    """K13a/b, each on its first call of mesh-preempt-wave (step 0 of the
    first chunk: no fold owed, so repeated calls are idempotent apart from
    K13b's step state). K13a: its one launch over every shard of the first
    device (bound, `ms` and `device_ms` for them together)."""
    from kubernetes_tpu_torch.ops import kernels as K

    def no_reset(a, base):
        pass

    def reset_side(a, base):
        a[0].st.copy_(base[0].st)

    args, _kw = _full(calls["shard_pressure_local"])
    shards, side, plan = args
    rows = sum(sh.rows for sh in shards)
    mesh_kernel_entry(
        report, "shard_pressure_local", calls["shard_pressure_local"],
        no_reset, pressure_local_outputs,
        scan_local_bytes(shards, side, plan)
        + nbytes([sh.vic for sh in shards], [sh.ghost for sh in shards]),
        sync, 50, f"the wave's first step, one launch over the "
        f"{len(shards)} shard(s) of the first device (bound and device_ms "
        f"for them together)",
        ops=rows * (plan.vic_P * OPS_PER_SLOT + OPS_PER_NODE_CYCLE),
        on_device=True)
    report["shard_pressure_local"]["shards"] = len(shards)
    args, _kw = _full(calls["shard_pressure_select"])
    side, plan = args
    mesh_kernel_entry(
        report, "shard_pressure_select", calls["shard_pressure_select"],
        reset_side, lambda a, r: (a[0].st, a[0].packed),
        scan_select_bytes(side, plan), sync, 50,
        "the gathered records of the wave's first step",
        "; both times include the copy that restores the step state "
        "before each call; " + describe_geometry(
            *K.last_geometry["shard_pressure_select"], select=True),
        ops=plan.n_real * OPS_PER_NODE_CYCLE, on_device=True)
    report["shard_pressure_select"]["plan"] = plan_entry(
        "shard_pressure_select")


def mesh_wave_path(infos, tree, pdbs, device, sync, report, ref,
                   check_kernels=True, mesh=None):
    """mesh-preempt-wave: the preempt-wave world's wave through
    TorchScheduler(mesh=Mesh([device] * MESH_D)) (one step of K13a/K13b
    per pod, 8 chunks, one fetch), launches counted, held against the
    single-device K8 wave of the same call (`ref` = (run, every chunk's
    K8 result)): outcomes with their victims, walk counters, the folded
    rows, and per chunk the ghost load, li, lni and the packed block."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    name = "mesh-preempt-wave"
    single, single_chunks = ref
    wave = wave_pods()
    caps = [capture(k) for k in PRESSURE_MESH_KERNELS] if check_kernels \
        else []
    obs.reset()
    with contextlib.ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        with capture("pressure_batch", keep_all=True) as rec:
            run = run_wave(infos, tree, pdbs, wave, device, sync,
                           mesh=mesh)
    counts = K.launches()
    refusals = obs.family("refusal")
    fetches = obs.get("fetch.pressure_batch")
    if refusals or run["out"] is None:
        raise SystemExit(f"{name}: refused ({refusals})")
    missing = [k for k in PRESSURE_MESH_KERNELS if counts[k] == 0]
    if missing or fetches != 1:
        raise SystemExit(f"{name}: kernels not launched {missing}, "
                         f"{fetches} fetches")
    if outcome_names(run["out"]) != outcome_names(single["out"]) \
            or run["counters"] != single["counters"]:
        raise SystemExit(f"{name}: outcomes or counters differ from the "
                         f"single-device wave")
    same_rows(f"{name} folded rows", run["rows"], single["rows"])
    d0 = mesh.devices[0]
    if len(rec.all) != len(single_chunks):
        raise SystemExit(f"{name}: {len(rec.all)} chunks, single-device "
                         f"{len(single_chunks)}")
    for i, (got, want) in enumerate(zip(rec.all, single_chunks)):
        same_rows(f"{name} chunk {i} ghost, li, lni and packed block",
                  whole_wave(got, d0)[1:], whole_wave(want, d0)[1:])
    kinds = {}
    for o in run["out"]:
        key = o[0] if o[0] != "failed" else f"failed(any_cand={o[1]})"
        kinds[key] = kinds.get(key, 0) + 1
    for want in ("bound", "nominated", "failed(any_cand=True)"):
        if not kinds.get(want):
            raise SystemExit(f"{name}: no {want} outcome ({kinds})")
    ph = run["phases"]
    mesh_step_line(name, mesh, ph, counts, PRESSURE_MESH_KERNELS,
                   dispatch=ph["scan"] - ph["fetch"],
                   runs=-(-len(wave) // 128))
    print(f"[path] {name}: {len(infos)} nodes on {mesh.size} shards "
          f"({len(mesh.distinct)} distinct devices), {len(wave)} "
          f"preemptors in {-(-len(wave) // 128)} chunks and 1 fetch, "
          f"{len(wave) / run['t_wave']:.1f} preemptors/s "
          f"({run['t_wave'] * 1e3:.2f} ms: encode {ph['encode'] * 1e3:.2f} "
          f"scan {ph['scan'] * 1e3:.2f} of which fetch "
          f"{ph['fetch'] * 1e3:.2f}); steps {ph['steps']} gather_bytes "
          f"{ph['gather_bytes']} ({ph['scan'] * 1e3 / ph['steps']:.4f} ms "
          f"a step); prewarm {run['t_prewarm'] * 1e3:.1f} ms; outcomes "
          f"{kinds}; launches {counts}; single-device wave "
          f"{single['t_wave'] * 1e3:.2f} ms; outcomes, victims, counters, "
          f"rows and every chunk's ghost, li, lni and packed block equal")
    if check_kernels:
        pressure_kernel_checks({c.fn_name: c.call for c in caps}, report,
                               sync)
    add_launches(report, counts)


def preempt_scan_kernel_checks(calls, report, sync):
    """K14a/b, each on its first call of mesh-preempt-single. K14a: its
    one launch over every shard of the first device (bound, `ms` and
    `device_ms` for them together), held on the records it writes in
    place; K14b on that device's records, after their stamps."""
    import torch
    from kubernetes_tpu_torch.ops import kernels as K

    def no_reset(a, base):
        pass

    def records(a, _result):
        # the rows of the launch's shards in the call's half, in place
        return torch.stack([a[1].records(a[2])[sh.index] for sh in a[0]])
    args, _kw = _full(calls["shard_preempt_local"])
    shards, side, call = args
    chunk = K.cand_record_bytes(call.P)
    rows_read = [{k: sh.nodes[k] for k in K._PREEMPT_PTRS[:8]}
                 for sh in shards]
    mesh_kernel_entry(
        report, "shard_preempt_local", calls["shard_preempt_local"],
        no_reset, records,
        nbytes(rows_read, [sh.vic for sh in shards],
               [sh.feas for sh in shards], [sh.rank for sh in shards])
        + len(shards) * chunk, sync, 50,
        f"the first mesh-preempt-single round, one launch over the "
        f"{len(shards)} shard(s) of the first device (bound and device_ms "
        f"for them together)",
        "; " + describe_grid(K.last_geometry["shard_preempt_local"][0])
        + " a shard",
        ops=sum(sh.rows for sh in shards) * call.P * OPS_PER_SLOT,
        on_device=True)
    report["shard_preempt_local"]["shards"] = len(shards)
    args, _kw = _full(calls["shard_preempt_select"])
    side, call = args
    mesh_kernel_entry(
        report, "shard_preempt_select", calls["shard_preempt_select"],
        no_reset, lambda a, r: r, call.D * chunk + 4 * (3 + call.P), sync,
        50, "the records of the first mesh-preempt-single round, in place",
        on_device=True)


def mesh_single_path(infos, tree, pdbs, device, sync, report,
                     check_kernels=True, mesh=None, rounds=N_MESH_SINGLE):
    """mesh-preempt-single: `rounds` more rounds on the world preempt-single
    left, through TorchScheduler(mesh=Mesh([device] * MESH_D)): schedule
    raises FitError through K9a/K9b (its reasons held against a
    single-device schedule of the same state), preempt runs K14a once a
    device over its shards and K14b once a device, the records in place
    (no record copy under the "peer" exchange); each round's K14 block is
    held against the single-device K7 block of the same rows and planes
    (the shards gathered back), then the shell evicts the victims and
    binds the pod. The [path] line splits preempt's time into encode,
    dispatch (the scan less its fetch) and fetch, and fails unless K14a
    and K14b ran once a device and round with no record copy (and, on
    several cards, over the "peer" exchange)."""
    import torch
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Pod, Container
    from kubernetes_tpu_torch.oracle.generic_scheduler import FitError
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    name = "mesh-preempt-single"
    sched = make_sched(tree, device, 50, mesh=mesh)
    ref = make_sched(tree, device, 50)
    real = K.preemption_scan
    d0 = mesh.devices[0]

    def checked(nodes, vic, *args, **kw):
        out = real(nodes, vic, *args, **kw)
        whole = {k: v.to(d0) for k, v in cat_rows(nodes).items()}
        planes = {k: v.to(d0) for k, v in cat_rows(vic).items()}
        want = real(whole, planes, *args)
        if max_abs_err(out, want) != 0:
            raise SystemExit(f"{name}: K14 block differs from the "
                             f"single-device K7 block "
                             f"({first_diff(out, want)})")
        return out
    names = tree.list_names()
    caps = [capture(k) for k in PREEMPT_MESH_KERNELS] if check_kernels \
        else []
    t = time.perf_counter()
    sched.prewarm_preempt(infos, names, pdbs)
    sync()
    t_prewarm = time.perf_counter() - t
    obs.reset()
    t_pre = t_sched = 0.0
    phases = {"encode": 0.0, "scan": 0.0, "fetch": 0.0}
    evicted = 0
    K.preemption_scan = checked
    try:
        with contextlib.ExitStack() as stack:
            for c in caps:
                stack.enter_context(c)
            for r in range(rounds):
                pod = Pod(name=f"mesh-single-{r}", priority=100,
                          node_selector={"pool": "preempt"},
                          containers=(Container.make(
                              name="c", requests={"cpu": 1000}),))
                errs = []
                t0 = time.perf_counter()
                for s in (sched, ref):
                    try:
                        s.schedule(pod, infos, tree.list_names())
                        raise SystemExit(f"{name}: the pod was scheduled")
                    except FitError as e:
                        errs.append(e)
                    if s is sched:
                        t_sched += time.perf_counter() - t0
                if errs[0].failed_predicates != errs[1].failed_predicates:
                    raise SystemExit(f"{name} round {r}: FitError reasons "
                                     f"differ from the single-device cycle")
                t1 = time.perf_counter()
                res = sched.preempt(pod, infos, names, errs[0], pdbs)
                sync()
                t_pre += time.perf_counter() - t1
                for k in phases:
                    phases[k] += sched.last_preempt_phases[k]
                if res is None or res.node is None or not res.victims:
                    raise SystemExit(f"{name} round {r}: {res}")
                for v in res.victims:
                    infos[v.node_name].remove_pod(v)
                evicted += len(res.victims)
                assume(infos, pod, res.node.name)
    finally:
        K.preemption_scan = real
    counts = K.launches()
    refusals = obs.family("refusal")
    if refusals:
        raise SystemExit(f"{name}: refusals {refusals}")
    missing = [k for k in PREEMPT_MESH_KERNELS + UNIFORM_MESH_KERNELS[:2]
               if counts[k] == 0]
    if missing:
        raise SystemExit(f"{name}: kernels not launched on the path: "
                         f"{missing}")
    cycle_mesh_check(name, mesh, counts)
    # one K14a launch (its shards together) and one K14b a device and
    # round, the records in place
    want = rounds * len(mesh.distinct)
    copies = obs.get("copies.preempt")
    if [counts[k] for k in PREEMPT_MESH_KERNELS] != [want, want] \
            or mesh.exchange != "peer" or copies != 0:
        raise SystemExit(f"{name}: K14a / K14b launched "
                         f"{[counts[k] for k in PREEMPT_MESH_KERNELS]} "
                         f"times, {want} each wanted; {copies} record "
                         f"copies under the {mesh.exchange!r} exchange")
    dispatch = phases["scan"] - phases["fetch"]
    print(f"[path] {name}: {len(infos)} nodes on {mesh.size} shards "
          f"({len(mesh.distinct)} distinct devices, exchange "
          f"{mesh.exchange}), {rounds} rounds of "
          f"schedule (FitError through K9a/b) + preempt (K14a/b), "
          f"{rounds / t_pre:.1f} preemptions/s (preempt {t_pre * 1e3:.1f} "
          f"ms in all: encode {phases['encode'] * 1e3:.2f} dispatch "
          f"{dispatch * 1e3:.2f} fetch {phases['fetch'] * 1e3:.2f}; "
          f"schedule {t_sched * 1e3:.1f} ms in all); K14a launches "
          f"{counts['shard_preempt_local']} ({want // rounds} a round), "
          f"record copies {copies}; prewarm "
          f"{t_prewarm * 1e3:.1f} ms; gather.preempt "
          f"{obs.get('gather.preempt')} bytes; {evicted} victims evicted; "
          f"victim planes uploaded {obs.get('dispatch.vic_upload')} and "
          f"scattered {obs.get('dispatch.vic_scatter')} times; launches "
          f"{counts}; FitError reasons equal to the single-device cycle "
          f"and every K14 block equal to the single-device K7 block")
    if check_kernels:
        preempt_scan_kernel_checks({c.fn_name: c.call for c in caps},
                                   report, sync)
    # the single-device schedule and K7 calls that hold the mesh ones
    # are comparisons, not the path's launches
    add_launches(report, {k: counts[k] for k in PREEMPT_MESH_KERNELS
                          + UNIFORM_MESH_KERNELS[:2]})


def nominated_world(n_nodes):
    """bench.py's cluster with nominees: a 2-CPU pod of priority 100
    nominated on two nodes of every three, a 1-CPU one of priority 10 on
    every fifth; returns (infos, tree, the nominated-pod map)."""
    from kubernetes_tpu_torch.api.types import Pod, Container
    infos, tree = cluster(n_nodes)

    class Nominated:
        def __init__(self):
            self.by_node = {}

        def has_any(self):
            return bool(self.by_node)

        def pods_for_node(self, name):
            return list(self.by_node.get(name, ()))
    nom = Nominated()
    for i in range(n_nodes):
        for k, (cpu, prio, every) in enumerate(((2000, 100, 3),
                                                (1000, 10, 5))):
            if (k == 0 and i % every != 0) or (k == 1 and i % every == 0):
                nom.by_node.setdefault(f"node-{i}", []).append(Pod(
                    name=f"nominee-{k}-{i}", priority=prio,
                    nominated_node_name=f"node-{i}",
                    containers=(Container.make(
                        name="c", requests={"cpu": cpu}),)))
    return infos, tree, nom


def mesh_nominated_path(device, sync, mesh=None):
    """mesh-nominated-serial (C1): N_NOMINATED serial cycles with nominees
    present on 15,000 nodes, through TorchScheduler(nominated=...,
    mesh=Mesh([device] * MESH_D)) (K9a with each shard's slice of the
    ghost load, K9b), each held against the single-device K2 run with the
    same ghost (host, evaluated and feasible counts, scores, walk
    counters); pods of priority 50 (the 2-CPU nominees of priority 100
    hold two nodes of three), 200 (no nominee counts) and 10; the first
    K2 call with a ghost held against its plain version."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Pod, Container
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.parallel import sharding as S
    mesh = mesh or S.Mesh([device] * MESH_D)
    name = "mesh-nominated-serial"
    infos, tree, nom = nominated_world(N_NODES)
    sched = make_sched(tree, device, 50, mesh=mesh)
    sched.nominated = nom
    ref = make_sched(tree, device, 50)
    ref.nominated = nom
    obs.reset()
    t_mesh = t_single = 0.0
    hosts = []
    with capture("schedule_cycle") as one:
        for r in range(N_NOMINATED):
            prio = (50, 200, 10, 50)[r % 4]
            pod = Pod(name=f"nominated-serial-{r}", priority=prio,
                      containers=(Container.make(name="c", requests={
                          "cpu": 2500}),))
            names = tree.list_names()
            t0 = time.perf_counter()
            want = ref.schedule(pod, infos, names)
            sync()
            t1 = time.perf_counter()
            got = sched.schedule(pod, infos, names)
            sync()
            t_mesh += time.perf_counter() - t1
            t_single += t1 - t0
            a = (got.suggested_host, got.evaluated_nodes,
                 got.feasible_nodes, tuple(got.host_priority))
            b = (want.suggested_host, want.evaluated_nodes,
                 want.feasible_nodes, tuple(want.host_priority))
            if a != b or (sched.last_index, sched.last_node_index) != (
                    ref.last_index, ref.last_node_index):
                raise SystemExit(f"{name} cycle {r}: differs from the "
                                 f"single-device K2 run")
            hosts.append(got.suggested_host)
            assume(infos, pod, got.suggested_host)
    counts = K.launches()
    ghosts = obs.get("dispatch.cycle_ghost")
    # a pod of priority 200 outranks every nominee: no ghost counts
    want_ghosts = 2 * sum(1 for r in range(N_NOMINATED)
                          if (50, 200, 10, 50)[r % 4] <= 100)
    if ghosts != want_ghosts or counts["shard_cycle_local"] == 0 \
            or counts["schedule_cycle"] == 0:
        raise SystemExit(f"{name}: {ghosts} ghost cycles, launches "
                         f"{counts}")
    cycle_mesh_check(name, mesh, counts)
    nodes, args, kw = one.call
    gk = K.schedule_cycle(nodes, *args, **kw)
    gp = K.schedule_cycle_plain(nodes, *args, **kw)
    err = max_abs_err({k: gk[k] for k in CYCLE_KEYS},
                      {k: gp[k] for k in CYCLE_KEYS})
    if kw.get("ghost") is None or err != 0:
        raise SystemExit(f"{name}: K2 with a ghost disagrees with plain "
                         f"(max_abs_err {err})")
    blocked = sum(1 for h in hosts if int(h.split("-")[1]) % 3 != 0)
    print(f"[path] {name}: {N_NODES} nodes on {mesh.size} shards, "
          f"{N_NOMINATED} serial cycles with "
          f"{sum(len(v) for v in nom.by_node.values())} nominees, mesh "
          f"{t_mesh * 1e3:.1f} ms and single-device {t_single * 1e3:.1f} "
          f"ms in all; {blocked} pods bound on nodes a priority-100 "
          f"nominee holds; launches {counts}; every result and walk "
          f"counter equal to the single-device K2 run, K2 with the ghost "
          f"equal to plain (max_abs_err 0)")


def twin_phase(device, sync):
    """The serial cycle's host twin (C4) on a CUDA TorchScheduler: on
    nominated_world's 15,000 nodes plus a nominee with a host port, a pod
    of priority 50 counts it (the device ghost cannot express a host
    port: the twin decides), then a pod of priority 70 counts only the
    2-CPU nominees of priority 100 (resource-only: K2 with the ghost).
    Both cycles, with their walk counters, equal a device="cpu" run of
    the same sequence (the twin and the plain K2); prints the twin's
    count and host ms beside the K2 cycle's."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import (
        Container, ContainerPort, Pod)
    from kubernetes_tpu_torch.ops import kernels as K
    name = "twin"
    runs = {}
    for dev in (device, "cpu"):
        infos, tree, nom = nominated_world(N_NODES)
        nom.by_node.setdefault("node-7", []).append(Pod(
            name="nominee-port", priority=60,
            nominated_node_name="node-7",
            containers=(Container.make(
                name="c", requests={"cpu": 500},
                ports=(ContainerPort(host_port=8080,
                                     container_port=8080),)),)))
        sched = make_sched(tree, dev, 50)
        sched.nominated = nom
        obs.reset()
        out, ms = [], []
        for r, prio in enumerate((50, 70)):
            pod = Pod(name=f"twin-serial-{r}", priority=prio,
                      containers=(Container.make(name="c", requests={
                          "cpu": 2500}),))
            t0 = time.perf_counter()
            res = sched.schedule(pod, infos, tree.list_names())
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append((res.suggested_host, res.evaluated_nodes,
                        res.feasible_nodes, tuple(res.host_priority),
                        sched.last_index, sched.last_node_index))
            assume(infos, pod, res.suggested_host)
            if r == 0:
                twins = obs.family("twin")
        runs[str(dev)] = (out, ms, twins, K.launches(),
                          obs.get("dispatch.cycle_ghost"))
        obs.reset()
    out, ms, twins, counts, ghosts = runs[str(device)]
    cpu = runs["cpu"]
    if twins != {"nominated-ghosts": 1} or cpu[2] != twins:
        raise SystemExit(f"{name}: twin cycles {twins} (cpu run {cpu[2]}), "
                         f"not one nominated-ghosts cycle")
    if counts["schedule_cycle"] != 1 or ghosts != 1:
        raise SystemExit(f"{name}: K2 launches {counts['schedule_cycle']}, "
                         f"ghost cycles {ghosts}: the second cycle did not "
                         f"run on K2 with the ghost")
    if out != cpu[0]:
        raise SystemExit(f"{name}: the cycles differ from the device=\"cpu\" "
                         f"run: {out} vs {cpu[0]}")
    print(f"[twin] {N_NODES} nodes: 1 twin cycle (nominated-ghosts, a "
          f"nominee with a host port counted) in {ms[0]:.1f} ms of host "
          f"time, then 1 K2 cycle with the ghost in {ms[1]:.1f} ms; both "
          f"with their walk counters equal to the device=\"cpu\" run "
          f"(twin {cpu[1][0]:.1f} ms, plain K2 {cpu[1][1]:.1f} ms)")


#: the shell's commit window in the [commit] phase, and the window (0-based)
#: whose commit answers False in its abort run
COMMIT_WAVE, COMMIT_ABORT_AT = 1024, 2


def commit_run(cfg, n_nodes, device, sync, fail_at=None, stale=None):
    """One burst of the uniform (pct 100) or scan-default (pct 50) cell
    through schedule_burst(commit=), wave_size COMMIT_WAVE: the callback
    assumes each window's pods, as the shell's commit binds them, and
    answers False at window `fail_at`; `stale(call, decided)` is the
    shell's node-death scan when given. Returns the returned hosts, the
    windows (lo, hosts), each commit's host ms, the walk counters, the
    resident rows, and the StaleNodeRefusal if one was raised."""
    from kubernetes_tpu_torch.core import StaleNodeRefusal
    infos, tree = cluster(n_nodes)
    window = pods(N_PODS)
    sched = make_sched(tree, device, cfg["pct"])
    sched.wave_size = COMMIT_WAVE
    windows, ms, scans = [], [], []

    def commit(lo, hosts):
        t = time.perf_counter()
        part = window[lo: lo + len(hosts)]
        gens = [assume(infos, p, h) for p, h in zip(part, hosts)]
        sched.note_burst_assumed_many(part, hosts, gens)
        ms.append((time.perf_counter() - t) * 1e3)
        windows.append((lo, list(hosts)))
        return len(windows) - 1 != fail_at
    if stale is not None:
        def scan(decided, _names):
            scans.append(len(decided))
            return stale(len(scans), decided)
        sched.stale_scan = scan
    refusal = None
    try:
        hosts = sched.schedule_burst(window, infos, tree.list_names(),
                                     commit=commit)
    except StaleNodeRefusal as e:
        hosts, refusal = None, e
    sync()
    return {"hosts": hosts, "windows": windows, "ms": ms, "scans": scans,
            "counters": (sched.last_index, sched.last_node_index),
            "rows": mutable_rows(sched), "refusal": refusal}


def commit_phase(device, sync):
    """The shell's wave commit on the card: the 15,000-node uniform burst
    (K3) and the scan-default burst (K5, pct 50), each
    - without a commit callback (the reference; the scan's K5 block
      captured for its per-pod walk counters);
    - with one at wave_size 1,024: the windows must tile the reference's
      decisions in order, and the decisions, walk counters and resident
      rows must equal the reference's;
    - with one that answers False at the third window: the returned list
      is the reference's first three windows and a None tail, the
      resident folds are dropped, and the walk counters are the
      reference's at that prefix (the uniform burst's are also held
      against the same abort on the plain path);
    - with a stale_scan that reports a decided node: StaleNodeRefusal
      with that node and the count of decisions naming it, before any
      window commits, the folds dropped and the counters untouched.
    Prints the windows and the host ms a commit (the callback's assume
    loop) on a `[commit]` line."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    cells = (({"name": "uniform", "pct": 100}, "uniform_burst",
              "schedule_batch_uniform"),
             ({"name": "scan-default", "pct": 50}, "schedule_batch",
              "schedule_batch"))
    for cfg, kernel, entry in cells:
        name = f"commit {cfg['name']}"
        obs.reset()
        with capture(entry) as cap:
            ref = commit_run(cfg, N_NODES, device, sync)
        ref_hosts = ref["hosts"]
        obs.reset()
        run = commit_run(cfg, N_NODES, device, sync)
        counts = K.launches()
        if counts[kernel] == 0:
            raise SystemExit(f"{name}: {kernel} was not launched")
        no_k1_launch(name, counts)
        if None in ref_hosts or run["hosts"] != ref_hosts:
            raise SystemExit(f"{name}: decisions differ from the burst "
                             f"without commit")
        los = [lo for lo, _h in run["windows"]]
        if los != list(range(0, N_PODS, COMMIT_WAVE)) or [
                h for _lo, w in run["windows"] for h in w] != ref_hosts:
            raise SystemExit(f"{name}: the windows {los} do not tile the "
                             f"decisions")
        if run["counters"] != ref["counters"]:
            raise SystemExit(f"{name}: walk counters {run['counters']} vs "
                             f"{ref['counters']}")
        same_rows(name, run["rows"], ref["rows"])
        # the abort at the third window
        cut = COMMIT_WAVE * (COMMIT_ABORT_AT + 1)
        ab = commit_run(cfg, N_NODES, device, sync, fail_at=COMMIT_ABORT_AT)
        if ab["hosts"] != ref_hosts[:cut] + [None] * (N_PODS - cut) \
                or len(ab["windows"]) != COMMIT_ABORT_AT + 1 \
                or ab["rows"] is not None:
            raise SystemExit(f"{name}: the aborted burst's prefix, windows "
                             f"or folds differ")
        if kernel == "uniform_burst":
            # the uniform kernel never moves last_index, and its one
            # launch's lni advance stands
            want = ref["counters"]
            with plain_versions():
                plain = commit_run(cfg, N_NODES, device, sync,
                                   fail_at=COMMIT_ABORT_AT)
            if (plain["hosts"], plain["counters"]) != (ab["hosts"],
                                                       ab["counters"]):
                raise SystemExit(f"{name}: the abort differs from the "
                                 f"plain path's")
        else:
            packed = cap.last[4]["packed"].cpu().numpy()
            B = (len(packed)) // 3
            want = (int(packed[B + cut - 1]), int(packed[2 * B + cut - 1]))
        if ab["counters"] != want:
            raise SystemExit(f"{name}: counters after the abort "
                             f"{ab['counters']}, want {want}")
        # the node-death drill: a decided node vanishes
        dead = ref_hosts[5]
        st = commit_run(cfg, N_NODES, device, sync,
                        stale=lambda call, decided: {dead} & set(decided))
        e = st["refusal"]
        n_dead = ref_hosts[:st["scans"][0]].count(dead) if st["scans"] \
            else 0
        if e is None or e.dead != {dead} or e.n_stale != n_dead \
                or st["windows"] or st["rows"] is not None \
                or st["counters"] != (0, 0):
            raise SystemExit(f"{name}: the stale drill gave {e!r}, "
                             f"windows {len(st['windows'])}, counters "
                             f"{st['counters']}")
        ms = run["ms"]
        print(f"[commit] {cfg['name']}: {N_NODES} nodes, {N_PODS} pods in "
              f"{len(run['windows'])} windows of {COMMIT_WAVE} (last "
              f"{len(run['windows'][-1][1])}), host ms a commit (the "
              f"window's assume loop) mean {sum(ms) / len(ms):.3f} max "
              f"{max(ms):.3f}; decisions, counters and rows equal to the "
              f"burst without commit; abort at window "
              f"{COMMIT_ABORT_AT + 1}: {cut} delivered, counters "
              f"{ab['counters']}, folds dropped; stale drill: "
              f"StaleNodeRefusal of {e.n_stale} decisions on {dead}")


# ---------------------------------------------------------------------------
# The scheduler shell: bench.py's default cell from the store to the bind,
# the preempt-baseline world through the shell, and the device-fault drill
# ---------------------------------------------------------------------------
SHELL_WARMUP = 64       # bench.py's warm-up burst
SHELL_MAX_PODS = 10000  # bench.py's schedule_burst(max_pods=10000)
#: breaker faults the degrade drill injected (every other phase: none)
DRILL_FAULTS = {"n": 0}


def bench_store(n_nodes, n_extra=0, watch_log_size=None, scalar=None):
    """bench.py's run_bench store and build_cluster as the port's objects:
    nodes of 4 CPU, 32 Gi, 110 pods, zone i % 3, each also advertising
    `scalar` ({resource: count}) when given; the watch log holds
    `watch_log_size` events, by default room for twice the objects."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.store.store import Store, NODES
    store = Store(watch_log_size=watch_log_size
                  or max(65536, 2 * (n_nodes + n_extra)))
    for i in range(n_nodes):
        store.create(NODES, Node(
            name=f"node-{i}",
            labels={"failure-domain.beta.kubernetes.io/zone": f"zone-{i % 3}",
                    "failure-domain.beta.kubernetes.io/region": "r1",
                    "kubernetes.io/hostname": f"node-{i}"},
            allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110,
                         **(scalar or {})}))
    return store


def bench_pods(store, n_pods, start=0):
    """bench.py's make_pods: density pods of 100m / 500 Mi, named
    pod-<start + j>."""
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.store.store import PODS
    for j in range(start, start + n_pods):
        store.create(PODS, Pod(
            name=f"pod-{j}", labels={"app": "density"},
            containers=(Container.make(
                name="c", requests={"cpu": 100, "memory": 500 * MI}),)))


def breaker_faults():
    """Faults every breaker of the process booked (the breaker module's
    `tpu_device_faults_total`)."""
    from kubernetes_tpu_torch.core import breaker
    return int(sum(c.value for c in breaker.DEVICE_FAULTS._children.values()))


def no_degrade(phase):
    """Fail when a phase other than the degrade drill absorbed a device
    fault or ran with the circuit open."""
    from kubernetes_tpu_torch import obs
    got = {k: obs.get(k) for k in (
        "twin.device-fault", "twin.circuit-open", "refusal.device-fault",
        "refusal.circuit-open") if obs.get(k)}
    faults = breaker_faults() - DRILL_FAULTS["n"]
    if got or faults:
        raise SystemExit(f"{phase}: device faults degraded the path "
                         f"({got}, breaker faults {faults})")


def direct_bursts(n_nodes, bursts, device, sync):
    """The bursts straight through TorchScheduler.schedule_burst on a fresh
    snapshot (run_path's helpers: `cluster`, `assume`), each burst's
    placements assumed before the next; returns the hosts in order."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    infos, tree = cluster(n_nodes)
    sched = TorchScheduler(percentage_of_nodes_to_score=100,
                           node_tree=tree, device=device)
    out = []
    for burst in bursts:
        hosts = sched.schedule_burst(burst, infos, tree.list_names())
        if hosts is None or None in hosts:
            raise SystemExit("shell uniform: the direct burst left pods "
                             "unplaced")
        gens = [assume(infos, p, h) for p, h in zip(burst, hosts)]
        sched.note_burst_assumed_many(burst, hosts, gens)
        tree.advance_enumerations(len(burst) - 1)
        out.extend(hosts)
    sync()
    return out


def shell_uniform_cell(device, sync, n_nodes, n_pods, freeze_gc=False):
    """bench.py's default cell through the port's shell on `device`: the
    store, a 64-pod warm-up burst, `n_pods` pods created and pumped, then
    the measured loop, bench.py's schedule_burst(max_pods=10000) until 0,
    and a pump. The counts are zeroed just before the loop; with
    `freeze_gc` the cyclic GC is frozen over the loop, as in the serve
    cell (the set-up's objects are not scanned inside it). Returns the
    store, the scheduler, the pods bound, the loop's wall seconds, the
    launches and the set-up seconds."""
    import gc
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.scheduler import Scheduler
    t0 = time.perf_counter()
    store = bench_store(n_nodes, n_pods)
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      device=device)
    sched.sync()
    bench_pods(store, SHELL_WARMUP, start=10_000_000)
    sched.pump()
    while sched.schedule_burst(max_pods=SHELL_MAX_PODS):
        pass
    sched.pump()
    bench_pods(store, n_pods)
    sched.pump()
    sync()
    t_setup = time.perf_counter() - t0
    sched.metrics.reset()
    obs.reset()
    if freeze_gc:
        gc.collect()
        gc.freeze()
    bound = 0
    t0 = time.perf_counter()
    while True:
        n = sched.schedule_burst(max_pods=SHELL_MAX_PODS)
        if n == 0:
            break
        bound += n
    sync()
    wall = time.perf_counter() - t0
    if freeze_gc:
        gc.unfreeze()
        gc.collect()
    sched.pump()
    return {"store": store, "sched": sched, "bound": bound, "wall": wall,
            "counts": K.launches(), "setup_s": t_setup}


def shell_uniform(device, sync, report, n_nodes=N_NODES, n_pods=N_PODS):
    """bench.py's default cell through the port's shell (see the module
    docstring); the measured loop is bench.py's: schedule_burst(max_pods=
    10000) until 0, then a pump."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.store.store import PODS
    name = "shell uniform"
    r = shell_uniform_cell(device, sync, n_nodes, n_pods)
    store, sched, bound, wall = r["store"], r["sched"], r["bound"], r["wall"]
    counts, t_setup = r["counts"], r["setup_s"]
    twins, refusals = obs.family("twin"), obs.family("refusal")
    ph = dict(sched.algorithm.last_burst_phases or {})
    commit_ms = sched.metrics.phase_duration["binding"].sum * 1e3
    if counts["uniform_burst"] == 0:
        raise SystemExit(f"{name}: K3 uniform_burst was not launched")
    if twins or refusals:
        raise SystemExit(f"{name}: twin cycles {twins}, refusals "
                         f"{refusals}")
    no_degrade(name)
    if sched.algorithm.breaker.faults_total:
        raise SystemExit(f"{name}: breaker faults "
                         f"{sched.algorithm.breaker.debug_state()}")
    by_name = {p.name: p.node_name for p in store.list(PODS)[0]}
    got = [by_name[f"pod-{10_000_000 + j}"] for j in range(SHELL_WARMUP)] \
        + [by_name[f"pod-{j}"] for j in range(n_pods)]
    if bound != n_pods or not all(got):
        raise SystemExit(f"{name}: {bound} of {n_pods} bound, "
                         f"{sum(1 for h in got if not h)} pods without a "
                         f"node in the store")
    t1 = time.perf_counter()
    want = direct_bursts(n_nodes, [pods(SHELL_WARMUP), pods(n_pods)],
                         device, sync)
    t_direct = time.perf_counter() - t1
    if got != want:
        diff = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise SystemExit(f"{name}: pod {diff} bound on {got[diff]}, the "
                         f"direct burst places it on {want[diff]}")
    add_launches(report, counts)
    alg = {k: v.sum * 1e3 for k, v in sched.metrics.phase_duration.items()}
    print(f"[shell] uniform: {n_nodes} nodes, {n_pods} pods bound through "
          f"the store in {wall * 1e3:.1f} ms ({n_pods / wall:.1f} pods/s; "
          f"store, informers, queue, cache, TorchScheduler, commit_wave); "
          f"last burst: encode {ph['encode'] * 1e3:.2f} (node mirror "
          f"{ph['mirror'] * 1e3:.2f}) dispatch {ph['dispatch'] * 1e3:.2f} "
          f"fetch {ph['fetch'] * 1e3:.2f} ms; shell commit "
          f"{commit_ms:.1f} ms; phase sums ms "
          f"{ {k: round(v, 2) for k, v in sorted(alg.items())} }; "
          f"launches {dict(counts)}; set-up (store, {SHELL_WARMUP}-pod warm-up, "
          f"pods created and pumped) {t_setup:.1f} s; hosts equal to the "
          f"direct TorchScheduler bursts ({t_direct * 1e3:.1f} ms)")


def shell_baseline_run(device, sync, n_nodes, n_preemptors,
                       extender_fn=None, trickle=False):
    """The preempt-baseline world through the shell on `device`: rounds of
    pump, schedule_burst(max_pods=128), pump and 2 s of a fake clock until
    three rounds in a row bind nothing; `extender_fn(store)`, when given,
    returns the shell's extenders. With `trickle` the preemptors arrive
    one at a time, each followed by its rounds. Returns the outcome, the
    wall seconds of the rounds and the scheduler."""
    from kubernetes_tpu_torch.api.types import Container, Node, Pod
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store.store import NODES, PODS, Store
    from kubernetes_tpu_torch.utils.clock import FakeClock
    store = Store(watch_log_size=65536)
    created = []
    for i in range(n_nodes):
        store.create(NODES, Node(name=f"node-{i}", allocatable={
            "cpu": 4000, "memory": 32 * GI, "pods": 110}))
        for k in range(10):
            store.create(PODS, Pod(
                name=f"victim-{i * 10 + k}", priority=1,
                node_name=f"node-{i}", containers=(Container.make(
                    name="c", requests={"cpu": 400}),)))
            created.append(f"default/victim-{i * 10 + k}")
    clock = FakeClock(100.0)
    sched = Scheduler(store, clock=clock, percentage_of_nodes_to_score=100,
                      device=device,
                      extenders=extender_fn(store) if extender_fn else None)
    # the shell's metrics run on the fake clock: its commits (the burst
    # waves' and the serial binds') are timed here on the host's
    commit_s = [0.0]

    def timed_commit(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                commit_s[0] += time.perf_counter() - t
        return call
    sched._commit_burst = timed_commit(sched._commit_burst)
    sched._bind = timed_commit(sched._bind)
    sched.sync()

    def rounds():
        idle = 0
        for _ in range(40):
            sched.pump()
            before = sched.metrics.schedule_attempts["scheduled"]
            while sched.schedule_burst(max_pods=128):
                pass
            sched.pump()
            idle = 0 if sched.metrics.schedule_attempts["scheduled"] \
                > before else idle + 1
            if idle >= 3:
                break
            clock.step(2.0)
    t0 = time.perf_counter()
    for k in range(n_preemptors):
        store.create(PODS, Pod(name=f"hi-{k}", priority=10, containers=(
            Container.make(name="c", requests={"cpu": 400}),)))
        created.append(f"default/hi-{k}")
        if trickle:
            rounds()
    if not trickle:
        rounds()
    sync()
    wall = time.perf_counter() - t0
    listed = store.list(PODS)[0]
    present = {p.key for p in listed}
    out = {"bindings": sorted((p.key, p.node_name) for p in listed),
           "nominations": sorted((p.key, p.nominated_node_name)
                                 for p in listed if p.nominated_node_name),
           "evictions": sorted(k for k in created if k not in present)}
    return out, wall, sched, commit_s[0]


def shell_preempt_baseline(device, sync, report, n_nodes=1000,
                           n_preemptors=128):
    """BASELINE.json configs[3] through the port's shell (see the module
    docstring), held against the same shell on device="cpu"."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    name = "shell preempt-baseline"
    obs.reset()
    run, wall, sched, commit_s = shell_baseline_run(device, sync, n_nodes,
                                                    n_preemptors)
    counts = K.launches()
    twins = obs.family("twin")
    refusals = obs.family("refusal")
    no_degrade(name)
    pre = dict(sched.algorithm.last_preempt_phases or {})
    sums = {k: round(sched.metrics.phase_duration[k].sum * 1e3, 2)
            for k in ("encode", "kernel", "fetch")
            if k in sched.metrics.phase_duration}
    if counts["pressure_batch"] == 0:
        raise SystemExit(f"{name}: K8 pressure_batch was not launched "
                         f"({counts}, refusals {refusals})")
    if counts["schedule_cycle"] == 0:
        raise SystemExit(f"{name}: the shell's serial cycles did not run "
                         f"on K2 ({counts})")
    obs.reset()
    ref, wall_cpu, _, _ = shell_baseline_run("cpu", sync, n_nodes,
                                             n_preemptors)
    ref_twins = obs.family("twin")
    obs.reset()
    if twins or ref_twins:
        raise SystemExit(f"{name}: twin cycles {twins} (cpu run "
                         f"{ref_twins})")
    for key in ("bindings", "nominations", "evictions"):
        if run[key] != ref[key]:
            diff = [a for a in run[key] if a not in ref[key]][:4]
            raise SystemExit(f"{name}: {key} differ from the device=\"cpu\" "
                             f"shell: {diff}")
    bound_hi = sum(1 for k, h in run["bindings"] if h and "/hi-" in k)
    if bound_hi != n_preemptors or len(run["evictions"]) != n_preemptors:
        raise SystemExit(f"{name}: {bound_hi} preemptors bound, "
                         f"{len(run['evictions'])} victims evicted")
    add_launches(report, counts)
    print(f"[shell] preempt-baseline: {n_nodes} nodes x 10 victims, "
          f"{n_preemptors} preemptors bound after {len(run['evictions'])} "
          f"evictions in {wall * 1e3:.1f} ms of rounds "
          f"({n_preemptors / wall:.1f} preemptors/s; the pressure wave: "
          f"encode {pre.get('encode', 0) * 1e3:.2f} scan "
          f"{pre.get('scan', 0) * 1e3:.2f} of which fetch "
          f"{pre.get('fetch', 0) * 1e3:.2f} ms); bursts' phase sums ms "
          f"{sums}; shell commit {commit_s * 1e3:.1f} ms (the burst "
          f"waves' and the serial binds'); launches {dict(counts)}; "
          f"refusals {refusals}; "
          f"bindings, nominations and evictions equal to the device=\"cpu\" "
          f"shell ({wall_cpu * 1e3:.1f} ms)")


# ---------------------------------------------------------------------------
# serving: the continuously-fed scheduler and the active-active fleet
# ---------------------------------------------------------------------------
#: the serve cell (`kubernetes_tpu/perf/harness.py` run_serve_cell) at the
#: repo's serve acceptance width; its 30 s of arrivals cut to 10
SERVE_CELL = {"nodes": 1000, "rate": 2000.0, "seconds": 10.0,
              "window": 2048, "depth": 3, "parity_windows": 3,
              "parity_pods": 256}
#: the fleet cell (run_fleet_cell): 2 instances on threads of their own,
#: 8 shards; its 20 s of arrivals cut to 10
FLEET_CELL = {"nodes": 1000, "instances": 2, "shards": 8, "rate": 4000.0,
              "seconds": 10.0, "window": 2048, "depth": 3}
#: the recorded fleet run: 3 instances on a fake clock, one killed
FLEET_RECORDED = {"nodes": 64, "instances": 3, "rounds": 8, "kill_round": 3,
                  "window": 32, "seed": 5}


class Reaper:
    """The cells' completion reaper: a watch collects binds of the pods
    named `prefix*` in commit order, and past `target` resident the
    oldest are deleted in one batch (the workload finishing)."""

    def __init__(self, store, prefix, target):
        from kubernetes_tpu_torch.store.store import PODS
        self.store, self.prefix, self.target = store, prefix, target
        self.watch = store.watch(PODS)
        self.fifo, self.seen, self.reaped = [], set(), 0

    def __call__(self):
        from kubernetes_tpu_torch.store.store import (MODIFIED, PODS,
                                                      ExpiredError)
        try:
            events = self.watch.drain()
        except ExpiredError:
            events = []
            self.fifo.clear()
            self.seen.clear()
            for p in self.store.list(PODS)[0]:
                if p.node_name and p.name.startswith(self.prefix):
                    self.fifo.append(p.key)
                    self.seen.add(p.key)
        for ev in events:
            if ev.type == MODIFIED and ev.obj.node_name \
                    and ev.obj.name.startswith(self.prefix) \
                    and ev.obj.key not in self.seen:
                self.fifo.append(ev.obj.key)
                self.seen.add(ev.obj.key)
        if len(self.fifo) > self.target:
            cut = len(self.fifo) - self.target
            batch, self.fifo = self.fifo[:cut], self.fifo[cut:]
            self.reaped += len(self.store.delete_many(PODS, batch))

    def stop(self):
        self.watch.stop()


def audit_arrivals(name, store, gen, reaped):
    """All admitted or 429'd: every created arrival is in the store bound
    or was reaped, and every attempt was created, given up or is still
    waiting for its retry."""
    from kubernetes_tpu_torch.store.store import PODS
    g = gen.stats()
    measured = [p for p in store.list(PODS)[0]
                if p.name.startswith(gen.name_prefix)]
    unbound = sum(1 for p in measured if not p.node_name)
    if len(measured) + reaped != g["created"] or unbound \
            or g["attempted"] != g["created"] + g["gave_up"] \
            + g["pending_retry"]:
        raise SystemExit(f"{name}: arrival audit failed: {len(measured)} "
                         f"in the store ({unbound} unbound) + {reaped} "
                         f"reaped against {g}")
    return g


def serve_cell(device, sync, nodes, rate, seconds, window, depth,
               parity_windows, parity_pods, seed=0):
    """run_serve_cell on the port: an ArrivalGenerator feeds pods at
    `rate`/s for `seconds` while a ServeLoop (`window`, launch queue
    `depth`) cuts windows from the live activeQ of the port's shell on
    `device`, a BackpressureGate sheds past max(4 x window, 2 x rate)
    with Retry-After 0.25 s, a reaper deletes the oldest bound arrivals
    past half the cell's pod capacity, and the cyclic GC is frozen over
    the timed window. Then the drain, the all-admitted-or-429'd audit,
    and `parity_windows` windows of fresh arrivals recorded in replay
    mode, each replayed through the port's oracle."""
    import gc
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.obs import flight
    from kubernetes_tpu_torch.obs.ledger import LEDGER
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.serve import ArrivalGenerator, ServeLoop
    name = "serve"
    t_setup = time.perf_counter()
    store = bench_store(nodes)
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      device=device)
    sched.sync()
    loop = ServeLoop(sched, window_size=window, depth=depth)
    warm = ArrivalGenerator(store, rate=10 ** 9, total=64,
                            name_prefix="warm-", seed=seed)
    warm.tick()
    warm.tick()
    loop.drain(timeout=30.0)
    gate = loop.attach_gate(max_depth=max(4 * window, int(2 * rate)),
                            retry_after_base=0.25)
    LEDGER.reset()
    gen = ArrivalGenerator(store, rate=rate, seed=seed)
    reap = Reaper(store, gen.name_prefix,
                  max(4 * window, nodes * min(110, 4000 // 100) // 2))
    sync()
    t_setup = time.perf_counter() - t_setup
    gc.collect()
    gc.freeze()
    thresholds = gc.get_threshold()
    gc.set_threshold(thresholds[0], thresholds[1], 1 << 16)
    obs.reset()
    sched.algorithm.inflight_peak = 0
    bound0, windows0, idle0 = loop.pods_bound, loop.windows_cut, \
        loop.idle_ticks
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        reap()
        gen.tick()
        if loop.step() == 0:
            time.sleep(min(loop.tick_interval, 0.001))
    sync()
    elapsed = time.perf_counter() - t0
    counts = K.launches()
    peak = sched.algorithm.inflight_peak
    twins, refusals = obs.family("twin"), obs.family("refusal")
    sustained = (loop.pods_bound - bound0) / elapsed
    windows = loop.windows_cut - windows0
    idle = loop.idle_ticks - idle0
    t_drain = time.perf_counter()
    deadline = t_drain + 30.0
    while time.perf_counter() < deadline:
        gen.flush_retries(timeout=0.5)
        reap()
        if loop.step() == 0 and gen.stats()["pending_retry"] == 0 \
                and sched.queue.num_pending() == 0:
            break
    t_drain = time.perf_counter() - t_drain
    reap.stop()
    gc.set_threshold(*thresholds)
    gc.unfreeze()
    gc.collect()
    g = audit_arrivals(name, store, gen, reap.reaped)
    led = LEDGER.snapshot()
    t_par = time.perf_counter()
    flight.RECORDER.configure(mode="replay", capacity=parity_windows)
    flight.RECORDER.clear()
    par = ArrivalGenerator(store, rate=10 ** 9, total=parity_pods,
                           name_prefix="par-", seed=seed + 1)
    try:
        while not par.finished():
            par.tick()
            loop.step()
        loop.drain(timeout=30.0)
        records = flight.RECORDER.records()
        violations = flight.RECORDER.replay_all()
    finally:
        flight.RECORDER.configure(mode="digest")
        flight.RECORDER.clear()
    t_par = time.perf_counter() - t_par
    if not records or any(r.capture is None for r in records):
        raise SystemExit(f"{name}: the parity windows left no replay "
                         f"record")
    if violations:
        raise SystemExit(f"{name}: replay violations {violations[:3]}")
    return {"store": store, "sched": sched, "loop": loop, "gate": gate,
            "arrivals": g, "elapsed": elapsed, "sustained": sustained,
            "windows": windows, "idle": idle, "peak": peak,
            "counts": counts, "twins": twins, "refusals": refusals,
            "ledger": led, "reaped": reap.reaped, "records": len(records),
            "setup_s": t_setup, "drain_s": t_drain, "parity_s": t_par}


def serve_phase(device, sync, report):
    """`[serve]`: the serve cell at 1,000 nodes x 2,000 arrivals/s for
    10 s on the card; fails on an audit miss, a replay violation, a twin
    or refusal count, a breaker fault, or no K3 launch."""
    c = SERVE_CELL
    r = serve_cell(device, sync, c["nodes"], c["rate"], c["seconds"],
                   c["window"], c["depth"], c["parity_windows"],
                   c["parity_pods"])
    name = "serve"
    if r["counts"]["uniform_burst"] == 0:
        raise SystemExit(f"{name}: K3 uniform_burst was not launched "
                         f"({r['counts']})")
    if r["twins"] or r["refusals"]:
        raise SystemExit(f"{name}: twin cycles {r['twins']}, refusals "
                         f"{r['refusals']}")
    no_degrade(name)
    if r["sched"].algorithm.breaker.faults_total:
        raise SystemExit(f"{name}: breaker faults "
                         f"{r['sched'].algorithm.breaker.debug_state()}")
    add_launches(report, r["counts"])
    led, g = r["ledger"], r["arrivals"]
    print(f"[serve] {c['nodes']} nodes, {c['rate']:.0f} arrivals/s for "
          f"{r['elapsed']:.2f} s (window {c['window']}, depth "
          f"{c['depth']}): sustained {r['sustained']:.1f} pods/s; startup "
          f"p50 {led['startup_p50'] * 1e3:.2f} ms, p99 "
          f"{led['startup_p99'] * 1e3:.2f} ms (SLO 5 s: "
          f"{'ok' if led['startup_slo_ok'] else 'missed'}; "
          f"{led['pods_completed']} pods); windows cut {r['windows']}, "
          f"idle ticks {r['idle']}, most launches in flight {r['peak']}; "
          f"sheds {r['gate'].rejected} (arrivals {g}); reaped "
          f"{r['reaped']}; launches in the timed window "
          f"{ {k: v for k, v in r['counts'].items() if v} }; every "
          f"admitted arrival bound; {r['records']} parity windows replayed "
          f"through the oracle with 0 violations; set-up "
          f"{r['setup_s']:.1f} s, drain {r['drain_s']:.2f} s, parity "
          f"{r['parity_s']:.1f} s")


def fleet_cell(device, sync, nodes, instances, shards, rate, seconds,
               window, depth, seed=0):
    """run_fleet_cell on the port: `instances` FleetInstances of the
    port's shell on `device`, each on a thread of its own, over one store
    (8 shards, one fleet gate), namespace-spread arrivals at `rate`/s for
    `seconds`, the reaper; audits: no double bind (BindAuditor), every
    arrival admitted and bound or 429'd, claims disjoint at every probe.
    An error on a drive thread stops the run."""
    import threading
    import zlib
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.fleet import (BIND_CONFLICTS, BindAuditor,
                                            FleetInstance)
    from kubernetes_tpu_torch.obs.ledger import LEDGER
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.serve import ArrivalGenerator, fleet_gate
    from kubernetes_tpu_torch.store.store import PODS
    name = "fleet cell"
    t_setup = time.perf_counter()
    store = bench_store(nodes, watch_log_size=1 << 17)
    idents = [f"sched-{i}" for i in range(instances)]
    fleet = [FleetInstance(store, ident, idents, device=device,
                           window=window, depth=depth, n_shards=shards,
                           lease_duration=5.0, renew_deadline=3.0,
                           percentage_of_nodes_to_score=100)
             for ident in idents]
    for inst in fleet:
        inst.sync()

    def mkpod(pod_name):
        ns = f"ns-{zlib.crc32(pod_name.encode()) % (4 * shards)}"
        return Pod(name=pod_name, namespace=ns, labels={"app": "fleet"},
                   containers=(Container.make(
                       name="c", requests={"cpu": 100, "memory": 500 * MI}),))

    def idle():
        return all(inst.sched.queue.num_pending() == 0
                   and inst.sched.informers.informer(PODS).backlog() == 0
                   for inst in fleet)

    warm = ArrivalGenerator(store, rate=10 ** 9, total=32 * instances,
                            pod_fn=mkpod, name_prefix="flwarm-", seed=seed)
    for _ in range(3):
        warm.tick()
        for inst in fleet:
            inst.step()
    deadline = time.perf_counter() + 60.0
    while time.perf_counter() < deadline:
        if sum(inst.step() for inst in fleet) == 0 and idle():
            break
    auditor = BindAuditor(store)
    store.admission_gate = fleet_gate([inst.loop for inst in fleet],
                                      max_depth=max(4 * window,
                                                    int(2 * rate)))
    LEDGER.reset()
    gen = ArrivalGenerator(store, rate=rate, pod_fn=mkpod,
                           name_prefix="fl-", seed=seed)
    reap = Reaper(store, "fl-",
                  max(4 * window, nodes * min(110, 4000 // 100) // 2))
    stop = threading.Event()
    errors = []

    def drive(inst):
        try:
            while not stop.is_set():
                if inst.step() == 0:
                    time.sleep(0.001)
        except BaseException as e:    # re-raised on the main thread below
            errors.append((inst.identity, e))
            stop.set()

    threads = [threading.Thread(target=drive, args=(inst,), daemon=True,
                                name=f"fleet-{inst.identity}")
               for inst in fleet]
    sync()
    t_setup = time.perf_counter() - t_setup
    obs.reset()
    conflicts0 = {k: BIND_CONFLICTS.labels(k).value
                  for k in ("requeued", "fenced")}
    bound0 = sum(inst.loop.pods_bound for inst in fleet)
    overlap = False
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    t_end = t0 + seconds
    while time.perf_counter() < t_end and not stop.is_set():
        reap()
        gen.tick()
        auditor.scan()
        seen: set = set()
        for inst in fleet:
            owned = inst.claims.owned()
            overlap |= bool(owned & seen)
            seen |= owned
        time.sleep(0.002)
    elapsed = time.perf_counter() - t0
    aggregate = (sum(inst.loop.pods_bound for inst in fleet) - bound0) \
        / elapsed
    t_settle = time.perf_counter()
    polls = 0
    while time.perf_counter() < t_settle + 30.0 and not stop.is_set():
        gen.flush_retries(timeout=0.2)
        reap()
        auditor.scan()
        if gen.stats()["pending_retry"] == 0 and idle():
            polls += 1
            if polls >= 3:
                break
        else:
            polls = 0
        time.sleep(0.05)
    stop.set()
    for th in threads:
        th.join(timeout=30.0)
    if errors:
        ident, err = errors[0]
        raise RuntimeError(f"{name}: instance {ident} failed") from err
    if any(th.is_alive() for th in threads):
        raise SystemExit(f"{name}: a drive thread did not stop")
    deadline = time.perf_counter() + 30.0
    while not idle() and time.perf_counter() < deadline:
        reap()
        for inst in fleet:
            inst.step()
    sync()
    t_settle = time.perf_counter() - t_settle
    counts = K.launches()
    auditor.scan()
    reap.stop()
    auditor.stop()
    g = audit_arrivals(name, store, gen, reap.reaped)
    if auditor.violations:
        raise SystemExit(f"{name}: double binds {auditor.violations[:5]}")
    if overlap:
        raise SystemExit(f"{name}: live shard claims overlapped")
    return {"fleet": fleet, "arrivals": g, "elapsed": elapsed,
            "aggregate": aggregate, "counts": counts,
            "twins": obs.family("twin"), "refusals": obs.family("refusal"),
            "ledger": LEDGER.snapshot(), "reaped": reap.reaped,
            "conflicts": {k: BIND_CONFLICTS.labels(k).value - v
                          for k, v in conflicts0.items()},
            "setup_s": t_setup, "settle_s": t_settle}


def fleet_recorded(device, sync, nodes, instances, rounds, kill_round,
                   window, seed):
    """A FleetManager(record=True) run on a fake clock: `instances`
    FleetInstances on `device` round-robin over one store, seeded mixed
    arrivals (run_fleet_trial's classes: plain, a hostname selector, a
    toleration, a priority) over namespaces, one instance killed at
    `kill_round`, then rounds until every pod is bound; no double bind,
    claims disjoint after every round; then `replay_instance` of every
    survivor on `device` must give its recorded bind stream bit for bit.
    Returns (manager, replay reports by instance)."""
    import random
    from kubernetes_tpu_torch.api.types import Container, Pod, Toleration
    from kubernetes_tpu_torch.fleet import (DEFAULT_SHARDS, FleetInstance,
                                            FleetManager, ScriptedClaims,
                                            replay_instance)
    from kubernetes_tpu_torch.store.store import PODS
    from kubernetes_tpu_torch.utils.clock import FakeClock
    name = "fleet recorded"
    rng = random.Random(seed)
    clock = FakeClock(100.0)
    store = bench_store(nodes, watch_log_size=1 << 17)
    idents = [f"i{k}" for k in range(instances)]
    kw = dict(window=window, depth=2, percentage_of_nodes_to_score=100,
              disable_preemption=True, device=device)

    def mk(ident):
        return FleetInstance(store, ident, idents, clock=clock, **kw)

    mgr = FleetManager(store, idents, mk, clock=clock, record=True)
    victim = idents[rng.randrange(instances)]
    j = 0
    for r in range(rounds):
        pods = []
        for _ in range(rng.randint(24, 48)):
            cls = rng.choice(["plain", "plain", "selector", "tolerate",
                              "prio"])
            extra = {"labels": {"app": cls}}
            if cls == "selector":
                extra["node_selector"] = {
                    "kubernetes.io/hostname": f"node-{rng.randrange(nodes)}"}
            elif cls == "tolerate":
                extra["tolerations"] = (Toleration(key="k", op="Exists"),)
            elif cls == "prio":
                extra["priority"] = rng.randint(1, 3)
            pods.append(Pod(
                name=f"p{j}", namespace=f"ns-{j % (3 * instances)}",
                uid=f"p{j}-uid", creation_timestamp=clock.now(),
                containers=(Container.make(name="c", requests={
                    "cpu": rng.choice([100, 300])}),), **extra))
            j += 1
        mgr.create_pods(pods)
        if r == kill_round:
            mgr.kill(victim)
        mgr.step_all()
        if not mgr.owned_disjoint():
            raise SystemExit(f"{name}: claims overlap after round {r}")
        mgr.advance_clock(rng.choice([1.0, 1.5, 2.0]))
    for _ in range(24):
        mgr.step_all()
        mgr.advance_clock(1.5)
        if all(p.node_name for p in store.list(PODS)[0]):
            break
    mgr.auditor.scan()
    unbound = [p.key for p in store.list(PODS)[0] if not p.node_name]
    if unbound or mgr.auditor.violations or not mgr.owned_disjoint():
        raise SystemExit(f"{name}: {len(unbound)} unbound, double binds "
                         f"{mgr.auditor.violations[:3]}")
    reports = {}
    for ident in idents:
        if ident == victim:
            continue

        def mk_solo(st, ck, _ident=ident):
            return FleetInstance(
                st, _ident, idents, clock=ck,
                claims=ScriptedClaims("default-scheduler", DEFAULT_SHARDS),
                **kw)
        rep = replay_instance(mgr.timeline, ident, mk_solo)
        if rep["mismatches"] or rep["replay_double_binds"] \
                or rep["compared"] == 0:
            raise SystemExit(f"{name}: {ident} replays with "
                             f"{rep['mismatches'][:2]} (double binds "
                             f"{rep['replay_double_binds'][:2]}, "
                             f"{rep['compared']} steps compared)")
        reports[ident] = rep
    sync()
    return mgr, victim, reports


def fleet_phase(device, sync, report):
    """`[fleet]`: (a) the fleet cell, 2 threaded instances on the card;
    (b) the recorded 3-instance run with a kill, each survivor replayed
    on the card bit for bit. The cell's windows are scan windows (its
    pods' namespaces differ, and a namespace is part of a pod's class
    signature, as in the JAX package). Fails on an audit miss, a double
    bind, a replay mismatch, a twin or refusal count, a breaker fault, or
    no K5 launch in (a)."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    c = FLEET_CELL
    r = fleet_cell(device, sync, c["nodes"], c["instances"], c["shards"],
                   c["rate"], c["seconds"], c["window"], c["depth"])
    name = "fleet"
    if r["counts"]["schedule_batch"] == 0:
        raise SystemExit(f"{name}: K5 schedule_batch was not launched "
                         f"({r['counts']})")
    if r["twins"] or r["refusals"]:
        raise SystemExit(f"{name}: twin cycles {r['twins']}, refusals "
                         f"{r['refusals']}")
    no_degrade(name)
    for inst in r["fleet"]:
        if inst.sched.algorithm.breaker.faults_total:
            raise SystemExit(f"{name}: breaker faults on {inst.identity}")
    add_launches(report, r["counts"])
    led, g = r["ledger"], r["arrivals"]
    print(f"[fleet] cell: {c['instances']} instances on threads of their "
          f"own on one card, {c['nodes']} nodes, {c['shards']} shards, "
          f"{c['rate']:.0f} arrivals/s for {r['elapsed']:.2f} s: aggregate "
          f"{r['aggregate']:.1f} pods/s (bound "
          f"{ {i.identity: i.loop.pods_bound for i in r['fleet']} }); "
          f"startup p50 {led['startup_p50'] * 1e3:.2f} ms, p99 "
          f"{led['startup_p99'] * 1e3:.2f} ms; double binds 0, claims "
          f"disjoint at every probe, fenced waves "
          f"{sum(i.sched.fenced_waves for i in r['fleet'])}, bind "
          f"conflicts {r['conflicts']}; arrivals {g}, reaped {r['reaped']}; "
          f"launches {({k: v for k, v in r['counts'].items() if v})}; "
          f"set-up {r['setup_s']:.1f} s, settle {r['settle_s']:.2f} s")
    obs.reset()
    t0 = time.perf_counter()
    d = FLEET_RECORDED
    mgr, victim, reps = fleet_recorded(device, sync, d["nodes"],
                                       d["instances"], d["rounds"],
                                       d["kill_round"], d["window"],
                                       d["seed"])
    wall = time.perf_counter() - t0
    counts = K.launches()
    twins, refusals = obs.family("twin"), obs.family("refusal")
    if twins or refusals:
        raise SystemExit(f"{name} recorded: twin cycles {twins}, refusals "
                         f"{refusals}")
    no_degrade(name)
    if not any(counts.values()):
        raise SystemExit(f"{name} recorded: no kernel launched")
    add_launches(report, counts)
    steps = sum(1 for e in mgr.timeline if e["op"] == "step")
    print(f"[fleet] recorded: {d['instances']} instances on a fake clock, "
          f"{d['nodes']} nodes, {steps} steps, {victim} killed at round "
          f"{d['kill_round']}; every pod bound, double binds 0; survivors "
          f"replayed on the card bit for bit "
          f"{ {i: rep['compared'] for i, rep in reps.items()} } steps "
          f"compared; launches {({k: v for k, v in counts.items() if v})}; "
          f"{wall:.1f} s")


#: the `[cmd]` runs: bench.py's cluster and burst as a cluster spec of
#: hollow nodes and pods (4 CPU / 32 Gi / 110 pods in 3 zones; 100m /
#: 500 Mi), and the Policy run's 15,001 nodes (a third `disktype=ssd`)
#: with scan-mixed's four pod shapes, 512 each
CMD_SPEC = {"nodes": [{"count": N_NODES, "zones": 3}],
            "pending_pods": [{"count": N_PODS}]}
CMD_POLICY_SPEC = {
    "nodes": [{"count": N_NODES + 1, "zones": 3,
               "label_fracs": {"disktype": ["ssd", 1 / 3]}}],
    "pending_pods": [
        {"count": 512, "cpu": 100, "mem": 500 * MI, "name_prefix": "small"},
        {"count": 512, "cpu": 250, "mem": GI, "name_prefix": "mid"},
        {"count": 512, "cpu": 500, "mem": 2 * GI, "name_prefix": "ssd",
         "node_affinity_key": "disktype", "node_affinity_values": ["ssd"]},
        {"count": 512, "cpu": 1000, "mem": 4 * GI, "name_prefix": "big"}]}
#: the `[scraper]` overhead floor: the scraper's cadence, the ABAB rounds
#: and the wall past which the cell runs at its reduced size
SCRAPER_INTERVAL, SCRAPER_ROUNDS, SCRAPER_BUDGET_S = 0.05, 3, 90.0
SCRAPER_REDUCED = (5000, 3000)


def cmd_run(argv, state=None):
    """One run of the port's `cmd.scheduler.main`; its stdout (the `--once`
    summary line) is caught, the scheduler it built kept (in `state` when
    given). The counts are zeroed just before. Returns the run's state,
    summary, launches, `twin.*` / `refusal.*` counts and wall seconds."""
    import io
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.ops import kernels as K
    state = {} if state is None else state
    out = io.StringIO()
    obs.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cmd.main(argv, state=state)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"cmd: main {argv} returned {rc}")
    return {"state": state, "wall": wall,
            "summary": json.loads(out.getvalue().strip().splitlines()[-1]),
            "counts": K.launches(), "twins": obs.family("twin"),
            "refusals": obs.family("refusal")}


def bindings(store):
    """{pod key: node} of every pod in a port store."""
    from kubernetes_tpu_torch.store.store import PODS
    return {p.key: p.node_name for p in store.list(PODS)[0]}


def cmd_route(sched):
    """The route a command's scheduler took: the device (the class and
    device of its TorchScheduler) or the host (the oracle)."""
    algo = sched.algorithm
    where = getattr(algo, "device", None)
    return f"{type(algo).__name__} on {where}" if where is not None \
        else f"{type(algo).__name__} on the host"


def cmd_checks(name, r, n_pods, kernel):
    """A `[cmd]` run must bind all its pods, none unschedulable or in
    error, on a TorchScheduler on the card, with `kernel` launched and no
    twin, refusal or breaker fault."""
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    sched = r["state"]["scheduler"]
    algo = sched.algorithm
    want = {"scheduled": n_pods, "unschedulable": 0, "errors": 0}
    if r["summary"] != want:
        raise SystemExit(f"{name}: main printed {r['summary']}, not {want}")
    if not isinstance(algo, TorchScheduler) or algo.device.type != "cuda":
        raise SystemExit(f"{name}: the scheduler is {cmd_route(sched)}, "
                         f"not a TorchScheduler on cuda")
    if r["counts"][kernel] == 0:
        raise SystemExit(f"{name}: {kernel} was not launched "
                         f"({r['counts']})")
    if r["twins"] or r["refusals"]:
        raise SystemExit(f"{name}: twin cycles {r['twins']}, refusals "
                         f"{r['refusals']}")
    no_degrade(name)
    if algo.breaker.faults_total:
        raise SystemExit(f"{name}: breaker faults "
                         f"{algo.breaker.debug_state()}")


def cmd_direct(spec, cfg, device, sync, burst):
    """The scheduler `create_scheduler` would build for `cfg`, built
    directly with the arguments it resolves, on a store loaded from the
    same spec, driven by the command's `--once --burst` loop. Returns its
    bindings and the loop's wall seconds."""
    from kubernetes_tpu_torch import factory
    from kubernetes_tpu_torch.cmd.scheduler import load_cluster_spec
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store.store import Store
    preds, weights, policy = factory.resolve_algorithm(cfg)
    store = Store(watch_log_size=1 << 20)
    load_cluster_spec(store, spec)
    sched = Scheduler(
        store, scheduler_name=cfg.scheduler_name, use_device=True,
        device=device,
        percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
        hard_pod_affinity_weight=cfg.hard_pod_affinity_symmetric_weight,
        disable_preemption=cfg.disable_preemption, predicate_names=preds,
        priority_weights=weights, plugins_enabled=cfg.plugins_enabled,
        mesh="auto")
    sched.sync()
    t0 = time.perf_counter()
    sched.pump()
    while sched.schedule_burst(max_pods=burst):
        pass
    sched.pump()
    sync()
    return bindings(store), time.perf_counter() - t0


def same_bindings(name, got, want, other):
    if got != want:
        diff = sorted(k for k in set(got) | set(want)
                      if got.get(k) != want.get(k))
        raise SystemExit(f"{name}: {len(diff)} pods bound apart from "
                         f"{other}, e.g. {diff[:3]}: "
                         f"{[(got.get(k), want.get(k)) for k in diff[:3]]}")


def cmd_http(sched, cfg):
    """serve_http over a create_scheduler scheduler on port 0: GET
    /healthz, /metrics (the scheduler's and the process families),
    /debug/timeseries and /configz. Returns the bytes of each answer."""
    import urllib.request
    from kubernetes_tpu_torch.cmd.scheduler import serve_http
    from kubernetes_tpu_torch.obs.timeseries import SCRAPER
    SCRAPER.reset(capacity=16)
    SCRAPER.sample()
    server = serve_http(sched, cfg, 0)
    port = server.server_address[1]
    got = {}
    try:
        for path in ("/healthz", "/metrics", "/debug/timeseries?window=1",
                     "/configz"):
            got[path] = urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30).read()
    finally:
        server.shutdown()
        server.server_close()
        SCRAPER.reset()
    metrics = got["/metrics"].decode()
    if got["/healthz"] != b"ok":
        raise SystemExit(f"cmd http: /healthz answered {got['/healthz']}")
    for fam in ("scheduler_schedule_attempts_total",
                "process_resident_memory_bytes"):
        if fam not in metrics:
            raise SystemExit(f"cmd http: /metrics has no {fam}")
    doc = json.loads(got["/debug/timeseries?window=1"])
    if doc["window"] != 1 or "process_resident_memory_bytes" not in \
            doc["families"]:
        raise SystemExit("cmd http: /debug/timeseries answered "
                         f"{str(doc)[:200]}")
    if json.loads(got["/configz"]) != cfg.to_dict():
        raise SystemExit("cmd http: /configz is not the run's config")
    return {k: len(v) for k, v in got.items()}


def cmd_phase(device, sync, report):
    """`[cmd]`: the port's kube-scheduler command on the card, three ways
    (see the module docstring), then its HTTP routes. Fails on a summary
    other than all bound, a scheduler that is not a TorchScheduler on
    cuda, bindings apart from the directly built scheduler's (a, b) or
    from the plain versions' (c), a kernel not launched, a twin or
    refusal count, a breaker fault, or a route that does not answer."""
    import shutil
    import tempfile
    from kubernetes_tpu_torch import factory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cmd_")
    try:
        def write(fname, doc):
            path = f"{tmp}/{fname}"
            with open(path, "w") as f:
                json.dump(doc, f)
            return path
        spec = write("spec.json", CMD_SPEC)
        cfg_path = write("config.json", {"percentage_of_nodes_to_score": 100})
        policy = dict(factory.DEFAULT_PRIORITY_WEIGHTS,
                      LeastRequestedPriority=1, NodeAffinityPriority=2)
        policy_path = write("policy.json", {
            "predicates": [{"name": n}
                           for n in factory.DEFAULT_PREDICATE_NAMES],
            "priorities": [{"name": n, "weight": w}
                           for n, w in policy.items()]})
        policy_spec = write("policy-spec.json", CMD_POLICY_SPEC)
        once = ["--once", "--burst", str(N_PODS)]
        for label, extra in (
                ("default", []),
                ("autoscaler",
                 ["--algorithm-provider", "ClusterAutoscalerProvider"])):
            name = f"cmd {label}"
            argv = ["--config", cfg_path, "--cluster-spec", spec] + extra \
                + once
            r = cmd_run(argv)
            cmd_checks(name, r, N_PODS, "uniform_burst")
            add_launches(report, r["counts"])
            st = r["state"]
            got = bindings(st["store"])
            want, direct_s = cmd_direct(spec, st["config"], device, sync,
                                        N_PODS)
            same_bindings(name, got, want, "the directly built scheduler")
            if label == "default":
                CMD_DEFAULT.update(bindings=got,
                                   loop_s=st["loop_seconds"])
            per_node = {}
            for h in got.values():
                per_node[h] = per_node.get(h, 0) + 1
            print(f"[cmd] {label}: main {' '.join(extra + once)} on "
                  f"{N_NODES} hollow nodes, {N_PODS} pods: "
                  f"{r['summary']}; route {cmd_route(st['scheduler'])}; "
                  f"loop {st['loop_seconds'] * 1e3:.1f} ms "
                  f"({N_PODS / st['loop_seconds']:.1f} pods/s), main's "
                  f"wall {r['wall']:.2f} s (with the spec's store); most "
                  f"pods on one node {max(per_node.values())} on "
                  f"{len(per_node)} nodes; launches "
                  f"{ {k: v for k, v in r['counts'].items() if v} }; "
                  f"bindings equal to the directly built Scheduler's "
                  f"(its loop {direct_s * 1e3:.1f} ms)")
        name = "cmd policy-mixed"
        n_pol = sum(p["count"] for p in CMD_POLICY_SPEC["pending_pods"])
        argv = ["--policy-config-file", policy_path, "--cluster-spec",
                policy_spec, "--once", "--burst", str(n_pol)]
        r = cmd_run(argv)
        cmd_checks(name, r, n_pol, "schedule_batch")
        add_launches(report, r["counts"])
        st = r["state"]
        got = bindings(st["store"])
        cpu = cmd_run(argv + ["--device", "cpu"])
        if cpu["summary"] != r["summary"]:
            raise SystemExit(f"{name}: the plain versions printed "
                             f"{cpu['summary']}, the card {r['summary']}")
        same_bindings(name, got, bindings(cpu["state"]["store"]),
                      "the plain versions'")
        print(f"[cmd] policy-mixed: main --policy-config-file (the "
              f"DefaultProvider's predicates and priorities, LeastRequested "
              f"1, NodeAffinity 2) --once --burst {n_pol} on "
              f"{N_NODES + 1} nodes (a third disktype=ssd), {n_pol} pods "
              f"of 4 specs: {r['summary']}; route "
              f"{cmd_route(st['scheduler'])}; loop "
              f"{st['loop_seconds'] * 1e3:.1f} ms "
              f"({n_pol / st['loop_seconds']:.1f} pods/s), main's wall "
              f"{r['wall']:.2f} s; launches "
              f"{ {k: v for k, v in r['counts'].items() if v} }; bindings "
              f"equal to --device cpu (the plain versions; its loop "
              f"{cpu['state']['loop_seconds'] * 1e3:.1f} ms)")
        sizes = cmd_http(st["scheduler"], st["config"])
        print(f"[cmd] http: serve_http on port 0 over the policy run's "
              f"scheduler answered {sizes} (bytes)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def scraper_phase(device, sync, report):
    """`[scraper]`: the scraper's overhead floor on the card
    (`tests/test_timeseries.py`'s, JAX package): `[shell] uniform`'s
    cell with the process-global SCRAPER sampling the whole registry
    every 0.05 s and without it, ABAB, best of 3 each. It passes when the
    best rate with the scraper is >= 0.95 x the best without, or the
    sampling duty cycle (seconds a sample over the interval, measured on
    the same registry) is under 1 %. When the first two runs of the
    15,000-node cell promise more than 90 s for the six, the cell runs
    at 5,000 nodes x 3,000 pods."""
    import gc
    from kubernetes_tpu_torch.obs.timeseries import SCRAPER
    name = "scraper"
    n_nodes, n_pods = N_NODES, N_PODS
    rates = {"off": [], "on": []}
    samples = []
    t_phase = time.perf_counter()

    def run(on):
        # the runs before leave stores of 25,000 objects behind, and a
        # collection inside the timed loop moves its wall by up to a
        # third: collect them now, and freeze the GC over the loop
        gc.collect()
        if on:
            SCRAPER.reset(capacity=256)
            SCRAPER.start(interval=SCRAPER_INTERVAL)
        try:
            r = shell_uniform_cell(device, sync, n_nodes, n_pods,
                                   freeze_gc=True)
        finally:
            if on:
                SCRAPER.stop()
                samples.append(SCRAPER.series()["samples"])
        if r["bound"] != n_pods or r["counts"]["uniform_burst"] == 0:
            raise SystemExit(f"{name}: {r['bound']} of {n_pods} bound, "
                             f"launches {r['counts']}")
        if r["sched"].algorithm.breaker.faults_total:
            raise SystemExit(f"{name}: breaker faults")
        add_launches(report, r["counts"])
        rates["on" if on else "off"].append(n_pods / r["wall"])

    reduced = False
    for k in range(SCRAPER_ROUNDS):
        run(False)
        run(True)
        if k == 0 and (time.perf_counter() - t_phase) * SCRAPER_ROUNDS \
                > SCRAPER_BUDGET_S:
            # the six runs would take too long: start again smaller
            reduced = True
            n_nodes, n_pods = SCRAPER_REDUCED
            rates = {"off": [], "on": []}
            samples.clear()
            run(False)
            run(True)
    if not all(samples):
        raise SystemExit(f"{name}: the scraper took no sample ({samples})")
    t0 = time.perf_counter()
    for _ in range(20):
        SCRAPER.sample()
    duty = ((time.perf_counter() - t0) / 20) / SCRAPER_INTERVAL
    SCRAPER.reset()
    best_on, best_off = max(rates["on"]), max(rates["off"])
    ratio = best_on / best_off
    verdict = "held" if ratio >= 0.95 or duty < 0.01 else "MISSED"
    print(f"[scraper] {n_nodes} nodes x {n_pods} pods "
          f"({'reduced: ' if reduced else ''}[shell] uniform's cell), "
          f"ABAB x {len(rates['on'])}, interval {SCRAPER_INTERVAL} s: "
          f"off {[round(x, 1) for x in rates['off']]} pods/s, on "
          f"{[round(x, 1) for x in rates['on']]} pods/s; best on / off "
          f"{best_on:.1f} / {best_off:.1f} = {ratio:.4f}; sampling duty "
          f"cycle {duty * 100:.3f} % ({duty * SCRAPER_INTERVAL * 1e3:.3f} "
          f"ms a sample); samples a run {samples}; floor (>= 0.95 or duty "
          f"< 1 %) {verdict}; {time.perf_counter() - t_phase:.1f} s")
    if verdict != "held":
        raise SystemExit(f"{name}: scraper overhead {ratio:.3f}x with a "
                         f"duty cycle of {duty:.2%}")


def tuner_phase(device, sync, report):
    """`[tuner]`: the tuner cell (`kubernetes_tpu_torch.tuner.cell`, the
    JAX harness's run_tuner_cell) on the card at its defaults: phase A
    records 4 worlds, phase B's seeded search runs twice (the same winner
    is required), phase C runs the two-lane FleetInstance A/B with the
    mid-run set_row + reload_profiles, the scraper and the gate. The cell
    raises on a double bind, an unbound arrival, a replay violation
    across the row write or a nondeterministic search; the phase also
    fails on no K5 launch, a twin or refusal count or a breaker fault."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.tuner.cell import run_tuner_cell
    name = "tuner"
    obs.reset()
    t0 = time.perf_counter()
    r = run_tuner_cell(device=device)
    sync()
    wall = time.perf_counter() - t0
    counts = K.launches()
    twins, refusals = obs.family("twin"), obs.family("refusal")
    if counts["schedule_batch"] == 0:
        raise SystemExit(f"{name}: K5 schedule_batch was not launched "
                         f"({counts})")
    if twins or refusals:
        raise SystemExit(f"{name}: twin cycles {twins}, refusals "
                         f"{refusals}")
    no_degrade(name)
    if not (r["search_deterministic"] and r["parity_violations"] == 0
            and r["double_binds"] == 0 and r["records_replayed"] > 0):
        raise SystemExit(f"{name}: audits {r}")
    add_launches(report, counts)
    lanes = r["lanes"]
    rate = {"incumbent": r["incumbent_bound"] / r["duration"],
            "shadow": r["shadow_bound"] / r["duration"]}
    print(f"[tuner] {r['nodes']} nodes, {r['arrival_rate']:.0f} arrivals/s "
          f"for {r['duration']:.2f} s, window 512, depth 2: search "
          f"{r['search_seconds']:.3f} s ({r['search']['strategy']}, "
          f"{r['search']['evaluated']} rows, twice, the same winner "
          f"{r['search']['best_weights']}); best reward "
          f"{r['search']['best_reward']:.3f}, incumbent "
          f"{r['incumbent_sim_reward']:.3f}; row installed at "
          f"{r['installed_at_s']:.2f} s; lanes "
          + "; ".join(f"{k} p99 {v['p99'] * 1e3:.2f} ms, utilization "
                      f"{v['utilization']}, {rate[k]:.1f} pods/s "
                      f"({v['committed']} committed)"
                      for k, v in lanes.items())
          + f"; gate {r['gate_decision']} ({r['gate_reason']}); replay "
          f"{r['records_replayed']} records across the row write, 0 "
          f"violations; double binds 0, all arrivals bound; K5 "
          f"{counts['schedule_batch']}, K3 {counts['uniform_burst']}, "
          f"launches {({k: v for k, v in counts.items() if v})}; "
          f"{wall:.1f} s")


# ---------------------------------------------------------------------------
# the extender passes (core/extender.py) and the HTTP pair (apiserver/,
# store/remote.py, the command's --server, --token and --api-port)
# ---------------------------------------------------------------------------
#: the managed resource of the `[extender]` binder, and the decision
#: extender's world: nodes, plain pods, urgent pods that must preempt, and
#: the nodes of the pool those urgent pods select
EXT_RESOURCE = "example.com/gpu"
EXT_DECISION = {"nodes": 1000, "plain": 192, "urgent": 8, "pool": 100}
#: `[http]`: the remote-arrivals cell (JAX tests/test_serve.py
#: TestRemoteServing's shape at the card's width) and the `--api-port`
#: run's spec
HTTP_ARRIVALS = {"nodes": 5000, "rate": 1000.0, "seconds": 5.0,
                 "window": 512, "depth": 2, "max_depth": 256, "lag": 0.5}
HTTP_API_SPEC = {"nodes": [{"count": 100, "zones": 3}],
                 "pending_pods": [{"count": 50}]}
#: bindings of `[cmd] default` ({pod key: node}), kept for `[http]`
CMD_DEFAULT = {}


def binder_extender(store, calls):
    """A callable binder extender for EXT_RESOURCE: its endpoint binds
    through `store` and books each call and its seconds in `calls`."""
    from kubernetes_tpu_torch.apis.policy import ExtenderConfig
    from kubernetes_tpu_torch.core.extender import SchedulerExtender

    def bind_ep(payload):
        t = time.perf_counter()
        store.bind_pod(payload["pod"], payload["node"])
        calls.append(time.perf_counter() - t)
        return {}
    return SchedulerExtender(
        ExtenderConfig(url_prefix="inproc://binder", bind_verb="bind",
                       managed_resources=(EXT_RESOURCE,)),
        endpoints={"bind": bind_ep})


def ext_bind_run(device, sync, n_nodes, n_plain, n_managed, with_binder):
    """`[extender]` (a)'s world through the shell: nodes advertising 4 of
    EXT_RESOURCE; two blocks of pods, each created and pumped, then
    schedule_burst(max_pods=10000) until 0: `n_plain` of bench.py's pods,
    then `n_managed` that also request 1 of it. Returns the bindings, the
    extender's calls, the loops' seconds, the launches and the
    scheduler."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store.store import PODS
    store = bench_store(n_nodes, n_plain + n_managed,
                        scalar={EXT_RESOURCE: 4})
    calls = []
    ext = [binder_extender(store, calls)] if with_binder else None
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      device=device, extenders=ext)
    sched.sync()
    obs.reset()
    wall = 0.0
    for block in ("plain", "managed"):
        if block == "plain":
            bench_pods(store, n_plain)
        else:
            for j in range(n_plain, n_plain + n_managed):
                store.create(PODS, Pod(
                    name=f"pod-{j}", labels={"app": "density"},
                    containers=(Container.make(
                        name="c", requests={"cpu": 100, "memory": 500 * MI,
                                            EXT_RESOURCE: 1}),)))
        sched.pump()
        sync()
        t0 = time.perf_counter()
        while sched.schedule_burst(max_pods=SHELL_MAX_PODS):
            pass
        sync()
        wall += time.perf_counter() - t0
        sched.pump()
    counts = K.launches()
    return {"bindings": bindings(store), "calls": calls, "wall": wall,
            "counts": counts, "sched": sched,
            "twins": obs.family("twin"), "refusals": obs.family("refusal")}


def ext_decision_server(verbs):
    """A ThreadingHTTPServer on 127.0.0.1 port 0 answering POST
    /<verb> with verbs[verb](payload) as JSON, on a thread of its own.
    Returns (server, thread, url)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n) or b"{}")
            body = json.dumps(verbs[self.path.rsplit("/", 1)[-1]](
                payload)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def ext_decision_run(device, sync, nodes, plain, urgent, pool):
    """`[extender]` (c): a filter + prioritize (weight 3) + preempt
    extender served over real HTTP (the urllib transport). `nodes` of 4
    CPU; `pool` of them (`pool=small`, index i with i % 5 == 1) hold a
    3.6-CPU filler of priority 0; `plain` pods of 100m, then `urgent`
    2-CPU pods of priority 100 that select the pool and must preempt.
    The filter verb drops every fifth node, the prioritize verb scores
    (7 i) % 11, the preempt verb keeps the candidates of even index.
    Rounds of pump, schedule_one until idle, pump, 2 s of a fake clock.
    Returns the route, the warnings, the calls by verb, the launches, the
    pods and the loop's seconds."""
    import warnings
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.api.types import Container, Node, Pod
    from kubernetes_tpu_torch.apis.policy import ExtenderConfig
    from kubernetes_tpu_torch.core.extender import SchedulerExtender
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store.store import NODES, PODS, Store
    from kubernetes_tpu_torch.utils.clock import FakeClock
    calls = {"filter": 0, "prioritize": 0, "preempt": 0}

    def idx(name):
        return int(name.rsplit("-", 1)[1])

    def filter_ep(p):
        calls["filter"] += 1
        keep = [n for n in p["nodes"] if idx(n) % 5]
        return {"nodeNames": keep,
                "failedNodes": {n: "ExtenderVetoed" for n in p["nodes"]
                                if not idx(n) % 5}}

    def prioritize_ep(p):
        calls["prioritize"] += 1
        return {"hostPriorityList": [{"host": n, "score": 7 * idx(n) % 11}
                                     for n in p["nodes"]]}

    def preempt_ep(p):
        calls["preempt"] += 1
        return {"nodeNameToVictims": {
            n: v for n, v in p["nodeNameToVictims"].items()
            if idx(n) % 2 == 0}}

    server, thread, url = ext_decision_server(
        {"filter": filter_ep, "prioritize": prioritize_ep,
         "preempt": preempt_ep})
    try:
        ext = SchedulerExtender(ExtenderConfig(
            url_prefix=url, filter_verb="filter",
            prioritize_verb="prioritize", preempt_verb="preempt",
            weight=3))
        store = Store(watch_log_size=65536)
        small = [i for i in range(nodes) if i % 5 == 1][:pool]
        for i in range(nodes):
            store.create(NODES, Node(
                name=f"node-{i}",
                labels={"pool": "small" if i in small else "big"},
                allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110}))
        for i in small:
            store.create(PODS, Pod(
                name=f"filler-{i}", node_name=f"node-{i}", priority=0,
                containers=(Container.make(
                    name="c", requests={"cpu": 3600}),)))
        clock = FakeClock(100.0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sched = Scheduler(store, clock=clock,
                              percentage_of_nodes_to_score=100,
                              device=device, extenders=[ext])
        sched.sync()
        for j in range(plain):
            store.create(PODS, Pod(name=f"plain-{j}", containers=(
                Container.make(name="c", requests={"cpu": 100,
                                                   "memory": 500 * MI}),)))
        for j in range(urgent):
            store.create(PODS, Pod(
                name=f"urgent-{j}", priority=100,
                node_selector={"pool": "small"},
                containers=(Container.make(name="c",
                                           requests={"cpu": 2000}),)))
        obs.reset()
        t0 = time.perf_counter()
        idle = 0
        for _ in range(40):
            sched.pump()
            before = sched.metrics.schedule_attempts["scheduled"]
            while sched.schedule_one(timeout=0.0):
                pass
            sched.pump()
            idle = 0 if sched.metrics.schedule_attempts["scheduled"] \
                > before else idle + 1
            if idle >= 3:
                break
            clock.step(2.0)
        sync()
        wall = time.perf_counter() - t0
        counts = K.launches()
        pods = {p.name: p.node_name for p in store.list(PODS)[0]}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return {"route": cmd_route(sched), "algorithm": sched.algorithm,
            "warnings": [str(w.message) for w in caught], "calls": calls,
            "counts": counts, "pods": pods, "wall": wall, "small": small}


def extender_phase(device, sync, report):
    """`[extender]`: (a) a callable binder extender for EXT_RESOURCE on
    bench.py's world (15,000 nodes, 9,000 plain pods then 1,000 managed):
    all bound, the endpoint called once a managed pod, K3 launched, the
    bindings equal to the same world with no extender; (b) the binder on
    `[shell] preempt-baseline`'s world, the preemptors arriving one at a
    time (each bound before the next: with a nominee pending, the device
    victim scan refuses, as the reference's does): the shell skips the
    pressure wave (K8) and preempts serially on K7, with victims,
    bindings and nominations equal to the run without it (one-pod K8
    waves); then the preemptors all queued at once: K7 for the first and
    a `preempt-nominated-ghosts` refusal (host preemption) for at most
    each later one, no K8, equal to the queued run without it (one K8
    wave); (c) a decision extender over real HTTP: the
    reference's route to the generic scheduler with its warning, no
    kernel launched, the extender's verbs obeyed."""
    from kubernetes_tpu_torch.oracle.generic_scheduler import (
        GenericScheduler)
    n_plain, n_managed = N_PODS - 1000, 1000
    name = "extender bind-only"
    r = ext_bind_run(device, sync, N_NODES, n_plain, n_managed, True)
    ref = ext_bind_run(device, sync, N_NODES, n_plain, n_managed, False)
    for run in (r, ref):
        if run["counts"]["uniform_burst"] == 0:
            raise SystemExit(f"{name}: K3 uniform_burst was not launched "
                             f"({run['counts']})")
        if run["twins"] or run["refusals"]:
            raise SystemExit(f"{name}: twin cycles {run['twins']}, "
                             f"refusals {run['refusals']}")
        if run["sched"].algorithm.breaker.faults_total:
            raise SystemExit(f"{name}: breaker faults")
    no_degrade(name)
    if sum(1 for h in r["bindings"].values() if h) != N_PODS:
        raise SystemExit(f"{name}: {sum(1 for h in r['bindings'].values() if h)}"
                         f" of {N_PODS} bound")
    if len(r["calls"]) != n_managed:
        raise SystemExit(f"{name}: the binder was called {len(r['calls'])} "
                         f"times, not {n_managed}")
    same_bindings(name, r["bindings"], ref["bindings"],
                  "the run without the extender")
    add_launches(report, r["counts"])
    add_launches(report, ref["counts"])
    ep_ms = sum(r["calls"]) * 1e3
    print(f"[extender] bind-only: {N_NODES} nodes with {EXT_RESOURCE}: 4, "
          f"{n_plain} plain + {n_managed} managed pods, a callable binder "
          f"extender (managed_resources {EXT_RESOURCE}): all bound in "
          f"{r['wall'] * 1e3:.1f} ms ({N_PODS / r['wall']:.1f} pods/s), "
          f"without the extender {ref['wall'] * 1e3:.1f} ms "
          f"({N_PODS / ref['wall']:.1f} pods/s); binder calls "
          f"{len(r['calls'])}, its endpoint {ep_ms:.1f} ms "
          f"({ep_ms / n_managed * 1e3:.1f} us a pod), the wall's "
          f"difference {(r['wall'] - ref['wall']) / n_managed * 1e6:.1f} "
          f"us a managed pod; K3 {r['counts']['uniform_burst']}, launches "
          f"{ {k: v for k, v in r['counts'].items() if v} }; bindings equal "
          f"to the run without the extender")
    name = "extender preempt"
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    runs = {}
    for label, binder in (("binder", True), ("none", False)):
        obs.reset()
        calls = []
        run, wall, sched, _commit = shell_baseline_run(
            device, sync, 1000, 128, trickle=True,
            extender_fn=(lambda s: [binder_extender(s, calls)])
            if binder else None)
        runs[label] = (run, wall, K.launches(), obs.family("twin"),
                       obs.family("refusal"), calls)
    (run, wall, counts, twins, refusals, calls) = runs["binder"]
    ref, ref_wall, ref_counts = runs["none"][:3]
    no_degrade(name)
    if counts["preempt_scan"] == 0 or counts["pressure_batch"] != 0:
        raise SystemExit(f"{name}: K7 {counts['preempt_scan']}, K8 "
                         f"{counts['pressure_batch']} launches with the "
                         f"binder (K7 and no K8 expected)")
    if ref_counts["pressure_batch"] == 0:
        raise SystemExit(f"{name}: the run without the extender launched "
                         f"no K8 ({ref_counts})")
    if twins or refusals or calls:
        raise SystemExit(f"{name}: twin cycles {twins}, refusals "
                         f"{refusals}, binder calls {len(calls)}")
    for key in ("bindings", "nominations", "evictions"):
        if run[key] != ref[key]:
            diff = [a for a in run[key] if a not in ref[key]][:4]
            raise SystemExit(f"{name}: {key} differ from the run without "
                             f"the extender: {diff}")
    add_launches(report, counts)
    add_launches(report, ref_counts)
    print(f"[extender] preempt: preempt-baseline's world (1000 nodes x 10 "
          f"victims), 128 preemptors arriving one at a time, with the "
          f"binder: no pressure wave, serial preemption on K7 "
          f"({counts['preempt_scan']} K7, {counts['schedule_cycle']} K2, "
          f"0 K8) in {wall * 1e3:.1f} ms of rounds; without it one-pod "
          f"waves, K8 {ref_counts['pressure_batch']}, K7 "
          f"{ref_counts['preempt_scan']} in {ref_wall * 1e3:.1f} ms; "
          f"{len(run['evictions'])} victims, bindings and nominations "
          f"equal")
    name = "extender preempt queued"
    runs = {}
    for label, binder in (("binder", True), ("none", False)):
        obs.reset()
        calls = []
        run, wall, sched, _commit = shell_baseline_run(
            device, sync, 1000, 128,
            extender_fn=(lambda s: [binder_extender(s, calls)])
            if binder else None)
        runs[label] = (run, wall, K.launches(), obs.family("twin"),
                       obs.family("refusal"), calls)
        no_degrade(name)
    (run, wall, counts, twins, refusals, calls) = runs["binder"]
    ref, ref_wall, ref_counts, ref_twins, ref_refusals = runs["none"][:5]
    n_refused = refusals.get("preempt-nominated-ghosts", 0)
    if counts["preempt_scan"] == 0 or counts["pressure_batch"] != 0:
        raise SystemExit(f"{name}: K7 {counts['preempt_scan']}, K8 "
                         f"{counts['pressure_batch']} launches with the "
                         f"binder (K7 and no K8 expected)")
    if set(refusals) - {"preempt-nominated-ghosts"} or n_refused > 127 \
            or twins or calls:
        raise SystemExit(f"{name}: refusals {refusals} (at most 127 "
                         f"preempt-nominated-ghosts expected), twin cycles "
                         f"{twins}, binder calls {len(calls)}")
    if ref_counts["pressure_batch"] == 0 or ref_twins or ref_refusals:
        raise SystemExit(f"{name}: the run without the extender: launches "
                         f"{ref_counts}, twin cycles {ref_twins}, refusals "
                         f"{ref_refusals}")
    for key in ("bindings", "nominations", "evictions"):
        if run[key] != ref[key]:
            diff = [a for a in run[key] if a not in ref[key]][:4]
            raise SystemExit(f"{name}: {key} differ from the queued run "
                             f"without the extender: {diff}")
    bound_hi = sum(1 for k, h in run["bindings"] if h and "/hi-" in k)
    if bound_hi != 128 or len(run["evictions"]) != 128:
        raise SystemExit(f"{name}: {bound_hi} preemptors bound, "
                         f"{len(run['evictions'])} victims evicted")
    add_launches(report, counts)
    add_launches(report, ref_counts)
    print(f"[extender] preempt queued: preempt-baseline's world, the 128 "
          f"preemptors queued at once, with the binder: no pressure wave, "
          f"K7 {counts['preempt_scan']}, 0 K8, refusals "
          f"preempt-nominated-ghosts {n_refused} of 128 (the host "
          f"preemptor decided those, as the reference's refusal does) in "
          f"{wall * 1e3:.1f} ms of rounds; without it K8 "
          f"{ref_counts['pressure_batch']}, K7 {ref_counts['preempt_scan']} "
          f"in {ref_wall * 1e3:.1f} ms; {len(run['evictions'])} victims, "
          f"bindings and nominations equal")
    name = "extender decision"
    c = EXT_DECISION
    d = ext_decision_run(device, sync, c["nodes"], c["plain"], c["urgent"],
                         c["pool"])
    no_degrade(name)
    if not isinstance(d["algorithm"], GenericScheduler):
        raise SystemExit(f"{name}: the route is {d['route']}, not the "
                         f"generic scheduler")
    if not any("extenders configured" in w for w in d["warnings"]):
        raise SystemExit(f"{name}: no route warning ({d['warnings']})")
    if any(d["counts"].values()):
        raise SystemExit(f"{name}: kernels launched on the host route "
                         f"({d['counts']})")
    bound = {k: v for k, v in d["pods"].items() if not k.startswith("filler")}
    idx = {k: int(v.rsplit("-", 1)[1]) for k, v in bound.items() if v}
    if len(idx) != c["plain"] + c["urgent"]:
        raise SystemExit(f"{name}: {len(idx)} of "
                         f"{c['plain'] + c['urgent']} pods bound")
    if any(i % 5 == 0 for i in idx.values()):
        raise SystemExit(f"{name}: a pod bound on a node the filter verb "
                         f"dropped")
    urgent = [i for k, i in idx.items() if k.startswith("urgent")]
    if any(i % 2 or i not in d["small"] for i in urgent):
        raise SystemExit(f"{name}: an urgent pod bound off the preempt "
                         f"verb's candidates ({sorted(urgent)})")
    evicted = c["pool"] - sum(1 for k in d["pods"] if k.startswith("filler"))
    if not (d["calls"]["filter"] and d["calls"]["prioritize"]
            and d["calls"]["preempt"] >= c["urgent"]):
        raise SystemExit(f"{name}: extender calls {d['calls']}")
    print(f"[extender] decision: filter + prioritize (weight 3) + preempt "
          f"over HTTP (urllib) on {c['nodes']} nodes, {c['plain']} plain + "
          f"{c['urgent']} urgent pods preempting on the {c['pool']}-node "
          f"pool: route {d['route']} with the warning \""
          f"{d['warnings'][0]}\"; no kernel launched; calls {d['calls']}; "
          f"all {len(idx)} bound on nodes the verbs kept, {evicted} of "
          f"{c['pool']} fillers evicted; {d['wall'] * 1e3:.1f} ms of "
          f"rounds")


def free_port():
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def timed_method(cls, name, book):
    """Wrap `cls.name` to add each call's seconds to book[name]; returns
    the original for the caller to restore. The wrapper keeps the
    method's signature: the shell reads `commit_wave`'s parameters to
    choose what it sends (the token and `event_spec`)."""
    import functools
    orig = getattr(cls, name)

    @functools.wraps(orig)
    def call(self, *a, **kw):
        t = time.perf_counter()
        try:
            return orig(self, *a, **kw)
        finally:
            book[name] = book.get(name, 0.0) + time.perf_counter() - t
    setattr(cls, name, call)
    return orig


def http_server_run(device, sync, spec_path, cfg_path, n_pods):
    """`[http]` (a): an APIServer on port 0 over a Store loaded from
    `spec_path` (models/hollow.py's populate_store and make_pods, as the
    command loads a spec), with bearer-token authentication for
    system:kube-scheduler and the default RBAC roles; then `main --server
    URL --token TOKEN --config cfg --once --burst n_pods`. Returns the
    run (cmd_run's), the server store's bindings and the seconds of the
    initial lists, the wave commits and the host probes over HTTP."""
    from kubernetes_tpu_torch.apiserver.auth import (
        RBACAuthorizer, TokenAuthenticator, UserInfo, default_roles)
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.cmd.scheduler import load_cluster_spec
    from kubernetes_tpu_torch.store.remote import RemoteStore
    from kubernetes_tpu_torch.store.store import Store
    store = Store(watch_log_size=1 << 20)
    t0 = time.perf_counter()
    load_cluster_spec(store, spec_path)
    t_load = time.perf_counter() - t0
    token = "scheduler-token"
    roles, role_bindings = default_roles()
    book = {}
    saved = {m: timed_method(RemoteStore, m, book)
             for m in ("list", "commit_wave", "missing_keys")}
    try:
        with APIServer(store, authenticator=TokenAuthenticator(
                {token: UserInfo("system:kube-scheduler")}),
                authorizer=RBACAuthorizer(roles=roles,
                                          bindings=role_bindings)) as srv:
            state = {}
            try:
                r = cmd_run(["--server", srv.url, "--token", token,
                             "--config", cfg_path, "--once", "--burst",
                             str(n_pods), "--device", str(device)],
                            state=state)
            finally:
                # the command's informers watch the server: end their
                # streams before the server goes
                if "scheduler" in state:
                    state["scheduler"].stop()
                    state["scheduler"].informers.stop_all()
    finally:
        for m, fn in saved.items():
            setattr(RemoteStore, m, fn)
    return r, bindings(store), book, t_load


def http_api_port_run(device, spec_path):
    """`[http]` (b): `main --api-port PORT --cluster-spec spec` (no
    --once: the command serves until its scheduler stops) on a thread;
    a GET of /api/v1/nodes, a pod created over the REST surface and a
    watch resumed from the list's resourceVersion that must deliver its
    ADDED and the command's bind (MODIFIED). Returns what was read."""
    import threading
    import urllib.request
    from kubernetes_tpu_torch.api import serde
    from kubernetes_tpu_torch.api.types import Container, Pod
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    state, err = {}, []

    def run():
        try:
            with contextlib.redirect_stdout(sys.stderr):
                cmd.main(["--api-port", str(port), "--cluster-spec",
                          spec_path, "--device", str(device)], state=state)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            err.append(e)
    t = threading.Thread(target=run, daemon=True, name="http-api-port")
    t.start()
    got = {}
    try:
        deadline = time.perf_counter() + 120
        while "api_server" not in state and not err:
            if time.perf_counter() > deadline:
                raise SystemExit("http api-port: the command did not "
                                 "serve within 120 s")
            time.sleep(0.05)
        if err:
            raise err[0]
        with urllib.request.urlopen(f"{url}/api/v1/nodes",
                                    timeout=30) as resp:
            doc = json.loads(resp.read())
        got["nodes"], rv = len(doc["items"]), doc["resourceVersion"]
        body = json.dumps(serde.to_dict(Pod(
            name="api-port-pod", containers=(Container.make(
                name="c", requests={"cpu": 100}),)))).encode()
        urllib.request.urlopen(urllib.request.Request(
            f"{url}/api/v1/pods", data=body, method="POST",
            headers={"Content-Type": "application/json"}), timeout=30).read()
        events = []
        with urllib.request.urlopen(
                f"{url}/api/v1/pods?watch=true&resourceVersion={rv}",
                timeout=30) as resp:
            for raw in resp:
                line = raw.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if ev["object"]["name"] != "api-port-pod":
                    continue
                events.append((ev["type"], ev["object"]["node_name"],
                               ev["resourceVersion"]))
                if ev["object"]["node_name"]:
                    break
        got["events"], got["rv"] = events, rv
    finally:
        sched = state.get("scheduler")
        if sched is not None:
            sched.stop()
        t.join(timeout=60)
    if t.is_alive():
        raise SystemExit("http api-port: the command did not end after "
                         "its scheduler stopped")
    if err:
        raise err[0]
    got["route"] = cmd_route(state["scheduler"])
    got["algorithm"] = state["scheduler"].algorithm
    return got


def http_arrivals_run(device, sync, nodes, rate, seconds, window, depth,
                      max_depth, lag, seed=0):
    """`[http]` (c): JAX's TestRemoteServing shape at `nodes` on the card:
    an APIServer over the embedded store, a ServeLoop (`window`,
    `depth`) on the port's shell behind a gate shedding past `max_depth`
    (Retry-After base 0.25 s), and an ArrivalGenerator POSTing through a
    RemoteStore at `rate`/s, `rate` x `seconds` arrivals in all; the
    client starts `lag` s before the loop (a backlog the gate sheds).
    Then the retries' flush,
    the drain, and the BindAuditor's double-bind tripwire. Returns the
    loop, the gate, the arrivals, the auditor and the numbers."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.fleet.manager import BindAuditor
    from kubernetes_tpu_torch.obs.ledger import LEDGER
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.serve import ArrivalGenerator, ServeLoop
    from kubernetes_tpu_torch.store.remote import RemoteStore
    from kubernetes_tpu_torch.store.store import PODS
    store = bench_store(nodes)
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      device=device)
    sched.sync()
    loop = ServeLoop(sched, window_size=window, depth=depth)
    gate = loop.attach_gate(max_depth=max_depth, retry_after_base=0.25)
    audit = BindAuditor(store)
    LEDGER.reset()
    obs.reset()
    with APIServer(store) as srv:
        gen = ArrivalGenerator(RemoteStore(srv.url), rate=rate,
                               total=int(rate * seconds), seed=seed)
        gen.tick()
        time.sleep(lag)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        bound0 = loop.pods_bound
        while time.perf_counter() < t_end:
            gen.tick()
            if loop.step() == 0:
                time.sleep(min(loop.tick_interval, 0.001))
            audit.scan()
        sync()
        elapsed = time.perf_counter() - t0
        sustained = (loop.pods_bound - bound0) / elapsed
        # the retries' flush, as JAX's TestRemoteServing settles: a tick
        # (the re-admissions due) and a loop step in turn, so the gate's
        # depth falls between the retries it answers
        deadline = time.perf_counter() + 30.0
        while not gen.finished() and time.perf_counter() < deadline:
            gen.tick()
            if loop.step() == 0:
                time.sleep(min(loop.tick_interval, 0.001))
            audit.scan()
        loop.drain(timeout=30.0)
        audit.scan()
    audit.stop()
    counts = K.launches()
    g = gen.stats()
    pods = [p for p in store.list(PODS)[0]
            if p.name.startswith(gen.name_prefix)]
    return {"loop": loop, "gate": gate, "arrivals": g, "audit": audit,
            "pods": pods, "elapsed": elapsed, "sustained": sustained,
            "counts": counts, "ledger": LEDGER.snapshot(), "sched": sched,
            "twins": obs.family("twin"), "refusals": obs.family("refusal")}


def http_phase(device, sync, report):
    """`[http]`: (a) the command over the wire: `main --server --token
    --once --burst 10000` against an APIServer over bench.py's cell of
    hollow nodes and pods; its scheduler a TorchScheduler on the card,
    all bound in the server's store, the bindings equal to `[cmd]
    default`'s embedded-store run on the same spec; (b) `--api-port`:
    the REST surface served by the command (a list, a create, a watch
    resumed from a resourceVersion delivering the command's bind); (c)
    remote arrivals at 1,000 pods/s for 5 s on 5,000 nodes behind a gate
    that sheds: 429s, every created pod bound, none twice."""
    import shutil
    import tempfile
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    tmp = tempfile.mkdtemp(prefix="chip_smoke_http_")
    try:
        def write(fname, doc):
            path = f"{tmp}/{fname}"
            with open(path, "w") as f:
                json.dump(doc, f)
            return path
        spec = write("spec.json", CMD_SPEC)
        cfg_path = write("config.json", {"percentage_of_nodes_to_score": 100})
        name = "http server"
        if not CMD_DEFAULT:
            st = cmd_run(["--config", cfg_path, "--cluster-spec", spec,
                          "--once", "--burst", str(N_PODS)])
            CMD_DEFAULT.update(bindings=bindings(st["state"]["store"]),
                               loop_s=st["state"]["loop_seconds"])
        r, got, book, t_load = http_server_run(device, sync, spec, cfg_path,
                                               N_PODS)
        cmd_checks(name, r, N_PODS, "uniform_burst")
        add_launches(report, r["counts"])
        same_bindings(name, got, CMD_DEFAULT["bindings"],
                      "[cmd] default's embedded-store run")
        loop_s = r["state"]["loop_seconds"]
        print(f"[http] server: main --server --token (system:kube-scheduler, "
              f"RBAC) --once --burst {N_PODS} against an APIServer over "
              f"{N_NODES} hollow nodes and {N_PODS} pods (loaded in "
              f"{t_load:.2f} s): {r['summary']}; route "
              f"{cmd_route(r['state']['scheduler'])}; main's wall "
              f"{r['wall']:.2f} s, initial lists over HTTP "
              f"{book.get('list', 0) * 1e3:.1f} ms, loop "
              f"{loop_s * 1e3:.1f} ms ({N_PODS / loop_s:.1f} pods/s; "
              f"[cmd] default's {CMD_DEFAULT['loop_s'] * 1e3:.1f} ms, "
              f"{N_PODS / CMD_DEFAULT['loop_s']:.1f} pods/s), of which "
              f"the wave commits over HTTP "
              f"{book.get('commit_wave', 0) * 1e3:.1f} ms and the host "
              f"probes {book.get('missing_keys', 0) * 1e3:.1f} ms; launches "
              f"{ {k: v for k, v in r['counts'].items() if v} }; all bound "
              f"in the server's store, bindings equal to [cmd] default's")
        name = "http api-port"
        spec_small = write("spec-small.json", HTTP_API_SPEC)
        a = http_api_port_run(device, spec_small)
        if not isinstance(a["algorithm"], TorchScheduler) \
                or a["algorithm"].device.type != "cuda":
            raise SystemExit(f"{name}: the scheduler is {a['route']}")
        n_spec = HTTP_API_SPEC["nodes"][0]["count"]
        kinds = [e[0] for e in a["events"]]
        if a["nodes"] != n_spec or kinds[:1] != ["ADDED"] \
                or not a["events"][-1][1] \
                or any(e[2] <= a["rv"] for e in a["events"]):
            raise SystemExit(f"{name}: nodes {a['nodes']}, events "
                             f"{a['events']} after rv {a['rv']}")
        no_degrade(name)
        print(f"[http] api-port: main --api-port (a free port) "
              f"--cluster-spec ({n_spec} nodes, "
              f"{HTTP_API_SPEC['pending_pods'][0]['count']} pods), route "
              f"{a['route']}: GET /api/v1/nodes listed {a['nodes']} at rv "
              f"{a['rv']}; a pod POSTed, and the watch resumed from rv "
              f"{a['rv']} delivered {a['events']} (its ADDED, then the "
              f"command's bind)")
        name = "http arrivals"
        c = HTTP_ARRIVALS
        v = http_arrivals_run(device, sync, c["nodes"], c["rate"],
                              c["seconds"], c["window"], c["depth"],
                              c["max_depth"], c["lag"])
        g = v["arrivals"]
        if v["counts"]["uniform_burst"] == 0:
            raise SystemExit(f"{name}: K3 uniform_burst was not launched "
                             f"({v['counts']})")
        if v["twins"] or v["refusals"]:
            raise SystemExit(f"{name}: twin cycles {v['twins']}, refusals "
                             f"{v['refusals']}")
        no_degrade(name)
        unbound = [p.name for p in v["pods"] if not p.node_name]
        if not (g["rejected_429"] > 0 and v["gate"].rejected > 0):
            raise SystemExit(f"{name}: no 429 crossed the wire ({g})")
        if unbound or len(v["pods"]) != g["created"] or g["gave_up"] \
                or g["pending_retry"]:
            raise SystemExit(f"{name}: {len(v['pods'])} created pods in the "
                             f"store, {len(unbound)} unbound, arrivals {g}")
        if v["audit"].violations:
            raise SystemExit(f"{name}: double binds "
                             f"{v['audit'].violations[:3]}")
        add_launches(report, v["counts"])
        led = v["ledger"]
        print(f"[http] arrivals: {c['nodes']} nodes, arrivals POSTed through "
              f"RemoteStore at {c['rate']:.0f}/s for {v['elapsed']:.2f} s "
              f"(started {c['lag']} s before the loop), window "
              f"{c['window']}, depth {c['depth']}, the gate at "
              f"{c['max_depth']}: sustained {v['sustained']:.1f} pods/s; "
              f"sheds {v['gate'].rejected} (429s {g['rejected_429']}); "
              f"startup p50 {led['startup_p50'] * 1e3:.2f} ms, p99 "
              f"{led['startup_p99'] * 1e3:.2f} ms ({led['pods_completed']} "
              f"pods); arrivals {g}; all {len(v['pods'])} created pods "
              f"bound, double binds 0; launches "
              f"{ {k: v2 for k, v2 in v['counts'].items() if v2} }")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the [cluster] phase's world: bench.py's cluster as hollow nodes (4 CPU /
#: 32 Gi / 110 pods, 3 zones), a Deployment of bench.py's pod count and a
#: Job beside it; part (a) kills the kubelets of `dead_per_zone` nodes a
#: zone
CLUSTER_CELL = {"nodes": N_NODES, "zones": 3, "replicas": N_PODS,
                "job_pods": 1000, "dead_per_zone": 2}
#: seconds a stepped round advances the FakeClock, between the scheduler
#: and the kubelets' tick (a live node's lease is never stale when the
#: node-lifecycle monitor reads it): past the 40 s grace period in one
#: round and past the 300 s default toleration in two
CLUSTER_ROUND_S = 150.0
CLUSTER_ROUNDS = 16             # the most rounds a stage may take
#: part (b)'s cluster size: 5,000 nodes, the largest the v1.15
#: scalability SLOs cover. At bench.py's 15,000 the four loops under one
#: interpreter lock took 176.4 s from the create to the last pod Running
#: and the phase 303.7 s (PERF.md §4, §6)
CLUSTER_THREADED_NODES = 5000
CLUSTER_WEB = {"cpu": 100, "memory": 500 * MI}     # bench.py's pod
CLUSTER_ROLLED = {"cpu": 250, "memory": GI}
STARTUP_SLO_S = 5.0             # density.go's pod startup SLO
CLUSTER_CHILD_S = 900           # the most seconds a part (a) run may take


def cluster_modules():
    """The port's modules a stepped run reads, under the names
    `ClusterSteps` takes them by (its caller passes them in, so the same
    driver can pump another package's copies)."""
    from types import SimpleNamespace
    from kubernetes_tpu_torch.api import types
    from kubernetes_tpu_torch.cmd import cluster
    from kubernetes_tpu_torch.store import store
    from kubernetes_tpu_torch.utils import clock
    return SimpleNamespace(pkg="kubernetes_tpu_torch", cluster=cluster,
                           T=types, S=store, clock=clock)


def cluster_objects(m, replicas, req):
    """(kind, object) of the web Service, its PDB (1 % of the replicas may
    be disrupted) and the Deployment of `replicas` pods of `req`,
    RollingUpdate at the reference's 25 % maxSurge / maxUnavailable."""
    T, S = m.T, m.S
    sel = T.LabelSelector.from_dict({"app": "web"})
    return [
        (S.SERVICES, T.Service(name="web", selector={"app": "web"})),
        (S.PDBS, T.PodDisruptionBudget(
            name="web", selector=sel,
            min_available=replicas - max(1, replicas // 100))),
        (S.DEPLOYMENTS, T.Deployment(
            name="web", replicas=replicas, selector=sel,
            max_surge=replicas // 4, max_unavailable=replicas // 4,
            template=cluster_template(m, "web", req)))]


def cluster_job(m, n_pods):
    """A Job of `n_pods` of bench.py's pod, all at once: a burst of
    identical pods no Service or ReplicaSet selects, so the scheduler
    takes it as one uniform class (K3); the Deployment's pods carry
    selector spread (its Service and ReplicaSet), so they take the scan
    (K5), as in the reference."""
    return m.T.Job(name="batch", completions=n_pods, parallelism=n_pods,
                   template=cluster_template(m, "batch", CLUSTER_WEB))


def cluster_template(m, app, req):
    T = m.T
    return T.PodTemplate(labels={"app": app}, containers=(
        T.Container.make(name="c", requests=dict(req)),))


class ClusterSteps:
    """Part (a)'s driver: the components a `Cluster` of package `m`
    (`cluster_modules()`) builds, pumped by hand in a fixed order with no
    threads: `start()`'s syncs and first kubelet tick, then rounds of the
    controllers, the scheduler's pump and `schedule_burst(max_pods=1024)`
    until it returns 0, the FakeClock's step, the kubelets' tick, the
    controllers and the proxiers. The kubelets and every controller read
    the FakeClock; the scheduler keeps its own clock. `sched_kw` picks
    the scheduler's route (`device=` here)."""

    def __init__(self, m, nodes, zones, **sched_kw):
        self.m = m
        self.book = {}
        t = time.perf_counter()
        c = self.c = m.cluster.Cluster(n_nodes=nodes, zones=zones,
                                       api_port=-1, **sched_kw)
        self.clock = m.clock.FakeClock(1_000_000.0)
        for k in c.kubelets:
            k.clock = self.clock
        for ctl in c.controllers.controllers.values():
            if hasattr(ctl, "clock"):
                ctl.clock = self.clock
        c.scheduler.sync()
        c.controllers.sync()
        for p in c.proxies:
            p.sync()
        c.kubelet_tick()
        self.book["set-up"] = time.perf_counter() - t
        self.rounds = 0

    def _timed(self, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.book[name] = self.book.get(name, 0.0) + time.perf_counter() - t
        return out

    def _proxies(self):
        for p in self.c.proxies:
            p.pump()

    def round(self):
        c = self.c
        self._timed("controllers", c.controllers.pump)
        while True:
            self._timed("scheduler", c.scheduler.pump)
            if not self._timed("scheduler", c.scheduler.schedule_burst,
                               1024):
                break
        self.clock.step(CLUSTER_ROUND_S)
        self._timed("kubelets", c.kubelet_tick)
        self._timed("controllers", c.controllers.pump)
        self._timed("proxiers", self._proxies)
        self.rounds += 1

    def until(self, stage, done):
        for _ in range(CLUSTER_ROUNDS):
            self.round()
            if done():
                return
        raise SystemExit(f"cluster stepped ({self.m.pkg}): {stage} not "
                         f"done after {CLUSTER_ROUNDS} rounds")

    def pods(self, app):
        return [p for p in self.c.store.list(self.m.S.PODS)[0]
                if p.labels.get("app") == app]

    def web_ready(self, replicas, cpu, dead=()):
        """All `replicas` web pods of one ReplicaSet bound and Running at
        `cpu` millicores, none on a `dead` node, in the Endpoints and in
        every proxier's table."""
        T, S, store = self.m.T, self.m.S, self.c.store
        pods = self.pods("web")
        sets = [r for r in store.list(S.REPLICASETS)[0]
                if r.owner_ref and r.owner_ref[1] == "web"]
        eps = {e.key: e for e in store.list(S.ENDPOINTS)[0]}
        ep = eps.get("default/web")
        return (len(pods) == replicas and len(sets) == 1
                and sets[0].ready_replicas == replicas
                and all(p.node_name and p.phase == "Running"
                        and p.node_name not in dead
                        and T.get_resource_request(p).milli_cpu == cpu
                        for p in pods)
                and ep is not None and len(ep.addresses) == replicas
                and all(len(p.backends("default/web")) == replicas
                        for p in self.c.proxies))

    def roll(self, req):
        """The web Deployment's template becomes `req`'s."""
        def mutate(dep):
            dep.template = cluster_template(self.m, "web", req)
            return dep
        self.c.store.guaranteed_update(self.m.S.DEPLOYMENTS, "default/web",
                                       mutate)

    def kill(self, per_zone):
        """Stop the kubelets of the first `per_zone` nodes of each zone (by
        name) that hold a web pod; returns their names."""
        holding = {p.node_name for p in self.pods("web")}
        zone = {n.name: n.labels.get(self.m.T.LABEL_ZONE_FAILURE_DOMAIN, "")
                for n in self.c.store.list(self.m.S.NODES)[0]}
        dead, by_zone = [], {}
        for name in sorted(holding):
            if by_zone.get(zone[name], 0) < per_zone:
                by_zone[zone[name]] = by_zone.get(zone[name], 0) + 1
                dead.append(name)
        for k in self.c.kubelets:
            if k.node_name in dead:
                k.stop()
        return dead

    def summary(self):
        """What the CUDA and CPU runs must agree on: every pod's node and
        phase, the ReplicaSets' names and statuses, the Endpoints, and
        every proxier's table (an md5 of each backend tuple, computed
        once a tuple object)."""
        import hashlib
        S, store = self.m.S, self.c.store
        memo = {}

        def digest(t):
            d = memo.get(id(t))
            if d is None:
                d = memo[id(t)] = (t, hashlib.md5(
                    repr(t).encode()).hexdigest())
            return d[1]
        out = {
            "pods": sorted([p.key, p.node_name, p.phase]
                           for p in store.list(S.PODS)[0]),
            "replicasets": sorted(
                [r.name, r.replicas, r.observed_replicas, r.ready_replicas]
                for r in store.list(S.REPLICASETS)[0]),
            "endpoints": {e.key: digest(tuple(e.addresses))
                          for e in store.list(S.ENDPOINTS)[0]},
            "tables": [[p.node_name, sorted(
                [k, digest(v)] for k, v in p.rules().items())]
                for p in self.c.proxies]}
        return json.loads(json.dumps(out))

    def scheduled_once(self):
        """Every pod the scheduler bound has exactly one Scheduled event,
        naming its node: no pod was bound twice. (A DaemonSet's pods are
        bound by their controller, with no event.) Returns the keys with
        more than one such event and the pods without the one."""
        S, store = self.m.S, self.c.store
        events = {}
        for e in store.list(S.EVENTS)[0]:
            if e.reason == "Scheduled":
                events.setdefault(e.involved_key, []).append(e.message)
        twice = [k for k, v in events.items() if len(v) != 1]
        wrong = [p.key for p in store.list(S.PODS)[0]
                 if not (p.owner_ref and p.owner_ref[0] == "DaemonSet")
                 and (len(events.get(p.key, ())) != 1
                      or not events[p.key][0].endswith(
                          f" to {p.node_name}"))]
        return twice, wrong


def cluster_stepped(device, nodes, zones, replicas, per_zone, job_pods):
    """Part (a) on `device`: the scale-up (the Deployment and the Job),
    the rollout to the second template and the node death, a summary
    after each stage; returns the summaries, rounds, dead nodes,
    launches, counts and times. The pod names come from the process's
    counters (`controllers/replicaset.py`, `controllers/job.py`): two
    runs agree only if both start them at the same value."""
    from kubernetes_tpu_torch import obs
    from kubernetes_tpu_torch.ops import kernels as K
    m = cluster_modules()
    t0 = time.perf_counter()
    s = ClusterSteps(m, nodes, zones, device=device)
    store = s.c.store
    obs.reset()
    for kind, obj in cluster_objects(m, replicas, CLUSTER_WEB):
        store.create(kind, obj)
    store.create(m.S.JOBS, cluster_job(m, job_pods))
    stages = []
    s.until("scale-up", lambda: s.web_ready(replicas, CLUSTER_WEB["cpu"]))
    stages.append(["scale-up", s.rounds, s.summary()])
    s.roll(CLUSTER_ROLLED)
    s.until("rollout", lambda: s.web_ready(replicas, CLUSTER_ROLLED["cpu"]))
    stages.append(["rollout", s.rounds, s.summary()])
    dead = s.kill(per_zone)
    s.until("node death", lambda: s.web_ready(
        replicas, CLUSTER_ROLLED["cpu"], dead))
    stages.append(["node death", s.rounds, s.summary()])
    counts = K.launches()
    twins, refusals = obs.family("twin"), obs.family("refusal")
    twice, wrong = s.scheduled_once()
    alg = s.c.scheduler.algorithm
    return {"stages": stages, "dead": dead, "counts": counts,
            "twins": twins, "refusals": refusals, "twice": twice[:5],
            "wrong": wrong[:5], "book": s.book,
            "route": f"{type(alg).__name__} on "
                     f"{getattr(alg, 'device', None)}",
            "wall": time.perf_counter() - t0}


def summary_diff(a, b, path=()):
    """Where two nested dicts and lists first differ: (the path of keys
    and indices, a's value, b's value), "length" ending the path where
    one list is longer; None where they are equal."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if k not in a or k not in b:
                return path + (k,), a.get(k), b.get(k)
            d = summary_diff(a[k], b[k], path + (k,))
            if d is not None:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            d = summary_diff(x, y, path + (i,))
            if d is not None:
                return d
        if len(a) != len(b):
            return path + ("length",), len(a), len(b)
        return None
    return None if a == b else (path, a, b)


CLUSTER_HASH_SEED = "23"       # PYTHONHASHSEED of both part (a) runs


def cluster_run(path, c, device):
    """Part (a) of cell `c` on `device`, in a child process of its own
    with the pod-name counters from 1; writes its result to `path`. The
    CPU run (the kernels' plain versions) takes one torch thread."""
    import itertools
    from kubernetes_tpu_torch.controllers import job, replicaset
    replicaset._suffix = itertools.count(1)
    job._suffix = itertools.count(1)
    if device == "cpu":
        import torch
        torch.set_num_threads(1)
    out = cluster_stepped(device, c["nodes"], c["zones"], c["replicas"],
                          c["dead_per_zone"], c["job_pods"])
    if device != "cpu":
        no_degrade("cluster stepped")
    with open(path, "w") as f:
        json.dump(out, f)


class ClusterRun:
    """Part (a) on one device in a spawned child process. The
    controllers drain their dirty keys as JAX's do, by `set.pop()`, whose
    order follows the strings' hashes: both runs get one PYTHONHASHSEED
    (CLUSTER_HASH_SEED), so the card's run and the CPU's drain their sets
    in one order, whatever this process's own seed."""

    def __init__(self, device, cell=None):
        import multiprocessing
        import os
        import tempfile
        self.device = device
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
        self.path = f"{self.tmp}/{device}.json"
        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=cluster_run, args=(self.path, cell or CLUSTER_CELL,
                                      device), daemon=True)
        seed = os.environ.get("PYTHONHASHSEED")
        os.environ["PYTHONHASHSEED"] = CLUSTER_HASH_SEED
        try:
            self.proc.start()
        finally:
            if seed is None:
                os.environ.pop("PYTHONHASHSEED", None)
            else:
                os.environ["PYTHONHASHSEED"] = seed

    def result(self, timeout):
        """The run's result; fails if it did not end in `timeout` s or
        failed."""
        self.proc.join(timeout)
        if self.proc.is_alive() or self.proc.exitcode != 0:
            state = ("did not end" if self.proc.is_alive()
                     else f"failed (exit code {self.proc.exitcode})")
            raise SystemExit(f"cluster stepped: the run on {self.device} "
                             f"{state}")
        with open(self.path) as f:
            out = json.load(f)
        out["ended_s"] = time.perf_counter() - self.t0
        return out

    def stop(self):
        import shutil
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(10)
        shutil.rmtree(self.tmp, ignore_errors=True)


class PodTimes:
    """A watch on the pods, drained on a thread of its own: when each pod
    was first seen (created) and first seen Running, and the live set."""

    def __init__(self, store):
        import threading
        from kubernetes_tpu_torch.store.store import PODS
        self.created, self.running, self.live = {}, {}, set()
        self.errors = []
        self._watch = store.watch(PODS)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                ev = self._watch.next(timeout=0.05)
                if ev is None:
                    continue
                now = time.perf_counter()
                key = ev.obj.key
                if ev.type == "DELETED":
                    self.live.discard(key)
                    continue
                self.live.add(key)
                self.created.setdefault(key, now)
                if ev.obj.phase == "Running":
                    self.running.setdefault(key, now)
        except Exception as e:   # reported by the phase, never swallowed
            self.errors.append(repr(e))

    def running_live(self):
        return sum(1 for k in list(self.live) if k in self.running)

    def stop(self):
        self._stop.set()
        self._watch.stop()
        self._thread.join(5.0)


def cluster_threaded(device, nodes, replicas):
    """Part (b): `Cluster(...).start()` with the REST apiserver on a free
    port and its four loops on threads; kubectl creates the web Service,
    PDB and Deployment over HTTP; pods/s from the create to the last pod
    Running and each pod's startup (first seen -> first seen Running), as
    the JAX harness's run_e2e_density measures them; then one `kubectl
    delete pods` and its replacement Running."""
    import io
    import tempfile
    from kubernetes_tpu_torch.api import serde
    from kubernetes_tpu_torch.cmd import kubectl
    from kubernetes_tpu_torch.cmd.cluster import Cluster
    from kubernetes_tpu_torch.ops import kernels as K
    from kubernetes_tpu_torch import obs
    t0 = time.perf_counter()
    # the kubelets tick every 0.02 s, as in run_e2e_density
    c = Cluster(n_nodes=nodes, zones=3, api_port=0, device=device,
                kubelet_interval=0.02)
    times = PodTimes(c.store)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    try:
        c.start()
        t_up = time.perf_counter() - t0
        path = f"{tmp}/web.json"
        with open(path, "w") as f:
            json.dump({"items": [dict(serde.to_dict(o), kind=kind)
                                 for kind, o in cluster_objects(
                                     cluster_modules(), replicas,
                                     CLUSTER_WEB)]}, f)
        obs.reset()

        def kc(*argv):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = kubectl.main(["--server", c.url, *argv])
            if rc != 0:
                raise SystemExit(f"cluster threaded: kubectl {argv} -> {rc}")
            return out.getvalue()
        t_create = time.perf_counter()
        said = kc("create", "-f", path)
        if not c.wait_for(lambda: times.running_live() >= replicas,
                          timeout=240):
            raise SystemExit(f"cluster threaded: {times.running_live()} of "
                             f"{replicas} pods Running after 240 s")
        web = [k for k in times.running if k.startswith("default/web-")]
        t_last = max(times.running[k] for k in web)
        lats = sorted(times.running[k] - times.created[k] for k in web)
        victim = sorted(web)[0]
        t_del = time.perf_counter()
        kc("delete", "pods", victim)
        if not c.wait_for(lambda: victim not in times.live
                          and times.running_live() >= replicas,
                          timeout=60):
            raise SystemExit(f"cluster threaded: {victim}'s replacement "
                             f"not Running after 60 s")
        t_replaced = time.perf_counter() - t_del
        counts = K.launches()
        twins, refusals = obs.family("twin"), obs.family("refusal")
        alg = c.scheduler.algorithm
        route = f"{type(alg).__name__} on {getattr(alg, 'device', None)}"
    finally:
        times.stop()
        c.stop()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    if times.errors:
        raise SystemExit(f"cluster threaded: the pod watch failed "
                         f"{times.errors}")

    def pct(q):
        return lats[min(len(lats) - 1, int(q * len(lats)))]
    return {"up_s": t_up, "said": said.strip().splitlines(),
            "pods_s": len(web) / (t_last - t_create), "n": len(web),
            "create_to_running_s": t_last - t_create,
            "p50": pct(0.50), "p99": pct(0.99), "replaced_s": t_replaced,
            "counts": counts, "twins": twins, "refusals": refusals,
            "route": route}


def cluster_phase(device, sync, report, runs=None):
    """`[cluster]`: the cluster-in-a-process (`cmd/cluster.py`) on the
    card. (a) its components pumped by hand (`ClusterSteps`) at bench.py's
    world, CLUSTER_CELL: the web Deployment's scale-up, the rollout to the
    second template, then the kubelets of two nodes a zone stop and the
    FakeClock runs past the grace period and the pods' 300 s tolerations
    until their pods are evicted, replaced and bound again; held against
    the same run on device="cpu" (a child process each, `runs`: started
    by `cuda_phases` before the variant checks that run beside them, or
    here): every pod's node and phase,
    the ReplicaSets, the Endpoints and every proxier's table after each
    stage, and the rounds; launches by kernel, K3 among them, no twin or
    refusal count, no double bind. (b), once both have ended,
    `Cluster(...).start()` with the apiserver on a free port, the same
    Deployment created with kubectl over HTTP: pods/s and startup p50 /
    p99 against the 5 s SLO, then one `kubectl delete pods` and its
    replacement."""
    cell = CLUSTER_CELL
    ref_run, run = runs or (ClusterRun("cpu"), ClusterRun("cuda"))
    try:
        name = "cluster stepped"
        a = run.result(CLUSTER_CHILD_S)
        print(f"[cluster] stepped on cuda (a child process): "
              f"{a['wall']:.1f} s "
              f"{ {k: round(v, 1) for k, v in a['book'].items()} }, ended "
              f"{a['ended_s']:.1f} s after its spawn, rounds "
              f"{[st[:2] for st in a['stages']]}", flush=True)
        counts = a["counts"]
        if "TorchScheduler on cuda" not in a["route"]:
            raise SystemExit(f"{name}: the scheduler is {a['route']}")
        if counts["uniform_burst"] == 0:
            raise SystemExit(f"{name}: K3 uniform_burst was not launched "
                             f"({counts})")
        if a["twins"] or a["refusals"]:
            raise SystemExit(f"{name}: twin cycles {a['twins']}, refusals "
                             f"{a['refusals']}")
        if a["twice"] or a["wrong"]:
            raise SystemExit(f"{name}: pods bound twice {a['twice']}, "
                             f"without one Scheduled event on their node "
                             f"{a['wrong']}")
        t_wait = time.perf_counter()
        ref = ref_run.result(CLUSTER_CHILD_S)
        t_wait = time.perf_counter() - t_wait
        if ref["dead"] != a["dead"]:
            raise SystemExit(f"{name}: dead nodes {a['dead']} on cuda, "
                             f"{ref['dead']} on cpu")
        for (sn, sr, got), (rn, rr, want) in zip(a["stages"],
                                                 ref["stages"]):
            if (sn, sr) != (rn, rr):
                raise SystemExit(f"{name}: {sn} took {sr} rounds on cuda, "
                                 f"{rr} on cpu")
            for part in ("pods", "replicasets", "endpoints", "tables"):
                if got[part] != want[part]:
                    diff = summary_diff(got[part], want[part])
                    raise SystemExit(f"{name}: after the {sn}, {part} "
                                     f"differ from the device=\"cpu\" run "
                                     f"at {diff}")
        add_launches(report, counts)
        pods = a["stages"][-1][2]["pods"]
        web = [p for p in pods if p[0].startswith("default/web-")]
        bk = {k: round(v, 1) for k, v in a["book"].items()}
        rbk = {k: round(v, 1) for k, v in ref["book"].items()}
        print(f"[cluster] stepped: {cell['nodes']} hollow nodes in "
              f"{cell['zones']} zones, a Deployment of {cell['replicas']} "
              f"pods (100m / 500 Mi) with a Service and a PDB, a Job of "
              f"{cell['job_pods']} such pods at once; rounds: "
              f"scale-up {a['stages'][0][1]}, rollout to 250m / 1 Gi "
              f"{a['stages'][1][1]}, the kubelets of {len(a['dead'])} nodes "
              f"stopped {a['dead']} {a['stages'][2][1]}; {len(web)} web "
              f"pods Running, none on a dead node, double binds 0; "
              f"{len(pods)} pods, the ReplicaSets, the Endpoints and "
              f"{len(a['stages'][2][2]['tables'])} proxier tables equal to "
              f"the device=\"cpu\" run after each stage; launches "
              f"{ {k: v for k, v in counts.items() if v} }; route "
              f"{a['route']}; cuda run {a['wall']:.1f} s {bk}; cpu run "
              f"{ref['wall']:.1f} s {rbk}, waited {t_wait:.1f} s for it")
        name = "cluster threaded"
        b = cluster_threaded(device, CLUSTER_THREADED_NODES,
                             cell["replicas"])
        if "TorchScheduler on cuda" not in b["route"]:
            raise SystemExit(f"{name}: the scheduler is {b['route']}")
        if b["twins"] or b["refusals"]:
            raise SystemExit(f"{name}: twin cycles {b['twins']}, refusals "
                             f"{b['refusals']}")
        no_degrade(name)
        if b["n"] != cell["replicas"]:
            raise SystemExit(f"{name}: {b['n']} web pods Running")
        add_launches(report, b["counts"])
        print(f"[cluster] threaded: Cluster(...).start() on "
              f"{CLUSTER_THREADED_NODES} hollow nodes (up in "
              f"{b['up_s']:.1f} s), kubectl create -f ({b['said']}): "
              f"{b['n']} pods Running {b['create_to_running_s']:.2f} s "
              f"after the create, {b['pods_s']:.1f} pods/s; startup p50 "
              f"{b['p50']:.3f} s, p99 {b['p99']:.3f} s (density.go's SLO "
              f"{STARTUP_SLO_S:.0f} s: "
              f"{'met' if b['p99'] <= STARTUP_SLO_S else 'missed'}); "
              f"kubectl delete pods: the replacement Running in "
              f"{b['replaced_s']:.2f} s; launches "
              f"{ {k: v for k, v in b['counts'].items() if v} }; route "
              f"{b['route']}")
    finally:
        run.stop()
        ref_run.stop()


def degrade_drill(device, sync, n_nodes=N_NODES, n_burst=128, n_serial=12):
    """The device-fault degrade on the card (see the module docstring):
    decisions equal to the undisturbed run, every fault counted."""
    from kubernetes_tpu_torch import chaos, obs
    from kubernetes_tpu_torch.core.torch_scheduler import TorchScheduler
    name = "degrade"
    f0 = breaker_faults()

    def world():
        infos, tree = cluster(n_nodes)
        return infos, tree, TorchScheduler(
            percentage_of_nodes_to_score=100, node_tree=tree, device=device)

    def serial(sched, infos, tree, plan_at=None, plan=None, until=None):
        """Serial cycles; the chaos plan `plan()` installed before cycle
        `plan_at` and removed after cycle `until` (default: the same)."""
        out = []
        for j, p in enumerate(pods(n_serial, prefix="drill-serial",
                                   cpu=300)):
            if j == plan_at:
                plan()
            r = sched.schedule(p, infos, tree.list_names())
            if j == (plan_at if until is None else until):
                chaos.disable()
            out.append((r.suggested_host, sched.last_index,
                        sched.last_node_index))
            assume(infos, p, r.suggested_host)
        return out

    def burst(sched, infos, tree, fault):
        """The burst with a commit callback; a faulted burst's undecided
        tail decided by serial cycles, as the shell's fallback does."""
        batch = pods(n_burst, prefix="drill")
        done = []
        if fault:
            chaos.plan(seed=0, rates={"device.fetch": 1.0}, limit=1)
        hosts = sched.schedule_burst(
            batch, infos, tree.list_names(),
            commit=lambda lo, hs: done.append((lo, hs)) or True)
        chaos.disable()
        k = len(hosts) - hosts.count(None) if hosts is not None else 0
        gens = [assume(infos, p, h) for p, h in zip(batch[:k], hosts[:k])]
        sched.note_burst_assumed_many(batch[:k], hosts[:k], gens)
        if k:
            tree.advance_enumerations(k - 1)
        out = list(hosts[:k])
        for p in batch[k:]:
            r = sched.schedule(p, infos, tree.list_names())
            assume(infos, p, r.suggested_host)
            out.append(r.suggested_host)
        return out, k

    obs.reset()
    infos, tree, ref = world()
    want_burst, k_ref = burst(ref, infos, tree, False)
    want_serial = serial(ref, infos, tree)
    if k_ref != n_burst or obs.family("twin"):
        raise SystemExit(f"{name}: the undisturbed run decided {k_ref} of "
                         f"{n_burst} on the device ({obs.family('twin')})")
    # one fault at the burst's fetch, one at a serial cycle's dispatch
    obs.reset()
    infos, tree, sched = world()
    t0 = time.perf_counter()
    got_burst, k = burst(sched, infos, tree, True)
    t_burst = time.perf_counter() - t0
    got_serial = serial(sched, infos, tree, plan_at=3, plan=lambda:
                        chaos.plan(seed=0, rates={"device.dispatch": 1.0},
                                   limit=1))
    st = sched.breaker.debug_state()
    twins = obs.family("twin")
    if (got_burst, got_serial) != (want_burst, want_serial):
        raise SystemExit(f"{name}: decisions under the two faults differ "
                         f"from the undisturbed run")
    if k != 0 or twins.get("device-fault") != 2 or st["faults_total"] != 2 \
            or st["state"] != "closed" or st["trips_total"]:
        raise SystemExit(f"{name}: {k} burst decisions kept, twin {twins}, "
                         f"breaker {st}")
    # three faults in a row open the circuit; a probe closes it
    obs.reset()
    infos, tree, sched = world()
    sched.breaker.probe_after = 4
    burst(sched, infos, tree, False)
    got_trip = serial(sched, infos, tree, plan_at=0, until=2, plan=lambda:
                      chaos.plan(seed=0, rates={"device.dispatch": 1.0},
                                 limit=3))
    tr = sched.breaker.debug_state()
    trip_twins = obs.family("twin")
    if got_trip != want_serial:
        raise SystemExit(f"{name}: decisions with the circuit open differ "
                         f"from the undisturbed run")
    if tr["faults_total"] != 3 or tr["trips_total"] != 1 \
            or tr["promotions_total"] != 1 or tr["state"] != "closed" \
            or trip_twins.get("device-fault") != 3 \
            or trip_twins.get("circuit-open") != 3:
        raise SystemExit(f"{name}: trip and probe gave breaker {tr}, twin "
                         f"{trip_twins}")
    faults = breaker_faults() - f0
    if faults != 5:
        raise SystemExit(f"{name}: the breakers booked {faults} faults, "
                         f"not 5")
    DRILL_FAULTS["n"] += faults
    obs.reset()
    print(f"[degrade] {n_nodes} nodes: a DeviceFault at device.fetch of a "
          f"{n_burst}-pod uniform burst ({k} decisions kept, the tail "
          f"decided by {n_burst} serial cycles in {t_burst * 1e3:.1f} ms) "
          f"and one at device.dispatch of serial cycle 4 of {n_serial}: "
          f"twin.device-fault {twins['device-fault']}, breaker faults "
          f"{st['faults_total']}, state {st['state']}; three faults in a "
          f"row: {trip_twins['circuit-open']} cycles on the host twin with "
          f"the circuit open, trips {tr['trips_total']}, probe after "
          f"{sched.breaker.probe_after} refused gates, promotions "
          f"{tr['promotions_total']}; every decision equal to the "
          f"undisturbed run; counts reset")


def no_twin(phase):
    """Fail when a phase other than twin_phase decided a cycle on the host
    twin."""
    from kubernetes_tpu_torch import obs
    twins = obs.family("twin")
    if twins:
        raise SystemExit(f"{phase}: cycles decided on the host twin "
                         f"{twins}")


def cards_phase(report):
    """`--cards`: the mesh phase over every card of the host, one shard
    per card (the mesh steps' locals write their records into every
    card's buffer over NVLink and publish stamps, the "peer" exchange;
    the other all-gathers' copies are peer copies between the cards):
    K13a-K14b against their plain versions on meshes of all the
    cards and of the first two, mesh-preempt-wave held against the
    single-device K8 wave on the first card and four mesh-preempt-single
    rounds held against K7; K13b, K9b and K9d at their C3 geometries
    over every card; K9a-d and K10a-K11b against their plain
    versions, then mesh-uniform at 15,000 and 15,001 nodes held against
    the single-device K3/K2 run on the first card, and mesh-scan-default
    (15,000 nodes) and mesh-fused held against the single-device K5 / K6
    run on the first card; last, mesh-scan-default once more on a mesh of
    the same cards that takes the host's copies (`exchange="copy"`)."""
    import torch
    from kubernetes_tpu_torch.parallel import sharding as S
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit("--cards needs a host with several cards")

    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)
    mesh = S.make_mesh()
    device = mesh.devices[0]
    meshes = [list(mesh.devices), list(mesh.devices[:2])]
    # the preemption paths first: their world is built once
    mesh_preempt_variant_checks(device, sync, meshes=meshes)
    mesh_pressure_local_checks(device, sync, meshes=meshes)
    pressure_select_geometry_checks(device, sync, list(mesh.devices))
    cycle_select_geometry_checks(device, sync, list(mesh.devices))
    uniform_select_geometry_checks(device, sync, list(mesh.devices))
    cycle_variant_checks(device, sync)
    infos, tree, pdbs = preempt_world(N_NODES)
    with capture("pressure_batch", keep_all=True) as one:
        single = run_wave(infos, tree, pdbs, wave_pods(), device, sync)
    mesh_wave_path(infos, tree, pdbs, device, sync, report,
                   (single, one.all), mesh=mesh)
    mesh_single_path(infos, tree, pdbs, device, sync, report, mesh=mesh,
                     rounds=4)
    del infos, tree, pdbs
    mesh_variant_checks(device, sync, meshes=meshes)
    for name, nn in (("even zones", N_NODES),
                     ("uneven zones (rotate)", N_NODES + 1)):
        mesh_path(f"{name}, {n} cards", nn, device, sync, report,
                  nn == N_NODES, mesh=mesh)
    mesh_scan_variant_checks(device, sync, meshes=meshes)
    mesh_local_checks(device, sync, meshes=meshes)
    refs = {}
    cfg, n_nodes, window_fn = scan_cells()[0]
    with capture("schedule_batch") as one:
        run = run_scan(cfg, n_nodes, window_fn(N_PODS), cfg["serial"],
                       device, sync)
    refs[cfg["name"]] = (run, one.last)
    with capture("schedule_batch_segments") as one:
        run = run_fused(FUSED_CELL, N_NODES, fused_window(), device, sync)
    refs[FUSED_CELL["name"]] = (run, one.last)
    mesh_scan_paths(device, sync, report, refs, mesh=mesh,
                    cells=(cfg["name"],))
    # the host's copies, as a host without peer access between its cards
    # takes them: the same window, held against the same reference
    copy_mesh = S.Mesh(mesh.devices, exchange="copy")
    mesh_scan_path(cfg, n_nodes, window_fn, device, sync,
                   {k: {"launches": 0} for k in report}, refs[cfg["name"]],
                   False, mesh=copy_mesh)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import kernels as K
    cards = sys.argv[1:] == ["--cards"]
    if sys.argv[1:] and not cards:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, or "
              f"--cards)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # a run still going near its limit (1,200 s) dumps every thread's
    # stack, so the log says where it stood if it hangs
    faulthandler.dump_traceback_later(RUN_LIMIT_S)
    device = torch.device("cuda")
    sync = torch.cuda.synchronize
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    card = ("\n".join(lines if cards else lines[:1]) if lines
            else f"nvidia-smi: {smi.stderr.strip()}")
    print(card)
    print("kernels: K1 local_total, K2 schedule_cycle, K3 uniform_burst, "
          "K4 scatter_rows, K5 schedule_batch, K6 schedule_segments, "
          "K7 preempt_scan, K8 pressure_batch, K9a shard_cycle_local, "
          "K9b shard_cycle_select, K9c shard_uniform_sweep, K9d "
          "shard_uniform_select, K10a shard_scan_local, K10b "
          "shard_scan_select, K11a shard_segments_local, K11b "
          "shard_segments_select, K13a shard_pressure_local, K13b "
          "shard_pressure_select, K14a shard_preempt_local, K14b "
          "shard_preempt_select (CUDA C++, sm_90a)")
    t = time.perf_counter()
    built = _build.build_all(verbose=True)
    print(f"[build] {sorted(built)} in {time.perf_counter() - t:.1f} s")
    if cards:
        report = {k: {"launches": 0} for k in K.KERNELS}
        cards_phase(report)
        no_twin("cards_phase")
        no_degrade("cards_phase")
        print(card)     # again beside the numbers, at the end of the log
        print(json.dumps({"kernels": [report[k] for k in MESH_KERNELS]}))
    else:
        report = cuda_phases(device, sync)
        print(card)     # again beside the numbers, at the end of the log
        print(json.dumps({"kernels": [report[k] for k in K.KERNELS]}))
    print(f"[time] chip_smoke.py {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cuda_phases(device, sync):
    """Every phase of the one-card run, in order; returns the kernels'
    report."""
    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[elapsed] {fn.__name__}: "
              f"{time.perf_counter() - t:.1f} s")
        no_twin(fn.__name__)
        no_degrade(fn.__name__)
        return out
    report = timed(kernel_checks, device, sync)
    timed(variant_checks, device, sync)
    timed(cycle_variant_checks, device, sync)
    timed(uniform_variant_checks, device, sync)
    timed(preempt_variant_checks, device, sync)
    timed(pressure_variant_checks, device, sync)
    timed(small_world_check, device, sync)
    timed(main_path, "even zones", N_NODES, device, sync, report)
    timed(main_path, "uneven zones (rotate)", N_NODES + 1, device, sync,
          report)
    timed(cycle_select_geometry_checks, device, sync)
    timed(uniform_select_geometry_checks, device, sync)
    timed(mesh_path, "even zones", N_NODES, device, sync, report, True)
    timed(mesh_path, "uneven zones (rotate)", N_NODES + 1, device, sync,
          report, False)
    refs = timed(scan_paths, device, sync, report)
    timed(scale_path, device, sync, report)
    timed(mesh_scan_variant_checks, device, sync)
    timed(mesh_local_checks, device, sync)
    timed(mesh_scan_paths, device, sync, report, refs)
    timed(preempt_paths, device, sync, report)
    timed(commit_phase, device, sync)
    timed(twin_phase, device, sync)
    timed(shell_uniform, device, sync, report)
    timed(shell_preempt_baseline, device, sync, report)
    timed(serve_phase, device, sync, report)
    timed(fleet_phase, device, sync, report)
    timed(cmd_phase, device, sync, report)
    timed(scraper_phase, device, sync, report)
    timed(tuner_phase, device, sync, report)
    timed(extender_phase, device, sync, report)
    timed(http_phase, device, sync, report)
    # [cluster] part (a) on the card and on device="cpu", each in a child
    # process: beside them run only the two variant checks, which time
    # nothing (the CPU run beside [http] cut its arrivals' rate tenfold)
    runs = (ClusterRun("cpu"), ClusterRun("cuda"))
    try:
        timed(scan_variant_checks, device, sync)
        timed(mesh_variant_checks, device, sync)
        timed(cluster_phase, device, sync, report, runs)
    finally:
        for run in runs:
            run.stop()
    timed(degrade_drill, device, sync)
    return report


if __name__ == "__main__":
    sys.exit(main())
