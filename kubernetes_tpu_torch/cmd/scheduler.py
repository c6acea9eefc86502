"""Scheduler command — cmd/kube-scheduler analog.

Mirrors cmd/kube-scheduler/app/server.go: flag/config layering
(options → SchedulerConfiguration → algorithm source), optional leader
election (:248-263), healthz (:201) and /metrics (:284) endpoints, then the
scheduling loop. The cluster substrate is the in-process store, loaded from
a cluster-spec JSON (hollow nodes + pods) or left empty for API-driven use.

Copied from the reference (`kubernetes_tpu.cmd.scheduler`) with the
port's imports. What differs:
- `--device` (default `cuda`) picks where the scheduler decides:
  `create_scheduler` builds the shell on a TorchScheduler on that device
  when the config routes to the device (the TPUScoring gate on, every
  priority and predicate on the kernels, no extender), else on the
  port's copy of the oracle. `--device cpu` runs the kernels' plain
  versions (the tests);
- `--server` / `--token` attach to a remote apiserver through the port's
  `store/remote.RemoteStore`, and `--api-port` serves the port's
  `apiserver/server.APIServer` over the embedded store, as the
  reference's flags do; `--profile-dir` (the profiler, ROADMAP A8) is not
  a flag of the port's command, and argparse refuses it;
- an error of the scheduling loop (a CUDA error of a kernel, a failed
  launch) ends the command with that error, under leader election too:
  the loop's thread hands it back to `main`.

Run: python -m kubernetes_tpu_torch.cmd.scheduler --cluster-spec spec.json --once
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubernetes_tpu_torch.apis.config import (
    SchedulerConfiguration, AlgorithmSource,
)
from kubernetes_tpu_torch.factory import create_scheduler
from kubernetes_tpu_torch.metrics import render_metrics, reset_metrics
from kubernetes_tpu_torch.models.hollow import NodeStrategy, PodStrategy, populate_store, make_pods
from kubernetes_tpu_torch.store.store import Store, PODS
from kubernetes_tpu_torch.utils.leader_election import LeaderElector, LeaderElectionConfig


def build_config(args) -> SchedulerConfiguration:
    if args.config:
        cfg = SchedulerConfiguration.from_file(args.config)
    else:
        cfg = SchedulerConfiguration()
    if args.algorithm_provider:
        cfg.algorithm_source = AlgorithmSource(provider=args.algorithm_provider)
    if args.policy_config_file:
        cfg.algorithm_source = AlgorithmSource(
            provider=None, policy_file=args.policy_config_file)
    if args.scheduler_name:
        cfg.scheduler_name = args.scheduler_name
    if args.percentage_of_nodes_to_score is not None:
        cfg.percentage_of_nodes_to_score = args.percentage_of_nodes_to_score
    if args.disable_preemption:
        cfg.disable_preemption = True
    if args.leader_elect:
        cfg.leader_election.leader_elect = True
    if args.feature_gates:
        for item in args.feature_gates.split(","):
            key, _, value = item.partition("=")
            cfg.feature_gates[key.strip()] = value.strip().lower() != "false"
    return cfg


def _pod_strategy(d: dict) -> PodStrategy:
    """A PodStrategy from JSON, which has no tuples: a list given for a
    tuple field (`node_affinity_values`) becomes a tuple, so the pods'
    affinity terms stay hashable. (The reference's command passes the
    list through and fails on such a spec.)"""
    d = dict(d)
    if isinstance(d.get("node_affinity_values"), list):
        d["node_affinity_values"] = tuple(d["node_affinity_values"])
    return PodStrategy(**d)


def load_cluster_spec(store: Store, path: str) -> None:
    """Cluster-spec JSON: {"nodes": [NodeStrategy kwargs...],
    "existing_pods": [PodStrategy kwargs...], "pending_pods": [...]}"""
    with open(path) as f:
        spec = json.load(f)
    node_strategies = [NodeStrategy(**n) for n in spec.get("nodes", [])]
    existing = [_pod_strategy(p) for p in spec.get("existing_pods", [])]
    populate_store(store, node_strategies, existing)
    idx = 0
    for p in spec.get("pending_pods", []):
        st = _pod_strategy(p)
        for pod in make_pods(st, start_index=idx):
            store.create(PODS, pod)
        idx += st.count


class _Handler(BaseHTTPRequestHandler):
    scheduler = None

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: str, ctype: str = "text/plain"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse
        u = urlparse(self.path)
        if u.path == "/healthz":
            self._send(200, "ok")
        elif u.path == "/metrics":
            # scheduler families + the process-global registry (device
            # pipeline, informers, workqueues) in one scrape — name sets
            # are disjoint, so the concatenation stays lintable
            from kubernetes_tpu_torch import obs
            self._send(200, render_metrics(self.scheduler)
                       + obs.render_global(),
                       "text/plain; version=0.0.4")
        elif u.path == "/debug/traces":
            # ?limit= newest N, ?cat= host|device
            from kubernetes_tpu_torch.obs import trace as obs_trace
            q = parse_qs(u.query)
            limit = q.get("limit", [None])[0]
            if limit is not None:
                try:
                    limit = int(limit)
                    if limit < 0:
                        raise ValueError(limit)
                except ValueError:
                    self._send(400, f"invalid limit {limit!r}")
                    return
            cat = q.get("cat", [None])[0]
            self._send(200, json.dumps(obs_trace.to_chrome(limit=limit,
                                                           cat=cat)),
                       "application/json")
        elif u.path == "/debug/timeseries":
            # the in-process time-series ring: ?family= one family,
            # ?window= newest N
            from kubernetes_tpu_torch.obs import timeseries as obs_timeseries
            q = parse_qs(u.query)
            window = q.get("window", [None])[0]
            if window is not None:
                try:
                    window = int(window)
                    if window < 0:
                        raise ValueError(window)
                except ValueError:
                    self._send(400, f"invalid window {window!r}")
                    return
            family = q.get("family", [None])[0]
            self._send(200, json.dumps(obs_timeseries.SCRAPER.series(
                family=family, window=window)), "application/json")
        elif u.path == "/debug/sched":
            from kubernetes_tpu_torch import obs
            snap = obs.debug_snapshot()
            # this command OWNS a scheduler: serve its sections directly
            # (no dependence on registration order / instance races)
            snap["scheduler"] = self.scheduler.debug_state()
            self._send(200, json.dumps(snap), "application/json")
        elif u.path == "/configz":
            self._send(200, json.dumps(self.scheduler_config.to_dict()),
                       "application/json")
        else:
            self._send(404, "not found")

    def do_DELETE(self):
        if self.path == "/metrics":
            reset_metrics(self.scheduler)
            self._send(200, "reset")
        else:
            self._send(404, "not found")


def serve_http(sched, cfg, port: int) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {
        "scheduler": sched, "scheduler_config": cfg})
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv: Optional[list[str]] = None,
         state: Optional[dict] = None) -> int:
    """The command. `state`, when given, is filled with the store, the
    config and the scheduler this run built, and the seconds of its
    scheduling loop (`loop_seconds`): for a caller that inspects the run,
    its bindings, its algorithm and device. With `--api-port` it also
    holds the `api_server`; a caller that runs `main` without `--once` on
    a thread ends it with `state["scheduler"].stop()`."""
    ap = argparse.ArgumentParser(prog="kube-scheduler-torch")
    ap.add_argument("--config", help="SchedulerConfiguration JSON file")
    ap.add_argument("--algorithm-provider")
    ap.add_argument("--policy-config-file")
    ap.add_argument("--scheduler-name")
    ap.add_argument("--percentage-of-nodes-to-score", type=int)
    ap.add_argument("--disable-preemption", action="store_true")
    ap.add_argument("--leader-elect", action="store_true")
    ap.add_argument("--leader-elect-identity", default="scheduler-0")
    ap.add_argument("--feature-gates", help="k=v,k2=v2 (e.g. TPUScoring=false)")
    ap.add_argument("--cluster-spec", help="cluster-spec JSON to load")
    ap.add_argument("--port", type=int, default=0, help="healthz/metrics port")
    ap.add_argument("--once", action="store_true",
                    help="drain the queue once and exit (bench/CI mode)")
    ap.add_argument("--burst", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the device route decides: cuda (the "
                         "kernels, the default) or cpu (their plain "
                         "versions)")
    ap.add_argument("--api-port", type=int, default=0,
                    help="also serve the REST apiserver surface over this "
                         "process's store (the in-process master of "
                         "test/integration/util/util.go:42)")
    ap.add_argument("--server",
                    help="attach to a REMOTE apiserver URL instead of an "
                         "embedded store: list+watch over HTTP with "
                         "resourceVersion resume and 410 re-list "
                         "(reflector.go:159) — the out-of-process posture "
                         "of every reference control-plane component")
    ap.add_argument("--token",
                    help="bearer token for --server (tokenfile authn; the "
                         "bootstrapped scheduler identity is "
                         "system:kube-scheduler)")
    args = ap.parse_args(argv)

    cfg = build_config(args)
    if args.server:
        if args.api_port:
            raise SystemExit("--server and --api-port are exclusive: a "
                             "remote-attached scheduler has no store of its "
                             "own to serve")
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store = RemoteStore(args.server, token=args.token)
        if args.cluster_spec:
            raise SystemExit("--cluster-spec requires the embedded store; "
                             "create objects through the apiserver instead")
    else:
        store = Store(watch_log_size=1 << 20)
        if args.cluster_spec:
            load_cluster_spec(store, args.cluster_spec)
    sched = create_scheduler(store, cfg, device=args.device)
    if state is not None:
        state.update(store=store, config=cfg, scheduler=sched)
    sched.sync()
    server = serve_http(sched, cfg, args.port) if args.port else None
    api_server = None
    if args.api_port:
        from kubernetes_tpu_torch.apiserver.server import APIServer
        api_server = APIServer(store, port=args.api_port).start()
        if state is not None:
            state["api_server"] = api_server

    def run_loop():
        sched.pump()
        if args.once:
            while (sched.schedule_burst(max_pods=args.burst)
                   if args.burst else sched.schedule_one(timeout=0.0)):
                pass
            sched.pump()
        else:
            sched.run()

    t_loop = time.perf_counter()
    try:
        if cfg.leader_election.leader_elect:
            # the scheduling loop runs on its own thread so the elector
            # keeps renewing the lease (client-go runs OnStartedLeading in
            # a goroutine while the renew loop continues — otherwise a
            # blocked winner stops renewing and a second instance goes
            # active: split-brain). An error of the loop is handed back
            # and raised here: the command never ends quietly over a
            # failed loop.
            loop_done = threading.Event()
            loop_error: list = []

            def start_leading():
                def wrapped():
                    try:
                        run_loop()
                    except BaseException as e:   # re-raised by main
                        loop_error.append(e)
                    finally:
                        loop_done.set()
                threading.Thread(target=wrapped, daemon=True).start()

            elector = LeaderElector(store, LeaderElectionConfig(
                lock_name=cfg.leader_election.lock_object_name,
                identity=args.leader_elect_identity,
                lease_duration=cfg.leader_election.lease_duration,
                renew_deadline=cfg.leader_election.renew_deadline,
                retry_period=cfg.leader_election.retry_period,
                on_started_leading=start_leading,
                on_stopped_leading=lambda: sched.stop()))
            while not loop_done.is_set():
                elector.step()
                if loop_done.wait(cfg.leader_election.retry_period):
                    break
            elector.release()
            if loop_error:
                raise loop_error[0]
        else:
            run_loop()
    finally:
        if server:
            server.shutdown()
            server.server_close()
        if api_server is not None:
            api_server.stop()
    if state is not None:
        state["loop_seconds"] = time.perf_counter() - t_loop

    if args.once:
        attempts = sched.metrics.schedule_attempts
        print(json.dumps({"scheduled": attempts["scheduled"],
                          "unschedulable": attempts["unschedulable"],
                          "errors": attempts["error"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
