"""The port's remote store client against the JAX package's, on the CPU.

`kubernetes_tpu_torch.store.remote` (RemoteStore, RemoteWatch) over the
port's apiserver:
- `tests/test_remote.py` on the port but the controller manager's case
  (`controllers/` is not ported yet): CRUD, PodGroups, the watch's
  resourceVersion resume, reconnect and 410, decode failures, the
  informer's auth failure and re-list, leader election over HTTP, the
  scheduler attached over HTTP, the 429 Retry-After handling and the
  retry table;
- the same world scheduled over HTTP by the port (its scheduler, client
  and server) and by the JAX package (its own three): the same bindings,
  serially and in bursts;
- the port's wave verb and existence probe: a burst wave commits in ONE
  request (binds and Scheduled records), a retried token lands once, a
  superseded fence rejects the wave whole, the stale-node probe asks once,
  `bind_pods` is one request too, a body carrying its own records is
  refused, and a scheduler restarted in a fresh process against the same
  server has its waves land (the dedupe token is unique across processes);
- `tests/test_serve.py`'s TestRemoteServing and `tests/test_fleet.py`'s
  TestRacingBindsHTTP on the port.
Every server listens on 127.0.0.1 port 0 and is stopped by its fixture or
`with` block; every scheduler or informer attached over HTTP is stopped
before its server; every client call carries the client's timeout, and
every watch `next()` its own.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu_torch.api.types import Pod, Node, Container
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.store.remote import RemoteStore, APIStatusError
from kubernetes_tpu_torch.store.store import (
    Store, PODS, NODES, EVENTS, AlreadyExistsError, BackpressureError,
    ConflictError, ExpiredError, FencedError, NotFoundError,
)
from kubernetes_tpu_torch.fleet import BIND_CONFLICTS
from kubernetes_tpu_torch.serve import ArrivalGenerator, ServeLoop
from tests.torch_threads import one_torch_thread  # noqa: F401

GI = 1024 ** 3


def mknode(name, cpu=4000):
    return Node(name=name,
                allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def mkpod(name, cpu=100, priority=0):
    return Pod(name=name, priority=priority,
               containers=(Container.make(name="c", requests={"cpu": cpu}),))


@pytest.fixture()
def served():
    store = Store(watch_log_size=65536)
    with APIServer(store) as srv:
        yield store, RemoteStore(srv.url)


def wait_until(cond, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


class TestRemoteStoreCRUD:
    def test_create_get_list_delete(self, served):
        store, remote = served
        created = remote.create(NODES, mknode("n1"))
        assert created.resource_version > 0
        got = remote.get(NODES, "n1")
        assert got.name == "n1" and got.allocatable["cpu"] == 4000
        objs, rv = remote.list(NODES)
        assert [o.name for o in objs] == ["n1"]
        assert rv == store.resource_version()
        gone = remote.delete(NODES, "n1")
        assert gone.name == "n1"
        with pytest.raises(NotFoundError):
            remote.get(NODES, "n1")
        with pytest.raises(NotFoundError):
            remote.delete(NODES, "n1")

    def test_already_exists_and_conflict(self, served):
        store, remote = served
        remote.create(NODES, mknode("n1"))
        with pytest.raises(AlreadyExistsError):
            remote.create(NODES, mknode("n1"))
        cur = remote.get(NODES, "n1")
        cur.unschedulable = True
        remote.update(NODES, cur, expect_rv=cur.resource_version)
        stale = cur   # now one version behind
        with pytest.raises(ConflictError):
            remote.update(NODES, stale, expect_rv=stale.resource_version)

    def test_guaranteed_update_retries_conflict(self, served):
        store, remote = served
        remote.create(PODS, mkpod("p1"))
        raced = {"done": False}

        def mutate(pod):
            if not raced["done"]:
                raced["done"] = True
                # out-of-band writer bumps the rv between GET and PUT
                store.set_nominated_node_name(pod.key, "other")
            pod.nominated_node_name = "winner"
            return pod

        out = remote.guaranteed_update(PODS, "default/p1", mutate)
        assert out.nominated_node_name == "winner"
        assert store.get(PODS, "default/p1").nominated_node_name == "winner"

    def test_bind_and_pod_conveniences(self, served):
        store, remote = served
        remote.create(PODS, mkpod("p1"))
        remote.bind_pod("default/p1", "n7")
        assert store.get(PODS, "default/p1").node_name == "n7"
        remote.set_nominated_node_name("default/p1", "n9")
        assert store.get(PODS, "default/p1").nominated_node_name == "n9"
        from kubernetes_tpu_torch.api.types import (PodCondition, POD_SCHEDULED,
                                              CONDITION_FALSE)
        rv0 = store.get(PODS, "default/p1").resource_version
        cond = PodCondition(type=POD_SCHEDULED, status=CONDITION_FALSE,
                            reason="Unschedulable", message="m")
        remote.update_pod_condition("default/p1", cond)
        assert store.get(PODS, "default/p1").conditions[0].reason == \
            "Unschedulable"
        # the no-op skip must hold over the wire too (store.py:308)
        rv1 = store.get(PODS, "default/p1").resource_version
        assert rv1 > rv0
        remote.update_pod_condition("default/p1", cond)
        assert store.get(PODS, "default/p1").resource_version == rv1


class TestRemotePodGroup:
    """PodGroup verbs + watch over the wire, pinning that the client's
    error mapping matches the apiserver's status codes for the new kind
    (the CLAUDE.md remote/apiserver sync rule)."""

    def test_round_trip_and_status_subresource(self, served):
        from kubernetes_tpu_torch.coscheduling.types import (
            PHASE_PRESCHEDULING, PodGroup)
        from kubernetes_tpu_torch.store.store import PODGROUPS
        store, remote = served
        g = PodGroup(name="g", min_member=4, schedule_timeout_seconds=30.0)
        created = remote.create(PODGROUPS, g)
        assert created.min_member == 4
        assert created.schedule_timeout_seconds == 30.0
        got = remote.get(PODGROUPS, "default/g")
        assert got == created
        objs, _rv = remote.list(PODGROUPS)
        assert [o.key for o in objs] == ["default/g"]
        # the /status subresource: status fields land, spec untouched, and
        # the same write through BOTH transports produces the same object
        updated = remote.update_pod_group_status(
            "default/g", phase=PHASE_PRESCHEDULING, members=2, now=1.5)
        assert updated.phase == PHASE_PRESCHEDULING
        assert updated.members == 2 and updated.min_member == 4
        assert store.get(PODGROUPS, "default/g") == updated
        gone = remote.delete(PODGROUPS, "default/g")
        assert gone.key == "default/g"

    def test_error_mapping_matches_apiserver_codes(self, served):
        from kubernetes_tpu_torch.coscheduling.types import PodGroup
        from kubernetes_tpu_torch.store.store import PODGROUPS
        _store, remote = served
        with pytest.raises(NotFoundError):        # 404
            remote.get(PODGROUPS, "default/missing")
        with pytest.raises(NotFoundError):        # 404 on the subresource
            remote.update_pod_group_status("default/missing", phase="X")
        remote.create(PODGROUPS, PodGroup(name="g"))
        with pytest.raises(AlreadyExistsError):   # 409 AlreadyExists
            remote.create(PODGROUPS, PodGroup(name="g"))
        g = remote.get(PODGROUPS, "default/g")
        g.min_member = 2
        remote.update(PODGROUPS, g, expect_rv=g.resource_version)
        with pytest.raises(ConflictError):        # 409 Conflict (stale rv)
            stale = g.clone()
            stale.min_member = 9
            remote.update(PODGROUPS, stale, expect_rv=g.resource_version)
        with pytest.raises(NotFoundError):        # 404 on delete
            remote.delete(PODGROUPS, "default/other")

    def test_watch_streams_podgroup_events(self, served):
        from kubernetes_tpu_torch.coscheduling.types import PodGroup
        from kubernetes_tpu_torch.store.store import PODGROUPS
        store, remote = served
        w = remote.watch(PODGROUPS, since_rv=store.resource_version())
        try:
            store.create(PODGROUPS, PodGroup(name="g", min_member=3))
            store.update_pod_group_status("default/g", phase="PreScheduling")
            ev1 = w.next(timeout=5.0)
            ev2 = w.next(timeout=5.0)
            assert ev1.type == "ADDED" and ev1.obj.min_member == 3
            assert ev2.type == "MODIFIED" \
                and ev2.obj.phase == "PreScheduling"
        finally:
            w.stop()


class TestRemoteWatch:
    def test_stream_resume_and_types(self, served):
        store, remote = served
        remote.create(NODES, mknode("n1"))
        objs, rv = remote.list(NODES)
        w = remote.watch(NODES, since_rv=rv)
        try:
            store.create(NODES, mknode("n2"))
            store.delete(NODES, "n1")
            evs = []
            assert wait_until(lambda: (evs.extend(w.drain()), len(evs) >= 2)[1])
            assert [(e.type, e.obj.name) for e in evs[:2]] == \
                [("ADDED", "n2"), ("DELETED", "n1")]
        finally:
            w.stop()

    def test_open_past_window_raises_expired(self):
        store = Store(watch_log_size=8)
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            for i in range(40):
                store.create(NODES, mknode(f"n{i}"))
            with pytest.raises(ExpiredError):
                remote.watch(NODES, since_rv=1)

    def test_reconnect_after_server_restart(self):
        """The stream drops when the server dies; the watch reconnects from
        the last seen resourceVersion once a server is back on the port and
        delivers everything written in between — reflector resume."""
        store = Store(watch_log_size=65536)
        srv = APIServer(store, port=0).start()
        port = int(srv.url.rsplit(":", 1)[1])
        remote = RemoteStore(srv.url)
        store.create(NODES, mknode("n1"))
        objs, rv = remote.list(NODES)
        w = remote.watch(NODES, since_rv=rv)
        try:
            store.create(NODES, mknode("n2"))
            evs = []
            assert wait_until(lambda: (evs.extend(w.drain()), len(evs) >= 1)[1])
            srv.stop()
            store.create(NODES, mknode("n3"))   # written while disconnected
            srv2 = APIServer(store, port=port).start()
            try:
                assert wait_until(
                    lambda: (evs.extend(w.drain()), len(evs) >= 2)[1],
                    timeout=15.0)
                assert [e.obj.name for e in evs[:2]] == ["n2", "n3"]
            finally:
                srv2.stop()
        finally:
            w.stop()


class TestWatchDecodeFailure:
    def test_malformed_event_marks_watch_expired(self, served, monkeypatch):
        """Schema drift: an event the client cannot decode must surface as
        ExpiredError from next() (informer re-lists) — the reader thread
        dying silently used to leave next() hanging forever."""
        store, remote = served
        w = remote.watch(PODS)
        try:
            def drifted(kind, d):
                raise ValueError("unknown field shape")
            monkeypatch.setattr(
                "kubernetes_tpu_torch.store.remote.serde.from_dict", drifted)
            store.create(PODS, mkpod("p1"))

            def sees_expiry():
                try:
                    w.next(timeout=0.05)
                    return False
                except ExpiredError:
                    return True
            assert wait_until(sees_expiry)
            # terminal: every subsequent next() keeps raising
            with pytest.raises(ExpiredError):
                w.next(timeout=0.01)
        finally:
            w.stop()


class TestInformerAuthFailure:
    def test_background_relist_stops_on_revoked_token(self):
        """A 401/403 during the background re-list is not transient: the
        informer must record the error and stop instead of silently
        retrying a revoked token forever (store/informer._safe_relist)."""
        from kubernetes_tpu_torch.store.informer import SharedInformer
        store = Store(watch_log_size=65536)
        store.create(NODES, mknode("n1"))
        inf = SharedInformer(store, NODES)
        inf.sync()

        class Revoked:
            calls = 0

            def list(self, kind):
                Revoked.calls += 1
                raise APIStatusError(401, "Unauthorized", "token revoked")

            def watch(self, kind, since_rv=None):
                raise AssertionError("watch must not open after 401")

        inf.store = Revoked()
        inf._safe_relist()
        assert isinstance(inf.last_error, APIStatusError)
        assert inf.last_error.code == 401
        assert inf._stop.is_set()          # the informer thread loop exits
        assert Revoked.calls == 1          # no retry storm

    def test_background_relist_still_retries_transient_errors(self):
        """The transient path is unchanged: a transport blip retries and
        the informer stays alive once the list lands."""
        from kubernetes_tpu_torch.store.informer import SharedInformer
        store = Store(watch_log_size=65536)
        store.create(NODES, mknode("n1"))
        inf = SharedInformer(store, NODES)
        inf.sync()
        real = inf.store

        class Blippy:
            calls = 0

            def list(self, kind):
                Blippy.calls += 1
                if Blippy.calls == 1:
                    raise OSError("connection reset")
                return real.list(kind)

            def watch(self, kind, since_rv=None):
                return real.watch(kind, since_rv=since_rv)

        inf.store = Blippy()
        inf._safe_relist()
        assert inf.last_error is None
        assert not inf._stop.is_set()
        assert Blippy.calls == 2


class TestInformerRelist:
    def test_replace_semantics_on_relist(self, served):
        """DeltaFIFO Replace (delta_fifo.go:96): after an expired-window
        resume the informer must emit deletes for vanished keys, updates
        for changed ones, adds for new ones — not a blind add replay."""
        store, remote = served
        from kubernetes_tpu_torch.store.informer import SharedInformer
        store.create(NODES, mknode("n1"))
        store.create(NODES, mknode("n2"))
        inf = SharedInformer(remote, NODES)
        seen = []
        inf.add_event_handler(
            on_add=lambda o: seen.append(("add", o.name)),
            on_update=lambda o, n: seen.append(("upd", n.name)),
            on_delete=lambda o: seen.append(("del", o.name)))
        inf.sync()
        assert sorted(seen) == [("add", "n1"), ("add", "n2")]
        seen.clear()
        # out-of-band world change the expired watch window would hide
        store.delete(NODES, "n1")
        store.create(NODES, mknode("n3"))
        n2 = store.get(NODES, "n2")
        n2.unschedulable = True
        store.update(NODES, n2)
        try:
            inf._relist()
            assert sorted(seen) == [("add", "n3"), ("del", "n1"),
                                    ("upd", "n2")]
            assert sorted(o.name for o in inf.list()) == ["n2", "n3"]
        finally:
            inf.stop()


class TestRemoteLeaderElection:
    def test_lease_cas_over_http(self, served):
        """Leader election's lease CAS works over the remote transport
        (resourcelock semantics; Lease is a registered API kind), so
        --server --leader-elect is a working combination."""
        from kubernetes_tpu_torch.utils.leader_election import (
            LeaderElector, LeaderElectionConfig)
        from kubernetes_tpu_torch.utils.clock import FakeClock
        store, remote = served
        clock = FakeClock(100.0)
        a = LeaderElector(remote, LeaderElectionConfig(
            identity="a", lease_duration=15.0), clock=clock)
        b = LeaderElector(remote, LeaderElectionConfig(
            identity="b", lease_duration=15.0), clock=clock)
        assert a.try_acquire_or_renew() is True
        assert b.try_acquire_or_renew() is False
        assert a.try_acquire_or_renew() is True      # renewal (bumps rv)
        clock.step(20.0)
        # b first OBSERVES the renewed record here — the observation clock
        # resets on any record change (leaderelection.go:287 semantics), so
        # takeover needs another full lease_duration of silence
        assert b.try_acquire_or_renew() is False
        clock.step(20.0)
        assert b.try_acquire_or_renew() is True      # takeover via CAS
        assert store.get("leases", "kube-scheduler").holder == "b"


class TestRemoteScheduler:
    def test_bindings_identical_to_in_process(self, request):
        """The headline contract (VERDICT r4 next #4): a scheduler attached
        over HTTP produces byte-identical bindings to the in-process run on
        the same world."""
        from kubernetes_tpu_torch.scheduler import Scheduler

        def world():
            s = Store(watch_log_size=65536)
            for i in range(6):
                s.create(NODES, mknode(f"n{i}",
                                       cpu=2000 if i % 2 else 4000))
            for j in range(20):
                s.create(PODS, mkpod(f"p{j}", cpu=[100, 300, 700][j % 3],
                                     priority=[0, 5][j % 2]))
            return s

        # in-process referee
        s_local = world()
        sched = Scheduler(s_local, use_device=False,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        sched.pump()
        while sched.schedule_one(timeout=0.0):
            pass
        sched.pump()
        want = sorted((p.key, p.node_name) for p in s_local.list(PODS)[0])

        # HTTP-attached run on an identical world
        s_remote = world()
        with APIServer(s_remote) as srv:
            remote = RemoteStore(srv.url)
            rsched = Scheduler(remote, use_device=False,
                               percentage_of_nodes_to_score=100)
            rsched.sync()
            request.addfinalizer(rsched.informers.stop_all)

            def drain():
                rsched.pump()
                progressed = False
                while rsched.schedule_one(timeout=0.0):
                    progressed = True
                return progressed

            def all_bound():
                drain()
                pods, _ = s_remote.list(PODS)
                return all(p.node_name for p in pods)
            assert wait_until(all_bound, timeout=30.0)
        got = sorted((p.key, p.node_name) for p in s_remote.list(PODS)[0])
        assert got == want

    def test_burst_commit_over_http(self, request):
        """The batched burst commit over the remote transport (the port's
        RemoteStore.commit_wave, one request a wave) — a remote-attached
        device-burst scheduler binds everything, one Scheduled record a
        pod."""
        store = Store(watch_log_size=65536)
        for i in range(4):
            store.create(NODES, mknode(f"n{i}"))
        for j in range(10):
            store.create(PODS, mkpod(f"p{j}", cpu=100))
        from kubernetes_tpu_torch.scheduler import Scheduler
        with APIServer(store) as srv:
            sched = Scheduler(RemoteStore(srv.url), device="cpu",
                              percentage_of_nodes_to_score=100)
            sched.sync()
            request.addfinalizer(sched.informers.stop_all)

            def all_bound():
                sched.pump()
                while sched.schedule_burst(max_pods=16):
                    pass
                pods, _ = store.list(PODS)
                return all(p.node_name for p in pods)
            assert wait_until(all_bound, timeout=60.0)
        from kubernetes_tpu_torch.store.store import EVENTS
        scheduled = [e for e in store.list(EVENTS)[0]
                     if e.reason == "Scheduled"]
        assert len(scheduled) == 10   # batched events landed per pod

    def test_cmd_scheduler_attaches_over_http(self):
        """cmd/scheduler.py --server URL: the CLI entry runs out-of-process
        against a served store (--once drain)."""
        from kubernetes_tpu_torch.cmd import scheduler as cmd_sched
        store = Store(watch_log_size=65536)
        for i in range(3):
            store.create(NODES, mknode(f"n{i}"))
        for j in range(6):
            store.create(PODS, mkpod(f"p{j}"))
        state = {}
        with APIServer(store) as srv:
            try:
                rc = cmd_sched.main(["--server", srv.url, "--once",
                                     "--percentage-of-nodes-to-score", "100",
                                     "--device", "cpu"], state=state)
            finally:
                state["scheduler"].informers.stop_all()
            assert rc == 0
            pods, _ = store.list(PODS)
            assert all(p.node_name for p in pods)


class TestBackpressure429:
    """Round-16 serving backpressure over the wire: a shed pod create
    answers 429 + reason=Backpressure + Retry-After, the client maps it
    to BackpressureError (DISTINCT from the eviction subresource's
    DisruptionBudgetError) and re-sends with capped jittered backoff,
    counted on remote_request_retries_total{backpressure} — the pinned
    contract the serve lane's arrival clients ride."""

    class _ShedGate:
        """Admission gate stub: shed the first `n` pod creates with a
        deliberately huge Retry-After (the cap must bite)."""

        def __init__(self, n, retry_after=10.0):
            self.n = n
            self.retry_after = retry_after

        def admit(self, pod):
            from kubernetes_tpu_torch.store.store import BackpressureError
            if self.n > 0:
                self.n -= 1
                raise BackpressureError(f"{pod.key}: shed",
                                        retry_after=self.retry_after)

    def test_create_honors_retry_after_capped_and_jittered(self, served):
        from kubernetes_tpu_torch.store.remote import REQUEST_RETRIES
        store, remote = served
        store.admission_gate = self._ShedGate(2)
        sleeps = []
        remote._sleep = sleeps.append
        before = REQUEST_RETRIES.labels("backpressure").value
        out = remote.create(PODS, mkpod("p1"))
        assert out.name == "p1"
        assert store.get(PODS, "default/p1").name == "p1"
        # two sheds -> two backoffs, each the server's 10s suggestion
        # CAPPED at 2s and jittered into [0.5, 1.0]x
        assert len(sleeps) == 2
        cap = remote.BACKPRESSURE_RETRY[1]
        assert all(0.5 * cap <= s <= cap for s in sleeps), sleeps
        assert REQUEST_RETRIES.labels("backpressure").value - before == 2

    def test_sub_second_retry_after_passes_through(self, served):
        store, remote = served
        store.admission_gate = self._ShedGate(1, retry_after=0.25)
        sleeps = []
        remote._sleep = sleeps.append
        remote.create(PODS, mkpod("p2"))
        assert len(sleeps) == 1
        assert 0.125 <= sleeps[0] <= 0.25, sleeps

    def test_exhausted_backpressure_raises_the_mapped_error(self, served):
        from kubernetes_tpu_torch.store.store import BackpressureError
        store, remote = served
        store.admission_gate = self._ShedGate(10 ** 9)
        remote._sleep = lambda _s: None
        with pytest.raises(BackpressureError) as ei:
            remote.create(PODS, mkpod("p3"))
        # the mapped error carries the server's Retry-After verbatim
        assert ei.value.retry_after == pytest.approx(10.0)
        with pytest.raises(NotFoundError):
            store.get(PODS, "default/p3")

    def test_eviction_429_still_maps_to_budget_error(self, served):
        """The eviction subresource's 429 keeps its own error type and is
        NEVER auto-retried (a landed retry would double-charge the
        budget) — the reason-split must not blur the two contracts."""
        from kubernetes_tpu_torch.api.types import (LabelSelector,
                                              PodDisruptionBudget)
        from kubernetes_tpu_torch.store.store import (DisruptionBudgetError,
                                                PDBS)
        store, remote = served
        remote.create(PODS, mkpod("guarded"))
        store.create(PDBS, PodDisruptionBudget(
            name="budget",
            selector=LabelSelector(match_labels=()),
            disruptions_allowed=0))
        sleeps = []
        remote._sleep = sleeps.append
        with pytest.raises(DisruptionBudgetError):
            remote.evict_pod("default/guarded")
        assert sleeps == []          # no auto-retry on budget refusals
        assert store.get(PODS, "default/guarded").name == "guarded"


class TestRetryPolicyTable:
    """Round-18 satellite pin, the client-side sibling of the
    TRANSIENT_ERROR_MARKERS table test (tests/test_chaos_plane.py): the
    per-verb-class retry budget is a correctness surface, not a tuning
    knob. In particular: a 409 (ConflictError, FencedError included) is
    a DEFINITIVE answer on every class, and Lease CAS writes (leader
    election acquire/renew/claim) get exactly ONE attempt even for
    transient transport failures — a renew ridden through retries can
    land, answer 409 to its own replay, and leave the elector believing
    a lie in either direction; the lost lease must surface to the
    elector, which steps down before the fencing window, not be retried
    into a fencing violation."""

    def _attempts(self, verb_class, exc_factory):
        import urllib.error   # noqa: F401 — factories close over it
        rs = RemoteStore("http://127.0.0.1:1")
        rs._sleep = lambda _s: None
        calls = {"n": 0}

        def boom(method, path, body=None):
            calls["n"] += 1
            raise exc_factory()
        rs._request_once = boom
        with pytest.raises(Exception):
            rs._request("PUT", "/api/v1/x", verb_class=verb_class)
        return calls["n"]

    def test_policy_table_pinned(self):
        assert RemoteStore.RETRY_POLICY == {
            "read": (4, 0.02),
            "cas": (3, 0.02),
            "bind": (4, 0.02),
            "status": (3, 0.02),
            "write": (1, 0.0),
            "lease": (1, 0.0),
        }

    def test_conflicts_never_auto_retried_on_any_class(self):
        from kubernetes_tpu_torch.store.store import FencedError
        for verb in ("read", "cas", "bind", "status", "write", "lease"):
            assert self._attempts(verb, lambda: ConflictError("cas")) == 1
            assert self._attempts(verb, lambda: FencedError("stale")) == 1

    def test_transient_budget_per_class(self):
        import urllib.error
        expected = {"read": 4, "cas": 3, "status": 3, "write": 1,
                    "lease": 1}
        for verb, n in expected.items():
            got = self._attempts(
                verb, lambda: urllib.error.URLError("connection reset"))
            assert got == n, (verb, got, n)

    def test_lease_cas_update_routes_to_lease_class(self):
        """update(LEASES, ..., expect_rv=...) rides the one-attempt lease
        class; every other kind's CAS keeps the cas class."""
        from kubernetes_tpu_torch.api.types import Lease
        from kubernetes_tpu_torch.api import serde
        from kubernetes_tpu_torch.store.store import LEASES
        rs = RemoteStore("http://127.0.0.1:1")
        seen = []

        def fake_request(method, path, body=None, verb_class="read"):
            seen.append(verb_class)
            if "leases" in path:
                return serde.to_dict(Lease(name="lock"))
            return serde.to_dict(mkpod("p"))
        rs._request = fake_request
        rs.update(LEASES, Lease(name="lock"), expect_rv=3)
        rs.update(PODS, mkpod("p"), expect_rv=3)
        rs.update(LEASES, Lease(name="lock"))   # unconditional: write
        assert seen == ["lease", "cas", "write"]


# -- tests/test_serve.py TestRemoteServing on the port -------------------------
def build_world(n_nodes=6):
    """tests/test_serve.py's build_world on the port (the plain versions
    of the device path)."""
    from kubernetes_tpu_torch.scheduler import Scheduler
    store = Store(watch_log_size=1 << 16)
    for i in range(n_nodes):
        store.create(NODES, Node(
            name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}",
                                  "failure-domain.beta.kubernetes.io/zone":
                                  f"z{i % 2}"},
            allocatable={"cpu": 4000, "memory": 32 * GI, "pods": 110}))
    sched = Scheduler(store, percentage_of_nodes_to_score=100,
                      device="cpu")
    sched.sync()
    return store, sched


class TestRemoteServing:
    """Admission over the wire: arrival clients POST pods through the
    apiserver (store/remote.py) WHILE the serve loop schedules — sheds
    travel as 429 + Retry-After and the remote client's capped jittered
    retry readmits them. Topology: apiserver + store + scheduler share a
    process (the cmd/cluster shape — the gate's depth_fn reads the live
    queue); arrival clients are genuinely remote."""

    def test_remote_arrivals_shed_and_converge(self):
        store, sched = build_world(n_nodes=4)
        loop = ServeLoop(sched, window_size=8, depth=2)
        loop.attach_gate(max_depth=6, retry_after_base=0.005)
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            gen = ArrivalGenerator(remote, rate=10 ** 6, total=40, seed=5)
            import time
            deadline = time.perf_counter() + 30.0
            while (not gen.finished()) and time.perf_counter() < deadline:
                gen.tick()
                loop.step()
            gen.flush_retries(timeout=10.0)
            loop.drain(timeout=10.0)
        g = gen.stats()
        assert loop.gate.rejected > 0          # sheds crossed the wire
        # the batched wire contract: the shed tail was accounted and
        # re-admitted off the server's Retry-After (round 17: arrivals
        # ride ONE collection POST per flush; the partial 429 carries
        # `accepted`, so nothing is lost OR double-created)
        assert g["rejected_429"] > 0
        bound = sum(1 for p in store.list(PODS)[0] if p.node_name)
        assert bound == g["created"] == 40
        assert g["attempted"] == 40 and g["gave_up"] == 0

    def test_remote_batch_create_partial_shed_accepted_count(self):
        """The collection POST's 429 surfaces `accepted` exactly: the
        prefix landed server-side, the tail did not."""
        store, sched = build_world(n_nodes=4)
        loop = ServeLoop(sched, window_size=8, depth=2)
        loop.attach_gate(max_depth=3)
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            with pytest.raises(BackpressureError) as ei:
                remote.create_many(PODS, [mkpod(f"b{j}") for j in range(8)])
        assert ei.value.accepted == 3
        assert ei.value.retry_after > 0
        stored = {p.name for p in store.list(PODS)[0]}
        assert stored == {"b0", "b1", "b2"}


# -- tests/test_fleet.py TestRacingBindsHTTP on the port --------------------------
def fleet_node(i, cpu=4000):
    return Node(name=f"n{i}",
                labels={"kubernetes.io/hostname": f"n{i}",
                        "failure-domain.beta.kubernetes.io/zone":
                        f"z{i % 3}"},
                allocatable={"cpu": cpu, "memory": 32 * GI, "pods": 110})


def fleet_pod(name, ns="default", cpu=100, **kw):
    kw.setdefault("uid", f"{ns}/{name}/fixed")
    return Pod(name=name, namespace=ns,
               containers=(Container.make(name="c", requests={"cpu": cpu}),),
               **kw)


class TestRacingBindsHTTP:
    def test_two_remote_stores_one_success_one_conflict(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store = Store()
        store.create(NODES, fleet_node(0))
        store.create(NODES, fleet_node(1))
        store.create(PODS, fleet_pod("raced"))
        results = []
        lock = threading.Lock()

        def bind(url, node):
            remote = RemoteStore(url)
            try:
                remote.bind_pod("default/raced", node)
                with lock:
                    results.append(("ok", node))
            except ConflictError as e:
                with lock:
                    results.append(("conflict", node, str(e)))
        with APIServer(store) as srv:
            ts = [threading.Thread(target=bind, args=(srv.url, f"n{i}"))
                  for i in range(2)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(5.0)
        outcomes = sorted(r[0] for r in results)
        assert outcomes == ["conflict", "ok"], results
        winner = next(r[1] for r in results if r[0] == "ok")
        assert store.get(PODS, "default/raced").node_name == winner
        # exactly ONE MODIFIED bind event ever hit the store
        binds = [e for e in store.list(PODS)[0] if e.node_name]
        assert len(binds) == 1

    def test_fenced_bind_and_fence_advance_over_http(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store.remote import RemoteStore
        store = Store()
        store.create(PODS, fleet_pod("f"))
        with APIServer(store) as srv:
            remote = RemoteStore(srv.url)
            assert remote.advance_fence("scope-a", 7) is True
            assert remote.advance_fence("scope-a", 6) is False
            with pytest.raises(FencedError):
                remote.bind_pod("default/f", "n0", fence=("scope-a", 6))
            assert not store.get(PODS, "default/f").node_name
            remote.bind_pod("default/f", "n0", fence=("scope-a", 7))
            assert store.get(PODS, "default/f").node_name == "n0"

    def test_losing_scheduler_requeues_with_backoff(self):
        """The scheduler-side half of the race: a wave whose pod was
        bound by a rival between decision and commit resolves as an
        rv-CAS conflict — the loser forgets its assume, counts the
        conflict, and the pod is NOT re-queued once the store shows it
        bound (creation-order requeue-with-backoff is _record_failure's
        existing contract for the still-unbound case)."""
        from kubernetes_tpu_torch.scheduler import Scheduler
        store = Store()
        store.create(NODES, fleet_node(0, cpu=100000))
        sched = Scheduler(store, use_device=False,
                          percentage_of_nodes_to_score=100)
        sched.sync()
        pod = store.create(PODS, fleet_pod("raced"))
        sched.pump()
        popped = sched.queue.pop(timeout=0)
        assert popped is not None
        # rival lands its binding first
        store.bind_pod("default/raced", "rival-node")
        before = BIND_CONFLICTS.labels("requeued").value
        sched._snapshot = sched.cache.update_snapshot(sched._snapshot)
        bound = sched._commit_burst([popped], ["n0"],
                                    [sched.queue.scheduling_cycle])
        assert bound == 0
        assert BIND_CONFLICTS.labels("requeued").value == before + 1
        # the winner's binding stands; the loser holds no copy
        assert store.get(PODS, "default/raced").node_name == "rival-node"
        assert sched.queue.num_pending() == 0
        assert not sched.cache.is_assumed_pod(pod)

    def test_fenced_wave_drops_pods_to_new_owner(self):
        from kubernetes_tpu_torch.scheduler import Scheduler
        store = Store()
        store.create(NODES, fleet_node(0, cpu=100000))
        sched = Scheduler(store, use_device=False,
                          percentage_of_nodes_to_score=100)
        sched.fence_provider = lambda: [("claim-s0", 3)]
        sched.sync()
        store.create(PODS, fleet_pod("z"))
        sched.pump()
        popped = sched.queue.pop(timeout=0)
        store.advance_fence("claim-s0", 9)   # a newer claimant fenced us
        before = BIND_CONFLICTS.labels("fenced").value
        sched._snapshot = sched.cache.update_snapshot(sched._snapshot)
        bound = sched._commit_burst([popped], ["n0"],
                                    [sched.queue.scheduling_cycle])
        assert bound == 0
        assert sched.fenced_waves == 1
        assert BIND_CONFLICTS.labels("fenced").value == before + 1
        # nothing landed, nothing re-queued (the new owner replays it),
        # and no zombie writes: no events were emitted for the pod
        assert not store.get(PODS, "default/z").node_name
        assert sched.queue.num_pending() == 0
        assert store.list(EVENTS)[0] == []


# -- parity with the JAX package and the port's batch verbs ----------------------
def seeded_world(pkg, seed=11, n_nodes=12, n_pods=40):
    """A store of `pkg` with nodes of 2-8 CPU and pods of 100-1500m at
    priorities 0-3, from a numpy seed."""
    import numpy as np
    if pkg == "port":
        from kubernetes_tpu_torch.api import types as T
        from kubernetes_tpu_torch.store import store as S
    else:
        from kubernetes_tpu.api import types as T
        from kubernetes_tpu.store import store as S
    rng = np.random.default_rng(seed)
    store = S.Store(watch_log_size=65536)
    for i in range(n_nodes):
        store.create(S.NODES, T.Node(name=f"n{i}", allocatable={
            "cpu": int(rng.choice([2000, 4000, 8000])), "memory": 32 * GI,
            "pods": 110}))
    for j in range(n_pods):
        store.create(S.PODS, T.Pod(
            name=f"p{j}", uid=f"default/p{j}/fixed",
            priority=int(rng.integers(0, 4)),
            containers=(T.Container.make(name="c", requests={
                "cpu": int(rng.choice([100, 300, 700, 1500]))}),)))
    return store, S


@pytest.mark.parametrize("mode", ["serial", "burst"])
def test_remote_scheduler_bindings_equal_the_reference(mode, request):
    """TestRemoteScheduler's contract across the packages: the port's
    scheduler over the port's client and server, and JAX's over its own,
    on the same seeded world: the same bindings (serial cycles on the
    generic scheduler, or bursts on the device route: the plain versions
    and JAX on the CPU)."""
    from kubernetes_tpu.apiserver.server import APIServer as JAPIServer
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu.store.remote import RemoteStore as JRemoteStore
    from kubernetes_tpu_torch.scheduler import Scheduler
    out = {}
    for pkg in ("port", "jax"):
        store, S = seeded_world(pkg)
        Server = APIServer if pkg == "port" else JAPIServer
        Remote = RemoteStore if pkg == "port" else JRemoteStore
        with Server(store) as srv:
            remote = Remote(srv.url)
            if pkg == "port":
                sched = Scheduler(remote, use_device=mode == "burst",
                                  device="cpu",
                                  percentage_of_nodes_to_score=100)
            else:
                sched = JScheduler(remote, use_tpu=mode == "burst",
                                   percentage_of_nodes_to_score=100)
            request.addfinalizer(sched.informers.stop_all)
            sched.sync()

            def all_bound():
                sched.pump()
                if mode == "burst":
                    while sched.schedule_burst(max_pods=16):
                        pass
                else:
                    while sched.schedule_one(timeout=0.0):
                        pass
                pods, _ = store.list(S.PODS)
                return all(p.node_name for p in pods)
            assert wait_until(all_bound, timeout=60.0)
            sched.informers.stop_all()
        out[pkg] = sorted((p.key, p.node_name)
                          for p in store.list(S.PODS)[0])
    assert out["port"] == out["jax"]


def test_burst_wave_commits_in_one_request(request, monkeypatch):
    """A remote-attached burst: each wave's binds and Scheduled records go
    in ONE POST to /api/v1/pods/bindings, the stale-node probe in one
    POST a launch or wave; no binding subresource POST, no event POST, no
    per-host GET."""
    from kubernetes_tpu_torch.scheduler import Scheduler
    seen = []
    real = RemoteStore._request_once

    def counting(self, method, path, body=None):
        seen.append((method, path))
        return real(self, method, path, body)
    monkeypatch.setattr(RemoteStore, "_request_once", counting)
    store = Store(watch_log_size=65536)
    for i in range(8):
        store.create(NODES, mknode(f"n{i}"))
    with APIServer(store) as srv:
        sched = Scheduler(RemoteStore(srv.url), device="cpu",
                          percentage_of_nodes_to_score=100)
        request.addfinalizer(sched.informers.stop_all)
        sched.sync()
        for j in range(24):
            store.create(PODS, mkpod(f"p{j}"))
        assert wait_until(lambda: (sched.pump(),
                                   sched.queue.num_pending() == 24)[1])
        seen.clear()
        assert sched.schedule_burst(max_pods=64) == 24
        sched.informers.stop_all()
    posts = [p for m, p in seen if m == "POST"]
    assert posts.count("/api/v1/pods/bindings") == 1
    assert all(p in ("/api/v1/pods/bindings", "/api/v1/nodes/existence")
               for p in posts)
    assert not [p for m, p in seen if m == "GET"
                and p.startswith("/api/v1/nodes/")]
    assert all(p.node_name for p in store.list(PODS)[0])
    assert len([e for e in store.list(EVENTS)[0]
                if e.reason == "Scheduled"]) == 24


def test_commit_wave_retried_under_its_token_lands_once(served):
    store, remote = served
    for i in range(2):
        store.create(NODES, mknode(f"n{i}"))
    for j in range(3):
        store.create(PODS, mkpod(f"w{j}"))
    wave = [("default/w0", "n0"), ("default/w1", "n1"),
            ("default/gone", "n0")]
    spec = {"component": "default-scheduler"}
    first = remote.commit_wave(wave, token="t-1", event_spec=spec)
    rv = store.resource_version()
    again = remote.commit_wave(wave, token="t-1", event_spec=spec)
    assert first == again == ["default/gone"]
    assert store.resource_version() == rv      # nothing landed twice
    assert [p.node_name for p in store.list(PODS)[0]] == ["n0", "n1", ""]
    assert len(store.list(EVENTS)[0]) == 2
    conflicts = []
    out = remote.commit_wave([("default/w0", "n1"), ("default/w2", "n1")],
                             token="t-2", event_spec=spec,
                             conflicts=conflicts)
    assert out == [] and conflicts == ["default/w0"]
    assert store.get(PODS, "default/w0").node_name == "n0"


def test_fenced_wave_rejected_whole_over_http(served):
    store, remote = served
    store.create(NODES, mknode("n0"))
    store.create(PODS, mkpod("f"))
    assert remote.advance_fence("claim-s0", 9) is True
    with pytest.raises(FencedError):
        remote.commit_wave([("default/f", "n0")], token="t",
                           event_spec={"component": "x"},
                           fence=[("claim-s0", 3)])
    assert not store.get(PODS, "default/f").node_name
    assert store.list(EVENTS)[0] == []
    assert remote.commit_wave([("default/f", "n0")], token="t2",
                              fence=[("claim-s0", 9)]) == []
    assert store.get(PODS, "default/f").node_name == "n0"


def test_missing_keys_in_one_request(served):
    store, remote = served
    for i in range(3):
        store.create(NODES, mknode(f"n{i}"))
    store.delete(NODES, "n1")
    assert remote.missing_keys(NODES, ["n0", "n1", "n2", "n9"]) == \
        ["n1", "n9"]
    assert remote.missing_keys(NODES, []) == []


def test_wave_verb_authorized_as_the_binding_subresource():
    """With authentication on, the wave verb binds for the scheduler's
    identity, refuses an anonymous caller (401) and a kubelet (403, the
    node authorizer), and the existence probe needs a read grant."""
    from kubernetes_tpu_torch.apiserver.auth import (
        NodeAuthorizer, RBACAuthorizer, TokenAuthenticator, UserInfo,
        default_roles, union)
    store = Store()
    store.create(NODES, mknode("n1"))
    store.create(PODS, mkpod("p"))
    roles, bindings = default_roles()
    authn = TokenAuthenticator({
        "sched": UserInfo("system:kube-scheduler"),
        "kubelet": UserInfo("system:node:n1", ("system:nodes",))})
    authz = union(RBACAuthorizer(roles=roles, bindings=bindings),
                  NodeAuthorizer())
    with APIServer(store, authenticator=authn, authorizer=authz) as srv:
        for token, code in ((None, 401), ("kubelet", 403)):
            with pytest.raises(APIStatusError) as ei:
                RemoteStore(srv.url, token=token).commit_wave(
                    [("default/p", "n1")], token="t")
            assert ei.value.code == code
        assert not store.get(PODS, "default/p").node_name
        sched = RemoteStore(srv.url, token="sched")
        assert sched.missing_keys(NODES, ["n1", "n2"]) == ["n2"]
        assert sched.commit_wave([("default/p", "n1")], token="t") == []
    assert store.get(PODS, "default/p").node_name == "n1"


def test_store_missing_keys_equals_contains():
    """The embedded store's `missing_keys` (the shell's stale-host probe)
    answers as a `contains` probe a key, in the keys' order."""
    store = Store()
    for i in range(4):
        store.create(NODES, mknode(f"n{i}"))
    store.delete(NODES, "n2")
    keys = ["n3", "n9", "n2", "n0", "n2"]
    assert store.missing_keys(NODES, keys) == \
        [k for k in keys if not store.contains(NODES, k)] == ["n9", "n2", "n2"]
    assert store.missing_keys(PODS, ["default/p"]) == ["default/p"]


def test_bind_pods_is_one_wave_request(served, monkeypatch):
    """`RemoteStore.bind_pods` sends its batch as ONE wave-verb request
    with no token and no records: the pods land, no record is written, a
    vanished pod comes back missing, an rv-CAS loser rides `conflicts`, a
    superseded fence rejects the batch whole."""
    store, remote = served
    seen = []
    real = RemoteStore._request_once

    def counting(self, method, path, body=None):
        seen.append((method, path, body))
        return real(self, method, path, body)
    monkeypatch.setattr(RemoteStore, "_request_once", counting)
    for i in range(2):
        store.create(NODES, mknode(f"n{i}"))
    for j in range(3):
        store.create(PODS, mkpod(f"b{j}"))
    out = remote.bind_pods([("default/b0", "n0"), ("default/b1", "n1"),
                            ("default/gone", "n0")])
    assert out == ["default/gone"]
    assert [(m, p) for m, p, _b in seen] == [("POST",
                                              "/api/v1/pods/bindings")]
    assert "token" not in seen[0][2] and "event_spec" not in seen[0][2]
    assert [p.node_name for p in store.list(PODS)[0]] == ["n0", "n1", ""]
    assert store.list(EVENTS)[0] == []
    conflicts = []
    assert remote.bind_pods([("default/b0", "n1"), ("default/b2", "n1")],
                            conflicts=conflicts) == []
    assert conflicts == ["default/b0"]
    assert remote.bind_pods([("default/b0", "n1")]) == ["default/b0"]
    assert store.get(PODS, "default/b0").node_name == "n0"
    store.create(PODS, mkpod("f"))
    assert remote.advance_fence("claim-s0", 9) is True
    with pytest.raises(FencedError):
        remote.bind_pods([("default/f", "n0")], fence=[("claim-s0", 3)])
    assert not store.get(PODS, "default/f").node_name


def test_wave_verb_refuses_caller_records(served):
    """The wave verb writes only the Scheduled records it builds from
    `event_spec`: a body that carries its own `events` is refused whole
    (400, nothing bound, nothing recorded), and the client refuses to send
    records."""
    store, remote = served
    store.create(NODES, mknode("n0"))
    store.create(PODS, mkpod("p"))
    rec = {"name": "forged", "namespace": "kube-system", "reason": "Forged"}
    req = urllib.request.Request(
        remote.base_url + "/api/v1/pods/bindings", method="POST",
        data=json.dumps({"bindings": [["default/p", "n0"]],
                         "events": [rec]}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10).close()
    assert ei.value.code == 400
    ei.value.close()
    assert not store.get(PODS, "default/p").node_name
    assert store.list(EVENTS)[0] == []
    with pytest.raises(ValueError):
        remote.commit_wave([("default/p", "n0")], [object()], token="t")
    assert not store.get(PODS, "default/p").node_name
    assert remote.commit_wave([("default/p", "n0")], [], token="t") == []
    assert store.get(PODS, "default/p").node_name == "n0"


def test_restarted_scheduler_waves_land():
    """`main --server URL --once --burst` run twice, each in a fresh
    process, against one long-lived server: the second process's waves
    are not answered from the first's recorded results in the server's
    dedupe map (its tokens are unique across processes), so every pod of
    both runs is bound and has its Scheduled record."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    store = Store(watch_log_size=65536)
    for i in range(4):
        store.create(NODES, mknode(f"n{i}"))
    with APIServer(store) as srv:
        for run in range(2):
            for j in range(6):
                store.create(PODS, mkpod(f"r{run}-{j}"))
            proc = subprocess.run(
                [sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler",
                 "--server", srv.url, "--once", "--burst", "16",
                 "--device", "cpu"],
                cwd=repo, env=env, capture_output=True, text=True,
                timeout=120)
            assert proc.returncode == 0, proc.stderr[-2000:]
            pods = store.list(PODS)[0]
            assert len(pods) == 6 * (run + 1)
            assert all(p.node_name for p in pods), \
                [p.key for p in pods if not p.node_name]
    scheduled = {e.involved_key for e in store.list(EVENTS)[0]
                 if e.reason == "Scheduled"}
    assert len(scheduled) == 12
