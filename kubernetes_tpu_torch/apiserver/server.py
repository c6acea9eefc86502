"""REST API server over the store — the kube-apiserver surface: the
port's copy of the reference's `apiserver/server.py` with the port's
imports, plus two batch verbs of the port's own (marked below) that let a
remote scheduler commit a burst wave and probe its hosts in one request
each, where the reference's client sends a request a pod.

The reference's apiserver is REST + watch over etcd
(staging/src/k8s.io/apiserver; pkg/master installs core/v1 at /api/v1).
This serves the same contract over the in-memory store:

  GET    /healthz | /readyz | /version
  GET    /api/v1/{kind}                 -> {"kind","items","resourceVersion"}
  GET    /api/v1/{kind}?watch=true&resourceVersion=N
                                        -> chunked JSON-lines event stream
  GET    /api/v1/{kind}/{key...}        -> object
  POST   /api/v1/{kind}                 -> admission chain -> create (201)
  PUT    /api/v1/{kind}/{key...}        -> update (409 on rv conflict)
  DELETE /api/v1/{kind}/{key...}        -> deleted object
  POST   /api/v1/pods/{ns}/{name}/binding  {"node": "..."}
                                        -> bind (the scheduler's write verb,
                                           factory.go:710)
  POST   /api/v1/pods/bindings  {"bindings": [[key, node], ...], "token"?,
                                 "fence"?, "event_spec"?}
                                        -> one burst wave: Store.commit_wave
                                           + fan-out; {"missing",
                                           "conflicts"} (the port's)
  POST   /api/v1/{kind}/existence  {"keys": [...]}
                                        -> {"missing": [...]} (the port's)

Namespaced kinds key as {namespace}/{name}; cluster-scoped (nodes, PVs,
priorityclasses) as {name}. Watch streams resume from resourceVersion and
end with a 410-Gone error line when the log window expired (the client
re-lists, exactly like the reference's Reflector).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

from kubernetes_tpu_torch import obs
from kubernetes_tpu_torch.obs import trace as obs_trace
from kubernetes_tpu_torch.obs import timeseries as obs_timeseries
from kubernetes_tpu_torch.api import serde
from kubernetes_tpu_torch.apiserver.admission import AdmissionChain, AdmissionError
from kubernetes_tpu_torch.apiserver.auth import Attributes
from kubernetes_tpu_torch.store.store import (
    Store, PODS, PODGROUPS, AlreadyExistsError, BackpressureError,
    ConflictError, DisruptionBudgetError, FencedError, NotFoundError,
    ExpiredError,
)

API_PREFIX = "/api/v1"


def wire_line(etype: str, obj, rv: int) -> bytes:
    """The watch stream's wire encoding of one event — THE byte-ring
    contract: installed into the store as the serialize-once encoder
    (each event is encoded once per subscription class and every
    classmate's HTTP stream serves the identical bytes). One JSON object
    per line, newline-terminated; chunked framing rides on top."""
    return json.dumps({"type": etype, "resourceVersion": rv,
                       "object": serde.to_dict(obj)}).encode() + b"\n"

# request metrics (apiserver_request_total / ..._duration_seconds /
# ..._longrunning analogs, staging/src/k8s.io/apiserver metrics.go) —
# registered at import so /metrics always exposes the families
REQUEST_TOTAL = obs.counter(
    "apiserver_request_total",
    "Requests served, by verb, resource, and HTTP code.",
    ("verb", "resource", "code"))
REQUEST_DURATION = obs.histogram(
    "apiserver_request_duration_seconds",
    "Request latency by verb (long-running watch streams excluded).",
    ("verb",))
IN_FLIGHT = obs.gauge(
    "apiserver_requests_in_flight",
    "Requests currently being served.")
ACTIVE_WATCHES = obs.gauge(
    "apiserver_active_watches",
    "Currently open watch streams, by resource.", ("resource",))


def make_handler(store: Store, admission: AdmissionChain,
                 authenticator=None, authorizer=None):
    # serialize-once byte ring: the store's commit core encodes each watch
    # event ONCE per subscription class with this server's wire encoder;
    # _watch then streams the shared bytes (zero per-watcher encoding)
    if hasattr(store, "set_wire_encoder"):
        store.set_wire_encoder(wire_line)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):   # quiet
            pass

        # -- instrumentation ------------------------------------------------
        def send_response(self, code, message=None):
            self._last_code = code
            super().send_response(code, message)

        def _classify(self) -> tuple[str, str]:
            """(verb, resource) for the request-metric labels — REST verbs
            for API paths, the raw method for operational endpoints."""
            u = urlparse(self.path)
            parts = [p for p in u.path.split("/") if p]
            method = self.command
            if len(parts) >= 3 and "/".join(parts[:2]) == "api/v1":
                resource = parts[2]
                if method == "GET":
                    if len(parts) == 3:
                        q = parse_qs(u.query)
                        verb = ("watch"
                                if q.get("watch", ["false"])[0] == "true"
                                else "list")
                    else:
                        verb = "get"
                else:
                    verb = {"POST": "create", "PUT": "update",
                            "DELETE": "delete"}.get(method, method.lower())
                return verb, resource
            return method.lower(), (parts[0] if parts else "/")

        def _instrumented(self, inner) -> None:
            verb, resource = self._classify()
            self._last_code = 0
            t0 = time.perf_counter()
            IN_FLIGHT.inc()
            try:
                inner()
            finally:
                IN_FLIGHT.dec()
                REQUEST_TOTAL.labels(verb, resource,
                                     str(self._last_code or 0)).inc()
                # long-running requests skip the duration histogram (the
                # reference excludes watches the same way) — a watch's
                # lifetime would swamp the latency signal
                if verb != "watch":
                    REQUEST_DURATION.labels(verb).observe(
                        time.perf_counter() - t0)

        def do_GET(self):
            self._instrumented(self._serve_GET)

        def do_POST(self):
            self._instrumented(self._serve_POST)

        def do_PUT(self):
            self._instrumented(self._serve_PUT)

        def do_DELETE(self):
            self._instrumented(self._serve_DELETE)

        # -- authn/authz ----------------------------------------------------
        def _authenticate(self):
            """Bearer-token authn (tokenfile analog). Returns the UserInfo
            (None when auth is disabled — the open in-process posture)."""
            if authenticator is None:
                return None
            return authenticator.authenticate(
                self.headers.get("Authorization"))

        def _authorized(self, user, verb: str, resource: str,
                        name: str = "") -> bool:
            """401 for anonymous, 403 on authorizer deny; True = proceed.
            With auth disabled every request passes (trusted in-process
            callers)."""
            if authenticator is None:
                return True
            if user is None:
                self._error(401, "Unauthorized",
                            "authentication required: present a bearer "
                            "token")
                return False
            if authorizer is not None and not authorizer.authorize(
                    Attributes(user=user, verb=verb, resource=resource,
                               name=name)):
                self._error(403, "Forbidden",
                            f"user {user.name!r} cannot {verb} {resource}"
                            f"{'/' + name if name else ''}")
                return False
            return True

        def _user_name(self, user) -> str | None:
            """The identity admission plugins act on: the VERIFIED token
            identity when auth is enabled, else the (trusting, in-process)
            X-Remote-User header — the spoofable header is dead the moment
            an authenticator is configured."""
            if authenticator is not None:
                return user.name if user is not None else None
            return self.headers.get("X-Remote-User")

        # -- helpers --------------------------------------------------------
        def _send(self, code: int, payload, chunked: bool = False,
                  headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, reason: str, message: str,
                   headers: dict | None = None,
                   extra: dict | None = None) -> None:
            body = {"kind": "Status", "status": "Failure",
                    "reason": reason, "message": message, "code": code}
            if extra:
                body.update(extra)
            self._send(code, body, headers=headers)

        def _route(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            parts = [p for p in u.path.split("/") if p]
            return u.path, parts, q

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        # -- verbs ----------------------------------------------------------
        def _serve_GET(self):
            path, parts, q = self._route()
            if path in ("/healthz", "/readyz", "/livez"):
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
                return
            if path == "/metrics":
                # one scrape of the process-global registry: apiserver
                # request families plus whatever components (workqueues,
                # informers, device pipeline) registered in this process
                body = obs.render_global().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path == "/debug/traces":
                # Chrome trace-event JSON of the span ring buffer —
                # loadable in Perfetto / chrome://tracing. `?limit=N`
                # keeps the newest N spans, `?cat=host|device` filters by
                # category (the full 64k-span ring is a multi-MB response)
                limit = q.get("limit", [None])[0]
                if limit is not None:
                    try:
                        limit = int(limit)
                        if limit < 0:
                            raise ValueError(limit)
                    except ValueError:
                        self._error(400, "BadRequest",
                                    f"invalid limit {limit!r}")
                        return
                cat = q.get("cat", [None])[0]
                self._send(200, obs_trace.to_chrome(limit=limit, cat=cat))
                return
            if path == "/debug/sched":
                # deep scheduler introspection: every registered debug
                # section (queue depths, parked gangs, device mirror,
                # victim table, ledger) plus THIS server's store (rv,
                # object counts, per-watcher cursor lag)
                snap = obs.debug_snapshot()
                snap["store"] = store.debug_state()
                self._send(200, snap)
                return
            if path == "/debug/timeseries":
                # the in-process time-series ring (obs.timeseries.SCRAPER):
                # `?family=NAME` filters to one family, `?window=N` keeps
                # the newest N samples. Empty (samples: 0) until a bench
                # cell or operator starts the scraper.
                window = q.get("window", [None])[0]
                if window is not None:
                    try:
                        window = int(window)
                        if window < 0:
                            raise ValueError(window)
                    except ValueError:
                        self._error(400, "BadRequest",
                                    f"invalid window {window!r}")
                        return
                family = q.get("family", [None])[0]
                self._send(200, obs_timeseries.SCRAPER.series(
                    family=family, window=window))
                return
            if path == "/version":
                self._send(200, {"gitVersion": "v0.3.0-kubernetes-tpu"})
                return
            if len(parts) < 3 or "/".join(parts[:2]) != "api/v1":
                self._error(404, "NotFound", path)
                return
            kind = parts[2]
            if kind not in serde.KIND_TYPES:
                self._error(404, "NotFound", f"unknown resource {kind}")
                return
            user = self._authenticate()
            if len(parts) == 3:
                if q.get("watch", ["false"])[0] == "true":
                    if not self._authorized(user, "watch", kind):
                        return
                    self._watch(kind, q)
                    return
                if not self._authorized(user, "list", kind):
                    return
                objs, rv = store.list(kind)
                self._send(200, {"kind": kind, "resourceVersion": rv,
                                 "items": [serde.to_dict(o) for o in objs]})
                return
            key = "/".join(parts[3:])
            if not self._authorized(user, "get", kind, key):
                return
            try:
                self._send(200, serde.to_dict(store.get(kind, key)))
            except NotFoundError:
                self._error(404, "NotFound", f"{kind}/{key}")

        def _watch(self, kind: str, q) -> None:
            since = q.get("resourceVersion", [None])[0]
            # opaque subscription-class key: watchers passing the same
            # (kind, selector) share one materialize-once / encode-once
            # class in the commit core (NOT a server-side event filter)
            selector = q.get("selector", [None])[0]
            try:
                w = store.watch(kind,
                                int(since) if since is not None else None,
                                selector=selector)
            except ExpiredError as e:
                self._error(410, "Expired", str(e))
                return
            # pre-encoded wire bytes straight from the class ring when the
            # core has the byte-ring verbs (a stale prebuilt .so degrades
            # to per-stream encoding)
            use_bytes = hasattr(getattr(store, "_core", None), "poll_bytes")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            ACTIVE_WATCHES.labels(kind).inc()

            def emit(line: bytes) -> bool:
                try:
                    self.wfile.write(hex(len(line))[2:].encode() + b"\r\n"
                                     + line + b"\r\n")
                    self.wfile.flush()
                    return True
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return False
            try:
                while True:
                    try:
                        if use_bytes:
                            line = w.next_bytes(timeout=0.5)
                        else:
                            ev = w.next(timeout=0.5)
                            line = None if ev is None else wire_line(
                                ev.type, ev.obj, ev.resource_version)
                    except ExpiredError:
                        # this consumer fell behind the fan-out ring and
                        # was dropped-with-resync: end the stream — the
                        # client reconnects from its last seen rv and gets
                        # a replay, or a 410 -> re-list (reflector contract)
                        break
                    if line is None:
                        # blank-line keep-alive (an empty chunk would be the
                        # stream terminator); readers skip empty lines
                        if not emit(b"\n"):
                            break
                        continue
                    if not emit(line):
                        break
            finally:
                ACTIVE_WATCHES.labels(kind).dec()
                w.stop()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
                self.close_connection = True

        def _serve_POST(self):
            path, parts, q = self._route()
            user = self._authenticate()
            # binding subresource: POST /api/v1/pods/{ns}/{name}/binding
            if len(parts) == 6 and parts[2] == PODS and parts[5] == "binding":
                key = f"{parts[3]}/{parts[4]}"
                if not self._authorized(user, "create", PODS, key):
                    return
                body = self._body()
                node = body.get("node", "")
                # optional fleet fencing token(s): [[scope, token], ...]
                fence = [(str(s), int(t)) for s, t in body.get("fence") or []]
                try:
                    current = store.get(PODS, key)
                    # the binding subresource runs admission too
                    # (NodeRestriction: node identities never bind)
                    admission.admit_binding(current, node, store,
                                            user=self._user_name(user))
                    if fence:
                        store.bind_pod(key, node, fence=fence)
                    else:
                        store.bind_pod(key, node)
                except AdmissionError as e:
                    self._error(422, "Invalid", str(e))
                    return
                except FencedError as e:
                    # superseded partition-lease token: the whole write
                    # was rejected atomically (reason distinguishes it
                    # from the rv-CAS loss on the wire)
                    self._error(409, "Fenced", str(e))
                    return
                except ConflictError as e:
                    # rv-CAS bind loss: the pod is already bound — the
                    # racing loser re-queues, never overwrites
                    self._error(409, "Conflict", str(e))
                    return
                except NotFoundError:
                    self._error(404, "NotFound", key)
                    return
                self._send(201, {"kind": "Status", "status": "Success"})
                return
            # the port's wave verb: POST /api/v1/pods/bindings — a
            # burst wave's binds and their Scheduled records as ONE
            # Store.commit_wave (the embedded store's token dedupe makes a
            # retried wave land once), then the wave's fan-out. Each
            # binding is authorized and admitted as the binding
            # subresource would; a denial or an admission error rejects
            # the whole wave before anything lands. The verb writes only
            # the records it builds from `event_spec`: a caller's own
            # records go through the events verb's authorization and
            # admission, so a body that carries them is refused.
            if len(parts) == 4 and parts[2] == PODS \
                    and parts[3] == "bindings":
                body = self._body()
                if "events" in body:
                    self._error(400, "BadRequest",
                                "the wave verb takes event_spec, not events")
                    return
                wave = [(str(k), str(n)) for k, n in body.get("bindings") or []]
                for key, _node in wave:
                    if not self._authorized(user, "create", PODS, key):
                        return
                name = self._user_name(user)
                try:
                    for key, node in wave:
                        try:
                            current = store.get(PODS, key)
                        except NotFoundError:
                            continue      # reported missing by the wave
                        admission.admit_binding(current, node, store,
                                                user=name)
                except AdmissionError as e:
                    self._error(422, "Invalid", str(e))
                    return
                kw: dict = {"token": body.get("token"),
                            "event_spec": body.get("event_spec")}
                fence = [(str(s), int(t)) for s, t in body.get("fence") or []]
                if fence:
                    kw["fence"] = fence
                conflicts: list = []
                try:
                    missing = store.commit_wave(wave, conflicts=conflicts,
                                                **kw)
                except FencedError as e:
                    self._error(409, "Fenced", str(e))
                    return
                store.fanout_wave()
                self._send(200, {"kind": "Status", "status": "Success",
                                 "missing": list(missing),
                                 "conflicts": conflicts})
                return
            # the port's existence probe: POST /api/v1/{kind}/existence
            # {"keys": [...]} -> the keys the store does not hold, for a
            # remote scheduler's stale-node checks (one request a launch
            # or wave instead of a GET a host)
            if len(parts) == 4 and parts[2] in serde.KIND_TYPES \
                    and parts[3] == "existence":
                kind = parts[2]
                if not self._authorized(user, "get", kind):
                    return
                keys = [str(k) for k in self._body().get("keys") or []]
                self._send(200, {"kind": "Status", "status": "Success",
                                 "missing": [k for k in keys
                                             if not store.contains(kind, k)]})
                return
            # fence-advance verb: POST /api/v1/fences/{scope} {"token": N}
            # — the claim protocol's handoff write (a new partition-lease
            # holder fences out the superseded one BEFORE replaying)
            if len(parts) == 4 and parts[2] == "fences":
                scope = parts[3]
                if not self._authorized(user, "update", "fences", scope):
                    return
                try:
                    token = int(self._body().get("token"))
                except (TypeError, ValueError) as e:
                    self._error(400, "BadRequest", f"token: {e}")
                    return
                if not store.advance_fence(scope, token):
                    self._error(409, "Fenced",
                                f"fence {scope!r}: token {token} is "
                                f"already superseded")
                    return
                self._send(200, {"kind": "Status", "status": "Success",
                                 "scope": scope, "token": token})
                return
            # batched eviction (round 23): POST /api/v1/pods/evictions
            # {"keys": [...], "reason"?, "stop_on_refusal"?} — the churn
            # plane's one-call PDB-guarded delete. Per-item outcomes come
            # back in the body (evicted/refused/missing/skipped/invalid);
            # a refusal is an OUTCOME here, never a 429 — the whole batch
            # always answers, callers refund tokens per "refused" item.
            if len(parts) == 4 and parts[2] == PODS \
                    and parts[3] == "evictions":
                if not self._authorized(user, "create", PODS):
                    return
                body = self._body()
                keys = list(body.get("keys") or [])
                outcomes: dict = {}
                attempt: list = []
                for key in keys:
                    try:
                        admission.admit_delete(
                            PODS, store.get(PODS, key), store,
                            user=self._user_name(user))
                    except AdmissionError:
                        outcomes[key] = "invalid"
                        continue
                    except NotFoundError:
                        outcomes[key] = "missing"
                        continue
                    attempt.append(key)
                if attempt:
                    outcomes.update(store.evict_many(
                        attempt, reason=body.get("reason", "api"),
                        stop_on_refusal=bool(body.get("stop_on_refusal"))))
                self._send(200, {"kind": "Status", "status": "Success",
                                 "outcomes": outcomes})
                return
            # eviction subresource: POST /api/v1/pods/{ns}/{name}/eviction
            # — PDB-guarded delete (reference: registry/core/pod/rest/
            # eviction.go). An exhausted budget answers 429 TooManyRequests
            # with Retry-After; the caller backs off and retries, like the
            # reference's EvictionsRetry contract.
            if len(parts) == 6 and parts[2] == PODS \
                    and parts[5] == "eviction":
                key = f"{parts[3]}/{parts[4]}"
                if not self._authorized(user, "create", PODS, key):
                    return
                # delete admission runs first (NodeRestriction: a kubelet
                # may evict only pods bound to its own node)
                try:
                    admission.admit_delete(PODS, store.get(PODS, key),
                                           store,
                                           user=self._user_name(user))
                    gone = store.evict_pod(key, reason="api")
                except AdmissionError as e:
                    self._error(422, "Invalid", str(e))
                    return
                except DisruptionBudgetError as e:
                    self._error(
                        429, "TooManyRequests", str(e),
                        headers={"Retry-After":
                                 str(int(e.retry_after))})
                    return
                except NotFoundError:
                    self._error(404, "NotFound", key)
                    return
                self._send(201, serde.to_dict(gone))
                return
            if len(parts) != 3 or parts[2] not in serde.KIND_TYPES:
                self._error(404, "NotFound", path)
                return
            kind = parts[2]
            if not self._authorized(user, "create", kind):
                return
            body = self._body()
            if isinstance(body, dict) and "items" in body:
                # collection create (round 17): the serving lane's batched
                # arrival ingest — one admission-gate evaluation and one
                # ledger admission batch land server-side in create_many
                self._create_collection(kind, body["items"], user)
                return
            admitted = None
            try:
                obj = serde.from_dict(kind, body)
                obj = admitted = admission.admit(
                    kind, obj, store, user=self._user_name(user))
                created = store.create(kind, obj)
            except AdmissionError as e:
                self._error(422, "Invalid", str(e))
                return
            except BackpressureError as e:
                # serving load shed (store.admission_gate): the write
                # never landed, so the client may safely retry after the
                # suggested backoff. Reason "Backpressure" distinguishes
                # this 429 from the eviction subresource's budget refusal
                # on the wire (RemoteStore maps them to distinct errors).
                # The admitted chain's side effects roll back like any
                # refused write (quota charges must not leak per shed).
                admission.refund(kind, admitted, store)
                self._error(429, "Backpressure", str(e),
                            headers={"Retry-After":
                                     f"{e.retry_after:.3f}"})
                return
            except AlreadyExistsError as e:
                # the admitted write never landed: roll back side-effecting
                # admissions (quota usage) or the charge leaks per retry
                admission.refund(kind, admitted, store)
                self._error(409, "AlreadyExists", str(e))
                return
            except (TypeError, ValueError, KeyError) as e:
                self._error(400, "BadRequest", str(e))
                return
            self._send(201, serde.to_dict(created))

        def _create_collection(self, kind, items, user) -> None:
            """Batched create: every item rides the admission chain, then
            ONE store.create_many (one gate evaluation + one ledger
            admission batch for pods). A partial shed answers 429
            reason=Backpressure with `accepted` in the status body (the
            first `accepted` items landed) + Retry-After — shed items'
            admission side effects (quota charges) are refunded, landed
            ones are not."""
            admitted: list = []
            try:
                for d in items:
                    obj = serde.from_dict(kind, d)
                    admitted.append(admission.admit(
                        kind, obj, store, user=self._user_name(user)))
            except AdmissionError as e:
                for a in admitted:
                    admission.refund(kind, a, store)
                self._error(422, "Invalid", str(e))
                return
            except (TypeError, ValueError, KeyError) as e:
                for a in admitted:
                    admission.refund(kind, a, store)
                self._error(400, "BadRequest", str(e))
                return
            try:
                stored = store.create_many(kind, admitted)
            except BackpressureError as e:
                k = max(0, min(int(getattr(e, "accepted", 0)),
                               len(admitted)))
                for a in admitted[k:]:
                    admission.refund(kind, a, store)
                self._error(429, "Backpressure", str(e),
                            headers={"Retry-After": f"{e.retry_after:.3f}"},
                            extra={"accepted": k})
                return
            except AlreadyExistsError as e:
                # callers pass fresh uniquely-named objects (create_many
                # contract); a duplicate is a caller bug, answered like
                # the single-create path
                self._error(409, "AlreadyExists", str(e))
                return
            self._send(201, {"kind": "Status", "status": "Success",
                             "created": len(stored or admitted)})

        def _update_collection(self, kind, body, user) -> None:
            """Batched update (round 23): every item rides the update
            admission chain against its current stored object, then ONE
            `store.update_many` (rv-CAS per item: resource_version 0/absent
            skips the CAS, anything else must match). The response carries
            per-item refusals — `conflicts` and `missing` key lists —
            instead of failing the batch; refused items' admission deltas
            are rolled back (the write never landed). An optional "fence"
            rejects the WHOLE batch atomically (409 Fenced), exactly like
            the binding subresource."""
            fence = [(str(s), int(t)) for s, t in body.get("fence") or []]
            pairs: list = []
            rollback: dict = {}    # key -> (old, admitted) for refunds
            missing: list = []
            try:
                for d in body["items"]:
                    obj = serde.from_dict(kind, d)
                    try:
                        old = store.get(kind, obj.key)
                    except NotFoundError:
                        missing.append(obj.key)
                        continue
                    obj = admission.admit_update(
                        kind, old, obj, store, user=self._user_name(user))
                    rollback[obj.key] = (old, obj)
                    pairs.append((obj, obj.resource_version or None))
            except AdmissionError as e:
                for old, a in rollback.values():
                    admission.refund_update(kind, old, a, store)
                self._error(422, "Invalid", str(e))
                return
            except (TypeError, ValueError, KeyError) as e:
                for old, a in rollback.values():
                    admission.refund_update(kind, old, a, store)
                self._error(400, "BadRequest", str(e))
                return
            conflicts: list = []
            try:
                stored = store.update_many(
                    kind, pairs, fence=fence or None,
                    conflicts=conflicts, missing=missing) if pairs else []
            except FencedError as e:
                for old, a in rollback.values():
                    admission.refund_update(kind, old, a, store)
                self._error(409, "Fenced", str(e))
                return
            for key in conflicts + missing:
                old, a = rollback.get(key, (None, None))
                if a is not None:   # the admitted write never landed
                    admission.refund_update(kind, old, a, store)
            self._send(200, {"kind": "Status", "status": "Success",
                             "updated": len(stored),
                             "items": [serde.to_dict(s) for s in stored],
                             "conflicts": conflicts, "missing": missing})

        def _serve_PUT(self):
            path, parts, q = self._route()
            # status subresource: PUT /api/v1/podgroups/{ns}/{name}/status
            # {"phase": ..., "members": ..., "scheduled": ...} — status-only
            # write (spec fields untouched), the controller/scheduler verb
            if len(parts) == 6 and parts[2] == PODGROUPS \
                    and parts[5] == "status":
                key = f"{parts[3]}/{parts[4]}"
                user = self._authenticate()
                if not self._authorized(user, "update", PODGROUPS, key):
                    return
                body = self._body()
                try:
                    updated = store.update_pod_group_status(
                        key, phase=body.get("phase"),
                        members=body.get("members"),
                        scheduled=body.get("scheduled"),
                        now=body.get("last_transition_time"))
                except NotFoundError:
                    self._error(404, "NotFound", f"{PODGROUPS}/{key}")
                    return
                except (TypeError, ValueError) as e:
                    self._error(400, "BadRequest", str(e))
                    return
                self._send(200, serde.to_dict(updated))
                return
            if len(parts) == 3 and parts[2] in serde.KIND_TYPES:
                # collection PUT (round 23): {"items": [...]} — the churn
                # plane's batched update, mirroring the round-17
                # collection POST on the mutation side
                kind = parts[2]
                user = self._authenticate()
                if not self._authorized(user, "update", kind):
                    return
                body = self._body()
                if not (isinstance(body, dict) and "items" in body):
                    self._error(400, "BadRequest",
                                "collection PUT takes {\"items\": [...]}")
                    return
                self._update_collection(kind, body, user)
                return
            if len(parts) < 4 or parts[2] not in serde.KIND_TYPES:
                self._error(404, "NotFound", path)
                return
            kind = parts[2]
            user = self._authenticate()
            if not self._authorized(user, "update", kind,
                                    "/".join(parts[3:])):
                return
            old = admitted = None
            try:
                obj = serde.from_dict(kind, self._body())
                # the chain runs on UPDATES too (the reference runs
                # admission on every write verb) — closing the PUT escape
                # hatch around LimitRanger/quota; the old object gives
                # plugins their delta
                old = store.get(kind, obj.key)
                obj = admitted = admission.admit_update(
                    kind, old, obj, store, user=self._user_name(user))
                expect = obj.resource_version or None
                updated = store.update(kind, obj, expect_rv=expect)
            except AdmissionError as e:
                self._error(422, "Invalid", str(e))
                return
            except NotFoundError as e:
                if admitted is not None:   # vanished between admit and write
                    admission.refund_update(kind, old, admitted, store)
                self._error(404, "NotFound", str(e))
                return
            except ConflictError as e:
                # the admitted write never landed: put the delta back
                admission.refund_update(kind, old, admitted, store)
                self._error(409, "Conflict", str(e))
                return
            except (TypeError, ValueError, KeyError) as e:
                self._error(400, "BadRequest", str(e))
                return
            self._send(200, serde.to_dict(updated))

        def _serve_DELETE(self):
            path, parts, q = self._route()
            if len(parts) < 4 or parts[2] not in serde.KIND_TYPES:
                self._error(404, "NotFound", path)
                return
            kind = parts[2]
            key = "/".join(parts[3:])
            user = self._authenticate()
            if not self._authorized(user, "delete", kind, key):
                return
            # deletes run admission too (NodeRestriction: a kubelet may
            # evict only pods bound to its own node)
            try:
                admission.admit_delete(kind, store.get(kind, key), store,
                                       user=self._user_name(user))
            except AdmissionError as e:
                self._error(422, "Invalid", str(e))
                return
            except NotFoundError:
                self._error(404, "NotFound", f"{kind}/{key}")
                return
            from kubernetes_tpu_torch.store.store import NAMESPACES
            if kind == NAMESPACES:
                # namespace finalization (reference: registry/core/namespace
                # storage sets DeletionTimestamp -> phase Terminating; the
                # namespace controller empties it and removes the object)
                def terminate(cur):
                    if cur.phase == "Terminating":
                        return None
                    cur.phase = "Terminating"
                    return cur
                try:
                    gone = store.guaranteed_update(NAMESPACES, key, terminate,
                                                   allow_skip=True)
                except NotFoundError:
                    self._error(404, "NotFound", f"{kind}/{key}")
                    return
                self._send(200, serde.to_dict(gone))
                return
            try:
                gone = store.delete(kind, key)
            except NotFoundError:
                self._error(404, "NotFound", f"{kind}/{key}")
                return
            self._send(200, serde.to_dict(gone))

    return Handler


class APIServer:
    """In-process apiserver: `with APIServer(store) as srv: srv.url`.

    Pass `authenticator` (apiserver.auth.TokenAuthenticator) to require
    bearer tokens, and `authorizer` (RBAC/node/union) to enforce access —
    admission's NodeRestriction then acts on the verified identity."""

    def __init__(self, store: Store, host: str = "127.0.0.1", port: int = 0,
                 admission: AdmissionChain | None = None,
                 authenticator=None, authorizer=None):
        self.store = store
        self.admission = admission or AdmissionChain()
        self._httpd = ThreadingHTTPServer(
            (host, port), make_handler(store, self.admission,
                                       authenticator, authorizer))
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
