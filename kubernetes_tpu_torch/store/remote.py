"""HTTP client store — the client-go analog for the apiserver.

`RemoteStore` implements the Store surface the scheduler, controllers, and
shared informers consume (get/list/watch + the write verbs) over the
apiserver's REST + chunked-watch contract (apiserver/server.py), so
`Scheduler(RemoteStore(url))` runs a control-plane component OUT of the
apiserver's process. It mirrors the reference's client runtime:

- REST client with status->error mapping
  (client-go/rest/request.go; Conflict/AlreadyExists/NotFound/Gone).
- Reflector transport semantics (client-go/tools/cache/reflector.go:159):
  list returns (objects, resourceVersion); watch streams JSON-lines from
  that version, transparently RECONNECTING from the last seen version when
  the TCP stream drops, and raising ExpiredError (410 Gone) when the
  server's event log no longer covers the resume point — the informer then
  re-lists.
- Client-side optimistic concurrency: guaranteed_update is a
  get -> mutate -> PUT(resourceVersion) -> retry-on-409 loop, exactly how
  reference controllers wrap their writes (GuaranteedUpdate semantics over
  plain REST); the pod convenience verbs reuse it with the same mutate
  logic as the embedded store so both transports produce identical writes.

The port's copy of the reference's `store/remote.py` with the port's
imports. What differs: `commit_wave` and `bind_pods` send a batch of
binds as ONE request to the port's wave verb, and `missing_keys` probes
many keys in one request (apiserver/server.py), where the reference posts
a binding (and a record) a pod and probes a host a GET.
"""
from __future__ import annotations

import json
import queue
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Optional

from kubernetes_tpu_torch import chaos, obs
from kubernetes_tpu_torch.api import serde
from kubernetes_tpu_torch.store.store import (
    Event, LEASES, PODS, AlreadyExistsError, BackpressureError,
    ConflictError, DisruptionBudgetError, ExpiredError, FencedError,
    NotFoundError, nominated_node_mutator, pod_condition_mutator,
)

# client-runtime metrics (rest_client_requests_total /
# reflector short-watch analogs)
WATCH_RECONNECTS = obs.counter(
    "remote_watch_reconnects_total",
    "Dropped watch streams reopened from the last seen resourceVersion, "
    "by kind.", ("kind",))
WATCH_DECODE_FAILURES = obs.counter(
    "remote_watch_decode_failures_total",
    "Watch events the client could not decode (schema drift -> watch "
    "marked expired), by kind.", ("kind",))
TRANSIENT_RETRIES = obs.counter(
    "remote_transient_retries_total",
    "Transient transport failures retried during watch re-open, by kind.",
    ("kind",))
REQUEST_RETRIES = obs.counter(
    "remote_request_retries_total",
    "Unary requests retried, by verb/outcome class: read / cas / bind / "
    "status retries follow a transient transport failure or 5xx; the "
    "distinct 'backpressure' label counts creates re-sent after a 429 "
    "admission shed, honoring the server's Retry-After with capped "
    "jittered backoff (the shed write never landed, so the retry is "
    "safe). Write classes that are not idempotent (create / delete) "
    "never retry on TRANSPORT failures.", ("verb",))


class APIStatusError(Exception):
    """Non-2xx response that maps to no store error (e.g. 422 admission
    rejection): carries the server's Status reason/message."""

    def __init__(self, code: int, reason: str, message: str):
        super().__init__(f"{code} {reason}: {message}")
        self.code = code
        self.reason = reason
        self.message = message


def _raise_for(code: int, reason: str, message: str,
               retry_after: Optional[str] = None,
               accepted: int = 0) -> None:
    if code == 404:
        raise NotFoundError(message)
    if code == 409:
        if reason == "AlreadyExists":
            raise AlreadyExistsError(message)
        if reason == "Fenced":
            # superseded partition-lease fencing token: the write was
            # rejected WHOLE — a definitive answer for a superseded
            # claim holder, never auto-retried (FencedError subclasses
            # ConflictError, so every conflict path already stops)
            raise FencedError(message)
        raise ConflictError(message)
    if code == 410:
        raise ExpiredError(message)
    if code == 429:
        # two distinct 429 contracts share the status code, split by
        # reason: "Backpressure" is the serving admission shed (the write
        # never landed — retry after the suggested backoff is SAFE),
        # anything else is the eviction subresource's budget refusal
        # (same error type as the embedded verb; never auto-retried).
        # Retry-After carries the server's suggested backoff either way.
        try:
            ra = float(retry_after) if retry_after else 10.0
        except ValueError:
            ra = 10.0
        if reason == "Backpressure":
            # `accepted` rides the status body on batched creates: the
            # first `accepted` items of the batch LANDED, only the tail
            # was shed (0 on the single-create path)
            raise BackpressureError(message, retry_after=ra,
                                    accepted=accepted)
        raise DisruptionBudgetError(message, retry_after=ra)
    raise APIStatusError(code, reason, message)


class RemoteWatch:
    """Chunked JSON-lines watch stream with reflector resume semantics.

    A background reader parses events into a queue; on a dropped stream it
    reopens from the last delivered resourceVersion. A 410 at (re)open
    surfaces as ExpiredError from next()/try_next() — the informer
    re-lists (reflector.go:159 / the server's watch contract)."""

    _RECONNECT_DELAY = 0.05

    def __init__(self, base: str, kind: str, since_rv: Optional[int],
                 timeout: float, token: Optional[str] = None,
                 selector: Optional[str] = None):
        self.kind = kind
        self.selector = selector
        self._base = base
        self._timeout = timeout
        self._token = token
        self._queue: "queue.Queue[Event]" = queue.Queue()
        self._stop = threading.Event()
        self._expired: Optional[str] = None
        self._last_rv = since_rv
        # open synchronously so an immediate 410 raises from watch() like
        # the embedded store's Store.watch does
        self._resp = self._open(since_rv)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"remote-watch-{kind}")
        self._thread.start()

    def _open(self, since_rv: Optional[int]):
        url = f"{self._base}/api/v1/{self.kind}?watch=true"
        if since_rv is not None:
            url += f"&resourceVersion={since_rv}"
        if self.selector is not None:
            # subscription-class key: server-side, watchers sharing it
            # serve from one serialize-once byte ring (reconnects carry
            # it so a resumed stream rejoins its class)
            url += "&selector=" + urllib.parse.quote(self.selector, safe="")
        headers = {}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        req = urllib.request.Request(url, method="GET", headers=headers)
        try:
            return urllib.request.urlopen(req, timeout=self._timeout)
        except urllib.error.HTTPError as e:
            body = _status_body(e)
            _raise_for(e.code, body.get("reason", ""),
                       body.get("message", str(e)))

    def _run(self) -> None:
        resp = self._resp
        while not self._stop.is_set():
            try:
                line = resp.readline()
            except (OSError, ValueError, AttributeError):
                # AttributeError: stop() closed the response under us and
                # http.client's chunked reader lost its fp mid-call
                line = b""
            if self._stop.is_set():
                break
            if line == b"":
                # stream ended: reconnect from the last seen version
                try:
                    resp.close()
                except OSError:
                    pass
                try:
                    WATCH_RECONNECTS.labels(self.kind).inc()
                    resp = self._resp = self._open(self._last_rv)
                except ExpiredError as e:
                    self._expired = str(e)
                    return
                except APIStatusError as e:
                    if e.code in (401, 403):
                        # token revoked/denied mid-watch: not transient.
                        # Surface as expiry so the informer's re-list runs
                        # and raises the auth error to its caller instead
                        # of a silent forever-retry.
                        self._expired = str(e)
                        return
                    TRANSIENT_RETRIES.labels(self.kind).inc()
                    if self._stop.wait(self._RECONNECT_DELAY):
                        return
                except (urllib.error.URLError, OSError, NotFoundError):
                    TRANSIENT_RETRIES.labels(self.kind).inc()
                    if self._stop.wait(self._RECONNECT_DELAY):
                        return
                continue
            line = line.strip()
            if not line:
                continue   # keep-alive blank line
            try:
                d = json.loads(line)
            except ValueError:
                continue
            try:
                rv = int(d.get("resourceVersion", 0))
                obj = serde.from_dict(self.kind, d["object"])
                etype = d["type"]
            except Exception as e:   # noqa: BLE001 — schema drift
                # an event the client cannot decode means the stream is no
                # longer trustworthy (server/client schema drift, not a
                # transport blip): mark the watch expired so next() raises
                # and the informer re-lists, instead of the reader thread
                # dying and next() hanging forever
                WATCH_DECODE_FAILURES.labels(self.kind).inc()
                self._expired = f"watch decode failed for {self.kind}: {e!r}"
                return
            self._last_rv = rv
            self._queue.put(Event(etype, self.kind, obj, rv))

    def _check_expired(self) -> None:
        if self._expired is not None and self._queue.empty():
            raise ExpiredError(self._expired)

    def next(self, timeout: Optional[float] = None) -> Optional[Event]:
        self._check_expired()
        try:
            return self._queue.get(
                timeout=timeout if timeout and timeout > 0 else 0.001)
        except queue.Empty:
            self._check_expired()
            return None

    def try_next(self) -> Optional[Event]:
        self._check_expired()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

    def drain(self) -> list[Event]:
        out = []
        while True:
            ev = self.try_next()
            if ev is None:
                return out
            out.append(ev)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._resp.close()
        except OSError:
            pass


def _status_body(e: urllib.error.HTTPError) -> dict:
    try:
        return json.loads(e.read() or b"{}")
    except ValueError:
        return {}


class RemoteStore:
    """The Store read/write surface over HTTP. Watch streams reconnect;
    unary calls retry transient transport failures with bounded
    exponential backoff + jitter PER VERB CLASS (reads and CAS-guarded
    writes are retry-safe; creates/deletes are not idempotent and fail
    fast), then fail with mapped errors."""

    #: verb class -> (total attempts, base backoff seconds). The bases are
    #: deliberately small: the client's job is to ride out a connection
    #: reset or an apiserver restart blip, not to poll an outage — callers
    #: with real deadlines own the long waits.
    RETRY_POLICY = {
        "read": (4, 0.02),     # GET/LIST: always idempotent
        "cas": (3, 0.02),      # rv-preconditioned PUT: a replay that landed
                               # surfaces as 409 to the CAS loop above it
        "bind": (4, 0.02),     # binding POST: read-your-write dedupe below
        "status": (3, 0.02),   # status subresource PUT (idempotent mutator)
        "write": (1, 0.0),     # create/delete: NOT idempotent — no retry
        # Lease CAS writes (leader-election acquire/renew/claim): exactly
        # ONE attempt, never ridden through transport retries. A retried
        # renew whose first attempt landed answers 409, which the elector
        # must read as a DEFINITIVE lost lease (step down before the
        # fencing window), not something a client-side loop may paper
        # over — a lease retried into "still holding" while another
        # candidate acquired is precisely the split-brain fencing exists
        # to kill. tests/test_remote.TestRetryPolicyTable pins this row.
        "lease": (1, 0.0),
    }

    def __init__(self, base_url: str, timeout: float = 30.0,
                 token: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token   # bearer identity (tokenfile authn analog)
        # deterministic jitter stream + injectable sleep (tests stub it)
        self._rng = random.Random(0xC0FFEE)
        self._sleep = time.sleep

    # -- transport -----------------------------------------------------------
    @staticmethod
    def _is_transient(exc: BaseException) -> bool:
        """A failure worth retrying on an idempotent verb: transport-level
        (connection reset/refused, timeout — incl. the chaos plane's
        injected RemoteFault, a URLError subclass) or a server-side 5xx.
        Mapped client errors (404/409/410/422...) are REAL answers."""
        if isinstance(exc, APIStatusError):
            return exc.code in (500, 502, 503, 504)
        return isinstance(exc, (urllib.error.URLError, OSError,
                                TimeoutError))

    def _backoff(self, attempt: int, base: float) -> float:
        return base * (2 ** attempt) * (0.5 + self._rng.random() / 2)

    def _request_once(self, method: str, path: str,
                      body: Optional[dict] = None) -> Any:
        chaos.check("remote.http")
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            b = _status_body(e)
            try:
                accepted = int(b.get("accepted", 0) or 0)
            except (TypeError, ValueError):
                accepted = 0
            _raise_for(e.code, b.get("reason", ""),
                       b.get("message", str(e)),
                       retry_after=e.headers.get("Retry-After"),
                       accepted=accepted)

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 verb_class: str = "read") -> Any:
        attempts, base = self.RETRY_POLICY.get(verb_class, (1, 0.0))
        for attempt in range(attempts):
            try:
                return self._request_once(method, path, body)
            except Exception as e:   # noqa: BLE001 — filtered below
                if attempt + 1 >= attempts or not self._is_transient(e):
                    raise
                REQUEST_RETRIES.labels(verb_class).inc()
                self._sleep(self._backoff(attempt, base))

    # -- reads ---------------------------------------------------------------
    def get(self, kind: str, key: str) -> Any:
        return serde.from_dict(kind, self._request(
            "GET", f"/api/v1/{kind}/{key}"))

    def list(self, kind: str) -> tuple[list[Any], int]:
        d = self._request("GET", f"/api/v1/{kind}")
        return ([serde.from_dict(kind, o) for o in d["items"]],
                int(d["resourceVersion"]))

    def watch(self, kind: str, since_rv: Optional[int] = None,
              selector: Optional[str] = None) -> RemoteWatch:
        return RemoteWatch(self.base_url, kind, since_rv, self.timeout,
                           token=self.token, selector=selector)

    #: (total attempts, cap seconds) for 429-Backpressure retries on
    #: create: the server's Retry-After is honored but capped (a server
    #: suggesting minutes must not stall the client thread), with the
    #: same 0.5-1.0x jitter stream as the transport backoff so a shed
    #: wave of clients doesn't re-arrive in phase. Distinct from the
    #: transport RETRY_POLICY: a 429 means the write definitively did
    #: NOT land, so re-POSTing is safe even though POST isn't idempotent.
    BACKPRESSURE_RETRY = (6, 2.0)

    # -- writes --------------------------------------------------------------
    def create(self, kind: str, obj: Any, move: bool = False) -> Any:
        # `move` is the embedded store's no-clone fast path; over the wire
        # serialization copies regardless. POST is not idempotent (a retry
        # whose first attempt landed would AlreadyExists) — no auto-retry
        # on TRANSPORT failures; only the 429-Backpressure shed (which
        # proves the write never landed) re-sends, on its own policy.
        attempts, cap = self.BACKPRESSURE_RETRY
        body = serde.to_dict(obj)
        for attempt in range(attempts):
            try:
                return serde.from_dict(kind, self._request(
                    "POST", f"/api/v1/{kind}", body, verb_class="write"))
            except BackpressureError as e:
                if attempt + 1 >= attempts:
                    raise
                REQUEST_RETRIES.labels("backpressure").inc()
                self._sleep(min(e.retry_after, cap)
                            * (0.5 + self._rng.random() / 2))

    def create_many(self, kind: str, objs: list, move: bool = False) -> None:
        """Batched create: ONE collection POST ({"items": [...]}) so the
        server runs ONE admission-gate evaluation + one batched ledger
        stamp for the whole flush (the round-17 arrival-ingest contract).
        A partial shed surfaces as BackpressureError carrying `accepted`
        (how many items of the prefix landed) + the server's Retry-After;
        NO auto-retry here — partial acceptance makes a blind re-POST
        unsafe, so the caller (ArrivalGenerator) re-queues the shed tail
        on its own backoff. Callers pass fresh uniquely-named objects,
        exactly like the embedded verb."""
        del move   # serialization copies regardless, as in create()
        self._request("POST", f"/api/v1/{kind}",
                      {"items": [serde.to_dict(o) for o in objs]},
                      verb_class="write")

    def update(self, kind: str, obj: Any,
               expect_rv: Optional[int] = None) -> Any:
        d = serde.to_dict(obj)
        # the server uses the object's resourceVersion as the CAS
        # precondition; expect_rv overrides it (None = unconditional)
        d["resource_version"] = expect_rv if expect_rv is not None else 0
        if kind == LEASES and expect_rv is not None:
            # lease acquire/renew CAS: one attempt, fail fast to the
            # elector (see the RETRY_POLICY "lease" row)
            verb = "lease"
        else:
            verb = "cas" if expect_rv is not None else "write"
        return serde.from_dict(kind, self._request(
            "PUT", f"/api/v1/{kind}/{obj.key}", d, verb_class=verb))

    def update_many(self, kind: str, updates: list, fence=None,
                    token: Optional[str] = None,
                    conflicts: Optional[list] = None,
                    missing: Optional[list] = None) -> list:
        """Batched update: ONE collection PUT ({"items": [...]}) — the
        churn plane's mutation twin of create_many. `updates` takes
        objects or (obj, expect_rv) pairs; each item's rv-CAS rides its
        serialized resource_version (0 = unconditional, matching the
        serial update()'s wire contract). Per-item refusals come back in
        the body and land in the caller's `conflicts`/`missing` lists —
        never an exception; 409 reason=Fenced (whole-batch) maps to
        FencedError. NOT idempotent under partial landing: no transport
        auto-retry (write verb class), same stance as create_many.
        Returns the stored snapshots echoed by the server, exactly like
        the embedded verb."""
        del token   # the server-side verb dedupes embedded callers only
        items = []
        for u in updates:
            obj, expect_rv = u if isinstance(u, tuple) else (u, None)
            d = serde.to_dict(obj)
            d["resource_version"] = expect_rv if expect_rv is not None \
                else 0
            items.append(d)
        body: dict = {"items": items}
        if fence:
            body["fence"] = [[s, t] for s, t in fence]
        out = self._request("PUT", f"/api/v1/{kind}", body,
                            verb_class="write")
        if conflicts is not None:
            conflicts.extend(out.get("conflicts") or [])
        if missing is not None:
            missing.extend(out.get("missing") or [])
        return [serde.from_dict(kind, d) for d in out.get("items") or []]

    def delete(self, kind: str, key: str) -> Any:
        return serde.from_dict(kind, self._request(
            "DELETE", f"/api/v1/{kind}/{key}", verb_class="write"))

    def contains(self, kind: str, key: str) -> bool:
        """Existence probe (the stale-host check's verb): GET mapped to
        bool. Rides the read retry policy."""
        try:
            self._request("GET", f"/api/v1/{kind}/{key}")
            return True
        except NotFoundError:
            return False

    def evict_pod(self, pod_key: str, reason: str = "api") -> Any:
        """POST pods/{ns}/{name}/eviction — the PDB-guarded delete. An
        exhausted budget surfaces as DisruptionBudgetError (429 +
        Retry-After mapped by _raise_for). NOT idempotent (a retry whose
        first attempt landed would double-charge the budget): no
        auto-retry, matching create/delete."""
        del reason   # the server books its own reason label for HTTP evicts
        return serde.from_dict(PODS, self._request(
            "POST", f"/api/v1/{PODS}/{pod_key}/eviction", {},
            verb_class="write"))

    def evict_many(self, pod_keys: list, reason: str = "api", fence=None,
                   token: Optional[str] = None,
                   stop_on_refusal: bool = False) -> dict:
        """POST pods/evictions — the batched PDB-guarded delete. Answers
        the embedded verb's per-item outcome dict ({key: "evicted" |
        "refused" | "missing" | "skipped" | "invalid"}); a refusal is an
        OUTCOME, never a 429, so callers refund tokens item-by-item. NOT
        idempotent (evicted items charged budgets): no auto-retry,
        matching evict_pod."""
        del fence, token   # embedded-verb seams; the wire batch is one POST
        out = self._request(
            "POST", f"/api/v1/{PODS}/evictions",
            {"keys": list(pod_keys), "reason": reason,
             "stop_on_refusal": bool(stop_on_refusal)},
            verb_class="write")
        return dict(out.get("outcomes") or {})

    def bind_pod(self, pod_key: str, node_name: str, fence=None) -> Any:
        """POST pods/{ns}/{name}/binding (factory.go:710), idempotent
        under retry: a transient failure after the POST went out is
        AMBIGUOUS (the write may have landed, only the response was lost),
        so before re-POSTing the client reads the pod back — a binding
        that already landed is success, never re-POSTed, and therefore
        never double-bumps the rv or double-emits the MODIFIED event.

        `fence` rides the body as [[scope, token], ...]; the server's 409
        reason=Fenced maps to FencedError (definitive, no retry), and the
        rv-CAS already-bound refusal maps to ConflictError."""
        attempts, base = self.RETRY_POLICY["bind"]
        path = f"/api/v1/{PODS}/{pod_key}/binding"
        body: dict = {"node": node_name}
        if fence:
            pairs = [fence] if isinstance(fence, tuple) else list(fence)
            body["fence"] = [[s, int(t)] for s, t in pairs]
        last: Optional[BaseException] = None
        for attempt in range(attempts):
            if attempt:
                # ambiguity check FIRST: did the lost attempt land?
                try:
                    current = self.get(PODS, pod_key)
                    if current.node_name == node_name:
                        return current
                except NotFoundError:
                    raise
                except Exception:   # noqa: BLE001 — probe is best-effort
                    pass
                REQUEST_RETRIES.labels("bind").inc()
                self._sleep(self._backoff(attempt - 1, base))
            try:
                return self._request_once("POST", path, body)
            except Exception as e:   # noqa: BLE001 — filtered below
                if not self._is_transient(e):
                    raise
                last = e
        raise last

    def bind_pods(self, bindings: list[tuple[str, str]],
                  fence=None, conflicts: Optional[list] = None) -> list[str]:
        """Batch contract of Store.bind_pods over the wire: the port's wave
        verb with no token and no records, ONE request, missing pods
        reported back instead of raised. rv-CAS losers (409 Conflict) go
        to `conflicts` when a list is passed, else ride the missing return
        — either way the caller requeues them. A superseded fencing token
        rejects the whole batch (FencedError). A binds-only wave is
        idempotent (the server's rv-CAS makes a landed bind's replay a
        no-op), so it rides the bind retry class."""
        return self._wave(bindings, {}, fence, conflicts, "bind")

    def commit_wave(self, bindings: list[tuple[str, str]],
                    events: Optional[list] = None,
                    token: Optional[str] = None,
                    event_spec: Optional[dict] = None,
                    fence=None,
                    conflicts: Optional[list] = None) -> list[str]:
        """Wave contract of Store.commit_wave over the wire, as ONE POST to
        the port's wave verb (`/api/v1/pods/bindings`): the server runs the
        embedded store's commit_wave (binds, and the Scheduled records of
        the binds that landed, built there from `event_spec`) and its
        fan-out. Missing pods come back in the body, rv-CAS losers in
        `conflicts` (else merged into the return), and a superseded
        fencing token rejects the whole wave (409 Fenced -> FencedError).
        The verb writes no caller-built records (a record write is the
        events verb's, with its own authorization and admission), so
        `events` must be empty.

        Idempotency: `token` rides to the server, whose store answers a
        retried wave that already landed from its token map — the caller
        (the shell's `_commit_wave_retrying`) retries under the same
        token, so this call itself is not retried (the reference's client,
        which has no batch verb, posts a binding and a record a pod)."""
        if events:
            raise ValueError("the wave verb builds its records from "
                             "event_spec; it takes no records")
        return self._wave(bindings, {"token": token,
                                     "event_spec": event_spec},
                          fence, conflicts, "write")

    def _wave(self, bindings, body: dict, fence, conflicts,
              verb_class: str) -> list[str]:
        body = {"bindings": [[k, n] for k, n in bindings], **body}
        if fence:
            pairs = [fence] if isinstance(fence, tuple) else list(fence)
            body["fence"] = [[s, int(t)] for s, t in pairs]
        out = self._request("POST", f"/api/v1/{PODS}/bindings", body,
                            verb_class=verb_class)
        missing = list(out.get("missing") or [])
        confl = list(out.get("conflicts") or [])
        if conflicts is not None:
            conflicts.extend(confl)
            return missing
        return missing + confl

    def missing_keys(self, kind: str, keys: list) -> list:
        """The keys of `keys` the server's store does not hold, in ONE
        request (the port's `/api/v1/{kind}/existence` verb): the shell's
        stale-node checks ask it once for a launch's or a wave's hosts.
        Rides the read retry policy."""
        out = self._request("POST", f"/api/v1/{kind}/existence",
                            {"keys": list(keys)})
        return list(out.get("missing") or [])

    def advance_fence(self, scope: str, token: int) -> bool:
        """POST /api/v1/fences/{scope} — the claim handoff's fence
        advance over the wire. Idempotent (the server records a maximum),
        so it rides the cas retry class; a 409 Fenced answer means the
        caller's token is itself already superseded -> False."""
        try:
            self._request("POST", f"/api/v1/fences/{scope}",
                          {"token": int(token)}, verb_class="cas")
            return True
        except FencedError:
            return False

    def fanout_wave(self) -> None:
        """Watch fan-out happens server-side (the embedded store's commit
        core); the wire client has nothing to deliver."""

    def guaranteed_update(self, kind: str, key: str,
                          mutate: Callable[[Any], Any],
                          allow_skip: bool = False) -> Any:
        """Client-side read-modify-write loop: GET, mutate, PUT with the
        read resourceVersion, retry on 409 — the reference controller
        pattern over plain REST."""
        while True:
            current = self.get(kind, key)
            rv = current.resource_version
            updated = mutate(current)
            if allow_skip and updated is None:
                return current
            try:
                return self.update(kind, updated, expect_rv=rv)
            except ConflictError:
                continue

    # pod conveniences: the SAME mutate closures as the embedded store
    # (store.nominated_node_mutator / pod_condition_mutator), so both
    # transports write identical objects by construction
    def set_nominated_node_name(self, pod_key: str, node_name: str) -> Any:
        return self.guaranteed_update(PODS, pod_key,
                                      nominated_node_mutator(node_name))

    def update_pod_condition(self, pod_key: str, condition) -> Any:
        return self.guaranteed_update(PODS, pod_key,
                                      pod_condition_mutator(condition),
                                      allow_skip=True)

    def update_pod_group_status(self, group_key: str,
                                phase: Optional[str] = None,
                                members: Optional[int] = None,
                                scheduled: Optional[int] = None,
                                now: Optional[float] = None) -> Any:
        """PodGroup /status subresource over the wire (the server applies
        the SAME pod_group_status_mutator the embedded store uses, so both
        transports produce identical writes). 404 maps to NotFoundError
        exactly like the embedded verb raising on a missing group."""
        from kubernetes_tpu_torch.store.store import PODGROUPS
        d = self._request(
            "PUT", f"/api/v1/{PODGROUPS}/{group_key}/status",
            {"phase": phase, "members": members, "scheduled": scheduled,
             "last_transition_time": now}, verb_class="status")
        return serde.from_dict(PODGROUPS, d)
