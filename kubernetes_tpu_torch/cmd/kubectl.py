"""kubectl analog — the CLI user tool over the REST apiserver.

Mirrors the pkg/kubectl verbs the scheduler ecosystem exercises
(cmd/kubectl; cli-runtime): talks HTTP to the apiserver (never the store
directly — process boundary preserved), prints get tables and describe
blocks (with the object's Events), applies JSON manifests, deletes, and
runs the node maintenance verbs (cordon/uncordon/drain — drain honors
matching PodDisruptionBudgets like the eviction subresource; pass
--disable-eviction for the reference's unconditional-delete mode).

  kubectl-torch --server URL get pods [-o json|wide] [--watch]
  kubectl-torch get pods default/p0 | nodes n0
  kubectl-torch describe pods default/p0
  kubectl-torch create -f manifest.json      (one object or {"items": [...]})
  kubectl-torch delete pods default/p0
  kubectl-torch cordon n0 | uncordon n0 | drain n0

(`kubectl-torch` is `python -m kubernetes_tpu_torch.cmd.kubectl`.)

The port's copy of the reference's `cmd/kubectl.py` with the port's
imports.
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Any, Optional

DEFAULT_SERVER = "http://127.0.0.1:8001"


class APIError(SystemExit):
    pass


def _req(server: str, method: str, path: str, body: Optional[dict] = None,
         return_codes: tuple = ()):
    """HTTP round trip; server errors print the Status message and exit,
    except codes in `return_codes`, which return (code, status_dict) so
    callers can handle them (apply's AlreadyExists/Conflict races)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(server + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            status = json.loads(e.read() or b"{}")
            msg = status.get("message", str(e))
        except Exception:
            status, msg = {}, str(e)
        if e.code in return_codes:
            return (e.code, status)
        print(f"Error from server ({e.code}): {msg}", file=sys.stderr)
        raise APIError(1)


def _columns(kind: str, obj: dict) -> list[tuple[str, str]]:
    name = obj.get("name", "")
    ns = obj.get("namespace")
    cols = [("NAMESPACE", ns)] if ns else []
    cols.append(("NAME", name))
    if kind == "pods":
        phase = obj.get("phase", "")
        node = obj.get("node_name", "") or "<none>"
        cols += [("STATUS", phase), ("NODE", node),
                 ("PRIORITY", str(obj.get("priority", 0)))]
    elif kind == "nodes":
        ready = "Ready"
        for c in obj.get("conditions", []):
            if c.get("type") == "Ready" and c.get("status") != "True":
                ready = "NotReady"
        if obj.get("unschedulable"):
            ready += ",SchedulingDisabled"
        cols += [("STATUS", ready),
                 ("TAINTS", str(len(obj.get("taints", []))))]
    elif kind == "events":
        cols += [("TYPE", obj.get("type", "")),
                 ("REASON", obj.get("reason", "")),
                 ("OBJECT", obj.get("involved_key", "")),
                 ("COUNT", str(obj.get("count", 1))),
                 ("MESSAGE", obj.get("message", "")[:60])]
    elif kind == "poddisruptionbudgets":
        cols += [("MIN-AVAILABLE", str(obj.get("min_available"))),
                 ("ALLOWED-DISRUPTIONS",
                  str(obj.get("disruptions_allowed", 0)))]
    return cols


def _print_table(kind: str, objs: list[dict]) -> None:
    if not objs:
        print("No resources found.")
        return
    rows = [_columns(kind, o) for o in objs]
    headers = [h for h, _ in rows[0]]
    widths = [max(len(headers[i]), *(len(r[i][1]) for r in rows)) + 2
              for i in range(len(headers))]
    print("".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip())
    for r in rows:
        print("".join(v.ljust(w) for (_h, v), w in zip(r, widths)).rstrip())


def cmd_get(args) -> int:
    if args.name:
        obj = _req(args.server, "GET", f"/api/v1/{args.kind}/{args.name}")
        if args.output == "json":
            print(json.dumps(obj, indent=2))
        else:
            _print_table(args.kind, [obj])
        return 0
    if args.watch:
        import urllib.request as u
        with u.urlopen(f"{args.server}/api/v1/{args.kind}?watch=true") as resp:
            for raw in resp:
                line = raw.strip()
                if line:
                    ev = json.loads(line)
                    print(ev["type"], json.dumps(ev["object"]))
        return 0
    body = _req(args.server, "GET", f"/api/v1/{args.kind}")
    if args.output == "json":
        print(json.dumps(body, indent=2))
    else:
        _print_table(args.kind, body.get("items", []))
    return 0


def cmd_describe(args) -> int:
    obj = _req(args.server, "GET", f"/api/v1/{args.kind}/{args.name}")

    def walk(d: Any, indent: int = 0) -> None:
        pad = " " * indent
        if isinstance(d, dict):
            for k, v in d.items():
                if isinstance(v, (dict, list)) and v:
                    print(f"{pad}{k}:")
                    walk(v, indent + 2)
                else:
                    print(f"{pad}{k}: {v}")
        elif isinstance(d, list):
            for v in d:
                walk(v, indent)
        else:
            print(f"{pad}{d}")
    walk(obj)
    # events for the object, like kubectl describe's Events: block
    key = obj.get("namespace", "") and \
        f"{obj['namespace']}/{obj['name']}" or obj.get("name", "")
    evs = _req(args.server, "GET", "/api/v1/events").get("items", [])
    mine = [e for e in evs if e.get("involved_key") == key]
    if mine:
        print("events:")
        for e in mine:
            print(f"  {e['type']}\t{e['reason']}\tx{e.get('count', 1)}\t"
                  f"{e['message']}")
    return 0


def _load_items(args) -> list[tuple[str, dict]]:
    with open(args.filename) as f:
        manifest = json.load(f)
    items = manifest.get("items", [manifest]) \
        if isinstance(manifest, dict) else manifest
    out = []
    for item in items:
        kind = item.pop("kind", None) or getattr(args, "kind", None)
        if not kind:
            raise SystemExit("manifest item missing 'kind'")
        out.append((kind, item))
    return out


def cmd_create(args) -> int:
    for kind, item in _load_items(args):
        created = _req(args.server, "POST", f"/api/v1/{kind}", item)
        print(f"{kind}/{created.get('name', '?')} created")
    return 0


def cmd_apply(args) -> int:
    """Declarative create-or-update: POST, and on AlreadyExists re-read the
    live object and PUT the manifest over it at the current
    resourceVersion, retrying the read-modify-write on Conflict (kubectl
    apply's effective behavior for this model)."""
    from kubernetes_tpu_torch.api.serde import CLUSTER_SCOPED_KINDS
    for kind, item in _load_items(args):
        r = _req(args.server, "POST", f"/api/v1/{kind}", item,
                 return_codes=(409,))
        if not (isinstance(r, tuple) and r[0] == 409):
            print(f"{kind}/{r.get('name', '?')} created")
            continue
        # exists: overlay at the live resourceVersion; a concurrent writer
        # between GET and PUT conflicts — re-read and retry, bounded
        name = item.get("name", "")
        key = name if kind in CLUSTER_SCOPED_KINDS \
            else f"{item.get('namespace', 'default')}/{name}"
        for _attempt in range(5):
            live = _req(args.server, "GET", f"/api/v1/{kind}/{key}")
            merged = {**live, **item,
                      "resource_version": live.get("resource_version", 0)}
            r = _req(args.server, "PUT", f"/api/v1/{kind}/{key}", merged,
                     return_codes=(409,))
            if not (isinstance(r, tuple) and r[0] == 409):
                break
        else:
            print(f"Error: {kind}/{key}: conflict persisted", file=sys.stderr)
            raise APIError(1)
        print(f"{kind}/{name} configured")
    return 0


def cmd_delete(args) -> int:
    _req(args.server, "DELETE", f"/api/v1/{args.kind}/{args.name}")
    print(f"{args.kind}/{args.name} deleted")
    return 0


def _patch_node(server: str, name: str, **fields) -> dict:
    node = _req(server, "GET", f"/api/v1/nodes/{name}")
    node.update(fields)
    return _req(server, "PUT", f"/api/v1/nodes/{name}", node)


def cmd_cordon(args) -> int:
    _patch_node(args.server, args.name, unschedulable=True)
    print(f"node/{args.name} cordoned")
    return 0


def cmd_uncordon(args) -> int:
    _patch_node(args.server, args.name, unschedulable=False)
    print(f"node/{args.name} uncordoned")
    return 0


def cmd_drain(args) -> int:
    """Cordon + evict every pod on the node THROUGH the eviction
    subresource (POST pods/{ns}/{name}/eviction): the server's atomic
    PDB check refuses with 429 + Retry-After when a pod's disruption
    budget is exhausted — the pod is left running and reported, exactly
    the reference drain behavior. --disable-eviction deletes directly
    (the reference flag that bypasses the eviction API)."""
    _patch_node(args.server, args.name, unschedulable=True)
    pods = _req(args.server, "GET", "/api/v1/pods").get("items", [])
    use_eviction = not getattr(args, "disable_eviction", False)
    refused = 0
    for p in pods:
        if p.get("node_name") != args.name:
            continue
        key = f"{p['namespace']}/{p['name']}"
        if use_eviction:
            out = _req(args.server, "POST",
                       f"/api/v1/pods/{key}/eviction", {},
                       return_codes=(429,))
            if isinstance(out, tuple):   # (429, status): budget exhausted
                print(f"error when evicting pod {key}: "
                      f"{out[1].get('message', 'disruption budget')}",
                      file=sys.stderr)
                refused += 1
                continue
        else:
            _req(args.server, "DELETE", f"/api/v1/pods/{key}")
        print(f"pod/{key} evicted")
    print(f"node/{args.name} drained" + (f" ({refused} refused)" if refused else ""))
    return 1 if refused else 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="kubectl-torch")
    ap.add_argument("--server", "-s", default=DEFAULT_SERVER)
    sub = ap.add_subparsers(dest="verb", required=True)

    g = sub.add_parser("get")
    g.add_argument("kind")
    g.add_argument("name", nargs="?")
    g.add_argument("-o", "--output", choices=["table", "wide", "json"],
                   default="table")
    g.add_argument("-w", "--watch", action="store_true")
    g.set_defaults(fn=cmd_get)

    d = sub.add_parser("describe")
    d.add_argument("kind")
    d.add_argument("name")
    d.set_defaults(fn=cmd_describe)

    c = sub.add_parser("create")
    c.add_argument("-f", "--filename", required=True)
    c.add_argument("--kind")
    c.set_defaults(fn=cmd_create)

    a = sub.add_parser("apply")
    a.add_argument("-f", "--filename", required=True)
    a.add_argument("--kind")
    a.set_defaults(fn=cmd_apply)

    rm = sub.add_parser("delete")
    rm.add_argument("kind")
    rm.add_argument("name")
    rm.set_defaults(fn=cmd_delete)

    for verb, fn in (("cordon", cmd_cordon), ("uncordon", cmd_uncordon),
                     ("drain", cmd_drain)):
        p = sub.add_parser(verb)
        p.add_argument("name")
        if verb == "drain":
            p.add_argument("--disable-eviction", action="store_true",
                           help="delete pods directly, skipping the PDB "
                                "eviction check")
        p.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
