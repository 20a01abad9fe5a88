"""Fleet ops CLI over a ServingFrontend's observability endpoint
(docs/OBSERVABILITY.md "Fleet observability"): the port's
``deepspeed_tpu_torch.telemetry.fleet.ObsEndpoint``, whose routes are the
JAX package's (counterpart of ``scripts/fleetctl.py``).

The frontend binds the endpoint when its config carries::

    observability:
      enabled: true
      listen: 127.0.0.1:9100

and this tool drives its routes — stdlib only, safe on any ops box::

    python -m deepspeed_tpu_torch.scripts.fleetctl --addr 127.0.0.1:9100 status
    python -m deepspeed_tpu_torch.scripts.fleetctl --addr 127.0.0.1:9100 health [--json]
    python -m deepspeed_tpu_torch.scripts.fleetctl --addr 127.0.0.1:9100 dump
    python -m deepspeed_tpu_torch.scripts.fleetctl --addr 127.0.0.1:9100 trace --out t.json

- ``status`` — one-screen fleet summary (replicas, remotes, federation
  peers, queue, firing alerts) rendered from ``/health``
- ``health`` — the full fleet health report (text summary, or the raw
  JSON with ``--json``)
- ``dump``   — trigger a fleet debug dump on the frontend host; prints
  the file paths it wrote (local + one per remote replica)
- ``trace``  — fetch the merged cross-process Chrome trace and write it
  to ``--out`` (open in chrome://tracing or Perfetto)

Exit code 0 on success, 1 on transport/HTTP failure — scriptable as a
liveness probe (``fleetctl status`` against a dead frontend fails).
"""

import argparse
import json
import sys
import urllib.error
import urllib.request


def _get(addr: str, path: str, timeout_s: float) -> bytes:
    url = f"http://{addr}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.read()
    except (urllib.error.URLError, OSError) as e:
        print(f"fleetctl: GET {url} failed: {e}", file=sys.stderr)
        sys.exit(1)


def _fmt_age(age) -> str:
    return f"{age:.1f}s" if isinstance(age, (int, float)) else "-"


def cmd_status(addr: str, args) -> None:
    r = json.loads(_get(addr, "/health", args.timeout))
    states = {}
    for rep in r.get("replicas", []):
        states[rep["state"]] = states.get(rep["state"], 0) + 1
    print(f"replicas: {len(r.get('replicas', []))} "
          + " ".join(f"{s}={n}" for s, n in sorted(states.items())))
    q = r.get("queue", {})
    print(f"queue: depth={q.get('depth', 0):.0f}"
          + ("  BROWNOUT" if q.get("brownout_active") else ""))
    for rem in r.get("remotes") or []:
        print(f"remote {rem['replica']} ({rem['source']}): "
              + ("up" if rem.get("connected") else "DOWN")
              + f" clk={float(rem.get('clock_offset_s') or 0) * 1e3:+.1f}ms"
              f" rpc={rem.get('rpc_calls', 0)}"
              f" status_age={_fmt_age(rem.get('last_status_age_s'))}")
    fed = r.get("federation")
    if fed:
        print(f"federation {fed['frontend_id']}: "
              f"peers_connected={len(fed.get('peers_live') or [])}")
        for p in fed.get("peers") or []:
            print(f"  peer {p.get('peer_id') or p['address']}: "
                  + ("up" if p.get("alive") else "DOWN")
                  + f" exports={p.get('exports_adopted', 0)}"
                  f" seats_in_use={p.get('inflight', 0)}"
                  f" status_age={_fmt_age(p.get('last_status_age_s'))}")
    fj = r.get("fleet_journal") or {}
    if fj:
        print("journal sources: "
              + " ".join(f"{s}({v.get('events', 0)})"
                         for s, v in sorted(fj.items())))
    firing = r.get("alerts_firing") or []
    if firing:
        print("ALERTS FIRING: " + " ".join(sorted(firing)))


def cmd_health(addr: str, args) -> None:
    body = _get(addr, "/health", args.timeout)
    if args.json:
        print(body.decode())
        return
    r = json.loads(body)
    print(json.dumps(r, indent=2, sort_keys=True, default=str))


def cmd_dump(addr: str, args) -> None:
    r = json.loads(_get(addr, "/dump", args.timeout))
    for key in ("json", "chrome_trace"):
        if r.get(key):
            print(f"{key}: {r[key]}")
    for src, path in sorted((r.get("remotes") or {}).items()):
        print(f"remote {src}: {path or 'FAILED'}")


def cmd_trace(addr: str, args) -> None:
    body = _get(addr, "/trace", args.timeout)
    with open(args.out, "wb") as f:
        f.write(body)
    n = len(json.loads(body).get("traceEvents", []))
    print(f"wrote {args.out}: {n} trace events")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="fleetctl", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--addr", required=True,
                    help="frontend observability endpoint host:port")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="per-request timeout in seconds")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status", help="one-screen fleet summary")
    p = sub.add_parser("health", help="full fleet health report")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of pretty-printed")
    sub.add_parser("dump", help="trigger a fleet debug dump")
    p = sub.add_parser("trace", help="fetch the merged Chrome trace")
    p.add_argument("--out", default="fleet_trace.json",
                   help="output file (default fleet_trace.json)")
    args = ap.parse_args(argv)
    {"status": cmd_status, "health": cmd_health,
     "dump": cmd_dump, "trace": cmd_trace}[args.cmd](args.addr, args)


if __name__ == "__main__":
    main()
