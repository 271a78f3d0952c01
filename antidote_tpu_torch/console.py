"""Operator console — the antidote_console / antidote-admin analogue
(reference src/antidote_console.erl:31-60, rel/files/antidote-admin).

Talks to a running node over the wire protocol (pb/server.py), so it
works against any live DC without touching its process:

    python -m antidote_tpu.console [--host H] [--port P] COMMAND

Commands:
    status                  node/DC status (partitions, clocks, flags)
    ring                    partition map summary
    descriptor [FILE]       print (or save) this DC's connection descriptor
    connect FILE [FILE...]  connect this DC to peers by descriptor file
    create-dc [NODE...]     form the DC (single-node; see api.create_dc)
    flag get NAME           read a runtime flag
    flag set NAME VALUE     set a runtime flag (bool/int/str inferred)

The console only speaks TCP: it must come up instantly and never touch
(or wait on) the card.  The package import pulls in torch, and
importing torch creates no CUDA context; nothing here creates one.
"""

from __future__ import annotations

import argparse
import json
import sys

from antidote_tpu_torch.pb.client import PbClient, PbError  # noqa: E402
from antidote_tpu_torch.pb import codec  # noqa: E402


def _parse_value(raw: str):
    low = raw.lower()
    if low in ("true", "on", "1"):
        return True
    if low in ("false", "off", "0"):
        return False
    try:
        return int(raw)
    except ValueError:
        return raw


def _jsonable(term):
    if isinstance(term, dict):
        return {str(k): _jsonable(v) for k, v in term.items()}
    if isinstance(term, (list, tuple)):
        return [_jsonable(v) for v in term]
    if isinstance(term, bytes):
        return term.decode(errors="replace")
    return term


def cmd_status(cl: PbClient, args) -> int:
    print(json.dumps(_jsonable(cl.admin_status()), indent=2, sort_keys=True))
    return 0


def cmd_ring(cl: PbClient, args) -> int:
    st = cl.admin_status()
    print(f"dc {st['dc_id']}: {st['n_partitions']} partitions")
    for p in st["partitions"]:
        dev = ", ".join(f"{t}={n}" for t, n in
                        sorted(dict(p["device_keys"]).items()) if n)
        print(f"  p{p['partition']}: host_keys={p['host_keys']}"
              f" prepared={p['prepared_txns']}"
              + (f" device[{dev}]" if dev else ""))
    return 0


def cmd_descriptor(cl: PbClient, args) -> int:
    desc = cl.get_connection_descriptor()
    blob = codec.descriptor_to_bytes(desc)
    if args.file:
        with open(args.file, "wb") as f:
            f.write(blob)
        print(f"descriptor for {desc.dc_id} written to {args.file}")
    else:
        sys.stdout.buffer.write(blob)
    return 0


def cmd_connect(cl: PbClient, args) -> int:
    descs = []
    for path in args.files:
        with open(path, "rb") as f:
            descs.append(codec.descriptor_from_bytes(f.read()))
    cl.connect_to_dcs(descs)
    print(f"connected to {[d.dc_id for d in descs]}")
    return 0


def cmd_create_dc(cl: PbClient, args) -> int:
    cl.create_dc(args.nodes or None)
    print("dc formed")
    return 0


def cmd_flag(cl: PbClient, args) -> int:
    if args.action == "get":
        print(json.dumps({args.name: cl.get_flag(args.name)}))
    else:
        value = cl.set_flag(args.name, _parse_value(args.value))
        print(json.dumps({args.name: value}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="antidote_tpu.console",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8087)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status").set_defaults(fn=cmd_status)
    sub.add_parser("ring").set_defaults(fn=cmd_ring)
    d = sub.add_parser("descriptor")
    d.add_argument("file", nargs="?")
    d.set_defaults(fn=cmd_descriptor)
    c = sub.add_parser("connect")
    c.add_argument("files", nargs="+")
    c.set_defaults(fn=cmd_connect)
    cd = sub.add_parser("create-dc")
    cd.add_argument("nodes", nargs="*")
    cd.set_defaults(fn=cmd_create_dc)
    f = sub.add_parser("flag")
    f.add_argument("action", choices=("get", "set"))
    f.add_argument("name")
    f.add_argument("value", nargs="?")
    f.set_defaults(fn=cmd_flag)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "action", None) == "set" and args.value is None:
        print("flag set requires a VALUE", file=sys.stderr)
        return 2
    try:
        with PbClient(host=args.host, port=args.port) as cl:
            return args.fn(cl, args)
    except PbError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"cannot reach {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
