"""Node-process CLI: ``python -m antidote_tpu_torch.cluster <node_id> ...``.

Runs one NodeServer (one OS process of a multi-node DC) until killed —
the rebuild's `bin/antidote start` for a cluster member (reference
release script + antidote_dc_manager staged join).  A coordinator (the
console, a test harness, or another node) pushes the cluster plan via
the "join" RPC; with ``--expect-plan`` the process just serves until
that happens.

Port of antidote_tpu/cluster/__main__.py with the same flags, plus
``--device``: the member's planes sit on the card by default (the
process raises where there is none), ``--device cpu`` keeps them on
the CPU.  The stop handlers are installed before the serving line is
printed, so a SIGTERM sent as soon as that line appears stops the node
cleanly.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m antidote_tpu_torch.cluster")
    ap.add_argument("node_id")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data-dir", default="antidote_data")
    ap.add_argument("--n-partitions", type=int, default=8)
    ap.add_argument("--heartbeat-s", type=float, default=1.0)
    ap.add_argument("--sync-log", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the member's planes live: the card "
                    "when omitted, or e.g. 'cpu'")
    args = ap.parse_args(argv)

    # serving fabric RPCs next to local work: the default 5 ms GIL
    # switch interval adds multi-ms scheduling stalls per cross-node
    # round trip
    sys.setswitchinterval(0.0005)

    from antidote_tpu_torch.cluster import NodeServer
    from antidote_tpu_torch.config import Config

    srv = NodeServer(
        args.node_id, host=args.host, port=args.port,
        data_dir=args.data_dir,
        config=Config(n_partitions=args.n_partitions,
                      heartbeat_s=args.heartbeat_s,
                      sync_log=args.sync_log),
        device=args.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())
    print(f"node {args.node_id} serving on {srv.addr[0]}:{srv.addr[1]}"
          f" (assembled={srv.node is not None})", flush=True)
    stop.wait()
    srv.close()


if __name__ == "__main__":
    sys.exit(main())
