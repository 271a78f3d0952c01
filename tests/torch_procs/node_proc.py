"""Subprocess node harness for the port's multi-process-DC tests: the
counterpart of tests/cluster/node_proc.py, over antidote_tpu_torch.

Runs one port NodeServer (its planes on the CPU) and obeys the
reference harness's line protocol, so the reference files' own
cross-process cases drive it unchanged (tests/test_torch_cluster.py).
It imports neither jax nor antidote_tpu.

Commands (JSON per line on stdin; one JSON reply per line on stdout):
  {"cmd": "addr"}
  {"cmd": "join", "dc": d, "ring": {"0": nid, ...},
   "members": {nid: [host, port], ...}}
  {"cmd": "update", "key": k, "type": t, "op": o, "arg": a,
   "clock": vc|null}
  {"cmd": "read", "key": k, "type": t, "clock": vc|null}
  {"cmd": "stable"}
  {"cmd": "modules"}  — the device, the fabric, and whether jax or
                        antidote_tpu was ever imported here
  {"cmd": "kill"}     — hard-exit without cleanup (crash injection)
  {"cmd": "exit"}     — graceful close
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from antidote_tpu_torch.clocks import VC  # noqa: E402
from antidote_tpu_torch.cluster import NodeServer  # noqa: E402
from antidote_tpu_torch.config import Config  # noqa: E402


def foreign_modules():
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "antidote_tpu"))


def main():
    node_id = sys.argv[1]
    data_dir = sys.argv[2]
    port = int(sys.argv[3])
    faults = sys.argv[4] if len(sys.argv) > 4 else ""
    if "die_in_resize_swap" in faults:
        # crash injection: kill -9 semantics at the nastiest resize
        # point — journal + new plan persisted, staged logs complete,
        # live logs NOT yet swapped (restart must resume via journal)
        from antidote_tpu_torch.txn.node import Node

        def dying(self, old_n, new_n):
            os._exit(9)

        Node._complete_resize_swap = dying
    srv = NodeServer(node_id, port=port, data_dir=data_dir,
                     config=Config(heartbeat_s=0.02, sync_log=True,
                                   clock_wait_timeout_s=20.0),
                     device="cpu")

    def out(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    out({"ready": True, "addr": list(srv.addr),
         "assembled": srv.node is not None})
    for line in sys.stdin:
        try:
            req = json.loads(line)
            cmd = req["cmd"]
            if cmd == "addr":
                out({"addr": list(srv.addr)})
            elif cmd == "join":
                srv.install_cluster(
                    req["dc"],
                    {int(p): nid for p, nid in req["ring"].items()},
                    {nid: tuple(a) for nid, a in req["members"].items()})
                out({"ok": True})
            elif cmd == "update":
                clock = VC(req["clock"]) if req.get("clock") else None
                ct = srv.api.update_objects_static(
                    clock,
                    [((req["key"], req["type"], "b"), req["op"],
                      req["arg"])])
                out({"clock": dict(ct)})
            elif cmd == "read":
                clock = VC(req["clock"]) if req.get("clock") else None
                vals, cvc = srv.api.read_objects_static(
                    clock, [(req["key"], req["type"], "b")])
                out({"value": vals[0], "clock": dict(cvc)})
            elif cmd == "stable":
                out({"stable": dict(
                    srv.plane.get_stable_snapshot())})
            elif cmd == "resize":
                ring = srv.resize_cluster(int(req["n"]))
                out({"ring": {str(p): o for p, o in ring.items()}})
            elif cmd == "width":
                out({"n": srv.node.config.n_partitions,
                     "parked": srv._resize_parking})
            elif cmd == "modules":
                out({"device": str(srv.device),
                     "fabric": srv.fabric_kind(),
                     "foreign": foreign_modules()})
            elif cmd == "kill":
                os._exit(9)
            elif cmd == "exit":
                srv.close()
                out({"ok": True})
                return
            else:
                out({"error": f"unknown cmd {cmd!r}"})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            out({"error": f"{type(e).__name__}: {e}"})


if __name__ == "__main__":
    main()
