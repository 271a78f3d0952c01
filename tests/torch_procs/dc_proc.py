"""Subprocess DC harness for the port's cross-process transport tests:
the counterpart of tests/interdc/dc_proc.py, over antidote_tpu_torch.

Runs one port DataCenter (its planes and gates on the CPU) over the TCP
transport and obeys the reference harness's line protocol, so the
reference file's own cross-process cases drive it unchanged
(tests/test_torch_tcp.py).  It imports neither jax nor antidote_tpu.

Commands (JSON per line on stdin; one JSON reply per line on stdout):
  {"cmd": "descriptor"}
  {"cmd": "connect", "desc": [dc_id, n_partitions, [[host, pub]], [[host, q]]]}
  {"cmd": "update", "key": k, "type": t, "op": o, "arg": a, "clock": vc|null}
  {"cmd": "read", "key": k, "type": t, "clock": vc|null}
  {"cmd": "fabric"}   — which publish plane is live (native hub?)
  {"cmd": "modules"}  — the device, and whether jax or antidote_tpu
                        was ever imported here
  {"cmd": "kill"}     — hard-exit without cleanup (crash injection)
  {"cmd": "exit"}     — graceful close
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from antidote_tpu_torch.clocks import VC  # noqa: E402
from antidote_tpu_torch.config import Config  # noqa: E402
from antidote_tpu_torch.interdc.dc import DataCenter  # noqa: E402
from antidote_tpu_torch.interdc.tcp import transport_from_config  # noqa: E402
from antidote_tpu_torch.interdc.wire import DcDescriptor  # noqa: E402


def foreign_modules():
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "antidote_tpu"))


def main():
    dc_id = sys.argv[1]
    data_dir = sys.argv[2]
    pub_port = int(sys.argv[3])
    query_port = int(sys.argv[4])
    cfg = Config(n_partitions=2, heartbeat_s=0.02,
                 clock_wait_timeout_s=20.0, sync_log=True)
    bus = transport_from_config(cfg, pub_port=pub_port,
                                query_port=query_port)
    dc = DataCenter(dc_id, bus, config=cfg, data_dir=data_dir,
                    device="cpu")
    dc.start_bg_processes()

    def out(obj):
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    out({"ready": True})
    for line in sys.stdin:
        try:
            req = json.loads(line)
            cmd = req["cmd"]
            if cmd == "descriptor":
                d = dc.descriptor()
                out({"desc": [d.dc_id, d.n_partitions,
                              [list(a) for a in d.pub_addrs],
                              [list(a) for a in d.logreader_addrs]]})
            elif cmd == "connect":
                did, np_, pub, q = req["desc"]
                dc.observe_dc(DcDescriptor(
                    dc_id=did, n_partitions=np_,
                    pub_addrs=tuple(tuple(a) for a in pub),
                    logreader_addrs=tuple(tuple(a) for a in q)))
                out({"ok": True})
            elif cmd == "update":
                clock = VC(req["clock"]) if req.get("clock") else None
                ct = dc.update_objects_static(
                    clock,
                    [((req["key"], req["type"], "b"), req["op"],
                      req["arg"])])
                out({"clock": dict(ct)})
            elif cmd == "read":
                clock = VC(req["clock"]) if req.get("clock") else None
                vals, cvc = dc.read_objects_static(
                    clock, [(req["key"], req["type"], "b")])
                out({"value": vals[0], "clock": dict(cvc)})
            elif cmd == "fabric":
                out({"hub": bus._hub is not None,
                     "staged": bus._staged})
            elif cmd == "modules":
                out({"device": str(dc.device),
                     "foreign": foreign_modules()})
            elif cmd == "kill":
                os._exit(1)
            elif cmd == "exit":
                dc.close()
                out({"ok": True})
                return
            else:
                out({"error": f"unknown cmd {cmd}"})
        except Exception as e:  # noqa: BLE001 — report, keep serving
            out({"error": f"{type(e).__name__}: {e}"})


if __name__ == "__main__":
    main()
