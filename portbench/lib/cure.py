"""The Cure cells: one DC of the port's ``AntidoteGPU`` served over the
wire (``pb.PbServer``) from this process, driven by the client fleet in
a child process (``portbench/lib/client.py``).

Set-up builds the node with every partition's device planes on the card,
fills every key of both types once (static transactions of
``fill["chunk"]`` keys, no read-back), starts the server on a port the
OS gives and the fleet, which warms up on the cell's own mix.  The
window is the fleet's.  Once it has closed, every read the window made
is held between the bounds the acknowledged updates set, and every key
the run touched is read back over the wire from the device planes (the
partitions' value caches emptied first) and compared with the plain
replay (``portbench/reference/txn.py``).
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench.lib.harness import Cell, Check, Outcome
from portbench.lib.trace import Window, span
from portbench.reference.txn import FILL_ELEM, Replay, StaleStore

#: seconds of the window a traced run records
TRACE_S = 10.0
#: keys a read-back request names
READ_CHUNK = 256
#: how stale the control's reads are, seconds
CONTROL_LAG_S = 0.2


class Spanned:
    """The node as the wire server sees it, each request inside a span
    the trace names idle time by."""

    def __init__(self, db):
        self._db = db

    def __getattr__(self, name):
        return getattr(self._db, name)

    def update_objects_static(self, *a, **k):
        with span("request.update"):
            return self._db.update_objects_static(*a, **k)

    def read_objects_static(self, *a, **k):
        with span("request.read"):
            return self._db.read_objects_static(*a, **k)


class ReadTimers:
    """Host seconds of each device read's round trip (the wait for the
    card's fold, the copy home, the host value), timed from the
    benchmark's side: every capture closure a type plane's
    ``read_begin`` / ``read_many_begin`` returns, and every
    ``device_plane.fused_read``; and a span around each flush."""

    def __init__(self, db):
        from antidote_tpu_torch.mat import device_plane

        self.dp = device_plane
        self.times = []
        self.fused = device_plane.fused_read
        for pm in db.node.partitions:
            for pl in pm.device.planes.values():
                for name in ("read_begin", "read_many_begin"):
                    setattr(pl, name, self._begin(getattr(pl, name)))
                pl.flush = self._flush(pl.flush)
        device_plane.fused_read = self._timed(self.fused)

    def _timed(self, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                with span("device_read"):
                    return fn(*a, **k)
            finally:
                self.times.append(time.perf_counter() - t0)

        for attr in ("split", "device"):
            if hasattr(fn, attr):
                setattr(run, attr, getattr(fn, attr))
        return run

    def _begin(self, begin):
        def wrapped(*a, **k):
            cl = begin(*a, **k)
            return self._timed(cl) if callable(cl) else cl
        return wrapped

    @staticmethod
    def _flush(flush):
        def wrapped(*a, **k):
            with span("flush"):
                return flush(*a, **k)
        return wrapped

    def close(self):
        self.dp.fused_read = self.fused


def counters() -> Dict[str, float]:
    from antidote_tpu_torch import stats

    r = stats.registry
    return {"aborts": r.aborted_transactions.value(),
            "log_appends": r.log_append_latency.count,
            "log_append_s": r.log_append_latency._sum,
            "flushes": r.device_flush_latency.count,
            "flush_s": r.device_flush_latency._sum,
            "read_dispatches": r.read_dispatches.value(),
            "cache_hits": r.read_cache_hits.value(),
            "cache_misses": r.read_cache_misses.value()}


def fill(db, keys: int, chunk: int) -> None:
    """Every key of both types written once, ``chunk`` keys a static
    transaction: a counter increment of 0, a set add of the fill
    element."""
    for lo in range(0, keys, chunk):
        ks = range(lo, min(lo + chunk, keys))
        with span("fill"):
            db.update_objects_static(None, [
                ((f"c{k}", "counter_pn", "bucket"), "increment", 0)
                for k in ks])
            db.update_objects_static(None, [
                ((f"s{k}", "set_aw", "bucket"), "add", FILL_ELEM.encode())
                for k in ks])


def read_back(port: int, keys):
    """Every (kind, index) of ``keys`` read over the wire: {key: value}."""
    from antidote_tpu_torch.pb import PbClient

    got = {}
    keys = sorted(keys)
    with PbClient(port=port, timeout=120) as cl:
        for lo in range(0, len(keys), READ_CHUNK):
            part = keys[lo:lo + READ_CHUNK]
            objs = [(f"{kind}{i}", "counter_pn" if kind == "c" else "set_aw",
                     "bucket") for kind, i in part]
            vals, _ = cl.read_objects_static(None, objs)
            for k, v in zip(part, vals):
                got[k] = v if k[0] == "c" else [
                    x.decode() if isinstance(x, bytes) else x for x in v]
    return got


def spawn_fleet():
    """The client fleet's process, started early so that its imports
    overlap the fill; it waits for its spec."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=root)
    return subprocess.Popen(
        [sys.executable, "-m", "portbench.lib.client"], cwd=root, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def start_fleet(proc, cell: Cell, port: int, result: str) -> None:
    spec = {"port": port, "traffic": cell.traffic, "seed": cell.seed,
            "keys": cell.config["keys_per_type"], "seconds": cell.seconds,
            "result": result}
    proc.stdin.write(json.dumps(spec) + "\n")
    proc.stdin.flush()


def stop_fleet(proc) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    proc.stdin.close()
    proc.stdout.close()


def expect_line(proc, key: str) -> dict:
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"the client fleet ended (exit {proc.wait()}) "
                           f"before {key!r}")
    msg = json.loads(line)
    if key not in msg:
        raise RuntimeError(f"the client fleet said {msg}, not {key!r}")
    return msg


def node(cell: Cell, data_dir: str):
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config

    c = cell.config
    conf = Config(n_partitions=c["n_partitions"], sync_log=c["sync_log"],
                  txn_prot=c["txn_prot"],
                  device_key_capacity=c["device_key_capacity"],
                  data_dir=data_dir,
                  flight_recorder_dir=os.path.join(data_dir, "obs"))
    return AntidoteGPU(config=conf, data_dir=data_dir, device=cell.device)


def run(cell: Cell) -> Outcome:
    cfg = cell.config
    cuda = cell.device.startswith("cuda")
    setup = {"start_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    from antidote_tpu_torch.pb import PbServer

    setup["import_s"] = time.perf_counter() - t
    if cell.control not in (None, "stale_read"):
        raise ValueError(f"unknown control {cell.control!r}")
    proc = spawn_fleet()
    timers = server = db = None
    try:
        t = time.perf_counter()
        if cell.control:
            db = StaleStore(CONTROL_LAG_S)
        else:
            db = node(cell, os.path.join(cell.scratch, "data"))
        setup["node_s"] = time.perf_counter() - t
        t = time.perf_counter()
        fill(db, cfg["keys_per_type"], cfg["fill_chunk"])
        if cuda:
            torch.cuda.synchronize()
        setup["fill_s"] = time.perf_counter() - t
        t = time.perf_counter()
        server = PbServer(Spanned(db), port=0).start()
        result = os.path.join(cell.scratch, "fleet.json")
        start_fleet(proc, cell, server.port, result)
        warm = expect_line(proc, "ready")["ready"]
        setup["fleet_and_warmup_s"] = time.perf_counter() - t
        setup["warmup_txns"] = warm
        win = None
        if cell.trace:
            if not cell.control:
                timers = ReadTimers(db)
            win = Window(cell.scratch, cuda)
        c0 = counters()
        cpu0 = resource.getrusage(resource.RUSAGE_SELF)
        if win is not None:
            win.start()
        setup_s = time.perf_counter() - cell.t_start
        proc.stdin.write("go\n")
        proc.stdin.flush()
        if win is not None:
            time.sleep(min(TRACE_S, cell.seconds))
            win.stop()
        expect_line(proc, "done")
        c1 = counters()
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
        if proc.wait(timeout=60) != 0:
            raise RuntimeError(f"the client fleet exited {proc.returncode}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        with open(result) as f:
            res = json.load(f)
        recs = res["records"]
        window = [r for r in recs if r["phase"] == "window"]
        ok = [r for r in window if r["ok"]]
        since = np.asarray([r["t_ack"] - res["t0"] for r in ok])
        done = since[since <= cell.seconds]
        per_s = np.bincount(done.astype(np.int64),
                            minlength=int(cell.seconds))
        setup["window"] = {
            "completed_each_s": per_s.tolist(),
            "server_cpu_s": (cpu1.ru_utime + cpu1.ru_stime)
            - (cpu0.ru_utime + cpu0.ru_stime),
            "fleet_cpu_s": res["cpu_s"], "late_s": res["late_s"]}
        metrics = {"txn_per_s": len(done) / cell.seconds,
                   "setup_s": setup_s}
        layer = {"counters": {k: c1[k] - c0[k] for k in c0},
                 "committed": len(ok),
                 "attempts": len(ok) + sum(r["retries"] for r in window),
                 "service_s": [r["t_ack"] - r["t_send"] for r in ok]}
        if timers is not None:
            layer["device_reads"] = list(timers.times)

        # the reference: every read between its bounds, every touched
        # key read back from the planes equal to the replay
        t = time.perf_counter()
        rep = Replay([r for r in recs if r["update"]])
        reads = [r for r in recs if not r["update"] and r["ok"]]
        off = sum(not rep.read_in_bounds(r) for r in reads)
        touched = {("c", r["c"]) for r in recs} | {("s", r["s"])
                                                   for r in recs}
        d0 = counters()["read_dispatches"]
        if not cell.control:
            for pm in db.node.partitions:
                with pm._lock:
                    pm._val_cache.clear()
        got = read_back(server.port, touched)
        dispatched = counters()["read_dispatches"] - d0
        differ = sum(not rep.final_ok(k[0], k[1], v) for k, v in got.items())
        setup["reference_check_s"] = time.perf_counter() - t
        checks = [Check("reads_outside_bounds", off, 0),
                  Check("keys_differ", differ, 0),
                  Check("keys_read_back", len(got), len(touched), "min")]
        if not cell.control:
            checks.append(Check("readback_dispatches", dispatched, 1, "min"))
        failed = sum(not r["ok"] for r in window)
        return Outcome(metrics=metrics, attempted=len(window), failed=failed,
                       checks=checks, setup=setup, memory_peak_bytes=peak,
                       layer=layer, trace=win)
    finally:
        if timers is not None:
            timers.close()
        stop_fleet(proc)
        if server is not None:
            server.stop()
        if db is not None:
            db.close()
