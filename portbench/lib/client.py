"""The client fleet of the Cure cells, run as a child process of the
benchmark (``python -m portbench.lib.client``) so that its Python does
not share the server's interpreter lock.  It never touches the card
(the parent starts it with no CUDA device visible).

Protocol on its standard streams, one JSON object a line:

1. the parent writes the spec: ``port``, ``traffic``, ``keys``,
   ``seed``, ``seconds``, ``result`` (a file path);
2. the fleet connects and runs the mix for ``traffic["warmup_s"]``
   seconds, then writes ``{"ready": ...}``;
3. on ``go`` from the parent it runs the window for ``seconds``, waits
   for every transaction it started, writes every record to the result
   file and ``{"done": ...}``.

``traffic["loop"]`` is ``"open"`` (``rate_per_s`` transactions a second
on a fixed schedule, each timed from the moment it was due, served by
``connections`` client connections) or ``"closed"`` (``clients``
connections, each sending its next transaction when the last returns).

Every transaction is a static one (one request): an update increments
counter ``c<i>`` and adds element ``e<j>`` to set ``s<i'>``; a read
reads one counter and one set.  A certification abort is retried, and
its time stays in the transaction's latency; any other failure ends the
transaction as failed.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time

import numpy as np

#: the server's words for a write-write certification abort
CERTIFICATION = ("committed after snapshot", "prepared by concurrent txn")
BUCKET = "bucket"
#: seconds a transaction may take after the window before it counts as
#: failed
GRACE_S = 60.0


def elem(j: int) -> str:
    return "e%d" % j


def perform(cl, txn, records, lock, phase, due):
    """One static transaction over ``cl``; appends its record."""
    from antidote_tpu_torch.pb import PbError, PbServerError

    upd, c, s, e = txn
    c_obj = (f"c{c}", "counter_pn", BUCKET)
    s_obj = (f"s{s}", "set_aw", BUCKET)
    rec = {"phase": phase, "update": upd, "c": c, "s": s,
           "t_due": due, "t_send": time.monotonic(), "retries": 0}
    while True:
        try:
            if upd:
                cl.update_objects_static(None, [
                    (c_obj, "increment", 1), (s_obj, "add", elem(e).encode())])
            else:
                vals, _ = cl.read_objects_static(None, [c_obj, s_obj])
                rec["val_c"] = int(vals[0])
                rec["val_s"] = [v.decode() if isinstance(v, bytes) else v
                                for v in vals[1]]
            rec["ok"] = True
            break
        except PbServerError as err:
            if any(m in str(err) for m in CERTIFICATION):
                rec["retries"] += 1
                continue
            rec["ok"], rec["error"] = False, str(err)[:200]
            break
        except (PbError, OSError) as err:
            rec["ok"], rec["error"] = False, str(err)[:200]
            break
    rec["t_ack"] = time.monotonic()
    if upd:
        rec["elem"] = elem(e)
    with lock:
        records.append(rec)


class Fleet:
    def __init__(self, spec):
        from portbench.lib import traffic as gen

        self.spec = spec
        tr = spec["traffic"]
        self.tr = tr
        rng = np.random.default_rng(spec["seed"])
        rate = tr.get("rate_per_s") or tr.get("max_rate_per_s", 2000)
        n = int(rate * (tr["warmup_s"] + spec["seconds"] + GRACE_S)) + 1
        t = gen.static_txns(tr, spec["keys"], rng, n)
        self.txns = list(zip(t["update"].tolist(), t["c_key"].tolist(),
                             t["s_key"].tolist(), t["elem"].tolist()))
        self.next = 0
        self.lock = threading.Lock()
        self.records = []
        n_conn = tr["connections"] if tr["loop"] == "open" else tr["clients"]
        from antidote_tpu_torch.pb import PbClient

        self.clients = [PbClient(port=spec["port"], timeout=GRACE_S)
                        for _ in range(n_conn)]

    def take(self):
        with self.lock:
            i = self.next
            self.next += 1
        return self.txns[i % len(self.txns)]

    def closed(self, seconds, phase):
        t_end = time.monotonic() + seconds

        def worker(cl):
            while time.monotonic() < t_end:
                now = time.monotonic()
                perform(cl, self.take(), self.records, self.lock, phase, now)

        return self._run(worker)

    def open(self, seconds, phase):
        rate = self.tr["rate_per_s"]
        q: queue.Queue = queue.Queue()
        t0 = time.monotonic()
        n = int(seconds * rate)
        late = [0.0]

        def dispatch():
            for k in range(n):
                due = t0 + k / rate
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                else:
                    late[0] = max(late[0], -wait)
                q.put((due, self.take()))
            for _ in self.clients:
                q.put(None)

        def worker(cl):
            while True:
                item = q.get()
                if item is None:
                    return
                due, txn = item
                perform(cl, txn, self.records, self.lock, phase, due)

        d = threading.Thread(target=dispatch)
        d.start()
        self._run(worker)
        d.join()
        return late[0]

    def _run(self, worker):
        threads = [threading.Thread(target=worker, args=(cl,))
                   for cl in self.clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return 0.0

    def run(self, seconds, phase):
        if self.tr["loop"] == "open":
            return self.open(seconds, phase)
        return self.closed(seconds, phase)

    def close(self):
        for cl in self.clients:
            cl.close()


def main() -> int:
    # the imports first: the parent fills the store meanwhile
    import antidote_tpu_torch.pb  # noqa: F401

    line = sys.stdin.readline()
    if not line:
        return 1
    spec = json.loads(line)
    fleet = Fleet(spec)
    try:
        fleet.run(spec["traffic"]["warmup_s"], "warm")
        print(json.dumps({"ready": len(fleet.records)}), flush=True)
        if sys.stdin.readline().strip() != "go":
            return 1
        t0 = time.monotonic()
        c0 = time.process_time()
        late = fleet.run(spec["seconds"], "window")
        t1 = time.monotonic()
        cpu = time.process_time() - c0
    finally:
        fleet.close()
    with open(spec["result"], "w") as f:
        json.dump({"t0": t0, "t1": t1, "late_s": late, "cpu_s": cpu,
                   "records": fleet.records}, f)
    print(json.dumps({"done": len(fleet.records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
