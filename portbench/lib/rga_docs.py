"""The RGA partition cell: DC 0's materializer of one partition holding
many collaborative text documents, through the port's partition path,
``DevicePlane`` at the port's ``Config`` defaults (its own flushes,
coalescing window and GCs), fed the deliveries of a 3-DC causal editing
history of the partition (``portbench/lib/docs_history.py``).

Set-up generates the history from the seed and builds the base as a
restart replays the log: every document's base history through
``DevicePlane.stage``, one op at a time in its delivery order, document
after document, before the DC has heard a GST (no stable VC: nothing
folds, and a full document grows); then one GC at DC 0's GST at the
fork, which folds every document but its last unstable ops.  It keeps a
pristine copy of the plane (the documents' tensors cloned on the
device, the host tables copied) and warms up on the first steps of a
session and a read of every document.

The window cycles the sessions: at each session's start the plane is
restored from the pristine copy, and that time is set-up's, not the
window's.  A step stages every op DC 0 receives that tick, one
``DevicePlane.stage(key, "rga", payload, gst)`` each with DC 0's GST as
the stable VC, as ``PartitionManager`` does, and then opens one
document with ``read_many([doc], "rga", vc)`` at DC 0's snapshot of the
step before.  Over a pass every document is opened once, in a seeded
order.  The window lasts the run's seconds, and two passes at least.

Every open of the first pass is kept (each document once), and on every
later pass each session's last open and one seeded open, which repeat
first-pass steps after a restore; after the window the plain reference
(``portbench/reference/rga_docs.py``) replays the whole partition and
the run compares each kept open with it row for row, tombstones
included.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import docs_history as dh
from portbench.lib.harness import Cell, Check, Outcome
from portbench.lib.rga import clone, kept_steps, nbytes
from portbench.lib.trace import Window, span
from portbench.reference.rga_docs import DocsReplay

#: seconds of the window a traced run records
TRACE_S = 3.0


def dc_name(k: int) -> str:
    return f"dc{k}"


def opens(part: dh.Partition, tr, seed: int) -> List[List[int]]:
    """The document each step opens: over a pass (every session's
    steps) each document once where there are as many steps as
    documents, in a seeded order."""
    perm = np.random.default_rng([seed, 9]).permutation(len(part.docs))
    steps = int(tr["steps"])
    return [[int(perm[(s * steps + j) % len(perm)]) for j in range(steps)]
            for s in range(len(part.sessions))]


def vc_of(row, n: int):
    """A dense VC as the port's ``VC`` (zero columns left out)."""
    from antidote_tpu_torch.clocks import VC

    return VC({dc_name(j): int(c) for j, c in enumerate(row[:n]) if c})


def payloads(rows: np.ndarray, doc: np.ndarray, keys: List[str], n: int):
    """(key, Payload) of each op row, in order: the effect the port's
    RGA decodes (``("ins", uid, ref, elem)`` / ``("rm", uid)``, uids
    (lamport, actor string), the head (0, "")), its origin DC, commit
    time and snapshot VC."""
    from antidote_tpu_torch.clocks import VC
    from antidote_tpu_torch.mat.materializer import Payload

    dcs = [dc_name(k) for k in range(n)]
    out = []
    for r, d in zip(rows.tolist(), doc.tolist()):
        uid = (r[dh.LAM], dh.actor(r[dh.ACT]))
        if r[dh.KIND] == dh.INSERT:
            ref = (0, "") if r[dh.RLAM] == 0 and r[dh.RACT] == 0 \
                else (r[dh.RLAM], dh.actor(r[dh.RACT]))
            eff = ("ins", uid, ref, r[dh.ELEM])
        else:
            eff = ("rm", uid)
        ss = VC({dcs[j]: c for j, c in enumerate(r[dh.SS:]) if c})
        out.append((keys[d], Payload(
            key=keys[d], type_name="rga", effect=eff,
            commit_dc=dcs[r[dh.DC]], commit_time=r[dh.CT],
            snapshot_vc=ss)))
    return out


def counters():
    """The RGA plane's counters (waits by site, appends and rows), or
    None where the program has none."""
    from antidote_tpu_torch.mat import device_plane

    waits = getattr(device_plane, "rga_plane_waits", None)
    appends = getattr(device_plane, "rga_plane_appends", None)
    if waits is None or appends is None:
        return None
    return {"waits": {s: waits.value(site=s)
                      for s in ("append", "fold", "read")},
            "appends": appends.value(what="appends"),
            "rows": appends.value(what="rows")}


class Program:
    """The port: one partition's ``DevicePlane`` at the ``Config``
    defaults, the base replayed through it."""

    def __init__(self, cfg, part: dh.Partition, dev, setup):
        from antidote_tpu_torch.config import Config
        from antidote_tpu_torch.mat.device_plane import DevicePlane

        n = int(cfg["n_dcs"])
        conf = Config()
        for k, v in cfg["plane"].items():
            if getattr(conf, k) != v:
                raise ValueError(f"the plane's {k} is {getattr(conf, k)} "
                                 f"by default, the configuration says {v}")
        self.dp = DevicePlane(config=conf, device=dev)
        #: the documents evicted now, and every one evicted in the run
        self.evicted: set = set()
        self.ever_evicted: set = set()

        def evict(key, _type, state=None):
            self.evicted.add(key)
            self.ever_evicted.add(key)
        self.dp.set_evict_handler(evict)
        self.plane = self.dp.planes["rga"]
        self.keys = [k for k, _t, _n in part.docs]
        t = time.perf_counter()
        for d, rows in enumerate(part.base):
            self.stage(payloads(rows, np.full(len(rows), d), self.keys, n),
                       None)
        self.dp.gc(vc_of(part.gst, n))
        setup["base_build_s"] = time.perf_counter() - t
        # the pristine copy: every host table of the plane, and the
        # documents' tensors
        self.saved = copy.deepcopy(
            {k: v for k, v in vars(self.plane).items() if k != "st"})
        self.saved_st = {i: clone(st) for i, st in self.plane.st.items()}
        self.saved_host_only = set(self.dp.host_only)

    def stage(self, ops, stable) -> int:
        """Stages ``ops`` ((key, payload) pairs); returns those of
        evicted documents, which the plane does not hold."""
        lost = 0
        for key, p in ops:
            if key in self.evicted:
                lost += 1
                continue
            self.dp.stage(key, "rga", p, stable)
        return lost

    def restore(self) -> None:
        vars(self.plane).update(copy.deepcopy(self.saved))
        self.plane.st = {i: clone(st) for i, st in self.saved_st.items()}
        self.dp.host_only = set(self.saved_host_only)
        self.evicted = set(self.saved_host_only)

    def open(self, d: int, vc, stale_vc):
        key = self.keys[d]
        return self.dp.read_many([key], "rga", vc).get(key)

    def state_bytes(self) -> int:
        return sum(nbytes(st) for st in self.saved_st.values())


class Control:
    """The reference in the program's place, reading one snapshot older
    (``--control stale_read``): it must come out not correct."""

    def __init__(self, cfg, part: dh.Partition, dev, setup):
        t = time.perf_counter()
        self.base = DocsReplay(range(len(part.docs)))
        for d, rows in enumerate(part.base):
            self.base.apply(rows, np.full(len(rows), d))
        setup["base_build_s"] = time.perf_counter() - t
        self.ever_evicted: set = set()

    def stage(self, ops, stable) -> int:
        rows, doc = ops
        self.live.apply(rows, doc)
        return 0

    def restore(self) -> None:
        self.live = self.base.fork()

    def open(self, d: int, vc, stale_vc):
        rep = self.live.docs[d]
        return as_tuples(rep.read(stale_vc, len(rep.elem)))


def as_tuples(out):
    """A reference read as the port's RGA state: ((lamport, actor),
    element, visible) a vertex in document order, tombstones
    included."""
    lam, act, elem, vis, n = out
    return tuple(((int(lam[i]), dh.actor(int(act[i]))), int(elem[i]),
                  bool(vis[i])) for i in range(n))


def rows_differ(got, want) -> int:
    """Vertices whose (lamport, actor, element, visible) differ between
    two reads, position by position, plus the difference in length; a
    missing read counts every vertex of the other."""
    if got is None:
        return len(want)
    n = min(len(got), len(want))
    return sum(got[i] != want[i] for i in range(n)) \
        + abs(len(got) - len(want))


def expected(part: dh.Partition, opened: List[List[int]]):
    """The reference's read at every step: {(session, step): the
    document the step opens, read as :func:`as_tuples`}."""
    base = DocsReplay(range(len(part.docs)))
    for d, rows in enumerate(part.base):
        base.docs[d].apply(rows)
    want = {}
    for s, steps in enumerate(part.sessions):
        r = base.fork()
        for j, st in enumerate(steps):
            r.apply(st.rows, st.doc)
            rep = r.docs[opened[s][j]]
            want[(s, j)] = as_tuples(rep.read(st.read_vc, len(rep.elem)))
    return want


def run(cell: Cell) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = int(cfg["n_dcs"])
    setup = {"start_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    from antidote_tpu_torch.obs.prof import profiler

    if cell.control not in (None, "stale_read"):
        raise ValueError(f"unknown control {cell.control!r}")
    if int(cfg["partitions"]) != 1:
        raise ValueError("the cell holds one partition on its card")
    setup["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    part = dh.build(cfg, tr, cell.seed)
    setup["history_s"] = time.perf_counter() - t
    S, J = len(part.sessions), int(tr["steps"])
    kept = kept_steps(tr, cell.seed)
    opened = opens(part, tr, cell.seed)

    prog = (Control if cell.control else Program)(cfg, part, dev, setup)
    sync()
    # each step's ops as the program stages them, its stable VC and its
    # read VCs
    t = time.perf_counter()
    keys = [k for k, _t, _n in part.docs]
    steps = []
    for sess in part.sessions:
        row = []
        for st in sess:
            ops = (st.rows, st.doc) if cell.control \
                else payloads(st.rows, st.doc, keys, n)
            row.append((ops, len(st.rows), vc_of(st.gst, n),
                        vc_of(st.read_vc, n), st.stale_vc))
        steps.append(row)
    setup["payloads_s"] = time.perf_counter() - t

    state = {"lost": 0, "restore_s": 0.0}
    reads: Dict[tuple, list] = {}

    def advance(g: int, keep_reads: bool) -> int:
        """Step g of the cycled sessions; returns its ops."""
        s, j = divmod(g % (S * J), J)
        if j == 0:
            t = time.perf_counter()
            prog.restore()
            state["restore_s"] += time.perf_counter() - t
        ops, n_ops, gst, read_vc, stale_vc = steps[s][j]
        state["lost"] += prog.stage(ops, gst)
        got = prog.open(opened[s][j], read_vc, stale_vc)
        if keep_reads and (g < S * J or j in kept[s]):
            reads.setdefault((s, j), []).append(got)
        return n_ops

    t = time.perf_counter()
    warm = max(1, min(int(tr["warmup_steps"]), J))
    for g in range(warm):
        with span("warmup_step"):
            advance(g, False)
    # every document's read shape, at the last warm-up step's snapshot
    _ops, _n, _gst, read_vc, stale_vc = steps[0][warm - 1]
    for d in range(len(part.docs)):
        prog.open(d, read_vc, stale_vc)
    sync()
    setup["warmup_s"] = time.perf_counter() - t - state["restore_s"]
    setup["warmup_restore_s"] = state["restore_s"]
    state.update(lost=0, restore_s=0.0)

    win = Window(cell.scratch, cuda, host=False) if cell.trace else None
    if win is not None:
        profiler.reset()
        profiler.configure(detail=True)
        win.start()
    traced = {"steps": None, "ns": None, "lo": time.time_ns()}

    def stop_trace(steps_done: int) -> None:
        if win is not None and not win.window_s:
            win.stop()
            profiler.configure(detail=False)
            traced["steps"] = steps_done
            traced["ns"] = (traced["lo"], time.time_ns())

    counts0 = counters()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    deadline = t0 + cell.seconds
    g, ops = 0, 0
    # two passes at least, so every document is opened twice, and each
    # kept open of a later pass repeats a first-pass step after a
    # restore
    while time.perf_counter() < deadline or g < 2 * S * J:
        with span("docs_window_step"):
            ops += advance(g, True)
        g += 1
        if win is not None and time.perf_counter() - t0 >= TRACE_S:
            stop_trace(g)
    sync()
    t1 = time.perf_counter()
    stop_trace(g)
    counts1 = counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    layer = {"steps": g, "traced_steps": traced["steps"],
             "traced_ns": traced["ns"],
             "plane_counters": None if counts0 is None
             else {"start": counts0, "end": counts1}}
    setup["restore_s"] = state["restore_s"]
    if not cell.control:
        setup["state_bytes"] = prog.state_bytes()

    t = time.perf_counter()
    want = expected(part, opened)
    off = sum(rows_differ(got, want[sj])
              for sj, gots in reads.items() for got in gots)
    setup["reference_check_s"] = time.perf_counter() - t
    n_kept = sum(len(v) for v in reads.values())
    setup["kept_reads"] = n_kept
    setup["window_steps"] = g
    checks = [Check("rows_differ", off, 0),
              Check("documents_evicted", len(prog.ever_evicted), 0),
              Check("reads_compared", n_kept, S * J, kind="min")]
    window_s = t1 - t0 - state["restore_s"]
    return Outcome(
        metrics={"merges_per_s": (ops - state["lost"]) / window_s,
                 "setup_s": setup_s},
        attempted=ops, failed=state["lost"], checks=checks, setup=setup,
        memory_peak_bytes=peak, layer=layer, trace=win)
