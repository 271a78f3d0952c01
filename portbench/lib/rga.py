"""The RGA text-document cell: DC 0's replica of one collaborative text
document, through the port's ``entry.rga_step``, fed the blocks of a
3-DC causal editing history (``portbench/lib/text_history.py``).

Set-up generates the history from the seed, builds the base on the
card (the first ``base_ops`` ops in chunks of ``base_block``, each
appended and folded at the frontier of what was delivered), keeps a
pristine copy of it, and runs one session as the warm-up.  The window
cycles the pool of sessions: at each session's start the state is
restored from the pristine copy; each step appends a block, folds at
DC 0's GST every ``fold_every``-th step and reads the whole document at
DC 0's snapshot of the step before.  The window lasts the run's
seconds, and two passes of the pool at least.  The reads of each
session's last step and of one seeded step a session are checked,
every pass (:class:`Kept`): the first pass's stay on the card, and a
later pass's read of the same step is compared with it there and
dropped, so the card holds the store and those few reads alone.

After the window the plain reference (``portbench/reference/rga.py``)
replays the base once and each session once, and the run compares the
kept reads with it row for row, and counts the ops of refused appends.
"""

from __future__ import annotations

import time
from dataclasses import fields, replace
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import text_history as th
from portbench.lib.harness import Cell, Check, Outcome
from portbench.lib.trace import Window, span
from portbench.reference.rga import RgaReplay, as_tensors

#: seconds of the window a traced run records
TRACE_S = 3.0


def clone(st):
    """A copy of an RGA state's tensors (the store updates in place)."""
    return replace(st, **{f.name: getattr(st, f.name).clone()
                          for f in fields(st) if f.name != "actor_bits"})


def nbytes(st) -> int:
    """Bytes of an RGA state's tensors: the document's footprint."""
    return sum(getattr(st, f.name).nbytes for f in fields(st)
               if f.name != "actor_bits")


def kept_steps(tr, seed: int) -> List[set]:
    """Each session's kept steps: its last and one seeded step."""
    rng = np.random.default_rng([seed, 7])
    steps = int(tr["steps"])
    return [{steps - 1, int(rng.integers(steps))}
            for _ in range(int(tr["sessions"]))]


class Program:
    """The port: ``entry.rga_step`` over the store built from the base."""

    def __init__(self, cfg, pool: th.Pool, dev):
        from antidote_tpu_torch import entry
        from antidote_tpu_torch.mat import rga_store

        self.rga_step = entry.rga_step
        st = rga_store.rga_store_init(
            cfg["pb"], cfg["nw"], cfg["md"], n_dcs=cfg["n_dcs"],
            actor_bits=cfg["actor_bits"], device=dev)
        self.refused = torch.zeros((), dtype=torch.int64, device=dev)
        for rows, vc in pool.chunks:
            ins, dl = th.columns(rows)
            st, ok = rga_store.rga_append_coalesced(st, ins, dl)
            self.refused.add_((~ok).long() * len(rows))
            st = rga_store.rga_fold_host(st, vc)
        self.pristine = st

    def fresh(self):
        return clone(self.pristine)

    def step(self, st, s, j, blk, rv, gst, keep):
        st, ok, out = self.rga_step(st, blk[0], blk[1], rv, gst)
        self.refused.add_((~ok).long() * blk[2])
        return st, out


class Control:
    """The reference in the program's place, reading one step older
    (``--control stale_read``): it must come out not correct."""

    def __init__(self, cfg, pool: th.Pool, dev):
        self.base = RgaReplay()
        self.base.apply(pool.base)
        self.pool, self.dev = pool, dev
        self.size = cfg["pb"] + cfg["nw"]
        self.refused = torch.zeros((), dtype=torch.int64, device=dev)

    def fresh(self):
        return self.base.fork()

    def step(self, st, s, j, blk, rv, gst, keep):
        st.apply(self.pool.sessions[s].blocks[j])
        if not keep:
            return st, None
        out = st.read(self.pool.sessions[s].stale_vc[j], self.size)
        return st, as_tensors(out, self.dev)


def expected(cfg, pool: th.Pool, kept: List[set]):
    """The reference's read at every kept step: {(session, step):
    (lam, act, elem, vis, n)}."""
    base = RgaReplay()
    base.apply(pool.base)
    size = cfg["pb"] + cfg["nw"]
    want = {}
    for s, sess in enumerate(pool.sessions):
        r = base.fork()
        for rows in sess.blocks:
            r.apply(rows)
        # later ops fall outside every earlier snapshot, and an RGA
        # insert never moves what is there: one order serves every read
        order = r.order()
        for j in sorted(kept[s]):
            want[(s, j)] = r.read(sess.read_vc[j], size, order)
    return want


def rows_differ(got, ref):
    """Positions whose (lam, act, elem, vis) differ, plus |n - n_ref|:
    a 0-d tensor on the reads' device (an int where lengths differ)."""
    if got[0].shape != ref[0].shape:
        return max(got[0].shape[0], ref[0].shape[0])
    off = torch.zeros_like(ref[3])
    for a, b in zip(got[:4], ref[:4]):
        off |= a != b
    return off.sum() + (got[4].long() - ref[4].long()).abs()


class Kept:
    """The kept reads, by (session, step): the first read of each on
    the card, how many times it was read, and the rows in which every
    later read differed from the first, counted on the card.

    :meth:`rows_differ` sums the first reads' differing rows from the
    reference, once a read, and the later reads' from the first: the
    sum of every kept read's differing rows from the reference where
    each later read equals its first, never below that sum, and so 0
    exactly when every kept read equals the reference."""

    def __init__(self, dev):
        self.first: Dict[tuple, tuple] = {}
        self.reads: Dict[tuple, int] = {}
        self.later = torch.zeros((), dtype=torch.int64, device=dev)

    def add(self, sj, out) -> None:
        self.reads[sj] = self.reads.get(sj, 0) + 1
        if sj in self.first:
            self.later += rows_differ(out, self.first[sj])
        else:
            self.first[sj] = out

    def rows_differ(self, want, dev) -> int:
        return int(self.later) + sum(
            self.reads[sj] * int(rows_differ(got, as_tensors(want[sj], dev)))
            for sj, got in self.first.items())


def run(cell: Cell) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = {"start_s": time.perf_counter() - cell.t_start}
    t = time.perf_counter()
    from antidote_tpu_torch.obs.prof import profiler

    if cell.control not in (None, "stale_read"):
        raise ValueError(f"unknown control {cell.control!r}")
    setup["import_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pool = th.build(cfg, tr, cell.seed)
    kept = kept_steps(tr, cell.seed)
    S, J, F = len(pool.sessions), int(tr["steps"]), int(tr["fold_every"])
    # each step's host columns, op count, read VC (on the card) and GST
    blocks = [[th.columns(b) + (len(b),) for b in sess.blocks]
              for sess in pool.sessions]
    read_vc = torch.from_numpy(np.stack(
        [sess.read_vc for sess in pool.sessions])).to(dev)
    gsts = [[sess.gst[j] if (j + 1) % F == 0 else None for j in range(J)]
            for sess in pool.sessions]
    setup["history_s"] = time.perf_counter() - t

    t = time.perf_counter()
    prog = (Control if cell.control else Program)(cfg, pool, dev)
    sync()
    setup["base_build_s"] = time.perf_counter() - t

    state = {"st": None, "keep_s": 0.0}
    reads = Kept(dev)

    def advance(g: int, keep_reads: bool) -> int:
        """Step g of the cycled pool; returns its ops."""
        s, j = divmod(g % (S * J), J)
        if j == 0:
            state["st"] = prog.fresh()
        keep = keep_reads and j in kept[s]
        blk = blocks[s][j]
        state["st"], out = prog.step(state["st"], s, j, blk, read_vc[s, j],
                                     gsts[s][j], keep)
        if keep:
            t = time.perf_counter()
            reads.add((s, j), out)
            state["keep_s"] += time.perf_counter() - t
        return blk[2]

    t = time.perf_counter()
    for g in range(J):
        with span("warmup_step"):
            advance(g, False)
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    warm_refused = int(prog.refused)

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

    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    deadline = t0 + cell.seconds
    g, ops = 0, 0
    # two passes of the pool at least, so every kept step's read is
    # compared with the reference and, once at least, with the first's
    while time.perf_counter() < deadline or g < 2 * S * J:
        with span("rga_window_step"):
            ops += advance(g, True)
        g += 1
        if win is not None and time.perf_counter() - t0 >= TRACE_S:
            stop_trace(g)
    sync()
    t1 = time.perf_counter()
    stop_trace(g)
    window_refused = int(prog.refused) - warm_refused
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    layer = {"steps": g, "traced_steps": traced["steps"],
             "traced_ns": traced["ns"]}
    # the host's time spent keeping reads inside the window
    setup["keep_s"] = state["keep_s"]
    if not cell.control:
        setup["state_bytes"] = nbytes(prog.pristine)
    del state

    t = time.perf_counter()
    want = expected(cfg, pool, kept)
    off = reads.rows_differ(want, dev)
    setup["reference_check_s"] = time.perf_counter() - t
    n_kept = sum(reads.reads.values())
    setup["kept_reads"] = n_kept
    setup["window_steps"] = g
    checks = [Check("rows_differ", off, 0),
              Check("appends_refused", int(prog.refused), 0),
              Check("reads_compared", n_kept, 1, kind="min")]
    return Outcome(
        metrics={"merges_per_s": (ops - window_refused) / (t1 - t0),
                 "setup_s": setup_s},
        attempted=ops, failed=window_refused, checks=checks, setup=setup,
        memory_peak_bytes=peak, layer=layer, trace=win)
