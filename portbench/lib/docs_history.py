"""A causal editing history of a partition of text documents replicated
over DCs, for the RGA partition cell (``portbench/lib/rga_docs.py``).

Each document's history is ``portbench/lib/text_history.py``'s, with
its own seeded stream: its authors, one a DC, type its share of a tick
at their DCs, DC k receives DC j's ops of tick t at the start of tick
t + ``lag``, and a document's Lamport times are its own.  The
configuration's ``tiers`` give each document its length, the traffic's
``ops_per_step`` its ops a tick by tier; all documents run the same
ticks, so activity follows length.  Documents are independent, so the
partition generates them in worker processes, one a core up to 8 (at
the cell's size 4.7 s against 9.6-10.4 s in one process on an H100
host of 8 cores); the result does not depend on how many.

A DC's commit times run over every document of the partition: DC k's
ops of tick t take the commit times after its ops of tick t - 1,
document after document, in the order typed.  So an op's snapshot VC
is its DC's: its own column the DC's commit before the op, DC j's the
last commit of DC j's ops of tick t - ``lag``.  DC 0 receives, each
tick, DC 1's then DC 2's ops of tick t - ``lag``, each in commit order
(document after document), and then makes its own; that is the order
the partition stages them.

Each DC's author writes under an actor string, and the strings sort
opposite to the DCs (DC 0's author is ``a3`` of 3), so at DC 0 every
document meets its actors out of string order.  The rows' actor ids are
relabelled to match (DC k's author is n_dcs - k), the order the strings
give; the reference and the port see the same rows.

The base is every document's DC 0 deliveries before the fork tick, at
each document's length; each session continues every document from the
fork with seeded streams of its own.

Nothing of the port is imported.  The same seed gives the same history.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from portbench.lib import text_history as th
from portbench.lib.text_history import (  # noqa: F401 (the row layout)
    ACT, CT, DC, ELEM, INSERT, KIND, LAM, RACT, RLAM, SS, TICK)

def actor(act: int) -> str:
    """The actor string of actor id ``act`` (ids sort as the strings)."""
    return f"a{act}"


def documents(cfg) -> List[Tuple[str, int, int]]:
    """(key, tier, base ops) of every document, tier by tier."""
    out = []
    for tier, (count, ops) in enumerate(cfg["tiers"]):
        out += [(f"doc{len(out) + i}", tier, int(ops)) for i in range(count)]
    return out


def fork_tick(docs, per_tick, lag: int) -> int:
    """The ticks before the fork: the most every document's base holds
    (each DC's share a tick, DC 0 adding what its base lacks)."""
    def ticks(base_ops, per):
        return th.base_ticks(base_ops, per[0], sum(per[1:]), lag)[0]
    return min(ticks(n, per_tick[tier]) for _k, tier, n in docs)


def extra_ops(base_ops: int, per: List[int], lag: int, ticks: int):
    """DC 0's extra own ops a tick so that its base deliveries over
    ``ticks`` ticks hold exactly ``base_ops``."""
    short = base_ops - per[0] * ticks - sum(per[1:]) * max(ticks - lag, 0)
    if short < 0:
        raise ValueError(f"{base_ops} ops do not fill {ticks} ticks")
    return [short // ticks + (i < short % ticks) for i in range(ticks)]


def _histories(job):
    """The documents of ``job``, each ``text_history.History`` run to
    the fork and forked once a session: {document: (its ops by DC of
    each base tick, and of each session tick, a session)}, rows with
    the document's own commit times."""
    n, tr, delete_share, seed, t_b, docs = job
    out = {}
    for d, per, extra in docs:
        h = th.History(n, tr, delete_share)
        rng = np.random.default_rng([seed, 0, d])
        for t in range(t_b):
            h.tick([per[0] + extra[t]] + per[1:], rng)
        sessions = []
        for s in range(int(tr["sessions"])):
            g = h.fork()
            srng = np.random.default_rng([seed, 1 + s, d])
            for _ in range(int(tr["steps"])):
                g.tick(per, srng)
            sessions.append([g.made[t] for t in range(t_b, g.t)])
        out[d] = ([h.made[t] for t in range(t_b)], sessions)
    return out


def generate(jobs: List[list], n, tr, delete_share, seed, t_b) -> Dict:
    """``_histories`` of every job, in worker processes where there is
    more than one job."""
    args = [(n, tr, delete_share, seed, t_b, docs) for docs in jobs]
    if len(args) == 1:
        return _histories(args[0])
    out = {}
    # a worker that dies raises here (BrokenProcessPool), never hangs
    with ProcessPoolExecutor(len(args), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        for part in pool.map(_histories, args):
            out.update(part)
    return out


class Clocks:
    """The partition's commit times over ticks, from each document's
    ops a tick by DC (``counts[t, d, k]``): ``end[t, k]`` is DC k's last
    commit at the end of tick t, and ``shift[t, d, k]`` what turns
    document d's own commit times of DC k's ops of tick t into the
    partition's."""

    def __init__(self, counts: np.ndarray):
        n = counts.shape[2]
        self.n = n
        self.end = np.cumsum(counts.sum(axis=1), axis=0)
        before_tick = np.vstack([np.zeros((1, n), np.int64), self.end[:-1]])
        # the partition's commit before document d's first op of tick t
        at = before_tick[:, None, :] + np.cumsum(counts, axis=1) - counts
        # document d's own commit before its first op of tick t
        own = np.cumsum(counts, axis=0) - counts
        self.shift = at - own

    def vc(self, t: int) -> np.ndarray:
        """Every DC's last commit at the end of tick t (0 before)."""
        return self.end[t].copy() if t >= 0 else np.zeros(self.n, np.int64)

    def snap0(self, t: int, lag: int) -> np.ndarray:
        """DC 0's snapshot VC at the end of tick t."""
        vc = self.vc(t - lag)
        vc[0] = self.end[t][0]
        return vc

    def stamp(self, rows: np.ndarray, doc: np.ndarray, lag: int):
        """``rows`` (of documents ``doc``) with the partition's commit
        times and snapshot VCs, and actor ids relabelled, in place."""
        t, k = rows[:, TICK], rows[:, DC]
        rows[:, CT] += self.shift[t, doc, k]
        seen = np.vstack([np.zeros((lag, self.n), np.int64), self.end])
        rows[:, SS:] = seen[t]          # the end of tick t - lag
        rows[np.arange(len(rows)), SS + k] = rows[:, CT] - 1
        n = self.n
        rows[:, ACT] = n + 1 - rows[:, ACT]
        ref = rows[:, RACT] != 0
        rows[ref, RACT] = n + 1 - rows[ref, RACT]
        return rows


@dataclass
class Step:
    """One tick's DC 0 deliveries over the partition: the op rows in
    staging order and each row's document index; DC 0's snapshot VC of
    the tick before (the read's) and of two before (the control's); and
    DC 0's GST."""

    rows: np.ndarray
    doc: np.ndarray
    read_vc: np.ndarray
    stale_vc: np.ndarray
    gst: np.ndarray


@dataclass
class Partition:
    """The documents (key, tier, base ops); each document's base rows
    in delivery order; the base's frontier (DC 0's snapshot at the
    fork) and DC 0's GST then; each session's steps."""

    docs: List[Tuple[str, int, int]]
    base: List[np.ndarray]
    frontier: np.ndarray
    gst: np.ndarray
    sessions: List[List[Step]]
    fork_tick: int


def _jobs(docs, per_tick, extras, workers: int) -> List[list]:
    """The documents split over ``workers`` jobs of about equal ops
    (the largest first, each to the lightest job)."""
    jobs, load = [[] for _ in range(workers)], [0] * workers
    for d in sorted(range(len(docs)), key=lambda d: -docs[d][2]):
        i = load.index(min(load))
        jobs[i].append((d, per_tick[docs[d][1]], extras[d]))
        load[i] += docs[d][2]
    return [j for j in jobs if j]


def build(cfg: Dict, tr: Dict, seed: int) -> Partition:
    """The partition's history from ``seed``: every document's base
    to the fork tick, then ``sessions`` sessions of ``steps`` ticks."""
    n = int(cfg["n_dcs"])
    lag, back, gst_lag = int(tr["lag"]), int(tr["read_back"]), \
        int(tr["gst_lag"])
    docs = documents(cfg)
    per_tick = [th.shares(int(b), n) for b in tr["ops_per_step"]]
    t_b = fork_tick(docs, per_tick, lag)
    extras = [extra_ops(ops, per_tick[tier], lag, t_b)
              for _k, tier, ops in docs]
    workers = min(8, os.cpu_count() or 1)
    made = generate(_jobs(docs, per_tick, extras, workers), n, tr,
                    cfg["delete_share"], seed, t_b)
    D, steps = len(docs), int(tr["steps"])

    def counts(sess):
        c = np.zeros((t_b + steps, D, n), np.int64)
        for d, (base, sessions) in made.items():
            for t, by_dc in enumerate(base + sessions[sess]):
                c[t, d] = [len(r) for r in by_dc]
        return c

    def tick_rows(d, t, sess=0):
        base, sessions = made[d]
        return base[t] if t < t_b else sessions[sess][t - t_b]

    # the base's ticks count alike in every session
    clocks = Clocks(counts(0))
    base = []
    for d in range(D):
        parts = []
        for t in range(t_b):
            if t >= lag:
                parts += [tick_rows(d, t - lag)[j] for j in range(1, n)]
            parts.append(tick_rows(d, t)[0])
        rows = np.concatenate(parts)
        base.append(clocks.stamp(rows, np.full(len(rows), d), lag))
        assert len(base[d]) == docs[d][2], (d, len(base[d]), docs[d][2])
    sessions = []
    for s in range(int(tr["sessions"])):
        c = Clocks(counts(s))
        out = []
        for t in range(t_b, t_b + steps):
            parts = [(tick_rows(d, t - lag, s)[j], d)
                     for j in range(1, n) for d in range(D)]
            parts += [(tick_rows(d, t, s)[0], d) for d in range(D)]
            rows = np.concatenate([p for p, _d in parts])
            doc = np.concatenate([np.full(len(p), d, np.int64)
                                  for p, d in parts])
            out.append(Step(rows=c.stamp(rows, doc, lag), doc=doc,
                            read_vc=c.snap0(t - back, lag),
                            stale_vc=c.snap0(t - back - 1, lag),
                            gst=c.vc(t - gst_lag)))
        sessions.append(out)
    return Partition(docs=docs, base=base,
                     frontier=clocks.snap0(t_b - 1, lag),
                     gst=clocks.vc(t_b - 1 - gst_lag),
                     sessions=sessions, fork_tick=t_b)
