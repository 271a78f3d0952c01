"""A causal editing history of one text document replicated over DCs,
for the RGA cell (``portbench/traffic/text-session-3dc.json``).

Time runs in ticks.  In tick t each DC's one author makes its share of
a block of ops at its DC; DC k receives DC j's ops of tick t at the
start of tick t + ``lag``, in the order they were made, before its own
author types.  Every op carries a Lamport time one more than the
largest its DC has seen, a commit time one more than its DC's last, and
a snapshot VC: what its DC had received of each DC (its own column the
DC's last commit before the op).

The typing model: an author inserts after their own last insert, and
with probability ``jump_p`` first jumps to a random visible vertex
their DC has seen.  A delete (``delete_share`` of the ops, where
anything is visible) removes, ``own_delete`` of the time, the author's
last character still visible at their DC (a backspace: the cursor moves
to that character's left reference), else a random visible vertex
their DC has seen.

DC 0 is the replica the store holds.  Its block of tick t is the two
other DCs' ops of tick t - ``lag`` and then its own of tick t.  The
base is every block of DC 0 before the fork tick, exactly ``base_ops``
ops; each session continues the history from the fork, with a seeded
stream of its own, for ``steps`` ticks.  A read at step i of a session
is at DC 0's snapshot ``read_back`` ticks before; a fold there is at
DC 0's GST: every DC's ops ``gst_lag`` ticks old or older.

Nothing of the port is imported.  The same seed gives the same history.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

#: an op row's columns (int64): kind (INSERT / DELETE), origin DC, the
#: op's Lamport time, the vertex (inserted or deleted: lamport, actor),
#: the insert's left reference (0, 0 = the head), the element, the
#: commit time, the tick, then the snapshot VC (one column a DC)
KIND, DC, TIME, LAM, ACT, RLAM, RACT, ELEM, CT, TICK, SS = range(11)
INSERT, DELETE = 0, 1
#: printable ASCII, the elements typed
ELEM_LO, ELEM_N = 32, 95


def key(lam: int, act: int) -> int:
    """A vertex's dictionary key (actors below 256)."""
    return lam << 8 | act


class _Dc:
    """One DC's view and its author's cursor."""

    __slots__ = ("lam", "known", "vis", "pos", "cursor", "stack")

    def __init__(self, n_dcs: int):
        self.lam = 0
        self.known = [0] * n_dcs     # last commit time received a DC
        self.vis: List[int] = []     # visible vertices seen here
        self.pos: Dict[int, int] = {}
        self.cursor = 0              # insert after this (0: the head)
        self.stack: List[int] = []   # the author's inserts, oldest first

    def copy(self) -> "_Dc":
        c = _Dc.__new__(_Dc)
        c.lam, c.known = self.lam, list(self.known)
        c.vis, c.pos = list(self.vis), dict(self.pos)
        c.cursor, c.stack = self.cursor, list(self.stack)
        return c

    def show(self, k: int) -> None:
        self.pos[k] = len(self.vis)
        self.vis.append(k)

    def hide(self, k: int) -> None:
        i = self.pos.pop(k, None)
        if i is None:
            return
        last = self.vis.pop()
        if i < len(self.vis):
            self.vis[i] = last
            self.pos[last] = i


def shares(block: int, n_dcs: int) -> List[int]:
    """Ops a tick by DC: the remote DCs ``block // n_dcs`` each, DC 0
    the rest, so DC 0's block holds ``block`` ops."""
    rem = block // n_dcs
    return [block - (n_dcs - 1) * rem] + [rem] * (n_dcs - 1)


class History:
    """The generator's whole state; :meth:`fork` copies it."""

    def __init__(self, n_dcs: int, tr: Dict, delete_share: float):
        if n_dcs > 255:
            raise ValueError("at most 255 DCs (one actor each)")
        self.n = n_dcs
        self.lag = int(tr["lag"])
        self.p_del = float(delete_share)
        self.jump_p = float(tr["jump_p"])
        self.own_del = float(tr["own_delete"])
        self.dcs = [_Dc(n_dcs) for _ in range(n_dcs)]
        self.ref_of: Dict[int, int] = {}
        #: tick -> each DC's ops of that tick (int64 rows)
        self.made: Dict[int, List[np.ndarray]] = {}
        #: DC 0's known VC and every DC's last commit time, a tick
        self.snap0: List[Tuple[int, ...]] = []
        self.ct_end: List[Tuple[int, ...]] = []
        self.t = 0

    def fork(self) -> "History":
        h = History.__new__(History)
        h.__dict__.update(self.__dict__)
        h.dcs = [d.copy() for d in self.dcs]
        h.ref_of = dict(self.ref_of)
        h.made = dict(self.made)
        h.snap0, h.ct_end = list(self.snap0), list(self.ct_end)
        return h

    def _receive(self, d: _Dc, rows: np.ndarray) -> None:
        for op in rows.tolist():
            if op[TIME] > d.lam:
                d.lam = op[TIME]
            j = op[DC]
            if op[CT] > d.known[j]:
                d.known[j] = op[CT]
            k = key(op[LAM], op[ACT])
            if op[KIND] == INSERT:
                d.show(k)
            else:
                d.hide(k)

    def _type(self, k: int, count: int, rng) -> np.ndarray:
        d = self.dcs[k]
        act = k + 1
        out = []
        for u0, u1, u2, u3 in rng.random((count, 4)).tolist():
            ss = list(d.known)
            d.lam += 1
            ct = ss[k] + 1
            d.known[k] = ct
            if u0 < self.p_del and d.vis:
                target = None
                if u1 < self.own_del:
                    while d.stack and d.stack[-1] not in d.pos:
                        d.stack.pop()
                    if d.stack:
                        target = d.stack.pop()
                if target is None:
                    target = d.vis[int(u2 * len(d.vis))]
                d.hide(target)
                if d.cursor == target:
                    d.cursor = self.ref_of[target]
                row = [DELETE, k, d.lam, target >> 8, target & 255, 0, 0,
                       0, ct]
            else:
                if u1 < self.jump_p and d.vis:
                    d.cursor = d.vis[int(u2 * len(d.vis))]
                ref = d.cursor
                me = key(d.lam, act)
                self.ref_of[me] = ref
                d.show(me)
                d.stack.append(me)
                d.cursor = me
                row = [INSERT, k, d.lam, d.lam, act, ref >> 8, ref & 255,
                       ELEM_LO + int(u3 * ELEM_N), ct]
            out.append(row + [self.t] + ss)
        return np.asarray(out, dtype=np.int64).reshape(count, SS + self.n)

    def tick(self, counts: List[int], rng) -> None:
        """Tick ``self.t``: every DC receives what is due, then types."""
        t = self.t
        due = self.made.get(t - self.lag)
        mine = []
        for k, d in enumerate(self.dcs):
            if due is not None:
                for j in range(self.n):
                    if j != k:
                        self._receive(d, due[j])
            mine.append(self._type(k, counts[k], rng))
        self.made[t] = mine
        self.snap0.append(tuple(self.dcs[0].known))
        self.ct_end.append(tuple(d.known[i] for i, d in enumerate(self.dcs)))
        self.t += 1

    def block0(self, t: int) -> np.ndarray:
        """DC 0's block of tick t: the others' ops of t - lag, then its
        own of t."""
        due = self.made.get(t - self.lag)
        parts = [due[j] for j in range(1, self.n)] if due else []
        return np.concatenate(parts + [self.made[t][0]])

    def gst(self, t: int, back: int) -> np.ndarray:
        """Every DC's last commit time at the end of tick t - back."""
        return np.asarray(self.ct_end[t - back] if t >= back
                          else (0,) * self.n, dtype=np.int64)


def commit_vc(rows: np.ndarray) -> np.ndarray:
    """int64[n, D]: each op's snapshot VC with its origin column set to
    its commit time."""
    vc = rows[:, SS:].copy()
    vc[np.arange(len(rows)), rows[:, DC]] = rows[:, CT]
    return vc


def columns(rows: np.ndarray):
    """The store's append argument tuples of a block: (insert columns,
    delete columns), as ``RgaPlane`` builds them (int32 ids, int64
    clocks)."""
    i32 = np.int32
    ins, dl = rows[rows[:, KIND] == INSERT], rows[rows[:, KIND] == DELETE]
    return ((ins[:, LAM].astype(i32), ins[:, ACT].astype(i32),
             ins[:, RLAM].astype(i32), ins[:, RACT].astype(i32),
             ins[:, ELEM].astype(i32), ins[:, DC].astype(i32),
             ins[:, CT].copy(), np.ascontiguousarray(ins[:, SS:])),
            (dl[:, LAM].astype(i32), dl[:, ACT].astype(i32),
             dl[:, DC].astype(i32), dl[:, CT].copy(),
             np.ascontiguousarray(dl[:, SS:])))


@dataclass
class Session:
    """One session's ``steps`` blocks of DC 0 (op rows), the read VC of
    each step, the read VC one step older (the control's) and DC 0's
    GST at each step."""

    blocks: List[np.ndarray]
    read_vc: np.ndarray
    stale_vc: np.ndarray
    gst: np.ndarray


@dataclass
class Pool:
    """The base (DC 0's first ``base_ops`` ops, in delivery order), its
    build in chunks of ``base_block`` with each chunk's fold VC, the
    sessions and the tick they fork at."""

    base: np.ndarray
    chunks: List[Tuple[np.ndarray, np.ndarray]]
    sessions: List[Session]
    fork_tick: int


def base_ticks(base_ops: int, own: int, remote: int, lag: int):
    """(ticks before the fork, DC 0's extra ops a tick) so that DC 0's
    blocks before the fork hold exactly ``base_ops`` ops."""
    def count(t):
        return own * t + remote * max(t - lag, 0)
    t = 1
    while count(t + 1) <= base_ops:
        t += 1
    if count(t) > base_ops:
        raise ValueError(f"a base of {base_ops} ops is under one tick")
    short = base_ops - count(t)
    return t, [short // t + (i < short % t) for i in range(t)]


def build(cfg: Dict, tr: Dict, seed: int) -> Pool:
    """The cell's history from ``seed``: the base, then ``sessions``
    sessions of ``steps`` steps, each forked from the base's end."""
    n = int(cfg["n_dcs"])
    per = shares(int(tr["block"]), n)
    remote = sum(per[1:])
    h = History(n, tr, cfg["delete_share"])
    t_b, extra = base_ticks(int(cfg["base_ops"]), per[0], remote, h.lag)
    rng = np.random.default_rng([seed, 0])
    for t in range(t_b):
        h.tick([per[0] + extra[t]] + per[1:], rng)
    base = np.concatenate([h.block0(t) for t in range(t_b)])
    assert len(base) == cfg["base_ops"], len(base)
    step = int(cfg["base_block"])
    frontier = np.maximum.accumulate(commit_vc(base), axis=0)
    chunks = [(base[lo:lo + step],
               frontier[min(lo + step, len(base)) - 1])
              for lo in range(0, len(base), step)]
    back, gst_lag = int(tr["read_back"]), int(tr["gst_lag"])
    sessions = []
    for s in range(int(tr["sessions"])):
        g = h.fork()
        srng = np.random.default_rng([seed, 1 + s])
        blocks = []
        for _ in range(int(tr["steps"])):
            g.tick(per, srng)
            blocks.append(g.block0(g.t - 1))
        ticks = range(t_b, g.t)
        sessions.append(Session(
            blocks=blocks,
            read_vc=np.asarray([g.snap0[t - back] for t in ticks], np.int64),
            stale_vc=np.asarray([g.snap0[t - back - 1] for t in ticks],
                                np.int64),
            gst=np.stack([g.gst(t, gst_lag) for t in ticks])))
    return Pool(base=base, chunks=chunks, sessions=sessions, fork_tick=t_b)
