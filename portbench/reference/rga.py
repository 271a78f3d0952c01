"""The plain reference of the RGA cell: one text document as a
Replicated Growable Array (Roh et al., "Replicated abstract data
types", JPDC 2011), replayed op by op in plain Python.

The document is a linked list of vertices, each named by its (lamport,
actor).  An insert goes right after its reference vertex (the head for
(0, 0)), past every successor whose (lamport, actor) is larger; a
delete marks its target and the vertex stays as a tombstone.  Ops are
applied in the order the replica received them, which is causal.

Every vertex and every delete keeps its commit VC (its snapshot VC
with its origin DC's column set to its commit time).  A read at a
snapshot VC keeps, in list order, exactly the vertices whose commit VC
the snapshot covers; such a vertex is visible unless a delete whose
commit VC the snapshot covers names it.

Nothing of the port is imported or used; torch only hands the answer
out as tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

#: the op rows' columns (portbench/lib/text_history.py's layout)
KIND, DC, TIME, LAM, ACT, RLAM, RACT, ELEM, CT, TICK, SS = range(11)
INSERT = 0
HEAD = (0, 0)
END = None


def covered(vcs, rv) -> List[bool]:
    """Whether snapshot ``rv`` covers each VC of ``vcs``, columnwise."""
    if not len(vcs):
        return []
    return (np.asarray(vcs, np.int64) <= rv).all(axis=1).tolist()


class RgaReplay:
    """The replica's document: the list, each vertex's element and
    commit VC, and every delete received with its commit VC."""

    def __init__(self):
        self.nxt: Dict[Tuple[int, int], object] = {HEAD: END}
        self.elem: Dict[Tuple[int, int], int] = {}
        self.cvc: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        #: every delete received: (target, commit VC)
        self.dels: List[Tuple[Tuple[int, int], Tuple[int, ...]]] = []

    def fork(self) -> "RgaReplay":
        r = RgaReplay.__new__(RgaReplay)
        r.nxt, r.elem, r.cvc = dict(self.nxt), dict(self.elem), \
            dict(self.cvc)
        r.dels = list(self.dels)
        return r

    def insert(self, v, ref, elem: int, cvc) -> None:
        if ref not in self.nxt:
            raise KeyError(f"insert {v} names {ref}, not yet received")
        p, n = ref, self.nxt[ref]
        while n is not END and n > v:
            p, n = n, self.nxt[n]
        self.nxt[v] = n
        self.nxt[p] = v
        self.elem[v] = elem
        self.cvc[v] = cvc

    def delete(self, v, cvc) -> None:
        if v not in self.elem:
            raise KeyError(f"delete of {v}, not yet received")
        self.dels.append((v, cvc))

    def apply(self, rows: np.ndarray) -> None:
        """Apply a block of op rows in order."""
        for op in rows.tolist():
            cvc = list(op[SS:])
            cvc[op[DC]] = op[CT]
            v = (op[LAM], op[ACT])
            if op[KIND] == INSERT:
                self.insert(v, (op[RLAM], op[RACT]), op[ELEM], tuple(cvc))
            else:
                self.delete(v, tuple(cvc))

    def order(self) -> List[Tuple[int, int]]:
        """Every vertex in document order, tombstones included."""
        out, v = [], self.nxt[HEAD]
        while v is not END:
            out.append(v)
            v = self.nxt[v]
        return out

    def read(self, rv, size: int, order=None):
        """The document at snapshot ``rv``: (lam, act, elem, vis) int32 /
        bool arrays of ``size`` rows in document order, tombstones
        included, zero past the last present vertex, and the number
        present."""
        rv = np.asarray(rv, np.int64)
        order = self.order() if order is None else order
        kept = [v for v, k in zip(order, covered(
            [self.cvc[v] for v in order], rv)) if k]
        gone = {v for (v, _), k in zip(self.dels, covered(
            [d for _, d in self.dels], rv)) if k}
        n = len(kept)
        if n > size:
            raise ValueError(f"{n} vertices do not fit {size} rows")
        lam = np.zeros(size, np.int32)
        act = np.zeros(size, np.int32)
        elem = np.zeros(size, np.int32)
        vis = np.zeros(size, bool)
        if n:
            lam[:n] = [v[0] for v in kept]
            act[:n] = [v[1] for v in kept]
            elem[:n] = [self.elem[v] for v in kept]
            vis[:n] = [v not in gone for v in kept]
        return lam, act, elem, vis, n


def as_tensors(out, device):
    """A read's arrays as tensors on ``device`` (n a 0-d int32)."""
    import torch

    lam, act, elem, vis, n = out
    return tuple(torch.from_numpy(a).to(device) for a in (lam, act, elem,
                                                          vis)) + (
        torch.tensor(n, dtype=torch.int32, device=device),)
