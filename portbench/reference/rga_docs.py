"""The plain reference of the RGA partition cell: each document of the
partition replayed on its own by ``portbench/reference/rga.py``'s
``RgaReplay`` (Roh et al.'s RGA, a linked list in plain Python).

Documents are independent: an op touches one document, and a read at a
snapshot VC keeps, of one document, exactly the ops whose commit VC the
snapshot covers.  So the partition is a dict of replays, and a block of
the partition's ops, each row tagged with its document, is applied row
by row to the replay of its document, in the block's order.

Nothing of the port is imported or used.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from portbench.reference.rga import RgaReplay


class DocsReplay:
    """The partition's documents, by index, each an ``RgaReplay``."""

    def __init__(self, docs: Iterable[int] = ()):
        self.docs: Dict[int, RgaReplay] = {d: RgaReplay() for d in docs}

    def fork(self) -> "DocsReplay":
        r = DocsReplay()
        r.docs = {d: rep.fork() for d, rep in self.docs.items()}
        return r

    def apply(self, rows: np.ndarray, doc: np.ndarray) -> None:
        """Apply the op rows (``doc[i]`` the document of row i) to the
        documents held, in order; rows of other documents are left
        out."""
        for d, rep in self.docs.items():
            mine = doc == d
            if mine.any():
                rep.apply(rows[mine])

    def read(self, d: int, rv, size: int):
        """Document ``d`` at snapshot ``rv``: ``RgaReplay.read``'s
        (lam, act, elem, vis, n)."""
        return self.docs[d].read(rv, size)
