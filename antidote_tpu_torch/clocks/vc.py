"""Host-side vector clocks for the control plane.

The transaction coordinator, inter-DC manager and metadata plane handle a
handful of clocks at a time (latency-bound, not throughput-bound), so they
use a plain dict-backed clock mirroring the reference's external
``vectorclock`` dep (DCID -> timestamp, missing = 0; call sites e.g.
reference src/clocksi_interactive_coord.erl:689-691).  The batched data
plane uses the dense kernels in :mod:`antidote_tpu.clocks.dense`;
:class:`ClockDomain` converts between the two representations.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, Mapping

import numpy as np

DcId = Hashable


class VC(dict):
    """A vector clock: mapping DCID -> int timestamp, missing entries are 0."""

    def get_dc(self, dc: DcId) -> int:
        return self.get(dc, 0)

    def set_dc(self, dc: DcId, t: int) -> "VC":
        out = VC(self)
        out[dc] = int(t)
        return out

    def le(self, other: Mapping[DcId, int]) -> bool:
        return all(v <= other.get(dc, 0) for dc, v in self.items())

    def ge(self, other: Mapping[DcId, int]) -> bool:
        return all(self.get(dc, 0) >= v for dc, v in other.items())

    def lt(self, other: Mapping[DcId, int]) -> bool:
        return self.le(other) and self != other

    def gt(self, other: Mapping[DcId, int]) -> bool:
        return self.ge(other) and self != other

    def concurrent(self, other: Mapping[DcId, int]) -> bool:
        return not self.le(other) and not self.ge(other)

    def all_dots_greater(self, other: Mapping[DcId, int]) -> bool:
        keys = set(self) | set(other.keys())
        return all(self.get(dc, 0) > other.get(dc, 0) for dc in keys)

    def all_dots_smaller(self, other: Mapping[DcId, int]) -> bool:
        keys = set(self) | set(other.keys())
        return all(self.get(dc, 0) < other.get(dc, 0) for dc in keys)

    def join(self, other: Mapping[DcId, int]) -> "VC":
        """Elementwise max."""
        out = VC(self)
        for dc, v in other.items():
            if v > out.get(dc, 0):
                out[dc] = v
        return out

    def meet(self, other: Mapping[DcId, int]) -> "VC":
        """Elementwise min (entries missing on either side -> 0 -> dropped)."""
        keys = set(self) | set(other.keys())
        return VC.clean(
            {dc: min(self.get(dc, 0), other.get(dc, 0)) for dc in keys}
        )

    def __eq__(self, other) -> bool:  # zero entries are not distinguishing
        if not isinstance(other, Mapping):
            return NotImplemented
        keys = set(self) | set(other.keys())
        return all(self.get(dc, 0) == other.get(dc, 0) for dc in keys)

    def __ne__(self, other) -> bool:
        res = self.__eq__(other)
        return res if res is NotImplemented else not res

    __hash__ = None  # mutable

    @staticmethod
    def clean(m: Mapping[DcId, int]) -> "VC":
        """Drop explicit zero entries (canonical form)."""
        return VC({dc: int(v) for dc, v in m.items() if v != 0})

    @staticmethod
    def from_list(pairs: Iterable[tuple]) -> "VC":
        return VC.clean(dict(pairs))


def vc_min(clocks: Iterable[Mapping[DcId, int]]) -> VC:
    """Column-wise min over a collection of clocks; empty -> bottom.

    Matches the GST merge: a DC missing from any clock pins that column to 0
    (reference src/stable_time_functions.erl:51-85).
    """
    clocks = list(clocks)
    if not clocks:
        return VC()
    out = VC.clean(clocks[0])
    for c in clocks[1:]:
        out = out.meet(c)
    return out


def vc_max(clocks: Iterable[Mapping[DcId, int]]) -> VC:
    out = VC()
    for c in clocks:
        out = out.join(c)
    return out


class ClockDomain:
    """Assigns each DCID a dense column index and converts VC <-> dense rows.

    The dense capacity ``d`` is fixed per domain instance (XLA wants static
    shapes); `grow()` returns a wider copy when more DCs join than capacity
    allows — callers re-pad device state on growth.
    """

    def __init__(self, d: int = 8):
        self.d = int(d)
        self._index: Dict[DcId, int] = {}
        self._ids: list = []

    @property
    def dc_ids(self) -> list:
        return list(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def index_of(self, dc: DcId) -> int:
        """Dense column of ``dc``, registering it on first sight."""
        if dc not in self._index:
            if len(self._ids) >= self.d:
                raise ValueError(
                    f"clock domain capacity {self.d} exhausted; grow() first"
                )
            self._index[dc] = len(self._ids)
            self._ids.append(dc)
        return self._index[dc]

    def contains(self, dc: DcId) -> bool:
        return dc in self._index

    def grow(self, new_d: int) -> "ClockDomain":
        if new_d < self.d:
            raise ValueError("cannot shrink a clock domain")
        out = ClockDomain(new_d)
        out._index = dict(self._index)
        out._ids = list(self._ids)
        return out

    def to_dense(self, vc: Mapping[DcId, int]) -> np.ndarray:
        # Pre-check capacity for all unseen DCs so a clock that overflows
        # the domain raises without partially mutating the index.
        unseen = [dc for dc, t in vc.items() if t and dc not in self._index]
        if len(self._ids) + len(unseen) > self.d:
            raise ValueError(
                f"clock domain capacity {self.d} exhausted; grow() first"
            )
        row = np.zeros((self.d,), dtype=np.int64)
        for dc, t in vc.items():
            if t:
                row[self.index_of(dc)] = t
        return row

    def from_dense(self, row) -> VC:
        row = np.asarray(row)
        return VC.clean({self._ids[i]: int(row[i]) for i in range(len(self._ids))})
