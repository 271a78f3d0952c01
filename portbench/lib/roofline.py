"""Peaks of the card and the work of the port's kernels, from shapes and
the run's own stream.

The bytes are what each operation needs for the inputs it is given:
computed from the shard's shape (keys K, lanes L, elements E, clock
entries D, the integer width w in bytes) and from what the stream has
put in the ring (the live ops, and the keys they name), and never from
the tensors the port allocates.  So a later layout, or a kernel that
reads only the live lanes, is held to the same work.  Each input byte is
read once and each output byte written once.

An OR-Set op row holds 6 scalars and two D-entry clocks (its observed
vector and its snapshot); the dot table holds E x D entries a key; the
lane bitmap and the presence are one byte an entry.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (NVIDIA's data sheet), HBM3 bandwidth in bytes/s
HBM_BYTES_PER_S = 3.35e12

OP_SCALARS = 6


def op_row_bytes(D: int, w: int) -> int:
    return (OP_SCALARS + 2 * D) * w


def orset_read_bytes(K: int, L: int, E: int, D: int, w: int,
                     live_ops: int) -> int:
    """A read of every key at a clock, with ``live_ops`` ops in the
    ring: the dot table, the lane bitmap (which lanes hold an op), the
    live ops' rows, the base clock, its flag and the read clock in; the
    presence (one byte a key and element) out."""
    return (K * E * D * w + K * L + live_ops * op_row_bytes(D, w)
            + 2 * D * w + 1 + K * E)


def orset_gc_bytes(K: int, L: int, E: int, D: int, w: int, live_ops: int,
                   keys: int) -> int:
    """A fold at a stable clock of the ``live_ops`` ops in the ring,
    which name ``keys`` distinct keys: the lane bitmap, the live ops'
    rows, those keys' dot rows and the clock in; those keys' dot rows
    and lanes out."""
    return (K * L + live_ops * op_row_bytes(D, w) + D * w
            + keys * (2 * E * D * w + L))


def bound_s(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` (both
    kernels lie far below the card's operations-to-bytes ratio)."""
    return nbytes / HBM_BYTES_PER_S
