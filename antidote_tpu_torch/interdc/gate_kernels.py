"""The dependency gate's device ring in PyTorch (port of
antidote_tpu/interdc/gate_kernels.py), and its fixpoint kernel.

Ring layout (``cap`` rows; ``d_pad`` dense clock columns):

- ``ss``     int64[cap, d_pad]  snapshot VC of each queued txn
- ``origin`` int32[cap]         dense column of the txn's origin DC
- ``pos``    int32[cap]         per-origin FIFO position (monotone)
- ``ts``     int64[cap]         commit timestamp (pings carry ts-1,
                                the exclusive-advance hardening —
                                interdc/dep.py module doc)
- ``ping``   bool[cap]
- ``live``   bool[cap]          slot holds a still-queued txn; dead
                                and never-used slots are inert in
                                every program

Every buffer has one spare row past ``cap`` (row ``cap``): a write the
JAX package's ``mode="drop"`` scatter discards (padding rows carry
``slots == cap``) lands there, so no scatter filters its rows, which
would wait for the card.  The spare row is never read: :func:`ring_rows`
gives the ``cap`` rows the fixpoint sees.  JAX donates the six buffers
to ``ring_append`` and ``ring_retire``; here they update the buffers in
place.

:func:`ring_fixpoint` replaces the JAX ``lax.while_loop`` (``:98``; and
``dep.gate_fixpoint``, ``dep.py:968``, the same cascade with every row
live) with one launch of the hand-written CUDA kernel in
``csrc/gate_kernels.cu``: eager PyTorch cannot loop on the device, and
its plain version, :func:`ring_fixpoint_plain`, waits for the card once
a round to read the loop's condition.  The kernel's bound is one read of
its inputs and one write of its outputs (about 2.5 µs on an H100 at the
256-DC gate's 2,048 × 512 ring); its data-dependent rounds, each two
barriers and, for a row whose dependencies moved, a load's round trip,
keep it above that.  It runs as one thread-block cluster of up to 16
CTAs whose shape :func:`fixpoint_geometry` picks from ``n`` and ``d``
alone (a small ring is one CTA), with the per-origin tables in shared
memory and L2 or, for a clock too wide for shared memory, in a global
scratch: it takes any width (the source's header says how).  A CPU
tensor runs the plain version, and only a CPU tensor; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from antidote_tpu_torch import _cuda, upload
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.obs.prof import kernel_span

#: FIFO-position infinity: larger than any real queue position, small
#: enough that +1 arithmetic cannot overflow int32
BIG_POS = np.int32(np.iinfo(np.int32).max // 2)
#: the fixpoint's "no blocked row" minimum (BIG, not BIG_POS: a padding
#: row's BIG_POS position still blocks nothing real)
_BIG = int(np.iinfo(np.int32).max)

#: the fixpoint kernel's geometry (mirrored in csrc/gate_kernels.cu):
#: rows up to which one CTA runs alone, and its most threads; rows a CTA
#: of a cluster takes, and its threads; the largest cluster (non-
#: portable above 8); the dynamic shared memory a CTA may use (H100:
#: 227 KB); bytes ahead of the clock
ONE_CTA_ROWS = 256
ONE_CTA_THREADS = 512
CTA_ROWS = 128
CLUSTER_THREADS = 1024
MAX_CTAS = 16
SMEM_LIMIT = 232_448
_SMEM_HEADER = 16


class FixpointGeometry(NamedTuple):
    """One fixpoint launch's shape: ``ctas`` CTAs of ``threads`` (one
    cluster when more than one); ``tables`` "shared" (the replicated
    clock and the column-split blocked minima in the CTAs' shared
    memory, the advance maxima too on one CTA, in ``scratch`` int64
    words of global memory in a cluster) or "global" (every table in
    the scratch); ``smem`` dynamic shared bytes a CTA; ``row_scratch``
    int64 words of global scratch for the rows' state (0: it is in
    shared memory)."""
    ctas: int
    threads: int
    tables: str
    smem: int
    scratch: int
    row_scratch: int


@lru_cache(maxsize=256)
def fixpoint_geometry(n: int, d: int) -> FixpointGeometry:
    """The fixpoint kernel's launch for ``n`` rows and ``d`` clock
    columns, from the shapes alone (picking reads no data): one CTA up
    to ``ONE_CTA_ROWS`` rows, of a warp a row up to ``ONE_CTA_THREADS``;
    else a power-of-two cluster of about ``CTA_ROWS`` rows a CTA, at
    most ``MAX_CTAS``, each of ``CLUSTER_THREADS``.  A CTA holds the
    whole clock (8 bytes a column), both parities of its slice of the
    blocked minima (4 bytes a column each) and, on one CTA, both
    parities of the advance maxima (8 bytes each); a cluster keeps the
    advances in global scratch (2 d words).  Where a CTA's share
    exceeds ``SMEM_LIMIT``, every table goes to global scratch: each
    CTA's clock, then both parities of the advances and of the minima
    (int32, two to a word).  Each CTA's rows' state (76 bytes a row)
    follows in shared memory where it fits, else it is kept in 8 n
    words of global scratch."""
    ctas, threads = 1, min(ONE_CTA_THREADS, 32 * max(2, n))
    if n > ONE_CTA_ROWS:
        ctas = min(MAX_CTAS, 1 << (-(-n // CTA_ROWS) - 1).bit_length())
        threads = CLUSTER_THREADS
    cpc = -(-d // ctas) if d else 1
    adv = 16 * cpc if ctas == 1 else 0
    smem = _SMEM_HEADER + 8 * d + adv + 8 * cpc
    tables, scratch = "shared", 0 if ctas == 1 else 2 * d
    if smem > SMEM_LIMIT:
        smem, tables, scratch = _SMEM_HEADER, "global", ctas * d + 3 * d
    rows, row_scratch = 76 * -(-n // ctas), 8 * n
    if smem + rows <= SMEM_LIMIT:
        smem, row_scratch = smem + rows, 0
    return FixpointGeometry(ctas, threads, tables, smem, scratch, row_scratch)


def ring_alloc(cap: int, d_pad: int, device):
    """Fresh all-dead ring buffers (and their spare row), created on
    ``device`` as fills: a rebuild uploads nothing."""
    device = torch.device(device)
    return (torch.zeros((cap + 1, d_pad), dtype=torch.int64, device=device),
            torch.zeros((cap + 1,), dtype=torch.int32, device=device),
            torch.zeros((cap + 1,), dtype=torch.int32, device=device),
            torch.zeros((cap + 1,), dtype=torch.int64, device=device),
            torch.zeros((cap + 1,), dtype=torch.bool, device=device),
            torch.zeros((cap + 1,), dtype=torch.bool, device=device))


def ring_rows(ring):
    """The ``cap`` rows of each buffer (views; the spare row dropped)."""
    return tuple(t[:-1] for t in ring)


def ring_load(arrays, device):
    """A ring holding six host arrays of ``cap`` rows (ss, origin, pos,
    ts, ping, live): each is copied into its buffer's first ``cap`` rows,
    through pinned memory and without blocking on the card."""
    ss = arrays[0]
    ring = ring_alloc(ss.shape[0], ss.shape[1], device)
    for buf, a in zip(ring_rows(ring), arrays):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if buf.is_cuda:
            t = t.pin_memory()
        buf.copy_(t, non_blocking=True)
    return ring


def ring_from_numpy(arrays, device):
    """(ring, pvc) from seven host arrays: the JAX ring's six buffers
    (``np.asarray`` of each) and the partition clock, so that a test
    feeds both packages one state."""
    *six, pvc = arrays
    device = torch.device(device)
    return ring_load(six, device), upload(np.asarray(pvc), device)


def _slots(slots: torch.Tensor, cap: int) -> torch.Tensor:
    """int64 slots, every one outside [0, cap) sent to the spare row."""
    return torch.where((slots >= 0) & (slots < cap), slots, cap).long()


@kernel_span("interdc.dep")
def ring_append(ss, origin, pos, ts, ping, live,
                slots, u_ss, u_origin, u_pos, u_ts, u_ping):
    """Scatter a padded batch of arrivals into ring ``slots``, in place.
    Padding rows carry ``slots == cap`` and land in the spare row.
    Returns the six buffers."""
    s = _slots(slots, live.shape[0] - 1)
    ss.index_copy_(0, s, u_ss)
    origin.index_copy_(0, s, u_origin)
    pos.index_copy_(0, s, u_pos)
    ts.index_copy_(0, s, u_ts)
    ping.index_copy_(0, s, u_ping)
    live.index_fill_(0, s, True)
    return ss, origin, pos, ts, ping, live


@kernel_span("interdc.dep")
def ring_retire(live, slots):
    """Mark ``slots`` dead, in place (txns popped outside the ring
    replay: the host walk ran in between, or a wave aborted on
    PartitionRetired).  Padding slots carry ``cap``; returns ``live``."""
    return live.index_fill_(0, _slots(slots, live.shape[0] - 1), False)


@kernel_span("interdc.dep")
def ring_gather(ss, origin, pos, ts, ping, idx, n_live: int, new_d: int):
    """Re-layout the ring through a device-side gather into new buffers:
    grow capacity (``idx`` longer than the ring), shrink it (lazy
    compaction), or widen the clock domain (``new_d`` > current width;
    new columns read 0 = the dense missing-entry semantics).  ``idx[i]``
    is the OLD slot written to new slot i; rows at or past ``n_live``
    come out dead.  No H2D beyond the index vector itself."""
    cap = idx.shape[0]
    # the new spare row gathers old row 0; it is dead and never read
    full = torch.cat([idx.long(), idx.new_zeros(1, dtype=torch.long)])
    out = torch.zeros((cap + 1, max(new_d, ss.shape[1])), dtype=ss.dtype,
                      device=ss.device)
    out[:, :ss.shape[1]] = ss.index_select(0, full)
    live = torch.arange(cap + 1, dtype=torch.int32, device=ss.device) \
        < n_live
    return (out, origin.index_select(0, full), pos.index_select(0, full),
            ts.index_select(0, full), ping.index_select(0, full), live)


def ring_fixpoint_plain(ss, origin, pos, ts, ping, live, pvc):
    """:func:`ring_fixpoint` as plain tensor programs, the JAX loop's
    rounds driven from the host (one wait a round)."""
    n, d = ss.shape[0], pvc.shape[0]
    live_in = live
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=ss.device)
    # rows whose origin column does not exist are inert (the kernel's
    # rule; the gate's column map never makes one)
    live = live & (origin >= 0) & (origin < d)
    o = origin.long().clamp(0, d - 1)
    deps = dense.set_dc(ss, origin, 0)

    def round_(pvc):
        ready = live & (ping | dense.ge(pvc, deps))
        # dead rows neither block (pos -> +inf) nor advance anything
        notready_pos = torch.where(ready | ~live, _BIG, pos)
        blocked_min = torch.full((d,), _BIG, dtype=torch.int32,
                                 device=ss.device).scatter_reduce(
            0, o, notready_pos, "amin")
        bound = blocked_min[o]
        applied = ready & (pos < bound)
        zeros = torch.zeros((d,), dtype=ts.dtype, device=ss.device)
        wm = zeros.scatter_reduce(0, o, torch.where(applied, ts, 0), "amax")
        # blocked-head rule (reference src/inter_dc_dep_vnode.erl:
        # 137-143): a live head that cannot apply still advances its
        # origin's clock to ts-1
        head_blocked = live & ~ready & (pos == bound)
        hb = zeros.scatter_reduce(0, o, torch.where(head_blocked, ts - 1, 0),
                                  "amax")
        return applied, torch.maximum(pvc, torch.maximum(wm, hb))

    def note_round(rounds, applied, r):
        return torch.where(applied & (rounds < 0), r, rounds)

    rounds = torch.full((n,), -1, dtype=torch.int32, device=ss.device)
    r = 0
    while True:
        applied, new_pvc = round_(pvc)
        rounds = note_round(rounds, applied, r)
        r += 1
        changed = bool((new_pvc != pvc).any())
        pvc = new_pvc
        if not changed:
            break
    # the loop exits after a round that did not advance pvc; evaluate
    # once more at the stable clock (no-progress-first-round case)
    applied, _ = round_(pvc)
    rounds = note_round(rounds, applied, r)
    new_live = None if live_in is None else live_in & ~applied
    return (applied, rounds, pvc, new_live,
            torch.sum(applied, dtype=torch.int32))


def _check(ss, origin, pos, ts, ping, live, pvc):
    n = ss.shape[0]
    want = [(ss, torch.int64, (n, pvc.shape[0])), (origin, torch.int32, (n,)),
            (pos, torch.int32, (n,)), (ts, torch.int64, (n,)),
            (ping, torch.bool, (n,)), (pvc, torch.int64, (pvc.shape[0],))]
    if live is not None:
        want.append((live, torch.bool, (n,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"ring_fixpoint takes {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != ss.device:
            raise ValueError(f"ring tensors on {ss.device} and {t.device}")


@kernel_span("interdc.dep")
def ring_fixpoint(ss, origin, pos, ts, ping, live, pvc):
    """Iterate-until-stable over the LIVE ring rows — the same monotone
    cascade as :func:`antidote_tpu_torch.interdc.dep.gate_fixpoint`
    (dominance test with the origin column zeroed, per-origin FIFO
    prefix, watermark + blocked-head ts-1 advance, reference
    src/inter_dc_dep_vnode.erl:96-154) with dead/unused slots gated out
    by ``live`` (None: every row live).

    Returns ``(applied bool[cap], round int32[cap], final pvc int64[D],
    new_live bool[cap] (None without ``live``), applied_count int32)``.
    On the card, one kernel launch: no round waits for the host."""
    _check(ss, origin, pos, ts, ping, live, pvc)
    if ss.device.type == "cpu":
        return ring_fixpoint_plain(ss, origin, pos, ts, ping, live, pvc)
    if ss.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {ss.device}")
    n, d = ss.shape[0], pvc.shape[0]
    args = (ss, origin, pos, ts, ping, pvc) + (() if live is None
                                                else (live,))
    if not all(t.is_contiguous() for t in args):
        raise ValueError("ring_fixpoint's kernel takes contiguous tensors")
    dev = ss.device
    applied = torch.empty((n,), dtype=torch.bool, device=dev)
    rounds = torch.empty((n,), dtype=torch.int32, device=dev)
    pvc_out = torch.empty((d,), dtype=torch.int64, device=dev)
    new_live = None if live is None else torch.empty_like(applied)
    count = torch.empty((), dtype=torch.int32, device=dev)
    geo = fixpoint_geometry(n, d)
    rows, tables = (torch.empty((k,), dtype=torch.int64, device=dev)
                    if k else None for k in (geo.row_scratch, geo.scratch))
    ptr = (lambda t: None if t is None else t.data_ptr())
    _cuda.call("antidote_gate_fixpoint", ss.data_ptr(), origin.data_ptr(),
               pos.data_ptr(), ts.data_ptr(), ping.data_ptr(), ptr(live),
               pvc.data_ptr(), n, d, applied.data_ptr(), rounds.data_ptr(),
               pvc_out.data_ptr(), ptr(new_live), count.data_ptr(),
               ptr(rows), ptr(tables), geo.ctas, geo.threads,
               int(geo.tables == "global"), geo.smem,
               torch.cuda.current_stream(dev).cuda_stream)
    ring_fixpoint.launches += 1
    ring_fixpoint.shapes[n, d] += 1
    return applied, rounds, pvc_out, new_live, count


#: launches of the kernel, in all and by (n, d)
ring_fixpoint.launches = 0
ring_fixpoint.shapes = Counter()
