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
256-DC gate's 2,048 × 512 ring); a single block running the data-
dependent rounds behind block-wide barriers sits far below it (the
source's header says what the design does about it).  A CPU tensor runs
the plain version, and only a CPU tensor; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from antidote_tpu_torch import _cuda
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat.device_plane import _upload

#: FIFO-position infinity: larger than any real queue position, small
#: enough that +1 arithmetic cannot overflow int32
BIG_POS = np.int32(np.iinfo(np.int32).max // 2)
#: the fixpoint's "no blocked row" minimum (BIG, not BIG_POS: a padding
#: row's BIG_POS position still blocks nothing real)
_BIG = int(np.iinfo(np.int32).max)
#: widest clock the kernel takes: its shared tables (20 bytes a column)
#: must fit a block's 227 KB
MAX_D = 8_192


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
    return ring_load(six, device), _upload(np.asarray(pvc), device)


def _slots(slots: torch.Tensor, cap: int) -> torch.Tensor:
    """int64 slots, every one outside [0, cap) sent to the spare row."""
    return torch.where((slots >= 0) & (slots < cap), slots, cap).long()


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


def ring_retire(live, slots):
    """Mark ``slots`` dead, in place (txns popped outside the ring
    replay: the host walk ran in between, or a wave aborted on
    PartitionRetired).  Padding slots carry ``cap``; returns ``live``."""
    return live.index_fill_(0, _slots(slots, live.shape[0] - 1), False)


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
    if d > MAX_D:
        raise ValueError(f"d = {d}: the kernel takes at most {MAX_D} "
                         f"clock columns")
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
    prog = torch.empty((n,), dtype=torch.int32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    _cuda.call("antidote_gate_fixpoint", ss.data_ptr(), origin.data_ptr(),
               pos.data_ptr(), ts.data_ptr(), ping.data_ptr(), ptr(live),
               pvc.data_ptr(), n, d, applied.data_ptr(), rounds.data_ptr(),
               pvc_out.data_ptr(), ptr(new_live), count.data_ptr(),
               prog.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    ring_fixpoint.launches += 1
    return applied, rounds, pvc_out, new_live, count


ring_fixpoint.launches = 0
