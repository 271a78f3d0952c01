"""Incremental RGA store (PyTorch port of antidote_tpu/mat/rga_store.py) —
steady-state collaborative editing on the device.

The one-shot merge (mat/rga_kernel.py) re-merges the whole op log per
call: O(history) per edit burst.  This store splits the document into

- a **base**: the stable prefix, materialized once into a frozen
  preorder (uid, parent-uid, element, live flag, subtree extent), and
- a **window**: the unstable op tail, kept as dense op lanes.

Reads merge only the window, then splice each window subtree into the
base by binary search and assemble the document with one O(doc) sort.
The splice is exact RGA order: a window vertex anchored at base vertex V
must sit among V's already-folded children in uid-descending order, so
the base keeps a child-search index sorted by ``(parent_uid, uid desc)``
and the splice position for a root with uid *u* is the preorder position
of V's first child with uid < u (else the end of V's subtree).

Folding (at a stability threshold, the GST analogue) runs the full merge
ONCE over base + newly-stable window ops — tombstones keep their rows
(they remain splice anchors) but drop their live flag — and rebuilds the
preorder/search arrays; the window compacts to its unstable suffix.

Stability gives the two invariants the split relies on: a stable
vertex's parent is stable (or base), so the stable set folds as whole
subtrees hanging off the base; and no stable op is still in flight, so
folded positions are final.

All shapes are static (PB base rows, NW window lanes, MD delete lanes);
capacity growth is a host-side repack.  Window and delete lanes carry
full commit vector clocks (origin column, commit time, snapshot VC
columns), so a read materializes exactly the snapshot's inclusion set —
``op in snapshot iff commit_vc(op) <= read_vc`` — and the fold horizon
is the dense GST.

Functions that take a state run on the state's device.  Those the JAX
version jits with a donated state (:func:`rga_append`,
:func:`rga_append_packed`, :func:`rga_fold`) may update the state's
tensors in place: the caller uses only the state they return.  The
appends never wait for the card (``ok`` stays a 0-d bool tensor;
:func:`rga_append_coalesced` uploads through pinned memory), and
neither do :func:`rga_read` and :func:`rga_fold`.
:func:`rga_append_padded` uploads each column on its own and
:func:`rga_fold_host` reads the counters to the host, as the JAX ones
do; it uploads its horizon through pinned memory.
:func:`rga_append_coalesced` counts its dispatch in
the INGEST_* metrics (``ingest.note_dispatch``).  The JAX functions'
``kernel_span`` profiling is ported: the device entry points carry
``obs/prof.py``'s ``@kernel_span("mat.rga")``, so in ``detail`` mode
each call of :func:`rga_append_packed`, :func:`rga_read` and
:func:`rga_fold` is timed on the card (a CUDA event pair) and kept as
a host span under its name; a call from inside another wrapped call
(``rga_append`` under ``rga_append_packed``) passes straight through.

The append's path: :func:`rga_append_coalesced` packs the block into
one int64 host array and uploads it once; :func:`rga_append_packed`
then writes it into the window and delete lanes.  On the card that is
one launch of the hand-written kernel ``gpu_kernels.rga_append_rows``
(``csrc/rga_kernels.cu``); on the CPU it is :func:`rga_append`, the
plain version: ~100 torch operations a block (:func:`_put_at` a
column), which :func:`rga_append_padded` takes on both devices and
the card tests hold the kernel to, bit for bit.  ``append_events``
counts the appends by path (``kernel``, ``plain``).

Where the JAX version jits :func:`rga_read` and :func:`rga_fold` each
into one XLA program, the port issues their operations (~400 a read,
~200 a fold) one by one on the CPU, and on the card replays each as one
CUDA graph (:class:`_Graph`): captured at a shape's first call, without
waiting for the card, then replayed.  Each call copies the state and
its clock (the snapshot, the horizon) into the graph's inputs and its
results out to fresh tensors, so states of any address share a graph
and a result outlives the next call: a folded state is the caller's
own.  A device keeps at most ``GRAPHS_PER_DEVICE`` read graphs and
``FOLD_GRAPHS_PER_DEVICE`` fold graphs, and drops one for a new shape
only once it has gone ``GRAPH_IDLE_READS`` reads (``GRAPH_IDLE_FOLDS``
folds) unused; until then a new shape runs the eager body on the card,
so shapes called in turn cannot make every call a capture
(:class:`_Graphs`).  ``read_graph_events`` and ``fold_graph_events``
count the captures, replays and eager calls on the card.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from antidote_tpu_torch import resolve_device, stats, upload
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import gpu_kernels, ingest, rga_kernel
from antidote_tpu_torch.mat.rga_kernel import (
    _I32MAX, _lexsort2, _shift_down, argsort, pack_uid, searchsorted,
    set_drop)
from antidote_tpu_torch.obs.prof import kernel_span

_I64MAX = 2**63 - 1


@dataclass
class RgaStoreState:
    """Tensors of one RGA document.

    Base rows sit in document preorder; ``bsort_*`` is the uid-sorted
    view for lookups and ``ckey/cpos`` the (parent, uid-desc) child
    index for splices.  ``actor_bits`` is the uid packing width."""

    # base, in preorder (padding rows: buid = INT32_MAX)
    buid: torch.Tensor       # int32[PB] packed uids
    bparent: torch.Tensor    # int32[PB] parent uid (0 = document head)
    belem: torch.Tensor      # int32[PB]
    blive: torch.Tensor      # bool[PB] (False = tombstone kept as anchor)
    bsub_end: torch.Tensor   # int32[PB] preorder index one past the subtree
    bn: torch.Tensor         # int32[] used rows
    # uid-sorted base view
    bsort_uid: torch.Tensor  # int32[PB]
    bsort_pos: torch.Tensor  # int32[PB] preorder index of that uid
    # child-search index, sorted by packed (parent_uid, uid desc)
    ckey: torch.Tensor       # int64[PB]
    cpos: torch.Tensor       # int32[PB]
    # window op lanes
    wlam: torch.Tensor       # int32[NW]
    wact: torch.Tensor       # int32[NW]
    wrlam: torch.Tensor      # int32[NW] left-neighbour ref (0 = head)
    wract: torch.Tensor      # int32[NW]
    welem: torch.Tensor      # int32[NW]
    wdc: torch.Tensor        # int32[NW] origin DC column
    wct: torch.Tensor        # int64[NW] commit time
    wss: torch.Tensor        # int64[NW, D] snapshot VC columns
    wn: torch.Tensor         # int32[]
    # pending delete lanes
    dlam: torch.Tensor       # int32[MD]
    dact: torch.Tensor       # int32[MD]
    ddc: torch.Tensor        # int32[MD]
    dct: torch.Tensor        # int64[MD]
    dss: torch.Tensor        # int64[MD, D]
    dn: torch.Tensor         # int32[]
    actor_bits: int

    @property
    def pb(self) -> int:
        return self.buid.shape[0]

    @property
    def nw(self) -> int:
        return self.wlam.shape[0]

    @property
    def md(self) -> int:
        return self.dlam.shape[0]

    @property
    def d(self) -> int:
        return self.wss.shape[1]


def rga_store_init(pb: int, nw: int, md: int, n_dcs: int = 1,
                   actor_bits: int = 8, device=None) -> RgaStoreState:
    """An empty document on ``device`` (None: the card, or raise)."""
    dev = resolve_device(device)

    def full(shape, fill=0, dtype=torch.int32):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    i64 = torch.int64
    return RgaStoreState(
        buid=full((pb,), _I32MAX), bparent=full((pb,)), belem=full((pb,)),
        blive=full((pb,), False, torch.bool), bsub_end=full((pb,)),
        bn=full(()),
        bsort_uid=full((pb,), _I32MAX), bsort_pos=full((pb,)),
        ckey=full((pb,), _I64MAX, i64), cpos=full((pb,)),
        wlam=full((nw,)), wact=full((nw,)), wrlam=full((nw,)),
        wract=full((nw,)), welem=full((nw,)),
        wdc=full((nw,)), wct=full((nw,), 0, i64),
        wss=full((nw, n_dcs), 0, i64), wn=full(()),
        dlam=full((md,)), dact=full((md,)),
        ddc=full((md,)), dct=full((md,), 0, i64),
        dss=full((md, n_dcs), 0, i64), dn=full(()),
        actor_bits=actor_bits,
    )


def _ckey_pack(parent_uid, uid):
    """int64 child-search key: (parent asc, uid desc)."""
    return ((parent_uid.to(torch.int64) << 32)
            | (_I32MAX - uid.to(torch.int64)))


def _put_at(dst, src, start, ok):
    """``dynamic_update_slice(dst, src, (where(ok, start, 0), 0))`` kept
    only where ``ok`` (0-d bool), in place: the whole (padded) ``src``
    block is written from row ``start``.  When ``ok`` is False every row
    the slice would touch is written back with what it holds, so nothing
    changes and nothing waits for the card."""
    b = src.shape[0]
    if b > dst.shape[0] or src.ndim != dst.ndim:
        raise ValueError(f"a block of {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    lane = torch.arange(b, device=dst.device)
    rows = torch.where(ok, start.long() + lane, lane)
    at = (rows,) + tuple(slice(0, k) for k in src.shape[1:])
    dst[at] = torch.where(ok, src.to(dst.dtype), dst[at])
    return dst


#: the store's appends by path
append_events = stats.Counter(
    "antidote_rga_append_total",
    "RGA store appends by path: kernel (rga_append_packed on the card, "
    "one launch of gpu_kernels.rga_append_rows) or plain (rga_append's "
    "torch operations: the CPU, and rga_append_padded on any device)",
    labels=("path",))


@kernel_span("mat.rga")
def rga_append(st: RgaStoreState, ins_lamport, ins_actor, ref_lamport,
               ref_actor, elem, ins_dc, ins_ct, ins_ss,
               del_lamport, del_actor, del_dc, del_ct, del_ss,
               n_ins=None, n_del=None):
    """Append one op block (B insert lanes + C delete lanes, tensors on
    the state's device) into the window, in place, each lane carrying its
    full commit VC (origin column, commit time, snapshot columns).
    Returns (state, ok) — ok (a 0-d bool tensor) False means the window
    or delete lanes are full and nothing changed: the caller folds (or
    grows) and retries.

    ``n_ins``/``n_del`` are the LOGICAL lane counts when the arrays
    are padded to a dispatch bucket (rga_append_padded): the padded
    tail is written into the invalid region beyond wn/dn — masked by
    every fold/read and overwritten by the next append — while the
    counters advance by the logical counts only."""
    append_events.inc(path="plain")
    b = ins_lamport.shape[0]
    c = del_lamport.shape[0]
    nb = b if n_ins is None else n_ins
    nc = c if n_del is None else n_del
    # physical room for the PADDED block (a partial write would corrupt
    # valid lanes) — refuse conservatively, the caller folds/grows
    ok = (st.wn + b <= st.nw) & (st.dn + c <= st.md)
    for dst, src in ((st.wlam, ins_lamport), (st.wact, ins_actor),
                     (st.wrlam, ref_lamport), (st.wract, ref_actor),
                     (st.welem, elem), (st.wdc, ins_dc), (st.wct, ins_ct),
                     (st.wss, ins_ss)):
        _put_at(dst, src, st.wn, ok)
    for dst, src in ((st.dlam, del_lamport), (st.dact, del_actor),
                     (st.ddc, del_dc), (st.dct, del_ct), (st.dss, del_ss)):
        _put_at(dst, src, st.dn, ok)
    return replace(
        st,
        wn=torch.where(ok, st.wn + nb, st.wn),
        dn=torch.where(ok, st.dn + nc, st.dn),
    ), ok


def _append_bucket(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def rga_append_padded(st: RgaStoreState, ins_cols, del_cols,
                      floor: int = 64):
    """:func:`rga_append` with both lane blocks padded to power-of-two
    buckets and the logical counts passed through, from host arrays:
    ``ins_cols``/``del_cols`` are the positional argument tuples of
    rga_append, each column uploaded on its own."""
    b = int(np.asarray(ins_cols[0]).shape[0])
    c = int(np.asarray(del_cols[0]).shape[0])
    bp, cp = _append_bucket(b, floor), _append_bucket(c, floor)
    dev = st.wn.device

    def pad(a, n):
        a = np.asarray(a)
        w = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return torch.from_numpy(np.pad(a, w)).to(dev)

    return rga_append(
        st, *(pad(a, bp) for a in ins_cols),
        *(pad(a, cp) for a in del_cols), n_ins=b, n_del=c)


#: packed-append column layout (shared by insert AND delete rows so
#: one [bp+cp, 7+D] tensor carries both sections): [lam, act, rlam,
#: ract, elem, dc, ct, ss(D)] — delete rows use the same lam/act/dc/
#: ct/ss positions and leave rlam/ract/elem zero
_PK_LAM, _PK_ACT, _PK_RLAM, _PK_RACT, _PK_ELEM, _PK_DC, _PK_CT, \
    _PK_NSCAL = 0, 1, 2, 3, 4, 5, 6, 7


@kernel_span("mat.rga")
def rga_append_packed(st: RgaStoreState, packed, bp: int, n_ins, n_del):
    """:func:`rga_append` fed from ONE packed int64 tensor on the state's
    device: rows ``[:bp]`` are the (padded) insert lanes, rows ``[bp:]``
    the delete lanes, columns per ``_PK_*``.  In place; never waits for
    the card.  On the card one launch of
    ``gpu_kernels.rga_append_rows``, on the CPU :func:`rga_append`: the
    same state and ``ok``, bit for bit."""
    if st.wn.device.type == "cuda":
        ok, wn, dn = gpu_kernels.rga_append_rows(
            packed, (st.wlam, st.wact, st.wrlam, st.wract, st.welem,
                     st.wdc, st.wct, st.wss),
            (st.dlam, st.dact, st.ddc, st.dct, st.dss), st.wn, st.dn,
            bp, n_ins, n_del)
        append_events.inc(path="kernel")
        return replace(st, wn=wn, dn=dn), ok
    d = st.d
    ins = packed[:bp]
    dl = packed[bp:]
    ss = slice(_PK_NSCAL, _PK_NSCAL + d)
    return rga_append(
        st,
        ins[:, _PK_LAM], ins[:, _PK_ACT], ins[:, _PK_RLAM],
        ins[:, _PK_RACT], ins[:, _PK_ELEM], ins[:, _PK_DC],
        ins[:, _PK_CT], ins[:, ss],
        dl[:, _PK_LAM], dl[:, _PK_ACT], dl[:, _PK_DC], dl[:, _PK_CT],
        dl[:, ss], n_ins=n_ins, n_del=n_del)


def rga_append_coalesced(st: RgaStoreState, ins_cols, del_cols,
                         floor: int = 64):
    """:func:`rga_append_padded`'s bucketing with one upload: both lane
    blocks pack into ONE int64 ``[bp+cp, 7+D]`` host array and ONE
    host-to-device copy (vs 13 per-column uploads), then
    :func:`rga_append_packed`, counted in the INGEST_* metrics.  Same
    argument tuples and return as rga_append_padded; never waits for the
    card."""
    b = int(np.asarray(ins_cols[0]).shape[0])
    c = int(np.asarray(del_cols[0]).shape[0])
    bp, cp = _append_bucket(b, floor), _append_bucket(c, floor)
    packed = np.zeros((bp + cp, _PK_NSCAL + st.d), dtype=np.int64)
    for j, a in enumerate(ins_cols[:_PK_NSCAL]):
        packed[:b, j] = np.asarray(a)
    packed[:b, _PK_NSCAL:] = np.asarray(ins_cols[_PK_NSCAL])
    dl = packed[bp:]
    for j, a in zip((_PK_LAM, _PK_ACT, _PK_DC, _PK_CT), del_cols[:4]):
        dl[:c, j] = np.asarray(a)
    dl[:c, _PK_NSCAL:] = np.asarray(del_cols[4])
    st, ok = rga_append_packed(st, upload(packed, st.wn.device), bp, b, c)
    ingest.note_dispatch(b + c, packed.nbytes)
    return st, ok


def _included(ss, dc, ct, rv):
    """bool[N]: commit_vc(op) <= rv columnwise (the materializer
    inclusion rule over dense lanes)."""
    cvc = dense.commit_vc(ss, dc, ct)
    return torch.all(cvc <= rv[None, :].to(torch.int64), dim=1)


def _bsearch_hit(sorted_arr, q):
    """(hit bool[...], int64 index) of q in a sorted int array."""
    n = sorted_arr.shape[0]
    p = searchsorted(sorted_arr, q)
    c = torch.clamp(p, 0, n - 1).long()
    return (p < n) & (sorted_arr[c] == q), c


@kernel_span("mat.rga")
def rga_read(st: RgaStoreState, read_vc):
    """Materialize the full RGA state at dense snapshot ``read_vc``
    (int64[D]): merge the snapshot-included window forest and splice it
    into the base preorder.  Returns ``(lam, act, elem, vis, n)`` —
    int32[PB+NW] arrays in document order INCLUDING tombstones (vis
    False), n = number of present vertices — i.e. exactly the host
    oracle's state tuple (crdt/rga.py).  Requires read_vc >= the fold
    horizon (every base row is in-snapshot by construction).

    On the card the read replays its shape's CUDA graph (the results
    are the caller's own tensors), or runs :func:`_read_eager` there
    while the device's graphs are all in use (:class:`_Graphs`); on the
    CPU it runs :func:`_read_eager`."""
    if st.wn.device.type == "cuda":
        return _READ_GRAPHS.call(st, read_vc)
    return _read_eager(st, read_vc)


def _read_eager(st: RgaStoreState, read_vc):
    """:func:`rga_read`'s body, one torch operation at a time: the CPU
    path, and what :class:`_Graph` captures."""
    nw, pb = st.nw, st.pb
    bits = st.actor_bits
    dev = st.wn.device
    lanes = torch.arange(nw, dtype=torch.int32, device=dev)
    winc = _included(st.wss, st.wdc, st.wct, read_vc)
    in_window = (lanes < st.wn) & winc

    wuid = pack_uid(st.wlam, st.wact, bits)
    # park invalid lanes, duplicates of base rows, and in-window dups
    in_base = _bsearch_hit(st.bsort_uid, wuid)[0]
    wuid = torch.where(in_window & ~in_base, wuid, _I32MAX)
    by_uid = argsort(wuid)
    sorted_uid = wuid[by_uid]
    dup = torch.empty((nw,), dtype=torch.bool, device=dev)
    dup[by_uid] = ~_shift_down(sorted_uid)
    wuid = torch.where(dup, _I32MAX, wuid)
    valid = wuid != _I32MAX

    ref = pack_uid(st.wrlam, st.wract, bits)
    # parent resolution: window first, then base anchor, else parked
    wpos = searchsorted(sorted_uid, ref)
    wcp = torch.clamp(wpos, 0, nw - 1).long()
    whit = (wpos < nw) & (sorted_uid[wcp] == ref) & ~dup[by_uid[wcp]]
    parent_w = by_uid[wcp]
    bhit, bidx = _bsearch_hit(st.bsort_uid, ref)
    is_root = valid & ~whit & (bhit | (ref == 0))
    parked_v = valid & ~whit & ~is_root
    valid = valid & ~parked_v  # unresolvable: excluded with subtree

    parked = nw  # sentinel vertex
    # segment key: real parent / unique per root / parked bucket
    parent_key = torch.where(
        whit & valid, parent_w,
        torch.where(is_root, nw + 1 + lanes, parked))

    rank, reachable, root_of, _fin = _window_tour(
        parent_key, wuid, valid, is_root, nw)

    # splice position for each root (gathered for every vertex via
    # root_of): first base child of the anchor with uid < root uid,
    # else the end of the anchor's subtree (head anchors end at bn)
    q = _ckey_pack(ref, wuid)
    ci = searchsorted(st.ckey, q)
    cic = torch.clamp(ci, 0, pb - 1).long()
    chit = (ci < pb) & ((st.ckey[cic] >> 32) == ref.to(torch.int64))
    anchor_pos = st.bsort_pos[bidx]
    sub_end = torch.where(
        ref == 0, st.bn,
        st.bsub_end[torch.clamp(anchor_pos, 0, pb - 1).long()])
    splice = torch.where(chit, st.cpos[cic], sub_end)     # [NW] (roots)

    # pending deletes: hide window and base targets (snapshot-included
    # deletes only — a tombstone newer than the read snapshot must not
    # hide its target yet)
    duid = pack_uid(st.dlam, st.dact, bits)
    dvalid = (torch.arange(st.md, dtype=torch.int32, device=dev) < st.dn) \
        & _included(st.dss, st.ddc, st.dct, read_vc)
    dwp = searchsorted(sorted_uid, duid)
    dwc = torch.clamp(dwp, 0, nw - 1).long()
    dwhit = dvalid & (dwp < nw) & (sorted_uid[dwc] == duid)
    deleted_w = set_drop(nw, False, torch.bool,
                         torch.where(dwhit, by_uid[dwc], nw), True)
    dbhit, dbidx = _bsearch_hit(st.bsort_uid, duid)
    hidden_b = set_drop(pb, False, torch.bool,
                        torch.where(dvalid & dbhit, st.bsort_pos[dbidx], pb),
                        True)

    bpos_arr = torch.arange(pb, dtype=torch.int32, device=dev)
    # presence = in the RGA state (tombstones included, as the host
    # oracle keeps them); visibility = live and not hidden at snapshot
    present_b = bpos_arr < st.bn
    present_w = reachable
    visible_w = present_w & ~deleted_w
    visible_b = st.blive & present_b & ~hidden_b

    # final order: (splice_pos, tier, uid desc among roots, tour rank)
    i64 = torch.int64
    rshift = max(1, (2 * (nw + 1)).bit_length())
    ruid = wuid[root_of]
    w_primary = splice[root_of].to(i64) << 1
    b_primary = (bpos_arr.to(i64) << 1) | 1
    w_secondary = ((_I32MAX - ruid.to(i64)) << rshift) | rank.to(i64)
    primary = torch.cat([
        torch.where(present_b, b_primary, _I64MAX),
        torch.where(present_w, w_primary, _I64MAX)])
    secondary = torch.cat(
        [torch.zeros((pb,), dtype=i64, device=dev), w_secondary])
    perm = _lexsort2(primary, secondary)
    mask32 = (1 << bits) - 1
    lam_all = torch.cat(
        [(st.buid >> bits) & (_I32MAX >> bits), st.wlam])
    act_all = torch.cat([st.buid & mask32, st.wact])
    elems = torch.cat([st.belem, st.welem])
    present = torch.cat([present_b, present_w])[perm]
    vis = torch.cat([visible_b, visible_w])[perm] & present
    lam = torch.where(present, lam_all[perm], 0)
    act = torch.where(present, act_all[perm], 0)
    elem_out = torch.where(present, elems[perm], 0)
    n = torch.sum(present, dtype=torch.int32)
    return lam, act, elem_out, vis, n


#: the state's tensor fields, in declaration order
_STATE_FIELDS = tuple(f.name for f in fields(RgaStoreState)
                      if f.name != "actor_bits")
#: the state fields :func:`_read_eager` reads (``bparent`` it does not)
_READ_FIELDS = ("buid", "belem", "blive", "bsub_end", "bn", "bsort_uid",
                "bsort_pos", "ckey", "cpos", "wlam", "wact", "wrlam",
                "wract", "welem", "wdc", "wct", "wss", "wn", "dlam", "dact",
                "ddc", "dct", "dss", "dn")


def _copy_grouped(dst, src) -> None:
    """``d.copy_(s)`` for each pair, one ``_foreach_copy_`` a pair of
    dtypes: a launch or two on the card in place of one a tensor."""
    groups = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


#: the captured reads a device keeps at most
GRAPHS_PER_DEVICE = 4
#: the reads on the card that a captured read must go unused before a
#: new shape may take its place.  A capture costs about 20 eager reads
#: (98-117 ms against ~5 ms at 2**18 base rows), so however shapes
#: follow one another, a device spends at most ``GRAPHS_PER_DEVICE``
#: captures in this many reads
GRAPH_IDLE_READS = 512
#: the captured folds a device keeps at most: room for a partition
#: whose documents fold in seven shapes (seven tiers of length) and
#: remap their actors in one more while they are small
FOLD_GRAPHS_PER_DEVICE = 8
#: the folds on the card that a captured fold must go unused before a
#: new shape may take its place (the reads' rule)
GRAPH_IDLE_FOLDS = 512

#: the reads on the card by event
read_graph_events = stats.Counter(
    "antidote_rga_read_graph_total",
    "RGA store reads on the card by CUDA-graph event: capture (a "
    "shape's first read recorded, then replayed), replay, or eager (the "
    "device's graphs all in use)", labels=("event",))
#: the folds on the card by event
fold_graph_events = stats.Counter(
    "antidote_rga_fold_graph_total",
    "RGA store folds on the card by CUDA-graph event: capture (a "
    "shape's first fold recorded, then replayed), replay, or eager (the "
    "device's fold graphs all in use)", labels=("event",))


class _Graph:
    """An eager body (:func:`_read_eager`, :func:`_fold_eager`) captured
    as one CUDA graph for one shape (PB, NW, MD, D, actor bits) and one
    stream.

    The body takes a state and an int64[D] clock (the read's snapshot,
    the fold's horizon) and returns a tuple of tensors.  The graph reads
    static inputs, the state's ``fields`` and the clock, and writes
    static outputs.  :meth:`run` copies the caller's state and clock
    into the inputs, replays, and copies the outputs into fresh tensors,
    all on the stream and under ``lock``, so callers of one shape share
    the graph in stream order and no result is overwritten by a later
    replay.  :meth:`capture` runs under ``lock`` too, and waits for the
    card nowhere: a warm-up call and the capture run on a side stream
    that waits on the caller's."""

    def __init__(self, body, fields_read, used: int):
        self.body = body
        self.fields = fields_read
        self.lock = threading.Lock()
        #: the cache's count of calls at this graph's last call
        self.used = used
        self.graph = None

    def capture(self, st: RgaStoreState, vc, stream) -> None:
        dev = st.wn.device
        self.inputs = [torch.empty_like(getattr(st, f)) for f in self.fields]
        self.vc = torch.empty((st.d,), dtype=torch.int64, device=dev)
        # a field the body never reads: a zero-row stand-in, not a
        # stale tensor
        unread = {f: getattr(st, f).new_empty((0,))
                  for f in _STATE_FIELDS if f not in self.fields}
        self.state = replace(st, **unread,
                             **dict(zip(self.fields, self.inputs)))
        self._stage(st, vc)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            # the warm-up does lazy set-up (kernel loads, sort scratch)
            # outside the capture
            self.body(self.state, self.vc)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outputs = self.body(self.state, self.vc)
            finally:
                graph.capture_end()
        # the next staging must not overwrite inputs the warm-up reads
        stream.wait_stream(side)
        self.graph = graph

    def _stage(self, st: RgaStoreState, vc) -> None:
        _copy_grouped(self.inputs + [self.vc],
                      [getattr(st, f) for f in self.fields] + [vc])

    def run(self, st: RgaStoreState, vc):
        with self.lock:
            if self.graph is None:
                raise RuntimeError("the RGA store's CUDA graph of this "
                                   "shape failed to capture")
            self._stage(st, vc)
            self.graph.replay()
            out = [torch.empty_like(o) for o in self.outputs]
            _copy_grouped(out, self.outputs)
        return tuple(out)


class _Graphs:
    """The process's captured calls of one eager ``body`` by (device,
    stream, shape), at most ``cap`` a device, each call on the card
    counted in ``events`` (``capture``, ``replay``, ``eager``).

    A shape's first call captures where its device has room.  A full
    device drops its least recently used graph for a new shape only
    once that graph has gone ``idle`` calls unused; until then the new
    shape runs ``body`` eagerly on the card.  So shapes called in turn
    keep the graphs they hold and the others run eagerly, and a document
    grown out of a shape leaves its graph to the next.  A capture runs
    outside the cache's lock, under its graph's own, so only callers of
    that shape wait for it.  A dropped graph may still be running: CUDA
    frees an executable graph in flight when it completes; the memory
    pool it captured into serves other allocations once ``empty_cache``
    or an out-of-memory retry releases it."""

    def __init__(self, body, fields_read, cap: int, idle: int, events):
        self.body = body
        self.fields = fields_read
        self.cap = cap
        self.idle = idle
        self.events = events
        self._lock = threading.Lock()
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._calls = 0

    def call(self, st: RgaStoreState, vc):
        dev = st.wn.device
        stream = torch.cuda.current_stream(dev)
        key = (dev.index, stream.cuda_stream, st.pb, st.nw, st.md, st.d,
               st.actor_bits)
        with self._lock:
            self._calls += 1
            g = self._graphs.get(key)
            if g is not None:
                event = "replay"
                g.used = self._calls
                self._graphs.move_to_end(key)
            elif self._make_room(dev.index):
                event = "capture"
                g = self._graphs[key] = _Graph(self.body, self.fields,
                                               self._calls)
                g.lock.acquire()
            else:
                event = "eager"
        self.events.inc(event=event)
        if g is None:
            return self.body(st, vc)
        if event == "capture":
            try:
                g.capture(st, vc, stream)
            except BaseException:
                with self._lock:
                    if self._graphs.get(key) is g:
                        del self._graphs[key]
                raise
            finally:
                g.lock.release()
        return g.run(st, vc)

    def _make_room(self, index) -> bool:
        """Whether device ``index`` may take one more graph: dropping its
        least recently used graphs over the cap if each has gone
        ``idle`` calls unused, else none."""
        mine = [k for k in self._graphs if k[0] == index]
        over = mine[:max(len(mine) - self.cap + 1, 0)]
        if any(self._calls - self._graphs[k].used <= self.idle
               for k in over):
            return False
        for k in over:
            del self._graphs[k]
        return True


def _read_graphs() -> _Graphs:
    """An empty cache of :func:`_read_eager`'s graphs."""
    return _Graphs(_read_eager, _READ_FIELDS, GRAPHS_PER_DEVICE,
                   GRAPH_IDLE_READS, read_graph_events)


_READ_GRAPHS = _read_graphs()


@kernel_span("mat.rga")
def rga_read_doc(st: RgaStoreState, read_vc):
    """Visible document only: (doc int32[PB+NW] padded with -1,
    n_visible) — the bench-facing view over :func:`rga_read`."""
    lam, act, elem, vis, _n = rga_read(st, read_vc)
    order = argsort((~vis).to(torch.uint8))
    n_vis = torch.sum(vis, dtype=torch.int32)
    lanes = torch.arange(vis.shape[0], device=vis.device)
    doc = torch.where(lanes < n_vis, elem[order], -1)
    return doc, n_vis


def _window_tour(parent_key, uid, valid, is_root, nw):
    """Euler tour + Wyllie rank over the window forest.  Returns
    (rank, reachable, root_of, fin) — rank orders vertices within their
    subtree (tour distance: order-exact, not dense)."""
    dev = uid.device
    parked = nw
    sperm = _lexsort2(parent_key, -uid)
    sparent = parent_key[sperm]
    first = _shift_down(sparent)
    sperm32 = sperm.to(torch.int32)
    # roots' keys (nw+1..2nw) lie past first_child's end: dropped
    first_child = set_drop(nw + 1, -1, torch.int32,
                           torch.where(first, sparent, 2 * nw + 3), sperm32)
    same = sparent[:-1] == sparent[1:]
    next_sib = set_drop(nw, -1, torch.int32,
                        torch.where(same, sperm[:-1], 2 * nw + 5),
                        sperm32[1:])

    up = nw + 1
    s = 2 * (nw + 1)
    v = torch.arange(nw + 1, dtype=torch.int32, device=dev)
    succ_down = torch.where(first_child >= 0, first_child, up + v)
    ns = torch.cat([next_sib,
                    torch.full((1,), -1, dtype=torch.int32, device=dev)])
    pk = torch.cat([parent_key.to(torch.int32),
                    torch.full((1,), parked, dtype=torch.int32, device=dev)])
    # non-root, non-parked: up -> next sib | parent's up.  pk < nw is a
    # real parent; roots/parked handled below
    par_clip = torch.clamp(pk, 0, nw)
    succ_up = torch.where(ns >= 0, ns, up + par_clip)
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    root_mask = torch.cat([is_root, no])
    succ_up = torch.where(root_mask, up + v, succ_up)  # terminal self-loop
    parked_mask = torch.cat([~valid, ~no])  # incl. sentinel vertex
    succ_down = torch.where(parked_mask, v, succ_down)
    succ_up = torch.where(parked_mask, up + v, succ_up)
    succ = torch.cat([succ_down, succ_up])

    dist, fin = rga_kernel.wyllie(succ)
    # reachable iff the chain terminates at an anchored root's up-slot
    is_root_up = torch.cat(
        [torch.zeros((nw + 1,), dtype=torch.bool, device=dev), root_mask])
    term = fin[:nw]
    reachable = valid & is_root_up[torch.clamp(term, 0, s - 1)]
    root_of = torch.clamp(term - up, 0, nw - 1)
    rank = dist[root_of] - dist[:nw]         # 0 at the root, tour order
    rank = torch.where(reachable, rank, 0)
    return rank, reachable, root_of, fin


def _compact(order, n_new, size):
    """Rows ``order`` moved to the front, rows from ``n_new`` on zeroed."""
    live = torch.arange(size, device=order.device) < n_new

    def go(a):
        m = live.reshape((size,) + (1,) * (a.ndim - 1))
        return torch.where(m, a[order], 0)
    return go


@kernel_span("mat.rga")
def rga_fold(st: RgaStoreState, gst):
    """Fold window ops whose commit VC <= the dense GST (int64[D], on
    the state's device) into the base: one full merge over base + stable
    window (tombstoned vertices keep their rows as anchors), then compact
    the window to its unstable suffix.  Returns (state, n_new): the
    base's new row count as a 0-d tensor.  Requires the folded base to
    fit PB rows (the host wrapper grows first; see rga_fold_host).

    On the card the fold replays its shape's CUDA graph (the folded
    state is the caller's own tensors), or runs :func:`_fold_eager`
    there while the device's fold graphs are all in use
    (:class:`_Graphs`); on the CPU it runs :func:`_fold_eager`."""
    if st.wn.device.type == "cuda":
        out = _FOLD_GRAPHS.call(st, gst)
    else:
        out = _fold_eager(st, gst)
    st = replace(st, **dict(zip(_STATE_FIELDS, out)))
    return st, st.bn


def _fold_eager(st: RgaStoreState, gst):
    """:func:`rga_fold`'s body, one torch operation at a time: the CPU
    path, and what :class:`_Graph` captures.  Returns the folded state's
    tensors in ``_STATE_FIELDS`` order.  It calls the merge's unwrapped
    body, so no profiler span opens inside a capture."""
    nw, pb, md = st.nw, st.pb, st.md
    bits = st.actor_bits
    mask32 = (1 << bits) - 1
    dev = st.wn.device
    i32 = torch.int32

    lanes = torch.arange(nw, dtype=i32, device=dev)
    in_window = lanes < st.wn
    stable_w = in_window & _included(st.wss, st.wdc, st.wct, gst)
    # duplicate deliveries of base rows must not re-enter the merge (a
    # kept window copy would shadow the base row's tombstone flag);
    # they are dropped from the window instead
    wuid_w = pack_uid(st.wlam, st.wact, bits)
    base_dup = in_window & _bsearch_hit(st.bsort_uid, wuid_w)[0]
    stable_w = stable_w & ~base_dup
    dlanes = torch.arange(md, dtype=i32, device=dev)
    stable_d = (dlanes < st.dn) & _included(st.dss, st.ddc, st.dct, gst)

    bpos = torch.arange(pb, dtype=i32, device=dev)
    in_base = bpos < st.bn
    blam = st.buid >> bits
    bact = st.buid & mask32
    bplam = st.bparent >> bits
    bpact = st.bparent & mask32

    ins_lam = torch.cat([torch.where(in_base, blam, 0), st.wlam])
    ins_act = torch.cat([torch.where(in_base, bact, 0), st.wact])
    ref_lam = torch.cat([bplam, st.wrlam])
    ref_act = torch.cat([bpact, st.wract])
    elem = torch.cat([st.belem, st.welem])
    valid = torch.cat([in_base, stable_w])
    prev_live = torch.cat(
        [st.blive, torch.ones((nw,), dtype=torch.bool, device=dev)])

    r = rga_kernel._merge_impl(
        ins_lam, ins_act, ref_lam, ref_act, elem, valid,
        st.dlam, st.dact, stable_d, actor_bits=bits)

    t = pb + nw
    rank = torch.where(r["reachable"], r["rank"], _I32MAX)
    perm = argsort(rank)[:pb]
    n_new = torch.sum(r["reachable"], dtype=i32)
    live = prev_live & ~r["deleted"]
    parent = r["parent"]
    parent_uid = torch.where(
        parent >= t, 0,
        r["uid"][torch.clamp(parent, 0, t - 1)]).to(i32)

    reach_s = r["reachable"][perm]
    buid = torch.where(reach_s, r["uid"][perm].to(i32), _I32MAX)
    bparent = torch.where(reach_s, parent_uid[perm], 0)
    belem = torch.where(reach_s, elem[perm], 0)
    blive = reach_s & live[perm]
    bsub_end = torch.where(reach_s, bpos + r["subtree"][perm], 0)

    sort_perm = argsort(buid)
    ck = torch.where(reach_s, _ckey_pack(bparent, buid), _I64MAX)
    ck_perm = argsort(ck)

    # compact the window to the unstable suffix (stable order
    # preserved); folded ops and base duplicates both drop
    keep_w = in_window & ~stable_w & ~base_dup
    worder = argsort((~keep_w).to(torch.uint8))
    wn_new = torch.sum(keep_w, dtype=i32)
    cw = _compact(worder, wn_new, nw)
    keep_d = (dlanes < st.dn) & ~stable_d
    dorder = argsort((~keep_d).to(torch.uint8))
    dn_new = torch.sum(keep_d, dtype=i32)
    cd = _compact(dorder, dn_new, md)

    folded = dict(
        buid=buid, bparent=bparent, belem=belem, blive=blive,
        bsub_end=bsub_end, bn=n_new,
        bsort_uid=buid[sort_perm], bsort_pos=bpos[sort_perm],
        ckey=ck[ck_perm], cpos=bpos[ck_perm],
        wlam=cw(st.wlam), wact=cw(st.wact), wrlam=cw(st.wrlam),
        wract=cw(st.wract), welem=cw(st.welem),
        wdc=cw(st.wdc), wct=cw(st.wct), wss=cw(st.wss),
        wn=wn_new,
        dlam=cd(st.dlam), dact=cd(st.dact),
        ddc=cd(st.ddc), dct=cd(st.dct), dss=cd(st.dss),
        dn=dn_new,
    )
    return tuple(folded[f] for f in _STATE_FIELDS)


#: the state fields :func:`_fold_eager` reads (the base's sorted
#: position, child index and subtree ends it rebuilds unread)
_FOLD_FIELDS = ("buid", "bparent", "belem", "blive", "bn", "bsort_uid",
                "wlam", "wact", "wrlam", "wract", "welem", "wdc", "wct",
                "wss", "wn", "dlam", "dact", "ddc", "dct", "dss", "dn")


def _fold_graphs() -> _Graphs:
    """An empty cache of :func:`_fold_eager`'s graphs."""
    return _Graphs(_fold_eager, _FOLD_FIELDS, FOLD_GRAPHS_PER_DEVICE,
                   GRAPH_IDLE_FOLDS, fold_graph_events)


_FOLD_GRAPHS = _fold_graphs()


def _pad(a, rows, fill=0, cols=None):
    """``a`` grown to ``rows`` rows (and ``cols`` columns), the new
    cells ``fill``, on ``a``'s device."""
    shape = (rows,) if a.ndim == 1 else (rows, cols)
    out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    out[tuple(slice(0, k) for k in a.shape)] = a
    return out


def rga_grow(st: RgaStoreState, pb: int | None = None,
             nw: int | None = None, md: int | None = None,
             n_dcs: int | None = None) -> RgaStoreState:
    """Capacity regrade (never shrinks); rare."""
    pb = max(pb or st.pb, st.pb)
    nw = max(nw or st.nw, st.nw)
    md = max(md or st.md, st.md)
    d = max(n_dcs or st.d, st.d)
    if (pb, nw, md, d) == (st.pb, st.nw, st.md, st.d):
        return st
    return RgaStoreState(
        buid=_pad(st.buid, pb, _I32MAX), bparent=_pad(st.bparent, pb),
        belem=_pad(st.belem, pb), blive=_pad(st.blive, pb, False),
        bsub_end=_pad(st.bsub_end, pb), bn=st.bn,
        bsort_uid=_pad(st.bsort_uid, pb, _I32MAX),
        bsort_pos=_pad(st.bsort_pos, pb),
        ckey=_pad(st.ckey, pb, _I64MAX), cpos=_pad(st.cpos, pb),
        wlam=_pad(st.wlam, nw), wact=_pad(st.wact, nw),
        wrlam=_pad(st.wrlam, nw), wract=_pad(st.wract, nw),
        welem=_pad(st.welem, nw),
        wdc=_pad(st.wdc, nw), wct=_pad(st.wct, nw),
        wss=_pad(st.wss, nw, cols=d), wn=st.wn,
        dlam=_pad(st.dlam, md), dact=_pad(st.dact, md),
        ddc=_pad(st.ddc, md), dct=_pad(st.dct, md),
        dss=_pad(st.dss, md, cols=d), dn=st.dn,
        actor_bits=st.actor_bits,
    )


def rga_remap_actors(st: RgaStoreState, perm) -> RgaStoreState:
    """Rewrite every packed actor id through ``perm`` (int32[2^bits],
    old id -> new id, 0 -> 0) and re-derive the base order.

    Needed because sibling order is uid-DESC and the host oracle breaks
    lamport ties by ACTOR STRING: the device's interned ids must order
    like the strings, so when a new actor arrives that does not sort
    after all existing ones, the owner re-interns in sorted order and
    remaps the document.  The base preorder depends on sibling order,
    hence the re-merge via a zero-horizon fold after the id rewrite."""
    bits = st.actor_bits
    mask = (1 << bits) - 1
    dev = st.buid.device
    pm = torch.as_tensor(perm, dtype=torch.int32, device=dev)

    def remap(ids):
        return pm[ids.long()]

    def remap_uid(uid_arr):
        out = ((uid_arr >> bits) << bits) | remap(uid_arr & mask)
        return torch.where(uid_arr == _I32MAX, _I32MAX, out)

    buid = remap_uid(st.buid)
    bparent = remap_uid(st.bparent)
    pos = torch.arange(st.pb, dtype=torch.int32, device=dev)
    sort_perm = argsort(buid)
    in_base = pos < st.bn
    ck = torch.where(in_base, _ckey_pack(bparent, buid), _I64MAX)
    ck_perm = argsort(ck)
    st = replace(
        st,
        buid=buid, bparent=bparent,
        bsort_uid=buid[sort_perm], bsort_pos=pos[sort_perm],
        ckey=ck[ck_perm], cpos=pos[ck_perm],
        wact=remap(st.wact), wract=remap(st.wract), dact=remap(st.dact),
    )
    # zero-horizon fold: folds nothing from the window (commit times are
    # positive) but re-merges the base rows, rebuilding the preorder and
    # subtree extents under the remapped sibling order
    st, _bn = rga_fold(st, torch.zeros((st.d,), dtype=torch.int64,
                                       device=dev))
    return st


def rga_fold_host(st: RgaStoreState, gst, counts=None) -> RgaStoreState:
    """Host wrapper around :func:`rga_fold`: grows the base first when
    the folded document might not fit (worst case bn + stable window).
    ``gst`` is the dense stable VC (int64[D]); a scalar is treated as a
    single-column horizon for the simulation benches.  ``counts`` is
    the state's ``(bn, wn)`` where the caller has read them to the host
    already; else they are read here (the one wait for the card)."""
    gst = np.asarray(gst, dtype=np.int64).reshape(-1)
    if gst.shape[0] != st.d:
        gst = np.pad(gst, (0, st.d - gst.shape[0]))
    bn, wn = (int(st.bn), int(st.wn)) if counts is None else counts
    need = int(bn) + int(wn)
    if need > st.pb:
        new_pb = st.pb
        while new_pb < need:
            new_pb *= 2
        st = rga_grow(st, pb=new_pb)
    st, _bn = rga_fold(st, upload(gst, st.bn.device))
    return st
