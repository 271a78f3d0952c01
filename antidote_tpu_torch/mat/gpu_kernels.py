"""The OR-Set materializer's CUDA kernels, their wrappers and their plain
PyTorch versions (port of antidote_tpu/mat/pallas_kernels.py), and the
wrappers of the store's and the RGA store's append kernels.

Each OR-Set wrapper takes the store's packed layout (mat/store.py
``OrsetShardState``): ``dots`` int[K, E, D], ``ops`` int[K*L, 6+2D] with
the columns [elem, is_add, dot_dc, dot_seq, op_dc, op_ct, obs_vv(D),
op_ss(D)], ``valid`` bool[K*L].  int32 and int64 shards both go through
the kernels.

- :func:`orset_read_packed`: full-shard presence at a read VC in one
  pass (replaces pallas_kernels.orset_read_packed).
- :func:`orset_fold_presence`: the fold and presence under a given
  inclusion mask; :func:`orset_read_hybrid` computes that mask with
  plain tensor ops and calls it (replaces orset_read_hybrid).
- :func:`orset_gc_packed`: the GC fold of the lanes stable at the GST
  (replaces orset_gc_packed).
- :func:`ring_append`: every shard type's append epilogue, the rank of
  each op's free lane and the row scatter (``csrc/store_kernels.cu``;
  replaces no Pallas kernel: the JAX package's append is XLA's scatter).
  Its plain version is ``store._scatter_rows_plain``, and
  ``store._scatter_rows`` picks between the two by the ring's device.
- :func:`rga_append_rows`: the RGA store's append, one packed op block
  written into the window and delete lanes (``csrc/rga_kernels.cu``;
  replaces no Pallas kernel: the JAX package's append is XLA's
  ``dynamic_update_slice``).  Its plain version is
  ``rga_store.rga_append``, and ``rga_store.rga_append_packed`` picks
  between the two by the state's device.

An OR-Set wrapper given CPU tensors runs the kernel's plain version, and
only then; given CUDA tensors it launches the kernel (``csrc/
orset_kernels.cu``) or raises.  ``ring_append`` and ``rga_append_rows``
launch or raise: their plain versions live in mat/store.py and
mat/rga_store.py, which import this module.  Each
wrapper counts its launches in its ``launches`` attribute.  The plain
versions (``*_plain``) are the CPU path, the reference the kernels are
held against on the card, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from antidote_tpu_torch import _cuda
from antidote_tpu_torch.clocks import dense
from antidote_tpu_torch.mat import kernels
from antidote_tpu_torch.obs.prof import kernel_span

_NSCAL = 6
#: the kernels' compile-time bounds (kMaxL/kMaxE/kMaxD in
#: csrc/orset_kernels.cu)
_MAX_L = _MAX_E = _MAX_D = 16


def _shape(dots: torch.Tensor, ops: torch.Tensor, lanes: torch.Tensor):
    """(K, L, E, D) of a packed shard; raises on what no path takes."""
    if dots.dim() != 3 or dots.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dots must be int32/int64 [K, E, D], got "
                        f"{dots.dtype} {tuple(dots.shape)}")
    k, e, d = dots.shape
    if k < 1:
        raise ValueError("empty shard (K = 0)")
    if (ops.dtype != dots.dtype or ops.dim() != 2
            or ops.shape[1] != _NSCAL + 2 * d or ops.shape[0] % k):
        raise ValueError(f"ops must be {dots.dtype} [K*L, {_NSCAL + 2 * d}]"
                         f", got {ops.dtype} {tuple(ops.shape)}")
    l = ops.shape[0] // k
    if lanes.dtype != torch.bool or lanes.shape != (k * l,):
        raise ValueError(f"lane bitmap must be bool [{k * l}], got "
                         f"{lanes.dtype} {tuple(lanes.shape)}")
    for t in (ops, lanes):
        if t.device != dots.device:
            raise ValueError(f"shard tensors on {dots.device} and "
                             f"{t.device}")
    return k, l, e, d


def _kernel_args(dots, ops, lanes, l, e, d):
    """Checks that only the kernel path makes; returns (is64, stream)."""
    if dots.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dots.device}")
    if l > _MAX_L or e > _MAX_E or d > _MAX_D:
        raise ValueError(f"L={l}, E={e}, D={d}: the kernels take at most "
                         f"L={_MAX_L}, E={_MAX_E}, D={_MAX_D}")
    for t in (dots, ops, lanes):
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
    return (int(dots.dtype == torch.int64),
            torch.cuda.current_stream(dots.device).cuda_stream)


def _vc(vc, dots: torch.Tensor, d: int) -> torch.Tensor:
    """A VC moved to the shard's device and integer type."""
    vc = torch.as_tensor(vc).to(device=dots.device, dtype=dots.dtype)
    if vc.shape != (d,):
        raise ValueError(f"VC must have shape ({d},), got {tuple(vc.shape)}")
    return vc.contiguous()


def _views(ops: torch.Tensor, k: int):
    """[K, L(, D)] views of the packed columns."""
    v = ops.reshape(k, -1, ops.shape[1])
    d = (ops.shape[1] - _NSCAL) // 2
    return dict(elem=v[..., 0], is_add=v[..., 1] != 0, dot_dc=v[..., 2],
                dot_seq=v[..., 3], op_dc=v[..., 4], op_ct=v[..., 5],
                obs_vv=v[..., _NSCAL:_NSCAL + d], op_ss=v[..., _NSCAL + d:])


def read_mask(ops, valid, base_vc, has_base, read_vc, k: int):
    """bool[K, L]: the Clock-SI inclusion mask at ``read_vc`` over the
    packed rows, with one shard-wide base VC."""
    v = _views(ops, k)
    d = v["op_ss"].shape[-1]
    has_base = torch.as_tensor(has_base, device=ops.device)
    return kernels.inclusion_mask(
        v["op_dc"], v["op_ct"], v["op_ss"], valid.reshape(k, -1),
        base_vc.expand(k, d), has_base.expand(k), read_vc)


def orset_fold_presence_plain(dots, ops, mask) -> torch.Tensor:
    """bool[K, E]: presence after folding the lanes of ``mask``
    (bool[K*L] or [K, L])."""
    k = dots.shape[0]
    v = _views(ops, k)
    live = kernels.orset_apply(dots, v["elem"], v["is_add"], v["dot_dc"],
                               v["dot_seq"], v["obs_vv"], mask.reshape(k, -1))
    return kernels.orset_present(live)


def orset_read_packed_plain(dots, ops, valid, base_vc, has_base, read_vc):
    """bool[K, E]: presence at ``read_vc`` as plain tensor ops
    (kernels.inclusion_mask + orset_apply + orset_present)."""
    mask = read_mask(ops, valid, base_vc, has_base, read_vc, dots.shape[0])
    return orset_fold_presence_plain(dots, ops, mask)


def orset_gc_packed_plain(dots, ops, valid, gst):
    """(new_dots int[K, E, D], new_valid bool[K*L]): fold every valid
    lane whose commit VC <= ``gst`` into the dot table and free it."""
    k = dots.shape[0]
    v = _views(ops, k)
    cvc = dense.commit_vc(v["op_ss"], v["op_dc"], v["op_ct"])
    valid2d = valid.reshape(k, -1)
    stable = valid2d & dense.le(cvc, gst)
    new_dots = kernels.orset_apply(dots, v["elem"], v["is_add"],
                                   v["dot_dc"], v["dot_seq"], v["obs_vv"],
                                   stable)
    return new_dots, (valid2d & ~stable).reshape(-1)


@kernel_span("mat.pallas")
def orset_read_packed(dots, ops, valid, base_vc, has_base, read_vc):
    """bool[K, E]: full-shard presence at ``read_vc`` in one pass over
    the packed rows.  A lane is included iff it is valid, its commit VC
    is <= ``read_vc``, and not (``has_base`` and commit VC <=
    ``base_vc``).  ``has_base`` and the VCs are read on the device: the
    call never waits for the card."""
    k, l, e, d = _shape(dots, ops, valid)
    if dots.device.type == "cpu":
        return orset_read_packed_plain(dots, ops, valid, base_vc, has_base,
                                       read_vc)
    is64, stream = _kernel_args(dots, ops, valid, l, e, d)
    base_vc, read_vc = _vc(base_vc, dots, d), _vc(read_vc, dots, d)
    has_base = torch.as_tensor(has_base).to(device=dots.device,
                                            dtype=torch.bool)
    if has_base.numel() != 1:
        raise ValueError("has_base must be one flag")
    has_base = has_base.reshape(1).contiguous()
    out = torch.empty((k, e), dtype=torch.bool, device=dots.device)
    with torch.cuda.device(dots.device):
        _cuda.call("antidote_orset_read", is64, dots.data_ptr(),
                   ops.data_ptr(), valid.data_ptr(), base_vc.data_ptr(),
                   has_base.data_ptr(), read_vc.data_ptr(), out.data_ptr(),
                   k, l, e, d, stream)
    orset_read_packed.launches += 1
    return out


def orset_fold_presence(dots, ops, mask):
    """bool[K, E]: presence after folding the lanes whose ``mask``
    (bool[K*L]) is set; the fold half of the hybrid read."""
    k, l, e, d = _shape(dots, ops, mask)
    if dots.device.type == "cpu":
        return orset_fold_presence_plain(dots, ops, mask)
    is64, stream = _kernel_args(dots, ops, mask, l, e, d)
    out = torch.empty((k, e), dtype=torch.bool, device=dots.device)
    with torch.cuda.device(dots.device):
        _cuda.call("antidote_orset_fold", is64, dots.data_ptr(),
                   ops.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   k, l, e, d, stream)
    orset_fold_presence.launches += 1
    return out


@kernel_span("mat.pallas")
def orset_read_hybrid(dots, ops, valid, base_vc, has_base, read_vc):
    """bool[K, E]: like :func:`orset_read_packed`, with the inclusion
    mask computed by plain tensor ops and only the fold in the kernel."""
    k = dots.shape[0]
    d = dots.shape[2]
    mask = read_mask(ops, valid, _vc(base_vc, dots, d), has_base,
                     _vc(read_vc, dots, d), k)
    return orset_fold_presence(dots, ops, mask.reshape(-1))


@kernel_span("mat.pallas")
def orset_gc_packed(dots, ops, valid, gst):
    """(new_dots int[K, E, D], new_valid bool[K*L]): the store's GC fold
    in one pass.  A lane is stable iff it is valid and its commit VC <=
    ``gst``; stable lanes fold into the dot table and are freed.  The
    caller sets base_vc = max(base_vc, gst) and has_base.  The inputs
    are left as they were."""
    k, l, e, d = _shape(dots, ops, valid)
    if dots.device.type == "cpu":
        return orset_gc_packed_plain(dots, ops, valid, gst)
    is64, stream = _kernel_args(dots, ops, valid, l, e, d)
    gst = _vc(gst, dots, d)
    new_dots = torch.empty_like(dots)
    new_valid = torch.empty_like(valid)
    with torch.cuda.device(dots.device):
        _cuda.call("antidote_orset_gc", is64, dots.data_ptr(),
                   ops.data_ptr(), valid.data_ptr(), gst.data_ptr(),
                   new_dots.data_ptr(), new_valid.data_ptr(), k, l, e, d,
                   stream)
    orset_gc_packed.launches += 1
    return new_dots, new_valid


def _batch(name: str, t: torch.Tensor, b: int, dtypes, device):
    if t.dtype not in dtypes or t.shape != (b,):
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))} "
                        f"[{b}], got {t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def ring_append(ops, valid, n_lanes: int, key_idx, lane_off, rows,
                active=None) -> torch.Tensor:
    """bool overflow[B]: place each row of ``rows`` ([B, F] of the
    ring's dtype) in its key's (``lane_off``+1)-th free lane of the ring
    (``ops`` int32/int64 [K*L, F], ``valid`` bool[K*L], L =
    ``n_lanes``) and mark the lane live, in place, with the contract of
    ``store._scatter_rows``: overflowed ops are not stored, keys outside
    [0, K) never, ``active`` (bool[B], optional) drops masked-off ops
    from both.  Every op ranks against the bitmap as it was before the
    batch.  ``key_idx`` and ``lane_off`` are int32 or int64; ``rows`` may
    have any row stride.  Two launches a call, counted as one in
    ``launches``; an empty batch launches nothing.  Never waits for the
    card."""
    if ops.dim() != 2 or ops.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ops must be int32/int64 [K*L, F], got "
                        f"{ops.dtype} {tuple(ops.shape)}")
    n, f = ops.shape
    if n_lanes < 1 or n < n_lanes or n % n_lanes:
        raise ValueError(f"{n} ring rows do not make K >= 1 keys of "
                         f"{n_lanes} lanes")
    if valid.dtype != torch.bool or valid.shape != (n,):
        raise ValueError(f"lane bitmap must be bool [{n}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    dev = ops.device
    if valid.device != dev or not (ops.is_contiguous()
                                   and valid.is_contiguous()):
        raise ValueError(f"the ring must be contiguous tensors on {dev}")
    b = key_idx.shape[0] if key_idx.dim() == 1 else -1
    index = (torch.int32, torch.int64)
    _batch("key_idx", key_idx, b, index, dev)
    _batch("lane_off", lane_off, b, index, dev)
    if active is not None:
        _batch("active", active, b, (torch.bool,), dev)
    if rows.dtype != ops.dtype or rows.shape != (b, f):
        raise ValueError(f"rows must be {ops.dtype} [{b}, {f}] like the "
                         f"ring, got {rows.dtype} {tuple(rows.shape)}")
    if rows.device != dev or (b > 0 and f > 1 and rows.stride(1) != 1):
        raise ValueError(f"rows must lie on {dev}, each row contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    overflow = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return overflow
    target = torch.empty((b,), dtype=torch.int64, device=dev)
    word = ops.element_size() // 4
    with torch.cuda.device(dev):
        _cuda.call("antidote_ring_append", ops.data_ptr(), valid.data_ptr(),
                   rows.data_ptr(), rows.stride(0) * word,
                   key_idx.data_ptr(), int(key_idx.dtype == torch.int64),
                   lane_off.data_ptr(), int(lane_off.dtype == torch.int64),
                   None if active is None else active.data_ptr(),
                   overflow.data_ptr(), target.data_ptr(), b, n // n_lanes,
                   n_lanes, f * word,
                   torch.cuda.current_stream(dev).cuda_stream)
    ring_append.launches += 1
    return overflow


#: the RGA append's packed block: 7 scalar columns, then the D snapshot
#: columns (mat/rga_store.py ``_PK_*``)
_RGA_NSCAL = 7


def _rga_columns(kind, cols, rows, d, dev):
    """Checks the RGA store's ``kind`` columns (``rows`` lanes, the last
    one [rows, d]) for the append kernel."""
    for i, t in enumerate(cols):
        shape = (rows, d) if i == len(cols) - 1 else (rows,)
        if t.dtype not in (torch.int32, torch.int64) or t.shape != shape:
            raise TypeError(f"{kind} column {i} must be int32/int64 "
                            f"{list(shape)}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{kind} column {i} must be contiguous on "
                             f"{dev}")


def rga_append_rows(packed, window, deletes, wn, dn, bp: int, n_ins: int,
                    n_del: int):
    """(ok, wn, dn), fresh 0-d tensors: the RGA store's append of one
    packed block (``csrc/rga_kernels.cu``) with the contract of
    ``rga_store.rga_append``.  ``packed`` is int64 [bp+cp, 7+D], insert
    rows first; ``window`` the 8 columns (wlam, wact, wrlam, wract,
    welem, wdc, wct [NW], wss [NW, D]), ``deletes`` the 5 (dlam, dact,
    ddc, dct [MD], dss [MD, D]), each int32 or int64; ``wn``/``dn`` the
    int32 0-d counters.  Where the padded block fits, ok = (wn + bp <=
    NW) & (dn + cp <= MD), its rows are written from row wn and dn in
    place and the counters advance by ``n_ins``/``n_del``; else nothing
    changes.  One launch a call; never waits for the card."""
    if (packed.dtype != torch.int64 or packed.dim() != 2
            or packed.shape[1] <= _RGA_NSCAL):
        raise TypeError(f"packed must be int64 [B, 7+D], got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    bp, n_ins, n_del = int(bp), int(n_ins), int(n_del)
    d = packed.shape[1] - _RGA_NSCAL
    cp = packed.shape[0] - bp
    if len(window) != 8 or len(deletes) != 5:
        raise ValueError(f"want 8 window and 5 delete columns, got "
                         f"{len(window)} and {len(deletes)}")
    nw, md = window[0].shape[0], deletes[0].shape[0]
    if not (0 <= bp <= nw and 0 <= cp <= md):
        raise ValueError(f"a block of {bp} insert and {cp} delete rows "
                         f"does not fit {nw} window and {md} delete lanes")
    dev = packed.device
    _rga_columns("window", window, nw, d, dev)
    _rga_columns("delete", deletes, md, d, dev)
    for t in (wn, dn):
        if t.dtype != torch.int32 or t.shape != () or t.device != dev:
            raise TypeError(f"counters must be int32 0-d on {dev}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    cols = window + deletes
    ptrs = (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols])
    is64 = sum([1 << i for i, t in enumerate(cols)
                if t.dtype == torch.int64])
    ok = torch.empty((), dtype=torch.bool, device=dev)
    wn_new, dn_new = torch.empty_like(wn), torch.empty_like(dn)
    with torch.cuda.device(dev):
        _cuda.call("antidote_rga_append", packed.data_ptr(), ptrs, is64,
                   wn.data_ptr(), dn.data_ptr(), nw, md, bp, cp, d, n_ins,
                   n_del, ok.data_ptr(), wn_new.data_ptr(),
                   dn_new.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    rga_append_rows.launches += 1
    return ok, wn_new, dn_new


orset_read_packed.launches = 0
orset_fold_presence.launches = 0
orset_gc_packed.launches = 0
ring_append.launches = 0
rga_append_rows.launches = 0

#: every kernel wrapper, for code that resets or reads the counters
KERNELS = (orset_read_packed, orset_fold_presence, orset_gc_packed,
           ring_append, rga_append_rows)


@kernel_span("mat.pallas")
def orset_read_fused(dots, elem_slot, is_add, dot_dc, dot_seq, obs_vv,
                     op_dc, op_ct, op_ss, valid, base_vc, has_base,
                     read_vc):
    """bool[K, E]: presence at ``read_vc`` from per-field [K, L(, D)]
    views.  Not a kernel: packs the fields into the store's row layout
    and runs :func:`orset_read_packed`."""
    k, l = elem_slot.shape
    dt = dots.dtype
    col = lambda a: a.to(dt)[:, :, None]  # noqa: E731
    ops = torch.cat([col(elem_slot), col(is_add), col(dot_dc), col(dot_seq),
                     col(op_dc), col(op_ct), obs_vv.to(dt), op_ss.to(dt)],
                    dim=2).reshape(k * l, -1)
    return orset_read_packed(dots, ops, valid.reshape(k * l).contiguous(),
                             base_vc, has_base, read_vc)
