"""antidote_tpu_torch.mat.kernels and mat.gpu_kernels against their JAX
counterparts (mat/kernels.py, and mat/pallas_kernels.py run as its own
tests run it on the CPU: interpret mode).  Exact equality throughout.

On the CPU the gpu_kernels wrappers run their plain versions; the CUDA
kernels themselves are held against those plain versions by the
card-only tests (tests/test_torch_cuda.py) and by chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.mat import kernels as jkernels
from antidote_tpu.mat import pallas_kernels, store as jstore
from antidote_tpu_torch.mat import gpu_kernels, kernels

DTYPES = [torch.int32, torch.int64]


def _fold_inputs(seed, dtype, K=37, Lx=6, Ex=5, Dx=4):
    """Random fold inputs with padding lanes (elem = E), element slots
    and DCs outside their ranges, and a partial mask."""
    rng = np.random.default_rng(seed)
    nd = np.int32 if dtype == torch.int32 else np.int64
    return dict(
        base_dots=rng.integers(0, 9, size=(K, Ex, Dx)).astype(nd),
        elem_slot=rng.integers(-1, Ex + 2, size=(K, Lx)).astype(np.int32),
        is_add=rng.random((K, Lx)) < 0.6,
        dot_dc=rng.integers(-1, Dx + 1, size=(K, Lx)).astype(np.int32),
        dot_seq=rng.integers(0, 12, size=(K, Lx)).astype(nd),
        obs_vv=rng.integers(0, 9, size=(K, Lx, Dx)).astype(nd),
        mask=rng.random((K, Lx)) < 0.8,
    )


_same = tp.same


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [None, 8])
def test_orset_apply_and_present(dtype, chunk, monkeypatch):
    """The fold, also when orset_apply runs over K in several blocks."""
    if chunk:
        monkeypatch.setattr(kernels, "_FOLD_CHUNK", chunk)
    x = _fold_inputs(1, dtype)
    want = jkernels.orset_apply(*(jnp.asarray(v) for v in x.values()))
    got = kernels.orset_apply(*(torch.from_numpy(v) for v in x.values()))
    _same(want, got)
    _same(jkernels.orset_present(want), kernels.orset_present(got))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("read_rows", [False, True])
def test_inclusion_mask_and_snapshot_vc(dtype, read_rows):
    rng = np.random.default_rng(2)
    nd = np.int32 if dtype == torch.int32 else np.int64
    K, Lx, Dx = 23, 6, 4
    op_dc = rng.integers(0, Dx, size=(K, Lx)).astype(np.int32)
    op_ct = rng.integers(5, 12, size=(K, Lx)).astype(nd)
    op_ss = rng.integers(0, 10, size=(K, Lx, Dx)).astype(nd)
    valid = rng.random((K, Lx)) < 0.8
    base = rng.integers(0, 9, size=(K, Dx)).astype(nd)
    has_base = rng.random(K) < 0.5
    read = (rng.integers(6, 12, size=(K, Dx)) if read_rows
            else rng.integers(6, 12, size=(Dx,))).astype(nd)
    args = (op_dc, op_ct, op_ss, valid, base, has_base, read)
    want = jkernels.inclusion_mask(*(jnp.asarray(a) for a in args))
    got = kernels.inclusion_mask(*(torch.from_numpy(a) for a in args))
    _same(want, got)
    snap = (op_dc, op_ct, op_ss, np.array(want), base)
    _same(jkernels.snapshot_vc_of(*(jnp.asarray(a) for a in snap)),
          kernels.snapshot_vc_of(*(torch.from_numpy(a) for a in snap)))


def _args(st, read_vc):
    return (st.dots, st.ops, st.valid, st.base_vc, st.has_base, read_vc)


@pytest.mark.parametrize("seed", [3, 11])
def test_read_packed_and_hybrid_match_pallas(seed):
    """K = 200 is no multiple of the Pallas block (64)."""
    jst, fr = tp.jax_filled(seed=seed, K=200, B=256)
    tst = tp.to_port(jst)
    read_vc = torch.from_numpy(fr)
    jargs = (jst.dots, jst.ops, jst.valid, jst.base_vc, jst.has_base,
             jnp.asarray(fr))
    want = pallas_kernels.orset_read_packed(*jargs, block_k=64,
                                            interpret=True)
    _same(want, gpu_kernels.orset_read_packed(*_args(tst, read_vc)))
    want_h = pallas_kernels.orset_read_hybrid(*jargs, block_k=64,
                                              interpret=True)
    _same(want_h, gpu_kernels.orset_read_hybrid(*_args(tst, read_vc)))


def test_read_fused_matches_pallas():
    jst, fr = tp.jax_filled(seed=5, K=64, B=128)
    tst = tp.to_port(jst)
    fields = ("dots", "elem_slot", "is_add", "dot_dc", "dot_seq", "obs_vv",
              "op_dc", "op_ct", "op_ss", "valid2d", "base_vc", "has_base")
    want = pallas_kernels.orset_read_fused(
        *(getattr(jst, f) for f in fields), jnp.asarray(fr), block_k=32,
        interpret=True)
    got = gpu_kernels.orset_read_fused(
        *(getattr(tst, f) for f in fields), torch.from_numpy(fr))
    _same(want, got)


def test_gc_packed_matches_pallas():
    """A GST between the base and the frontier: some lanes fold, some
    survive."""
    jst, fr = tp.jax_filled(seed=12, K=200, B=384)
    tst = tp.to_port(jst)
    gst = ((np.asarray(jst.base_vc) + fr) // 2).astype(np.int32)
    want_dots, want_valid = pallas_kernels.orset_gc_packed(
        jst.dots, jst.ops, jst.valid, jnp.asarray(gst), block_k=64,
        interpret=True)
    got_dots, got_valid = gpu_kernels.orset_gc_packed(
        tst.dots, tst.ops, tst.valid, torch.from_numpy(gst))
    _same(want_dots, got_dots)
    _same(want_valid, got_valid)
    folded = int(tst.valid.sum() - got_valid.sum())
    assert 0 < folded < int(tst.valid.sum())


def test_int64_kernels_match_jnp_store():
    """int64 shards go through the same wrappers (the Pallas kernels are
    int32 only, so the reference is the JAX store's jnp path)."""
    jst, fr = tp.jax_filled(seed=7, K=96, B=192, dtype=torch.int64)
    tst = tp.to_port(jst)
    fr64 = fr.astype(np.int64)
    want = jstore.orset_read(jst, jnp.asarray(fr64))
    read_vc = torch.from_numpy(fr64)
    _same(want, gpu_kernels.orset_read_packed(*_args(tst, read_vc)))
    _same(want, gpu_kernels.orset_read_hybrid(*_args(tst, read_vc)))
    gst = (np.asarray(jst.base_vc) + fr64) // 2
    got_dots, got_valid = gpu_kernels.orset_gc_packed(
        tst.dots, tst.ops, tst.valid, torch.from_numpy(gst))
    want_st = jstore.orset_gc(jst, jnp.asarray(gst))
    _same(want_st.dots, got_dots)
    _same(want_st.valid, got_valid)


def test_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    jst, fr = tp.jax_filled(seed=1, K=16, B=32, rounds=1)
    st = tp.to_port(jst)
    vc = torch.from_numpy(fr)
    before = [k.launches for k in gpu_kernels.KERNELS]
    gpu_kernels.orset_read_packed(*_args(st, vc))
    gpu_kernels.orset_gc_packed(st.dots, st.ops, st.valid, vc)
    assert [k.launches for k in gpu_kernels.KERNELS] == before
    with pytest.raises(TypeError):
        gpu_kernels.orset_read_packed(st.dots.float(), st.ops, st.valid,
                                      st.base_vc, st.has_base, vc)
    with pytest.raises(ValueError):
        gpu_kernels.orset_read_packed(st.dots, st.ops.to(torch.int64),
                                      st.valid, st.base_vc, st.has_base, vc)
    with pytest.raises(ValueError):
        gpu_kernels.orset_gc_packed(st.dots, st.ops[:-1], st.valid[:-1], vc)
    with pytest.raises(ValueError):
        gpu_kernels.orset_fold_presence(st.dots, st.ops,
                                        st.valid.to(torch.int32))



# ---------------------------------------------------------------------------
# the other CRDT types' folds


def _to(*xs, jax=False):
    return [jnp.asarray(x) if jax else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [None, 8])
def test_mvreg_apply(dtype, chunk, monkeypatch):
    """The cross-slot fold, with reset rows (slot E), slots and DCs out
    of range and a partial mask, also over K in several blocks."""
    if chunk:
        monkeypatch.setattr(kernels, "_FOLD_CHUNK", chunk)
    x = _fold_inputs(4, dtype)
    args = [x[k] for k in ("base_dots", "elem_slot", "dot_dc", "dot_seq",
                           "obs_vv", "mask")]
    _same(jkernels.mvreg_apply(*_to(*args, jax=True)),
          kernels.mvreg_apply(*_to(*args)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_flag_ew_read(dtype):
    x = _fold_inputs(6, dtype)
    args = [x["base_dots"][:, 0], x["dot_dc"], x["dot_seq"], x["is_add"],
            x["obs_vv"], x["mask"]]
    _same(jkernels.flag_ew_read(*_to(*args, jax=True)),
          kernels.flag_ew_read(*_to(*args)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_counter_read_promotes_int32_to_int64(dtype):
    rng = np.random.default_rng(7)
    nd = np.int32 if dtype == torch.int32 else np.int64
    args = (rng.integers(-50, 50, size=23).astype(nd),
            rng.integers(-9, 9, size=(23, 6)).astype(nd),
            rng.random((23, 6)) < 0.7)
    want = jkernels.counter_read(*_to(*args, jax=True))
    got = kernels.counter_read(*_to(*args))
    _same(want, got)
    assert got.dtype == torch.int64


def test_rw_kinds():
    assert (kernels.RW_ADD, kernels.RW_RMV, kernels.RW_RESET) == (
        jkernels.RW_ADD, jkernels.RW_RMV, jkernels.RW_RESET)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [None, 8])
def test_rwset_apply_and_present(dtype, chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(kernels, "_FOLD_CHUNK", chunk)
    x = _fold_inputs(8, dtype)
    rng = np.random.default_rng(9)
    kind = rng.integers(0, 3, size=x["mask"].shape).astype(np.int32)
    obs_rmv = rng.integers(0, 9, size=x["obs_vv"].shape).astype(
        x["obs_vv"].dtype)
    args = [x["base_dots"], x["base_dots"][::-1].copy(), x["elem_slot"],
            kind, x["dot_dc"], x["dot_seq"], x["obs_vv"], obs_rmv,
            x["mask"]]
    want = jkernels.rwset_apply(*_to(*args, jax=True))
    got = kernels.rwset_apply(*_to(*args))
    for w, g in zip(want, got):
        _same(w, g)
    _same(jkernels.rwset_present(*want), kernels.rwset_present(*got))


def test_setgo_apply():
    x = _fold_inputs(10, torch.int32)
    base = np.random.default_rng(11).random((37, 5)) < 0.2
    args = [base, x["elem_slot"], x["mask"]]
    _same(jkernels.setgo_apply(*_to(*args, jax=True)),
          kernels.setgo_apply(*_to(*args)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lww_read(dtype):
    """Few distinct timestamps and tiebreaks, so ties on ts and on (ts,
    tie) are common; some keys have no included op."""
    rng = np.random.default_rng(12)
    nd = np.int32 if dtype == torch.int32 else np.int64
    K, Lx = 41, 6
    args = (rng.integers(0, 4, size=K).astype(nd),
            rng.integers(0, 3, size=K).astype(nd),
            rng.integers(-1, 9, size=K).astype(nd),
            rng.integers(0, 5, size=(K, Lx)).astype(nd),
            rng.integers(0, 3, size=(K, Lx)).astype(nd),
            rng.integers(0, 50, size=(K, Lx)).astype(nd),
            rng.random((K, Lx)) < 0.6)
    want = jkernels.lww_read(*_to(*args, jax=True))
    got = kernels.lww_read(*_to(*args))
    for w, g in zip(want, got):
        _same(w, g)
