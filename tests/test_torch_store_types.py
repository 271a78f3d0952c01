"""antidote_tpu_torch.mat.store against antidote_tpu.mat.store for every
shard type but the OR-Set (tests/test_torch_store.py): MV-register,
PN-counter, grow-only set, remove-wins set and LWW register.  The same
seeded batches go through both stores; states, overflow reports and
reads must be equal in values and dtypes."""

from dataclasses import fields

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.mat import kernels as jkernels
from antidote_tpu.mat import store as jstore
from antidote_tpu_torch.mat import kernels, store, synth

DTYPES = [torch.int32, torch.int64]
TYPES = ["register_mv", "counter_pn", "set_go", "set_rw", "register_lww"]
T = store.SHARD_TYPES


def _pair(typ, K, dtype):
    jst = tp.jinit(typ, K, dtype)
    tst = tp.tinit(typ, K, dtype)
    tp.assert_state_equal(jst, tst)
    return jst, tst


def _same_read(j, t):
    """Reads are one tensor or a tuple of them (set_rw, register_lww)."""
    if isinstance(t, tuple):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            tp.same(a, b)
    else:
        tp.same(j, t)


def _filled(typ, dtype, seed, K, B):
    jst, fr = tp.jax_filled(seed=seed, K=K, B=B, dtype=dtype, name=typ)
    fr = fr.astype(np.int64 if dtype == torch.int64 else np.int32)
    return jst, tp.to_port(jst, typ), fr


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("typ", TYPES)
def test_append_overflow_and_active(typ, dtype, with_active):
    """B >> K: keys overflow their 8 lanes, and the overflow reports
    agree (with ``active``, masked-off ops neither land nor overflow)."""
    K, B = 40, 160
    jst, tst = _pair(typ, K, dtype)
    rng = np.random.default_rng(5)
    n_over = 0
    for s in tp.type_batches(typ, seed=2, K=K, B=B, rounds=3):
        active = rng.random(B) < 0.6 if with_active else None
        jst, jov = tp.jax_append(jst, s, active, name=typ)
        tst, tov = tp.port_append(tst, s, store, active, name=typ)
        tp.same(jov, tov)
        tp.assert_state_equal(jst, tst)
        n_over += int(tov.sum())
    assert n_over > 0
    tp.same(jst.valid2d, tst.valid2d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("typ", TYPES)
def test_gc_at_a_mixed_gst(typ, dtype):
    """A shard with a base, GC'd at a GST between the base and the
    frontier: some lanes fold and some stay.  The counter of an int32
    shard comes back int64 in both packages."""
    jst, tst, fr = _filled(typ, dtype, seed=14, K=64, B=128)
    gst = (np.asarray(jst.base_vc) + fr) // 2
    live = int(tst.valid.sum())
    want = tp.jfn(typ, "gc")(jst, jnp.asarray(gst))
    got = T[typ].gc(tst, torch.from_numpy(gst))
    tp.assert_state_equal(want, got)
    assert 0 < live - int(got.valid.sum()) < live
    if typ == "counter_pn":
        assert got.value.dtype == torch.int64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("typ", TYPES)
def test_read_above_the_base(typ, dtype):
    """The full read at the frontier (above the base) and at a VC
    between the base and the frontier."""
    jst, tst, fr = _filled(typ, dtype, seed=15, K=64, B=128)
    mid = (np.asarray(jst.base_vc) + fr + 1) // 2
    for vc in (fr, mid.astype(fr.dtype)):
        _same_read(tp.jfn(typ, "read")(jst, jnp.asarray(vc)),
                   T[typ].read(tst, torch.from_numpy(vc)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("typ", TYPES)
def test_read_keys(typ, dtype):
    jst, tst, fr = _filled(typ, dtype, seed=16, K=64, B=128)
    keys = np.array([0, 5, 5, 63, 17], dtype=np.int32)
    want = tp.jfn(typ, "read_keys")(jst, jnp.asarray(keys),
                                    jnp.asarray(fr))
    got = T[typ].read_keys(tst, torch.from_numpy(keys),
                           torch.from_numpy(fr))
    _same_read(want, got)
    full = T[typ].read(tst, torch.from_numpy(fr))
    rows = full if isinstance(full, tuple) else (full,)
    got = got if isinstance(got, tuple) else (got,)
    for f, g in zip(rows, got):
        assert torch.equal(f[torch.from_numpy(keys).long()], g)


@pytest.mark.parametrize("typ", TYPES)
def test_read_keys_past_the_end_raises(typ):
    """JAX clamps a key past the end; the port raises (the device plane
    only asks for keys it holds)."""
    tst = tp.tinit(typ, 16, torch.int32)
    with pytest.raises(IndexError):
        T[typ].read_keys(
            tst, torch.tensor([3, 16], dtype=torch.int32),
            torch.zeros(tp.D, dtype=torch.int32))


@pytest.mark.parametrize("typ", TYPES)
def test_purge_with_an_out_of_range_key(typ):
    """Indices past the end (padding) touch nothing; key K-1, which a
    clamped index would hit, keeps its lanes."""
    jst, tst, _ = _filled(typ, torch.int32, seed=17, K=48, B=96)
    keys = np.array([2, 46, 48, 9, 2, 4000], dtype=np.int32)
    live_last = int(tst.valid2d[47].sum())
    want = tp.jfn(typ, "purge_keys")(jst, jnp.asarray(keys))
    got = T[typ].purge_keys(tst, torch.from_numpy(keys))
    tp.assert_state_equal(want, got)
    assert not bool(got.valid2d[[2, 9, 46]].any())
    assert int(got.valid2d[47].sum()) == live_last > 0


@pytest.mark.parametrize("typ", TYPES)
def test_purge_with_no_key_in_range(typ):
    """Every index past the end: the state is as it was, in both."""
    jst, tst, _ = _filled(typ, torch.int32, seed=24, K=48, B=96)
    keys = np.array([48, 4000, 49], dtype=np.int32)
    before = tp.to_port(jst, typ)                # a copy: JAX donates jst
    want = tp.jfn(typ, "purge_keys")(jst, jnp.asarray(keys))
    got = T[typ].purge_keys(tst, torch.from_numpy(keys))
    tp.assert_state_equal(want, got)
    for f in fields(got):
        a, b = getattr(before, f.name), getattr(got, f.name)
        assert a == b if f.name == "n_lanes" else torch.equal(a, b)


def test_synth_rw_kinds_are_the_folds():
    """synth derives set_rw batches with the fold's kind codes."""
    assert (synth._RW_ADD, synth._RW_RMV, synth._RW_RESET) == (
        kernels.RW_ADD, kernels.RW_RMV, kernels.RW_RESET)


@pytest.mark.parametrize("typ", TYPES)
def test_append_in_which_nothing_lands(typ):
    """Every op masked off, then every op on a full ring: no row is kept,
    so every dropped row writes back what its target held, and the state
    is as it was."""
    jst, tst, _ = _filled(typ, torch.int32, seed=22, K=6, B=64)
    assert bool(tst.valid.all())            # every ring is full
    s = tp.type_batches(typ, seed=23, K=6, B=20, rounds=1)[0]
    for active in (np.zeros(20, dtype=bool), None):
        jst, jov = tp.jax_append(jst, s, active, name=typ)
        tst, tov = tp.port_append(tst, s, store, active, name=typ)
        tp.same(jov, tov)
        tp.assert_state_equal(jst, tst)
    assert bool(tov.all())
    fresh_j, fresh_t = _pair(typ, 6, torch.int32)
    fresh_j, _ = tp.jax_append(fresh_j, s, np.zeros(20, dtype=bool),
                               name=typ)
    fresh_t, _ = tp.port_append(fresh_t, s, store, np.zeros(20, dtype=bool),
                                name=typ)
    tp.assert_state_equal(fresh_j, fresh_t)
    assert not bool(fresh_t.valid.any())


def _grows(typ):
    if T[typ].slots:
        return [dict(n_keys=60), dict(n_slots=11), dict(n_dcs=10),
                dict(n_keys=50, n_slots=9, n_dcs=9), {}]
    return [dict(n_keys=60), dict(n_dcs=10), dict(n_keys=50, n_dcs=9), {}]


@pytest.mark.parametrize("typ,grow", [
    (t, g) for t in TYPES for g in _grows(t)],
    ids=[f"{t}-{'-'.join(g) or 'none'}"
         for t in TYPES for g in _grows(t)])
def test_grow(typ, grow):
    jst, tst, _ = _filled(typ, torch.int32, seed=18, K=40, B=80)
    want = tp.jfn(typ, "grow")(jst, **grow)
    got = T[typ].grow(tst, **grow)
    tp.assert_state_equal(want, got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("typ", TYPES)
def test_state_from_numpy_carries_a_jax_state(typ, dtype):
    """A JAX-built state carried across equals it field by field, and is
    a copy: the port's in-place append leaves the JAX arrays alone."""
    jst, tst, _ = _filled(typ, dtype, seed=19, K=32, B=64)
    assert type(tst) is T[typ].state
    tp.assert_state_equal(jst, tst)
    ops = np.array(jst.ops)
    s = tp.type_batches(typ, seed=20, K=32, B=64, rounds=1)[0]
    tp.port_append(tst, s, store, name=typ)
    np.testing.assert_array_equal(np.asarray(jst.ops), ops)


def _lww_filled(dtype):
    jst, tst, _ = _filled("register_lww", dtype, seed=21, K=48,
                          B=96)
    return jst, tst


@pytest.mark.parametrize("dtype", DTYPES)
def test_lww_reval(dtype):
    jst, tst = _lww_filled(dtype)
    n = int(max(np.asarray(jst.ops)[:, 2].max(),
                np.asarray(jst.base_val).max())) + 1
    remap = np.random.default_rng(3).permutation(n).astype(np.int64)
    remap[1] = -1
    tp.assert_state_equal(jstore.lww_reval(jst, remap),
                          store.lww_reval(tst, remap))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lww_retie(dtype):
    jst, tst = _lww_filled(dtype)
    shift = 20
    remap = np.array([2, 0, 1, 5], dtype=np.int64)
    tp.assert_state_equal(jstore.lww_retie(jst, remap, shift),
                          store.lww_retie(tst, remap, shift))


def test_lww_tie_takes_the_lowest_lane():
    """Two included ops tied on (ts, tie) in one key: the lower lane's
    value wins in both packages (torch.argmax takes no bool)."""
    jst = jstore.lww_shard_init(2, 4, 2, dtype=jnp.int64)
    tst = store.lww_shard_init(2, 4, 2, device="cpu")
    s = dict(key_idx=np.array([1, 1, 1], np.int32),
             lane_off=np.array([0, 1, 2], np.int32),
             ts=np.array([5, 7, 7]), tie=np.array([1, 3, 3]),
             val=np.array([10, 11, 12]), op_dc=np.zeros(3, np.int32),
             op_ct=np.array([1, 2, 3]), op_ss=np.zeros((3, 2), np.int64))
    typ = "register_lww"
    jst, _ = tp.jax_append(jst, s, name=typ)
    tst, _ = tp.port_append(tst, s, store, name=typ)
    vc = np.array([9, 0])
    want = jstore.lww_read(jst, jnp.asarray(vc))
    got = store.lww_read(tst, torch.from_numpy(vc))
    _same_read(want, got)
    assert got[2].tolist() == [-1, 11]


# ---------------------------------------------------------------------------
# remove-wins semantics (the cases of tests/unit/test_store.py), on both


def _rw_run(ops):
    """Drive one-op rwset appends (key, slot, kind, dot, obs_add, obs_rmv,
    dc, ct, ss), GC'ing where an op is the string "gc@<vc>", through both
    stores; return each read's presence from both."""
    jst = jstore.rwset_shard_init(4, 6, 2, 4, dtype=jnp.int64)
    tst = store.rwset_shard_init(4, 6, 2, 4, device="cpu")
    typ = "set_rw"
    out = []
    for op in ops:
        if isinstance(op, tuple) and op[0] == "gc":
            gst = np.asarray(op[1], dtype=np.int64)
            jst = jstore.rwset_gc(jst, jnp.asarray(gst))
            tst = store.rwset_gc(tst, torch.from_numpy(gst))
            continue
        if isinstance(op, tuple) and op[0] == "read":
            rv = np.asarray(op[1], dtype=np.int64)
            j = jkernels.rwset_present(*jstore.rwset_read(
                jst, jnp.asarray(rv)))
            t = kernels.rwset_present(*store.rwset_read(
                tst, torch.from_numpy(rv)))
            tp.same(j, t)
            out.append(t)
            continue
        key, slot, kind, dot, oa, orm, dc, ct, ss = op
        s = dict(key_idx=np.array([key], np.int32),
                 lane_off=np.zeros(1, np.int32),
                 elem_slot=np.array([slot], np.int32),
                 kind=np.array([kind], np.int32),
                 dot_dc=np.array([dot[0]], np.int32),
                 dot_seq=np.array([dot[1]], np.int64),
                 obs_add=np.asarray(oa, np.int64)[None],
                 obs_rmv=np.asarray(orm, np.int64)[None],
                 op_dc=np.array([dc], np.int32),
                 op_ct=np.array([ct], np.int64),
                 op_ss=np.asarray(ss, np.int64)[None])
        jst, jov = tp.jax_append(jst, s, name=typ)
        tst, tov = tp.port_append(tst, s, store, name=typ)
        tp.same(jov, tov)
        assert not bool(tov.any())
    tp.assert_state_equal(jst, tst)
    return out


Z = [0, 0, 0, 0]


def test_rwset_remove_wins_over_concurrent_add():
    """Concurrent add and remove of one element: absent.  A later add
    that observed the remove's dot resurrects it, and a GC fold of the
    concurrent pair leaves every read as it was."""
    add, rmv = kernels.RW_ADD, kernels.RW_RMV
    p = _rw_run([
        (0, 0, add, (0, 1), Z, Z, 0, 1, Z),
        (0, 0, rmv, (1, 1), Z, Z, 1, 1, Z),
        ("read", [1, 1, 0, 0]),
        (0, 0, add, (0, 2), Z, [0, 1, 0, 0], 0, 2, [1, 1, 0, 0]),
        ("read", [2, 1, 0, 0]),
        ("read", [1, 1, 0, 0]),
        ("gc", [1, 1, 0, 0]),
        ("read", [2, 1, 0, 0]),
    ])
    assert [bool(x[0, 0]) for x in p] == [False, True, False, True]


def test_rwset_reset_clears_both_planes():
    """A reset cancels every observed dot on both planes at each
    element's own slot; a concurrent (unobserved) add survives it, and a
    later add that observed nothing is visible only because the reset
    cleared the remove plane."""
    add, rmv, reset = kernels.RW_ADD, kernels.RW_RMV, kernels.RW_RESET
    p = _rw_run([
        (0, 0, add, (0, 1), Z, Z, 0, 1, Z),
        (0, 1, rmv, (1, 1), Z, Z, 1, 1, Z),
        (0, 0, add, (0, 2), Z, Z, 0, 2, [1, 0, 0, 0]),
        (0, 0, reset, (0, 0), [1, 0, 0, 0], Z, 2, 1, [1, 1, 0, 0]),
        (0, 1, reset, (0, 0), Z, [0, 1, 0, 0], 2, 1, [1, 1, 0, 0]),
        ("read", [2, 1, 1, 0]),
        (0, 1, add, (0, 3), Z, Z, 0, 3, [2, 1, 1, 0]),
        ("read", [3, 1, 1, 0]),
    ])
    assert bool(p[0][0, 0]) and not bool(p[0][0, 1])
    assert bool(p[1][0, 1])
