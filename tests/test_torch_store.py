"""antidote_tpu_torch.mat.store against antidote_tpu.mat.store (its OR-Set
section): the same seeded synth batches through both stores, exact
equality of state, overflow and reads."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.mat import store as jstore
from antidote_tpu_torch.mat import store

DTYPES = [torch.int32, torch.int64]


_same = tp.same


def _pair(K, dtype):
    jst = jstore.orset_shard_init(K, n_lanes=tp.L, n_slots=tp.E,
                                  n_dcs=tp.D, dtype=tp.JDT[dtype])
    tst = store.orset_shard_init(K, tp.L, tp.E, tp.D, dtype=dtype,
                                 device="cpu")
    tp.assert_state_equal(jst, tst)
    return jst, tst


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_active", [False, True])
def test_append_overflow_and_views(dtype, with_active):
    """B >> K: keys overflow their 8 lanes, and the overflow reports
    agree (with ``active``, masked-off ops neither land nor overflow)."""
    K = 40
    jst, tst = _pair(K, dtype)
    rng = np.random.default_rng(5)
    n_over = 0
    for s in tp.batches(seed=2, K=K, B=160, rounds=3):
        active = rng.random(160) < 0.6 if with_active else None
        jst, jov = tp.jax_append(jst, s, active)
        tst, tov = tp.port_append(tst, s, store, active)
        _same(jov, tov)
        tp.assert_state_equal(jst, tst)
        n_over += int(tov.sum())
    assert n_over > 0
    for view in ("count", "elem_slot", "is_add", "dot_dc", "dot_seq",
                 "op_dc", "op_ct", "obs_vv", "op_ss", "valid2d"):
        _same(getattr(jst, view), getattr(tst, view))


def test_free_lanes():
    rng = np.random.default_rng(8)
    valid2d = rng.random((30, tp.L)) < 0.5
    key_idx = rng.integers(0, 30, size=64).astype(np.int32)
    lane_off = jstore.batch_lane_offsets(key_idx)
    want = jstore._free_lanes(jnp.asarray(valid2d), jnp.asarray(key_idx),
                              jnp.asarray(lane_off))
    got = store._free_lanes(torch.from_numpy(valid2d),
                            torch.from_numpy(key_idx),
                            torch.from_numpy(lane_off))
    for w, g in zip(want, got):
        _same(w, g)
    assert got[0].dtype == torch.int32


@pytest.mark.parametrize("key_idx", [
    np.array([3, 1, 3, 0, 7, 3, 9, 1], dtype=np.int32),
    np.zeros(0, dtype=np.int32)])
def test_batch_lane_offsets(key_idx):
    np.testing.assert_array_equal(jstore.batch_lane_offsets(key_idx),
                                  store.batch_lane_offsets(key_idx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [False, True, "auto", "hybrid"])
def test_gc_full_and_reads(dtype, fused):
    """A store with a base and a mixed GST: orset_gc_full on every path
    equals the JAX fold and leaves ``st`` usable; every read path equals
    the JAX read before and after the fold."""
    jst, fr = tp.jax_filled(seed=13, K=72, B=144, dtype=dtype)
    tst = tp.to_port(jst)
    fr = fr.astype(np.int64 if dtype == torch.int64 else np.int32)
    want_read = jstore.orset_read(jst, jnp.asarray(fr))
    _same(want_read, store.orset_read_full(tst, torch.from_numpy(fr), fused))
    gst = (np.asarray(jst.base_vc) + fr) // 2
    snapshot = {f: getattr(tst, f).clone()
                for f in ("dots", "base_vc", "has_base", "ops", "valid")}
    got = store.orset_gc_full(tst, torch.from_numpy(gst), fused=fused)
    for f, t in snapshot.items():           # st was not consumed
        assert torch.equal(getattr(tst, f), t), f
    _same(want_read, store.orset_read(tst, torch.from_numpy(fr)))
    want = jstore.orset_gc(jst, jnp.asarray(gst))
    tp.assert_state_equal(want, got)
    _same(jstore.orset_read(want, jnp.asarray(fr)),
          store.orset_read_full(got, torch.from_numpy(fr), fused))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gc(dtype):
    jst, fr = tp.jax_filled(seed=14, K=64, B=128, dtype=dtype)
    tst = tp.to_port(jst)
    gst = (np.asarray(jst.base_vc) + fr) // 2
    got = store.orset_gc(tst, torch.from_numpy(gst))
    tp.assert_state_equal(jstore.orset_gc(jst, jnp.asarray(gst)), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_read_keys(dtype):
    jst, fr = tp.jax_filled(seed=15, K=64, B=128, dtype=dtype)
    tst = tp.to_port(jst)
    keys = np.array([0, 5, 5, 63, 17], dtype=np.int32)
    _same(jstore.orset_read_keys(jst, jnp.asarray(keys), jnp.asarray(fr)),
          store.orset_read_keys(tst, torch.from_numpy(keys),
                                torch.from_numpy(fr)))


def test_purge_keys():
    """Indices past the end (padding) are dropped."""
    jst, _ = tp.jax_filled(seed=16, K=48, B=96)
    tst = tp.to_port(jst)
    keys = np.array([2, 47, 48, 9, 2], dtype=np.int32)
    want = jstore.orset_purge_keys(jst, jnp.asarray(keys))
    tp.assert_state_equal(
        want, store.orset_purge_keys(tst, torch.from_numpy(keys)))


@pytest.mark.parametrize("grow", [dict(n_keys=60), dict(n_slots=11),
                                  dict(n_dcs=10),
                                  dict(n_keys=50, n_slots=9, n_dcs=9), {}])
def test_grow(grow):
    jst, _ = tp.jax_filled(seed=17, K=40, B=80)
    tst = tp.to_port(jst)
    tp.assert_state_equal(jstore.orset_grow(jst, **grow),
                          store.orset_grow(tst, **grow))
