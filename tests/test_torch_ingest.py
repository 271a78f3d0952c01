"""antidote_tpu_torch.mat.ingest against antidote_tpu.mat.ingest: the
packed layout, the host packer and the packed append, for every entry of
``PACKED_PERMS``, held against the JAX package's packed path and its
per-column appends (as tests/unit/test_ingest.py holds them)."""

from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.mat import ingest as jingest
from antidote_tpu.mat import store as jstore
from antidote_tpu.mat.device_plane import _pack_rows
from antidote_tpu_torch.mat import ingest, store

#: each packed append's plane row tags (device_plane ``_row_cols``) and
#: its shard type
ROW_COLS = {
    "orset_append": (("s", "s", "s", "s", "vv", "s", "s", "vv"), "set_aw"),
    "rwset_append": (("s", "s", "s", "s", "vv", "vv", "s", "s", "vv"),
                     "set_rw"),
    "counter_append": (("s", "s", "s", "vv"), "counter_pn"),
    "lww_append": (("s", "s", "s", "s", "s", "vv"), "register_lww"),
    "setgo_append": (("s", "s", "s", "vv"), "set_go"),
}
K, LANES, E_, D_ = 8, 4, 4, 4


def _rows(rng, n, cols, k=K):
    """Decoded plane rows: (key, *fields); scalars small enough to be
    valid slots, DCs and kinds, "vv" fields one to three (col, seq)
    pairs, repeated columns included."""
    rows = []
    for i in range(n):
        row = [int(rng.integers(0, k))]
        for tag in cols:
            if tag == "vv":
                row.append([(int(rng.integers(0, D_)),
                             int(rng.integers(1, 40)))
                            for _ in range(int(rng.integers(1, 4)))])
            else:
                row.append(int(rng.integers(0, 3)))
        row[-2 if cols[-1] == "vv" else -1] = 10 + i   # op_ct
        rows.append(tuple(row))
    return rows


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 256, 257, 5000])
def test_bucket(n):
    assert ingest.bucket(n) == jingest.bucket(n)
    assert ingest._MIN_BUCKET == jingest._MIN_BUCKET


@pytest.mark.parametrize("config", [
    None, SimpleNamespace(mat_ingest=False, mat_coalesce_us=5,
                          mat_coalesce_rows=9)])
def test_ingest_from_config(config):
    assert asdict(ingest.ingest_from_config(config)) == asdict(
        jingest.ingest_from_config(config))


def test_perms_and_names():
    """The layout table is the JAX one, and each port append finds its
    permutation by name."""
    assert ingest.PACKED_PERMS == jingest.PACKED_PERMS
    for name, perm in ingest.PACKED_PERMS.items():
        assert ingest.perm_for(getattr(store, name)) == perm
        assert ingest.perm_for(getattr(store, name)) == jingest.perm_for(
            getattr(jstore, name))
    assert ingest.perm_for(store.orset_read) is None


@pytest.mark.parametrize("name", sorted(ROW_COLS))
def test_pack_rows_matches_jax(name):
    cols, _ = ROW_COLS[name]
    rows = _rows(np.random.default_rng(1), 70, cols)
    perm = ingest.PACKED_PERMS[name]
    assert ingest.packed_width(cols, D_) == jingest.packed_width(cols, D_)
    tp.same(jingest.pack_rows(rows, K, D_, cols, perm),
            torch.from_numpy(ingest.pack_rows(rows, K, D_, cols, perm)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_split_packed(dtype):
    packed = ingest.pack_rows(_rows(np.random.default_rng(2), 9,
                                    ROW_COLS["counter_append"][0]),
                              K, D_, ROW_COLS["counter_append"][0],
                              ingest.PACKED_PERMS["counter_append"])
    want = jingest.split_packed(jnp.asarray(packed), tp.JDT[dtype])
    got = ingest.split_packed(torch.from_numpy(packed), dtype)
    for w, g in zip(want, got):
        tp.same(w, g)


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", sorted(ROW_COLS))
def test_packed_append_matches_per_column(name, dtype, with_active):
    """Two flushes of rows that overflow some 4-lane rings: the port's
    packed append equals the JAX per-column append of the same rows (and
    the JAX packed append), overflow of every row, padding included."""
    cols, tname = ROW_COLS[name]
    perm = ingest.PACKED_PERMS[name]
    rng = np.random.default_rng(3)
    dims = dict(n_lanes=LANES, n_slots=E_, n_dcs=D_)
    j_col = tp.jinit(tname, K, dtype, **dims)
    j_pack = tp.jinit(tname, K, dtype, **dims)
    tst = tp.tinit(tname, K, dtype, **dims)
    n_over = 0
    for _ in range(2):
        rows = _rows(rng, 24, cols)
        packed = ingest.pack_rows(rows, K, D_, cols, perm)
        B = packed.shape[0]
        active = rng.random(B) < 0.7 if with_active else None
        ki, lo, arrays = _pack_rows(rows, K, D_, cols)
        kw = {} if active is None else dict(active=jnp.asarray(active))
        j_col, jov = getattr(jstore, name)(
            j_col, jnp.asarray(ki), jnp.asarray(lo),
            *(jnp.asarray(a) for a in arrays), **kw)
        j_pack, jov_p = jingest.packed_append(j_pack, jnp.asarray(packed),
                                              **kw)
        tst, tov = ingest.packed_append(
            tst, torch.from_numpy(packed),
            None if active is None else torch.from_numpy(active))
        tp.same(jov, tov)
        tp.same(jov_p, tov)
        tp.assert_state_equal(j_col, tst)
        tp.assert_state_equal(j_pack, tst)
        n_over += int(tov[:len(rows)].sum())
    assert n_over > 0


def test_packed_overflow_reported():
    """Three same-key ops into a 2-lane ring: the third is reported and
    not stored (tests/unit/test_ingest.py's case)."""
    st = store.counter_shard_init(2, 2, 4, device="cpu")
    rows = [(0, 1, 0, 10 + i, [(0, 1)]) for i in range(3)]
    packed = ingest.pack_rows(rows, 2, 4, ("s", "s", "s", "vv"),
                              ingest.PACKED_PERMS["counter_append"])
    st, ov = ingest.packed_append(st, torch.from_numpy(packed))
    assert ov[:3].tolist() == [False, False, True]
    assert int(st.count[0]) == 2


def _ingest_counters(reg):
    return ([reg.ingest_flushes.value(kind=k)
             for k in jingest.INGEST_FLUSH_KINDS]
            + [reg.ingest_dispatches.value(), reg.ingest_coalesced_ops.value(),
               reg.ingest_h2d_bytes.value()])


def test_counters_move_as_in_jax():
    """note_flush, note_dispatch and the RGA coalesced append's dispatch
    move the stats registry's INGEST_* counters as the JAX package's
    move its own, for the same calls."""
    from antidote_tpu import stats as jstats
    from antidote_tpu.mat import rga_store as jrga
    from antidote_tpu_torch import stats as tstats
    from antidote_tpu_torch.mat import rga_store as trga

    assert ingest.INGEST_FLUSH_KINDS == jingest.INGEST_FLUSH_KINDS
    before = [_ingest_counters(r) for r in (jstats.registry, tstats.registry)]
    for mod in (jingest, ingest):
        for kind in ingest.INGEST_FLUSH_KINDS[::-1] + ("rows", "gc"):
            mod.note_flush(kind)
        mod.note_dispatch(17, 4096)
        mod.note_dispatch(3, 512, replicas=4)
    ins = (np.arange(1, 6, dtype=np.int32), np.ones(5, np.int32),
           np.zeros(5, np.int32), np.zeros(5, np.int32),
           np.arange(5, dtype=np.int32), np.zeros(5, np.int32),
           np.arange(1, 6, dtype=np.int64), np.zeros((5, 1), np.int64))
    dels = (np.asarray([2], np.int32), np.ones(1, np.int32),
            np.zeros(1, np.int32), np.asarray([6], np.int64),
            np.zeros((1, 1), np.int64))
    jrga.rga_append_coalesced(jrga.rga_store_init(64, 64, 64), ins, dels)
    trga.rga_append_coalesced(trga.rga_store_init(64, 64, 64, device="cpu"),
                              ins, dels)
    after = [_ingest_counters(r) for r in (jstats.registry, tstats.registry)]
    moved = [[a - b for a, b in zip(x, y)] for x, y in zip(after, before)]
    assert moved[1] == moved[0]
    assert moved[1][len(ingest.INGEST_FLUSH_KINDS)] == 3   # dispatches
    reg = tstats.registry
    assert reg.ingest_ops_per_dispatch.value() == \
        reg.ingest_coalesced_ops.value() / reg.ingest_dispatches.value()
