"""The port's RGA path (antidote_tpu_torch/mat/rga_kernel.py and
mat/rga_store.py) against the JAX package's, on the CPU: the one-shot
merge on synthetic and replica-simulated logs, the incremental base +
window store driven block by block with lagged folds (every state field
compared after each append and fold, both reads at the latest and at a
past snapshot), the window-full refusal, the host-side regrades, and a
document built by JAX carried across with state_from_numpy.  Equality
is exact: values and dtypes."""

from dataclasses import fields

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from antidote_tpu.mat import rga_kernel as jrk
from antidote_tpu.mat import rga_store as jrs
from antidote_tpu.mat.synth import rga_trace as jax_rga_trace
from antidote_tpu_torch.mat import rga_kernel as trk
from antidote_tpu_torch.mat import rga_store as trs
from antidote_tpu_torch.mat import synth as tsynth
from antidote_tpu_torch.mat.convert import state_from_numpy

LATEST = np.array([np.iinfo(np.int64).max // 2], np.int64)
MERGE_ARGS = ("ins_lamport", "ins_actor", "ref_lamport", "ref_actor", "elem",
              "valid", "del_lamport", "del_actor", "del_valid")


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def to_port(jst):
    return state_from_numpy(trs.RgaStoreState, jst, device="cpu")


def same_out(j, t):
    """Every output of a JAX call equals the port's (tuples or dicts)."""
    if isinstance(j, dict):
        assert sorted(j) == sorted(t)
        for k in j:
            tp.same(j[k], t[k])
        return
    if not isinstance(j, tuple):
        j, t = (j,), (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        tp.same(a, b)


# -- synth --------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(n_ops=300), dict(n_ops=1000, n_actors=3, p_delete=0.3),
    dict(n_ops=50, p_delete=0.0), dict(n_ops=64, n_actors=16, actor_bits=4),
])
def test_rga_trace_matches_jax(args):
    j = jax_rga_trace(np.random.default_rng(5), **args)
    t = tsynth.rga_trace(np.random.default_rng(5), **args)
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k])


@pytest.mark.parametrize("args", [dict(n_ops=10, n_actors=9, actor_bits=3),
                                  dict(n_ops=1 << 24, actor_bits=8)])
def test_rga_trace_asserts_like_jax(args):
    for gen in (jax_rga_trace, tsynth.rga_trace):
        with pytest.raises(AssertionError):
            gen(np.random.default_rng(0), **args)


# -- one-shot merge -----------------------------------------------------

def _trace_case(seed, n_ops, pad=0, junk_pad=False, no_deletes=False):
    f = tsynth.rga_trace(np.random.default_rng(seed), n_ops, n_actors=6)
    if pad:
        rng = np.random.default_rng(seed + 100)
        for k in ("ins_lamport", "ins_actor", "ref_lamport", "ref_actor",
                  "elem"):
            extra = (rng.integers(0, 50, pad) if junk_pad
                     else np.zeros(pad)).astype(np.int32)
            f[k] = np.concatenate([f[k], extra])
        f["valid"] = np.concatenate([f["valid"], np.zeros(pad, bool)])
    if no_deletes:
        f["del_valid"] = np.zeros_like(f["del_valid"])
    return f


def _replica_case(seed, n_steps, pad=0, n_replicas=4):
    ins, dels = tp.replica_trace(np.random.default_rng(seed), n_steps,
                                 n_replicas=n_replicas)
    return tp.merge_fields(ins, dels, pad=pad, del_pad=pad)


_HEAD = [(i + 1, 0, i, 0, 100 + i) for i in range(5)]
MERGE_CASES = {
    "trace": lambda: _trace_case(0, 300),
    "trace_padded": lambda: _trace_case(1, 300, pad=13),
    "trace_junk_padding": lambda: _trace_case(2, 200, pad=9, junk_pad=True),
    "trace_no_deletes": lambda: _trace_case(3, 200, no_deletes=True),
    "replica": lambda: _replica_case(0, 200),
    "replica_padded": lambda: _replica_case(1, 200, pad=7),
    "replica_6": lambda: _replica_case(7, 300, n_replicas=6),
    "duplicate_delivery": lambda: tp.merge_fields(
        [(1, 0, 0, 0, 100), (1, 0, 0, 0, 100), (2, 0, 1, 0, 101),
         (2, 1, 1, 0, 102), (2, 1, 1, 0, 102)], [(1, 0), (1, 0)]),
    "unresolvable_subtree": lambda: tp.merge_fields(
        _HEAD + [(50, 1, 40, 1, 201), (51, 1, 50, 1, 202),
                 (52, 2, 51, 1, 203)], [(51, 1), (99, 3)]),
    "equal_lamport_heads": lambda: tp.merge_fields(
        [(1, 0, 0, 0, 10), (1, 1, 0, 0, 20), (1, 2, 0, 0, 30),
         (2, 0, 1, 1, 40)], []),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_matches_jax(case):
    f = MERGE_CASES[case]()
    jargs = [_j(f[k]) for k in MERGE_ARGS]
    targs = [_t(f[k]) for k in MERGE_ARGS]
    same_out(jrk.rga_merge(*jargs), trk.rga_merge(*targs))
    same_out(jrk.rga_merge_full(*jargs), trk.rga_merge_full(*targs))


def test_merge_other_actor_bits():
    f = tsynth.rga_trace(np.random.default_rng(9), 200, n_actors=12,
                         actor_bits=4)
    jargs = [_j(f[k]) for k in MERGE_ARGS]
    targs = [_t(f[k]) for k in MERGE_ARGS]
    same_out(jrk.rga_merge_full(*jargs, actor_bits=4),
             trk.rga_merge_full(*targs, actor_bits=4))


# -- the incremental store ----------------------------------------------

def vc_cols(stamps):
    """Single-DC commit-VC columns from scalar stamps (dc 0, commit time
    = stamp, empty snapshot), as host arrays."""
    s = np.asarray(stamps, dtype=np.int64)
    return (np.zeros(len(s), np.int32), s, np.zeros((len(s), 1), np.int64))


def block_cols(tr, ins, dl, fed_i, fed_d, n):
    """(insert columns, delete columns) of one block: insert i is
    stamped i+1, delete j n+j+1 (after every insert)."""
    bi, bd = ins.stop - ins.start, dl.stop - dl.start
    return ((tr["ins_lamport"][ins], tr["ins_actor"][ins],
             tr["ref_lamport"][ins], tr["ref_actor"][ins], tr["elem"][ins],
             *vc_cols(np.arange(fed_i + 1, fed_i + bi + 1))),
            (tr["del_lamport"][dl], tr["del_actor"][dl],
             *vc_cols(np.arange(n + fed_d + 1, n + fed_d + bd + 1))))


def append_both(route, jst, tst, ins_cols, del_cols):
    """One block through the same append of both packages; returns both
    (state, ok) pairs after checking they agree."""
    if route == "direct":
        j = jrs.rga_append(jst, *map(_j, ins_cols), *map(_j, del_cols))
        t = trs.rga_append(tst, *map(_t, ins_cols), *map(_t, del_cols))
    else:
        fn = "rga_append_" + route
        j = getattr(jrs, fn)(jst, ins_cols, del_cols)
        t = getattr(trs, fn)(tst, ins_cols, del_cols)
    assert t[1].shape == () and t[1].dtype == torch.bool
    tp.same(j[1], t[1])
    tp.assert_state_equal(j[0], t[0])
    return j, t


def fold_both(jst, tst, gst):
    jst = jrs.rga_fold_host(jst, gst)
    tst = trs.rga_fold_host(tst, gst)
    tp.assert_state_equal(jst, tst)
    return jst, tst


def reads_equal(jst, tst, rv):
    """Both reads of both packages agree at ``rv``; returns the port's
    visible document."""
    same_out(jrs.rga_read(jst, _j(rv)), trs.rga_read(tst, _t(rv)))
    j = jrs.rga_read_doc(jst, _j(rv))
    t = trs.rga_read_doc(tst, _t(rv))
    same_out(j, t)
    return t[0][: int(t[1])]


def oneshot_doc(tr, n_ins, n_del):
    """The port's one-shot merge of the first n_ins inserts and n_del
    deletes: the document the store must materialize."""
    f = dict(tr)
    f["valid"] = np.arange(len(tr["ins_lamport"])) < n_ins
    f["del_valid"] = tr["del_valid"] & (np.arange(len(tr["del_valid"]))
                                        < n_del)
    doc, n_vis, _, _ = trk.rga_merge(*(_t(f[k]) for k in MERGE_ARGS))
    return doc[: int(n_vis)]


def drive(seed, n_ops, block, fold_every, route, nw=None, pb=256):
    """tests/unit/test_rga_store.py's drive through both packages: feed
    the trace block-wise (deletes from the second half on), fold at a
    frontier lagging one block, and after every step compare the states
    and both reads at the latest and at a strict-past snapshot.  A small
    ``pb`` makes the folds grow the base."""
    tr = tsynth.rga_trace(np.random.default_rng(seed), n_ops, n_actors=6)
    n, m = len(tr["ins_lamport"]), len(tr["del_lamport"])
    # a padded delete block takes 64 lanes whatever its logical count
    shape = dict(pb=pb, nw=nw or max(64, 2 * block), md=m + 65)
    jst = jrs.rga_store_init(**shape)
    tst = trs.rga_store_init(**shape, device="cpu")
    tp.assert_state_equal(jst, tst)
    fed_i = fed_d = step = 0
    while fed_i < n or fed_d < m:
        bi = min(block, n - fed_i)
        bd = min(max(1, block // 8), m - fed_d) if fed_i >= n // 2 else 0
        cols = block_cols(tr, slice(fed_i, fed_i + bi),
                          slice(fed_d, fed_d + bd), fed_i, fed_d, n)
        (jst, jok), (tst, tok) = append_both(route, jst, tst, *cols)
        if not bool(tok):
            jst, tst = fold_both(jst, tst, fed_i)
            (jst, jok), (tst, tok) = append_both(route, jst, tst, *cols)
            assert bool(tok)
        prev_i = fed_i
        fed_i += bi
        fed_d += bd
        step += 1
        if step % fold_every == 0:
            jst, tst = fold_both(jst, tst, max(fed_i - block, 0))
        doc = reads_equal(jst, tst, LATEST)
        assert torch.equal(doc, oneshot_doc(tr, fed_i, fed_d))
        if prev_i:
            reads_equal(jst, tst, np.array([prev_i], np.int64))
    jst, tst = fold_both(jst, tst, n + m + 1)
    assert int(tst.wn) == 0 and int(tst.dn) == 0
    assert torch.equal(reads_equal(jst, tst, LATEST),
                       oneshot_doc(tr, n, m))


@pytest.mark.parametrize("seed,n_ops,block,fold_every,route,nw,pb", [
    (0, 240, 32, 2, "direct", None, 8),
    (1, 240, 32, 2, "padded", 256, 256),
    (2, 240, 32, 2, "coalesced", 128, 256),
    (11, 120, 24, 10**9, "coalesced", 256, 256),
    (12, 160, 16, 1, "padded", None, 256),
])
def test_store_drive_matches_jax(seed, n_ops, block, fold_every, route, nw,
                                 pb):
    drive(seed, n_ops, block, fold_every, route, nw, pb)


def test_padded_equals_coalesced():
    tr = tsynth.rga_trace(np.random.default_rng(4), 200, n_actors=5)
    n = len(tr["ins_lamport"])
    states = {r: trs.rga_store_init(64, 256, 128, device="cpu")
              for r in ("padded", "coalesced")}
    for lo, hi, dlo, dhi in ((0, 40, 0, 0), (40, 97, 0, 5), (97, 170, 5, 30)):
        cols = block_cols(tr, slice(lo, hi), slice(dlo, dhi), lo, dlo, n)
        oks = {}
        for r in states:
            states[r], oks[r] = getattr(trs, "rga_append_" + r)(
                states[r], *cols)
        assert bool(oks["padded"]) and bool(oks["coalesced"])
        a, b = states["padded"], states["coalesced"]
        for f in fields(a):
            if f.name != "actor_bits":
                x, y = getattr(a, f.name), getattr(b, f.name)
                assert x.dtype == y.dtype and torch.equal(x, y), f.name


def _jax_doc(seed=3, n_ops=200, pb=64, nw=128, md=32, fold_at=100,
             n_actors=4):
    """A JAX-built document: inserts [0, fold_at) folded into the base,
    the rest and the first deletes left in the window.  Returns (state,
    trace, the block columns left to append)."""
    tr = jax_rga_trace(np.random.default_rng(seed), n_ops,
                       n_actors=n_actors)
    n, m = len(tr["ins_lamport"]), len(tr["del_lamport"])
    st = jrs.rga_store_init(pb, nw, md)
    for ins, dl, fed_i in ((slice(0, fold_at), slice(0, 0), 0),
                           (slice(fold_at, n), slice(0, m // 2), fold_at)):
        ins_cols, del_cols = block_cols(tr, ins, dl, fed_i, 0, n)
        st, ok = jrs.rga_append(st, *map(_j, ins_cols), *map(_j, del_cols))
        assert bool(ok)
        if fed_i == 0:
            st = jrs.rga_fold_host(st, fold_at)
    return st, tr


@pytest.mark.parametrize("window", ["inserts", "deletes"])
def test_full_window_refuses_and_keeps_state(window):
    jst, tr = _jax_doc(nw=112, md=16, fold_at=60) if window == "inserts" \
        else _jax_doc(nw=128, md=16)
    tst = to_port(jst)
    before = {f.name: getattr(tst, f.name).clone() for f in fields(tst)
              if f.name != "actor_bits"}
    n = len(tr["ins_lamport"])
    cols = block_cols(tr, slice(0, 12), slice(0, 12), 0, 0, n)
    (jst, jok), (tst, tok) = append_both("direct", jst, tst, *cols)
    assert not bool(tok)
    for name, t in before.items():
        assert torch.equal(getattr(tst, name), t), name
    tp.assert_state_equal(jst, tst)


@pytest.mark.parametrize("grow", [
    dict(pb=256), dict(nw=512, md=64), dict(n_dcs=3),
    dict(pb=128, nw=256, md=40, n_dcs=2), dict(pb=8), dict()])
def test_grow_matches_jax(grow):
    jst, _ = _jax_doc()
    tst = to_port(jst)
    jg, tg = jrs.rga_grow(jst, **grow), trs.rga_grow(tst, **grow)
    tp.assert_state_equal(jg, tg)
    for rv in (LATEST, np.array([150], np.int64)):
        reads_equal(jg, tg, np.pad(rv, (0, tg.d - 1)))


def test_remap_actors_matches_jax():
    jst, _ = _jax_doc(n_actors=5)
    tst = to_port(jst)
    perm = np.arange(256, dtype=np.int32)
    perm[1:5] = [4, 2, 1, 3]
    jst = jrs.rga_remap_actors(jst, perm)
    tst = trs.rga_remap_actors(tst, perm)
    tp.assert_state_equal(jst, tst)
    reads_equal(jst, tst, LATEST)


def test_fold_host_grows_the_base():
    jst, tr = _jax_doc(pb=16, nw=256, fold_at=10)
    tst = to_port(jst)
    assert int(tst.bn) + int(tst.wn) > tst.pb
    jst, tst = fold_both(jst, tst, 120)
    assert tst.pb == 256 and int(tst.bn) > 16
    reads_equal(jst, tst, LATEST)


def test_fold_matches_jax():
    jst, _ = _jax_doc()
    tst = to_port(jst)
    gst = np.array([140], np.int64)
    jst, jn = jrs.rga_fold(jst, _j(gst))
    tst, tn = trs.rga_fold(tst, _t(gst))
    tp.same(jn, tn)
    tp.assert_state_equal(jst, tst)


def test_jax_document_continues_in_the_port():
    """A document JAX built, carried across, goes on in both packages:
    more blocks and lagged folds, states and reads equal throughout."""
    jst, tr = _jax_doc(n_ops=400, pb=128, nw=512, md=128, fold_at=150)
    tst = to_port(jst)
    assert tst.actor_bits == 8 and isinstance(tst.actor_bits, int)
    assert tst.ckey.dtype == torch.int64 and tst.blive.dtype == torch.bool
    tp.assert_state_equal(jst, tst)
    n, m = len(tr["ins_lamport"]), len(tr["del_lamport"])
    fed_d = m // 2
    for step, dhi in enumerate((fed_d + 10, fed_d + 25, m)):
        cols = block_cols(tr, slice(0, 0), slice(fed_d, dhi), n, fed_d, n)
        (jst, _), (tst, tok) = append_both("coalesced", jst, tst, *cols)
        assert bool(tok)
        fed_d = dhi
        jst, tst = fold_both(jst, tst, n + fed_d - 5 * step)
        reads_equal(jst, tst, LATEST)
    jst, tst = fold_both(jst, tst, n + m + 1)
    assert torch.equal(reads_equal(jst, tst, LATEST), oneshot_doc(tr, n, m))
