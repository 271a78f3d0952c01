"""The port's superstep (antidote_tpu_torch.entry) against the JAX store
driven step by step, starting from a state the JAX package built and
carried across with mat.convert.state_from_numpy; the RGA document's
step against the JAX RGA store's same calls over a 3-DC history; plus
the package's import isolation and its refusal to run on the CPU
unasked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.clocks import dense as jdense
from antidote_tpu.mat import rga_store as jrga
from antidote_tpu.mat import store as jstore
from antidote_tpu_torch import entry
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.interdc import DataCenter, InProcBus, dep
from antidote_tpu_torch.mat import (convert, device_plane, rga_store,
                                    store)
from antidote_tpu_torch.txn.node import Node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_superstep(jst, b, gc):
    """__graft_entry__._step's append / GC at the batch frontier / read,
    with the batch's lane offsets (never _step itself, whose zero
    offsets collide same-key ops)."""
    jst, ov = tp.jax_append(jst, b)
    frontier = jnp.max(jdense.commit_vc(
        jnp.asarray(b["op_ss"]), jnp.asarray(b["op_dc"]),
        jnp.asarray(b["op_ct"])), axis=0)
    if gc:
        jst = jstore.orset_gc(jst, frontier)
    return jst, jstore.orset_read(jst, frontier), ov


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("fused", [False, "auto", "hybrid"])
def test_superstep_matches_jax(dtype, fused):
    K, B = 96, 320
    jst, _ = tp.jax_filled(seed=21, K=K, B=B, rounds=2, gc_at=0,
                           dtype=dtype)
    tst = tp.to_port(jst)
    tp.assert_state_equal(jst, tst)
    rng = np.random.default_rng(22)
    clock = np.full(tp.N_DCS, 10_000, dtype=np.int32)
    n_over = 0
    for i in range(5):
        b = entry.make_batch(rng, K, B, tp.D, tp.N_DCS, clock,
                             device="cpu")
        gc = i % 2 == 1
        jst, jpres, jov = _jax_superstep(
            jst, {k: v.numpy() for k, v in b.items()}, gc)
        tst, tpres, tov = entry.superstep(tst, b, gc=gc, fused=fused)
        np.testing.assert_array_equal(np.asarray(jov), tov.numpy())
        np.testing.assert_array_equal(np.asarray(jpres), tpres.numpy())
        tp.assert_state_equal(jst, tst)
        n_over += int(tov.sum())
    assert n_over > 0


def test_entry_runs_like_the_jax_step():
    fn, (st, batch) = entry.entry(K=128, B=256, device="cpu")
    st, present, overflow = fn(st, batch)
    jst = jstore.orset_shard_init(128, n_lanes=8, n_slots=8, n_dcs=8,
                                  dtype=jnp.int32)
    jst, jpres, jov = _jax_superstep(
        jst, {k: v.numpy() for k, v in batch.items()}, gc=True)
    np.testing.assert_array_equal(np.asarray(jpres), present.numpy())
    tp.assert_state_equal(jst, st)
    assert present.dtype == torch.bool and present.shape == (128, 8)


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2])
def test_rga_step_matches_jax(seed):
    """``entry.rga_step`` makes the JAX RGA store's calls in the same
    order (``rga_append_coalesced``, ``rga_fold_host`` at the GST when
    one is given, ``rga_read`` at the snapshot): every output and the
    whole state equal after each step, from a base both built alike,
    over a 3-DC history small enough for the JAX store's jit on the
    CPU (a base of ~500 ops, then 16 steps of 64, a fold every 4th)."""
    chunks, steps = tp.dc_history(seed)
    shape = dict(pb=1024, nw=512, md=256, n_dcs=3, actor_bits=8)
    jst = jrga.rga_store_init(**shape)
    tst = rga_store.rga_store_init(**shape, device="cpu")
    for ins, dl, vc in chunks:
        jst, _ = jrga.rga_append_coalesced(jst, ins, dl)
        jst = jrga.rga_fold_host(jst, vc)
        tst, _ = rga_store.rga_append_coalesced(tst, ins, dl)
        tst = rga_store.rga_fold_host(tst, vc)
    tp.assert_state_equal(jst, tst)
    folds = 0
    for ins, dl, rv, gst in steps:
        jst, jok = jrga.rga_append_coalesced(jst, ins, dl)
        if gst is not None:
            jst = jrga.rga_fold_host(jst, gst)
            folds += 1
        jout = jrga.rga_read(jst, jnp.asarray(rv))
        tst, tok, tout = entry.rga_step(tst, ins, dl, torch.from_numpy(rv),
                                        gst)
        tp.same(jok, tok)
        assert bool(tok)
        assert len(jout) == len(tout) == 5
        for a, b in zip(jout, tout):
            tp.same(a, b)
        tp.assert_state_equal(jst, tst)
    # the window held the newest blocks past the read's snapshot
    assert folds == 4 and int(tst.wn) > 0 and int(tout[4]) < \
        int(tst.bn) + int(tst.wn)


def test_state_from_numpy_copies():
    jst, _ = tp.jax_filled(seed=23, K=16, B=32, rounds=1)
    ops = np.array(jst.ops)
    src = dict(dots=jst.dots, base_vc=jst.base_vc, has_base=jst.has_base,
               ops=ops, valid=jst.valid, n_lanes=jst.n_lanes)
    st = convert.state_from_numpy(store.OrsetShardState, src, device="cpu")
    st.ops.zero_()
    assert ops.any()
    assert st.ops.dtype == torch.int32 and st.valid.dtype == torch.bool


def test_import_leaves_jax_out():
    code = ("import sys, antidote_tpu_torch, antidote_tpu_torch.entry, "
            "antidote_tpu_torch.mat.convert, antidote_tpu_torch._cuda, "
            "antidote_tpu_torch.mat.ingest, antidote_tpu_torch.mat.synth, "
            "antidote_tpu_torch.mat.rga_kernel, "
            "antidote_tpu_torch.mat.rga_store, "
            "antidote_tpu_torch.mat.device_plane, "
            "antidote_tpu_torch.mat.materializer, antidote_tpu_torch.crdt, "
            "antidote_tpu_torch.config, antidote_tpu_torch.stats, "
            "antidote_tpu_torch.obs.prof, antidote_tpu_torch.interdc.dep, "
            "antidote_tpu_torch.interdc.synth, antidote_tpu_torch.meta, "
            "antidote_tpu_torch.oplog, antidote_tpu_torch.txn, "
            "antidote_tpu_torch.api, antidote_tpu_torch.txn.node, "
            "antidote_tpu_torch.mat.serve, antidote_tpu_torch.oplog.convert, "
            "antidote_tpu_torch.interdc, antidote_tpu_torch.interdc.dc, "
            "antidote_tpu_torch.bcounter, antidote_tpu_torch.obs.pipeline, "
            "antidote_tpu_torch.obs.slo, antidote_tpu_torch.obs.fleet, "
            "antidote_tpu_torch.meta.device_stable; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'antidote_tpu.')) or "
            "m == 'antidote_tpu']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("call", [
    lambda: store.orset_shard_init(4, 8, 8, 8),
    lambda: entry.entry(K=4, B=4),
    lambda: entry.make_batch(np.random.default_rng(0), 4, 4, 8, 3,
                             np.zeros(3, np.int32)),
    lambda: convert.state_from_numpy(store.OrsetShardState, dict(
        dots=np.zeros((4, 8, 8), np.int32), base_vc=np.zeros(8, np.int32),
        has_base=False, ops=np.zeros((32, 22), np.int32),
        valid=np.zeros(32, bool), n_lanes=8)),
    lambda: store.counter_shard_init(4, 8, 8),
    lambda: store.lww_shard_init(4, 8, 8),
    lambda: store.rwset_shard_init(4, 8, 8, 8),
    lambda: store.setgo_shard_init(4, 8, 8, 8),
    lambda: rga_store.rga_store_init(16, 16, 8),
    lambda: device_plane.DevicePlane(),
    lambda: dep.DependencyGate(None, "dc", lambda: 0),
    lambda: dep.gate_from_config(None, "dc", lambda: 0, Config()),
    lambda: AntidoteGPU(),
    lambda: Node(),
    lambda: DataCenter("dc1", InProcBus()),
])
def test_no_device_raises_without_a_card(call, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)     # Config's default data_dir is relative
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert os.listdir(tmp_path) == []
