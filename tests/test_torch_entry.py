"""The port's superstep (antidote_tpu_torch.entry) against the JAX store
driven step by step, starting from a state the JAX package built and
carried across with mat.convert.state_from_numpy; plus the package's
import isolation and its refusal to run on the CPU unasked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import torch_parity as tp
from antidote_tpu.clocks import dense as jdense
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
