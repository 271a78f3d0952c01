"""The RGA partition cell on the CPU at a tiny size: the partition's
history keeps each document's length and the DCs' clocks over the
partition, the port's plane equals the plain reference on it row for
row, the control and planted faults come out not correct, every new
reader gives a number, and the reference and the generator import
nothing of the port.

The ``rga_docs`` system's tiny size lives here and is given to
``conftest.TINY`` when this module is collected, as
``test_portbench_rga.py`` gives the ``rga`` system's."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from portbench.lib import docs_history as dh
from portbench.lib import harness, rga_docs
from portbench.tests.conftest import ROOT

CELL = "rga-docs-3dc-edit"
#: the tiny size of the ``rga_docs`` system's cells: 8 documents in 4
#: tiers, 2 sessions of 4 steps (a pass opens each document once) of
#: 640 ops, so each session passes the plane's 2,048 ops to a GC
TINY_DOCS = ({"tiers": [[1, 2048], [1, 1024], [2, 512], [4, 256]]},
             {"ops_per_step": [256, 128, 64, 32], "sessions": 2,
              "steps": 4, "warmup_steps": 1})
SEED = 2 ** 31 + 7
NEW_READERS = ("rga_plane.append_host_ms", "rga_plane.fold_host_ms",
               "rga_plane.decode_host_ms", "rga_plane.waits_per_step",
               "rga_plane.rows_per_append")


def register_tiny_size():
    """``TINY_DOCS`` under ``"rga_docs"`` in every loaded copy of
    ``conftest.py`` (see test_portbench_rga.register_tiny_size)."""
    path = os.path.join(ROOT, "portbench", "tests", "conftest.py")
    for mod in list(sys.modules.values()):
        if os.path.abspath(getattr(mod, "__file__", None) or "") == path:
            mod.TINY.setdefault("rga_docs", TINY_DOCS)


register_tiny_size()


def tiny_cell(control=None, trace=False, seed=SEED):
    bench = harness.load_json(f"{ROOT}/BENCHMARK.json")
    cell = harness.make_cell(bench, ROOT, CELL, seed, 1.0, trace)
    cell.config.update(TINY_DOCS[0])
    cell.traffic.update(TINY_DOCS[1])
    cell.device, cell.control = "cpu", control
    cell.scratch = tempfile.mkdtemp()
    return bench, cell


def run(**kw):
    bench, cell = tiny_cell(**kw)
    return harness.run_cell(bench, cell)


def test_the_history_keeps_lengths_and_the_partitions_clocks():
    _bench, cell = tiny_cell()
    part = dh.build(cell.config, cell.traffic, SEED)
    assert [len(b) for b in part.base] == [2048, 1024, 512, 512] + [256] * 4
    n = cell.config["n_dcs"]
    every = np.concatenate(part.base)
    share = (every[:, dh.KIND] == 1).mean()
    assert abs(share - cell.config["delete_share"]) <= 0.05, share
    for sess in part.sessions:
        rows = np.concatenate([s.rows for s in sess])
        assert [len(s.rows) for s in sess] == [640] * 4
        # each origin's ops arrive in its commit order, one commit time
        # an op over the whole partition
        for k in range(n):
            ct = rows[rows[:, dh.DC] == k, dh.CT]
            assert (np.diff(ct) == 1).all()
        for s in sess:
            cvc = s.rows[:, dh.SS:].copy()
            cvc[np.arange(len(cvc)), s.rows[:, dh.DC]] = s.rows[:, dh.CT]
            # the read lags the step's own block; the GST lags the read
            assert not (cvc <= s.read_vc).all(axis=1).any()
            assert (s.gst <= s.read_vc).all()
            assert (s.stale_vc <= s.read_vc).all()
    base_cvc = every[:, dh.SS:].copy()
    base_cvc[np.arange(len(every)), every[:, dh.DC]] = every[:, dh.CT]
    assert (base_cvc <= part.frontier).all()
    assert (part.gst <= part.frontier).all()
    assert not (base_cvc <= part.gst).all(axis=1).all()
    # DC 0's author is actor n, which sorts after the others'
    ins = every[every[:, dh.KIND] == 0]
    assert set(ins[ins[:, dh.DC] == 0, dh.ACT]) == {n}


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 11])
def test_the_port_equals_the_reference(seed):
    res = run(seed=seed)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rows_differ"]["value"] == 0
    assert res["checks"]["documents_evicted"]["value"] == 0
    # every open of the first pass: each of the 8 documents once
    assert res["checks"]["reads_compared"]["value"] >= 8
    assert res["failed"] == 0 and res["attempted"] > 0


def test_the_control_is_not_correct():
    res = run(control="stale_read")
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["rows_differ"]["value"] > 0


@pytest.mark.parametrize("fault", ["read_at_latest", "deletes_dropped",
                                   "one_document_stale"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    import torch

    from antidote_tpu_torch.mat import rga_store

    if fault == "one_document_stale":
        # only the last document reads one snapshot older: every
        # document's first-pass open is compared, so it is caught
        open_ = rga_docs.Program.open

        def stale(self, d, vc, stale_vc):
            return open_(self, d, rga_docs.vc_of(stale_vc, 3)
                         if d == 7 else vc, stale_vc)
        monkeypatch.setattr(rga_docs.Program, "open", stale)
    elif fault == "read_at_latest":
        read = rga_store.rga_read
        monkeypatch.setattr(rga_store, "rga_read", lambda st, rv: read(
            st, torch.full_like(rv, 2 ** 62)))
    else:
        append = rga_store.rga_append_coalesced

        def dropped(st, ins, dl, *a, **k):
            return append(st, ins, tuple(c[:0] for c in dl), *a, **k)
        monkeypatch.setattr(rga_store, "rga_append_coalesced", dropped)
    res = run()
    assert res["correct"] is False, res["checks"]


def test_every_new_reader_gives_a_number(monkeypatch):
    monkeypatch.setattr(rga_docs, "TRACE_S", 600.0)   # the whole window
    res = run(trace=True)
    assert res["correct"] is True, res["checks"]
    for name in NEW_READERS + ("device.idle_pct.superstep",):
        assert res["metrics"][name]["value"] > 0, name
    assert res["metrics"]["rga_plane.rows_per_append"]["value"] >= 1


def test_opens_visit_every_document_once_a_pass():
    _bench, cell = tiny_cell()
    part = dh.build(cell.config, cell.traffic, SEED)
    opened = rga_docs.opens(part, cell.traffic, SEED)
    assert sorted(d for row in opened for d in row) == list(range(8))
    assert opened == rga_docs.opens(part, cell.traffic, SEED)


def test_the_reference_and_generator_import_nothing_of_the_port():
    code = ("import sys, json, portbench.reference.rga_docs, "
            "portbench.lib.docs_history\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    mods = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "antidote_tpu",
                       "antidote_tpu_torch"}, mods


def test_workers_give_the_same_history(monkeypatch):
    """One process (a host of one core) and three workers give the same
    history."""
    _bench, cell = tiny_cell()
    monkeypatch.setattr(dh.os, "cpu_count", lambda: 1)
    one = dh.build(cell.config, cell.traffic, SEED)
    monkeypatch.setattr(dh.os, "cpu_count", lambda: 3)
    three = dh.build(cell.config, cell.traffic, SEED)
    for a, b in zip(one.base, three.base):
        np.testing.assert_array_equal(a, b)
    for sa, sb in zip(one.sessions, three.sessions):
        for a, b in zip(sa, sb):
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.doc, b.doc)
