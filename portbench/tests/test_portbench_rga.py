"""The RGA cell on the CPU at a tiny size: the generated 3-DC history is
a valid causal history with the B4 trace's delete share, it holds the
cases the store must order and hide right, the port equals the plain
reference bit for bit on it, the control and planted faults come out
not correct, the reference imports nothing of the port, and the
readers credit the card's work to the span that launched it.

The ``rga`` system's tiny size lives here and is given to
``conftest.TINY`` when this module is collected, so that
``test_portbench_cells.py`` cuts the cell as it cuts the others' when
the directory runs."""

import os
import subprocess
import sys
import tempfile
from collections import defaultdict

import numpy as np
import pytest

from portbench.lib import harness, rga, spantrace
from portbench.lib import text_history as th
from portbench.tests.conftest import ROOT

CELL = "rga-text-3dc-session"
#: the tiny size of the ``rga`` system's cells (configuration, traffic),
#: in the form of ``conftest.TINY``'s entries
TINY_RGA = ({"base_ops": 4096, "base_block": 512, "pb": 8192, "nw": 2048,
             "md": 1024}, {"block": 128, "sessions": 2, "steps": 8})
SEED = 2 ** 31 + 7
#: a history in which authors jump before every insert, over a small
#: base: concurrent inserts after one vertex at one Lamport time occur
#: inside the sessions, not only at the head
CROWDED = ({"base_ops": 256}, {"jump_p": 1.0})
CROWDED_SEEDS = (2 ** 31 + 3, 2 ** 31 + 5)


def tiny_parts(cfg=None, tr=None):
    """The cell's configuration and traffic cut to the tiny size."""
    bench = harness.load_json(f"{ROOT}/BENCHMARK.json")
    cell = harness.make_cell(bench, ROOT, CELL, SEED, 1.0, False)
    c, t = TINY_RGA
    return ({**cell.config, **c, **(cfg or {})},
            {**cell.traffic, **t, **(tr or {})})


def register_tiny_size():
    """``TINY_RGA`` under ``"rga"`` in every loaded copy of
    ``conftest.py``: pytest loads it under a module name of its own
    besides the ``portbench.tests.conftest`` that test files import."""
    path = os.path.join(ROOT, "portbench", "tests", "conftest.py")
    for mod in list(sys.modules.values()):
        if os.path.abspath(getattr(mod, "__file__", None) or "") == path:
            mod.TINY.setdefault("rga", TINY_RGA)


register_tiny_size()


def every_op(pool):
    return np.concatenate([pool.base] + [b for s in pool.sessions
                                         for b in s.blocks])


def deliveries(pool, session, n_dcs, lag):
    """Each DC's ops in the order it received and made them, from the
    base's ticks through one session: DC k gets DC j's ops of tick t at
    tick t + lag, before its own of that tick.  Rebuilt from the op
    rows' ticks, apart from the generator's own bookkeeping."""
    rows = np.concatenate([pool.base] + pool.sessions[session].blocks)
    # DC 0's blocks miss the other DCs' last ``lag`` ticks; what DC 0
    # never received is left out of every DC's view alike
    by = defaultdict(list)
    for r in rows.tolist():
        by[(r[th.TICK], r[th.DC])].append(r)
    last = max(t for t, _ in by)
    out = []
    for k in range(n_dcs):
        seq = []
        for t in range(last + 1):
            for j in range(n_dcs):
                if j != k:
                    seq += [(False, r) for r in by.get((t - lag, j), ())]
            seq += [(True, r) for r in by.get((t, k), ())]
        out.append(seq)
    return out


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 11])
def test_the_history_is_causal(seed):
    cfg, tr = tiny_parts()
    pool = th.build(cfg, tr, seed)
    n = cfg["n_dcs"]
    assert len(pool.base) == cfg["base_ops"]
    for s in range(len(pool.sessions)):
        for k, seq in enumerate(deliveries(pool, s, n, tr["lag"])):
            cvc = {(0, 0): np.zeros(n, np.int64)}
            lam = {(0, 0): 0}
            for own, r in seq:
                v = (r[th.LAM], r[th.ACT])
                mine = th.commit_vc(np.asarray([r]))[0]
                if own:
                    dep = (r[th.RLAM], r[th.RACT]) \
                        if r[th.KIND] == th.INSERT else v
                    # the reference (or the delete's target) was here
                    # first, and the op's snapshot covers its commit
                    assert dep in cvc, (k, r)
                    assert (cvc[dep] <= np.asarray(r[th.SS:])).all()
                    if r[th.KIND] == th.INSERT:
                        assert r[th.TIME] > lam[dep]
                if r[th.KIND] == th.INSERT:
                    cvc[v], lam[v] = mine, r[th.TIME]
    ops = every_op(pool)
    share = (pool.base[:, th.KIND] == th.DELETE).mean()
    assert abs(share - 0.298) <= 0.01, share
    assert abs((ops[:, th.KIND] == th.DELETE).mean() - 0.298) <= 0.01


def test_the_full_base_keeps_the_traces_length_and_shares():
    assert th.shares(1024, 3) == [342, 341, 341]
    ticks, extra = th.base_ticks(259_778, 342, 682, 2)
    assert 342 * ticks + sum(extra) + 682 * (ticks - 2) == 259_778


def siblings_at_one_time(rows, since_tick):
    """Pairs of inserts made at or after ``since_tick`` after one
    vertex at one Lamport time by different actors."""
    by_ref = defaultdict(list)
    for r in rows[rows[:, th.KIND] == th.INSERT].tolist():
        by_ref[(r[th.RLAM], r[th.RACT])].append(r)
    return sum(1 for rs in by_ref.values() for a in rs for b in rs
               if a[th.LAM] == b[th.LAM] and a[th.ACT] < b[th.ACT]
               and b[th.TICK] >= since_tick)


def test_the_histories_hold_the_hard_cases():
    cfg, tr = tiny_parts(*CROWDED)
    for seed in CROWDED_SEEDS:
        pool = th.build(cfg, tr, seed)
        assert siblings_at_one_time(every_op(pool), pool.fork_tick - 2)
    cfg, tr = tiny_parts()
    pool = th.build(cfg, tr, SEED)
    ops = every_op(pool)
    dl = ops[ops[:, th.KIND] == th.DELETE]
    # deletes of inserts made at another DC
    assert (dl[:, th.ACT] != dl[:, th.DC] + 1).sum() > 0
    for sess in pool.sessions:
        for j, rows in enumerate(sess.blocks):
            vc = th.commit_vc(rows)
            # the read is below the newest delivery: none of the step's
            # own block is in its snapshot, all of the one before is
            assert not (vc <= sess.read_vc[j]).all(axis=1).any()
            if j:
                prev = th.commit_vc(sess.blocks[j - 1])
                assert (prev <= sess.read_vc[j]).all()
            # the GST lags: the block before holds ops it does not cover
            if j and (j + 1) % tr["fold_every"] == 0:
                assert not (prev <= sess.gst[j]).all(axis=1).all()
                assert (sess.gst[j] <= sess.read_vc[j]).all()


def run(cell):
    cell.scratch = tempfile.mkdtemp()
    bench = harness.load_json(f"{ROOT}/BENCHMARK.json")
    return harness.run_cell(bench, cell)


def tiny_cell(control=None, cfg=None, tr=None, seed=SEED):
    bench = harness.load_json(f"{ROOT}/BENCHMARK.json")
    cell = harness.make_cell(bench, ROOT, CELL, seed, 1.5, False)
    cell.config, cell.traffic = tiny_parts(cfg, tr)
    cell.device, cell.control = "cpu", control
    return cell


@pytest.mark.parametrize("seed,crowded", [(SEED, False),
                                          (CROWDED_SEEDS[0], True),
                                          (CROWDED_SEEDS[1], True)])
def test_the_port_equals_the_reference(seed, crowded):
    res = run(tiny_cell(seed=seed, **(dict(zip(("cfg", "tr"), CROWDED))
                                      if crowded else {})))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rows_differ"]["value"] == 0
    assert res["checks"]["reads_compared"]["value"] >= 4
    assert res["failed"] == 0


def test_the_control_is_not_correct():
    res = run(tiny_cell(control="stale_read"))
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["rows_differ"]["value"] > 0


def plant(monkeypatch, fault, cell):
    from antidote_tpu_torch.mat import rga_store

    append, read = rga_store.rga_append_coalesced, rga_store.rga_read
    if fault == "deletes_dropped":
        # one block of the window's first step loses its deletes
        at = -(-cell.config["base_ops"] // cell.config["base_block"]) \
            + cell.traffic["steps"] + 1
        calls = {"n": 0}

        def dropped(st, ins, dl, *a, **k):
            calls["n"] += 1
            if calls["n"] == at:
                dl = tuple(c[:0] for c in dl)
            return append(st, ins, dl, *a, **k)
        monkeypatch.setattr(rga_store, "rga_append_coalesced", dropped)
    elif fault == "read_at_latest":
        import torch

        def latest(st, rv):
            return read(st, torch.full_like(rv, 2 ** 62))
        monkeypatch.setattr(rga_store, "rga_read", latest)
    elif fault in ("answer_altered", "later_pass_altered"):
        # the later fault spares the warm-up's session and the window's
        # first pass, whose reads the later passes are compared with
        spare = 0 if fault == "answer_altered" else cell.traffic["steps"] \
            * (1 + cell.traffic["sessions"])
        calls = {"n": 0}

        def altered(st, rv):
            lam, act, elem, vis, n = read(st, rv)
            calls["n"] += 1
            if calls["n"] > spare:
                elem = elem.clone()
                elem[0] += 1
            return lam, act, elem, vis, n
        monkeypatch.setattr(rga_store, "rga_read", altered)


@pytest.mark.parametrize("fault", ["deletes_dropped", "read_at_latest",
                                   "answer_altered", "later_pass_altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    cell = tiny_cell()
    plant(monkeypatch, fault, cell)
    res = run(cell)
    assert res["correct"] is False, res["checks"]
    per_pass = sum(len(k) for k in rga.kept_steps(cell.traffic, SEED))
    assert res["checks"]["reads_compared"]["value"] > per_pass


def test_kept_reads_count_every_later_difference():
    """The first read of a step stays; a later read is compared with it
    and dropped; the sum counts a first read's rows once a read."""
    import torch

    def read(elem, n):
        z = torch.zeros(6, dtype=torch.int32)
        return (z, z, torch.tensor(elem, dtype=torch.int32),
                torch.ones(6, dtype=torch.bool), torch.tensor(n))
    ref = [0, 1, 2, 3, 4, 5]
    kept = rga.Kept("cpu")
    kept.add((0, 7), read(ref, 6))
    kept.add((0, 7), read(ref, 6))
    kept.add((1, 7), read([0, 1, 9, 3, 4, 5], 6))
    kept.add((1, 7), read([0, 1, 9, 3, 9, 5], 5))
    assert len(kept.first) == 2 and kept.reads == {(0, 7): 2, (1, 7): 2}
    want = {sj: (np.zeros(6, np.int32), np.zeros(6, np.int32),
                 np.asarray(ref, np.int32), np.ones(6, bool), 6)
            for sj in kept.first}
    # (1, 7): its first read differs in 1 row, read twice; the later
    # read differs from the first in 1 row and in n by 1
    assert kept.rows_differ(want, "cpu") == 2 * 1 + 1 + 1
    clean = rga.Kept("cpu")
    for _ in range(3):
        clean.add((0, 7), read(ref, 6))
    assert clean.rows_differ(want, "cpu") == 0


def test_the_reference_and_generator_import_nothing_of_the_port():
    code = ("import sys, json, portbench.reference.rga, "
            "portbench.lib.text_history\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    mods = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "antidote_tpu",
                       "antidote_tpu_torch"}, mods


def test_kept_steps_hold_each_sessions_last():
    _, tr = tiny_parts()
    kept = rga.kept_steps(tr, SEED)
    assert len(kept) == tr["sessions"]
    assert all(tr["steps"] - 1 in k and 1 <= len(k) <= 2 for k in kept)
    assert kept == rga.kept_steps(tr, SEED)


class Ev:
    """A torch.profiler event as ``spantrace`` reads it."""

    def __init__(self, cat, name, start, end, corr):
        self.cat, self.n, self.s, self.e, self.c = cat, name, start, end, corr

    def activity_type(self):
        return self.cat

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def correlation_id(self):
        return self.c


class Trace:
    cuda, window_s = True, 1.0

    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _: events})()
        self.prof = type("P", (), {"profiler": type(
            "Q", (), {"kineto_results": kineto})()})()


def test_device_time_follows_each_operations_launch(monkeypatch):
    """A kernel and a copy run after the spans that launched them have
    closed (the card lags the host), outside every span: each is
    credited to the span its launch lies in, by correlation id, and a
    span that launched nothing reads 0; spans outside the window and
    host spans past a drop give nothing."""
    from antidote_tpu_torch.obs.prof import profiler

    spans = [("rga_read", 100, 200, 0), ("rga_read", 300, 400, 0),
             ("rga_step.fold", 500, 600, 0), ("rga_read", 5000, 5100, 0)]
    kept = {"spans": spans, "dropped": 0, "dropped_until_ns": 0}
    monkeypatch.setattr(profiler, "host_spans", lambda: kept)
    events = [Ev("cuda_runtime", "cudaLaunchKernel", 150, 160, 7),
              Ev("cuda_runtime", "cudaMemcpyAsync", 520, 530, 8),
              Ev("cuda_runtime", "cudaLaunchKernel", 4900, 4910, 9),
              # launched in the first read and the fold, run later
              Ev("kernel", "sort", 220, 260, 7),
              Ev("gpu_memcpy", "Memcpy DtoH", 640, 645, 8),
              Ev("kernel", "late", 5050, 5060, 9)]
    ctx = {"trace": Trace(events), "layer": {"traced_ns": (0, 1000)}}
    assert spantrace.device_ms(ctx, "rga_read") == 40 / 2 / 1e6
    assert spantrace.device_ms(ctx, "rga_step.fold") == 5 / 1e6
    assert spantrace.host_ms(ctx, "rga_read") == 100 / 1e6
    assert spantrace.device_ms(ctx, "rga_append_packed") is None
    kept["dropped"], kept["dropped_until_ns"] = 3, 10
    assert spantrace.spans(ctx, "rga_read") is None
    assert spantrace.device_ms({"trace": None, "layer": {}},
                               "rga_read") is None
