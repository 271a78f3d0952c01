"""The yardstick stands apart from the program: the kernels' bytes come
from shapes, the references import nothing of the port, a run loads no
JAX module, and the command refuses to run without the card."""

import json
import os
import subprocess
import sys

from portbench.tests.conftest import ROOT

FOREIGN = ("jax", "jaxlib", "flax", "antidote_tpu", "antidote_tpu_torch")


def loaded_after(code: str, cwd=ROOT):
    """Top-level names of the modules a fresh interpreter holds after
    ``code`` (the port's name begins with the JAX package's: compared
    whole)."""
    probe = code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=cwd,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_kernel_bytes_count_what_the_ring_holds():
    """The reads and folds of a traced range are charged the ops the
    stream has put in the ring since the last fold, and a fold the
    distinct keys those ops name, counted here by hand."""
    import numpy as np

    from portbench.lib import roofline, superstep, traffic

    cfg = {"keys": 1 << 14, "lanes": 8, "elems": 8, "dcs": 8,
           "live_dcs": 3, "gc_every": 4}
    tr = {"batch": 512, "pool": 4, "add_share": 0.7, "obs_lag": 2}
    pool, per_cycle = traffic.orset_pool(tr, cfg, np.random.default_rng(3))
    _, _, dropped, work = superstep.replay(cfg, pool, per_cycle, 11, set(),
                                           range(2, 10), "cpu")
    B, G = tr["batch"], cfg["gc_every"]
    assert dropped == 0
    # reads at steps 2..9: the GC steps 3 and 7 read an empty ring
    assert work["reads"] == 8
    assert work["read_ops"] == B * (3 + 0 + 1 + 2 + 3 + 0 + 1 + 2)
    assert work["gcs"] == 2 and work["gc_ops"] == 2 * G * B
    keys = [np.unique(np.concatenate([pool[j % 4]["key_idx"]
                                      for j in range(g, g + G)])).size
            for g in (0, 4)]
    assert work["gc_keys"] == sum(keys)
    shape = (cfg["keys"], 8, 8, 8, 4)
    got = superstep.kernel_bytes(shape, work)
    row = roofline.op_row_bytes(8, 4)
    assert got["orset_read_packed"] == sum(
        roofline.orset_read_bytes(*shape, n * B) for n in (3, 0, 1, 2, 3,
                                                           0, 1, 2))
    assert got["orset_gc_packed"] == sum(
        roofline.orset_gc_bytes(*shape, G * B, k) for k in keys)
    # a fold of nothing moves the bitmap and the clock alone
    assert roofline.orset_gc_bytes(*shape, 0, 0) == cfg["keys"] * 8 + 32
    assert row == 88


def test_the_references_import_nothing_of_the_port():
    mods = loaded_after("import portbench.reference.orset, "
                        "portbench.reference.txn, portbench.lib.traffic, "
                        "portbench.lib.roofline")
    assert not mods & set(FOREIGN), mods & set(FOREIGN)


def test_a_run_loads_no_jax_module():
    code = (
        "import tempfile, json\n"
        "from portbench.lib import harness\n"
        "from portbench.tests.conftest import (load_bench, tiny_cell,\n"
        "                                      with_cure_cells)\n"
        "bench = with_cure_cells(load_bench())\n"
        "for name in ('orset-1m-superstep', 'cure-16p-update-uniform'):\n"
        "    c = tiny_cell(bench, name, seconds=0.5)\n"
        "    c.scratch = tempfile.mkdtemp()\n"
        "    harness.run_cell(bench, c)\n")
    mods = loaded_after(code)
    assert "antidote_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "antidote_tpu"}


def test_the_command_refuses_without_the_card():
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "orset-1m-superstep", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
