"""Shared fixtures of the benchmark's CPU tests: each cell of
``BENCHMARK.json`` cut to a size a test run holds, its planes and
stores on the CPU.  Tests that need the card are marked ``cuda`` and
decide in the ``card`` fixture, never while a module is imported."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the tiny sizes every system's cells are cut to here (the Cure cells'
#: rate to what this machine's CPU serves with its planes on the CPU)
TINY = {
    "cure": ({"keys_per_type": 256, "n_partitions": 2,
              "device_key_capacity": 1024},
             {"warmup_s": 0.5, "rate_per_s": 400}),
    "superstep": ({"keys": 2048}, {"batch": 512, "pool": 4,
                                   "warmup_steps": 4}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; the test's fixture skips it where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return "cuda"


def load_bench():
    """BENCHMARK.json as it stands."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


#: cells of the Cure driver (``portbench/lib/cure.py``), for its tests
#: alone: BENCHMARK.json holds none of them yet (PERF.md, Open questions)
CURE_CELLS = {"cure-16p-update-uniform": "pb-update-heavy-uniform",
              "cure-16p-read-zipf": "pb-read-heavy-zipf"}


def with_cure_cells(bench):
    """``bench`` with the Cure driver's test cells, their end-to-end
    ``txn_per_s`` and, as their per-layer metrics, every reader of
    ``portbench/metrics/`` that BENCHMARK.json does not name."""
    cells = list(CURE_CELLS)
    bench["configs"].append({"name": "cure-1dc-16p",
                             "file": "portbench/configs/cure-1dc-16p.json"})
    bench["workloads"] += [{"name": n, "config": "cure-1dc-16p",
                            "traffic": t, "chips": 1}
                           for n, t in CURE_CELLS.items()]
    bench["end_to_end"].append({"name": "txn_per_s", "unit": "txn/s",
                                "workloads": cells})
    named = {m["name"] for m in bench["per_layer"]}
    readers = sorted(f[:-3] for f in os.listdir(
        os.path.join(ROOT, "portbench", "metrics")) if f.endswith(".py"))
    bench["per_layer"] += [{"name": r, "unit": "1", "moves": "txn_per_s",
                            "workloads": cells}
                           for r in readers if r not in named]
    return bench


@pytest.fixture
def bench():
    return with_cure_cells(load_bench())


def tiny_cell(bench, name, trace=False, seconds=1.5, seed=2 ** 31 + 7,
              device="cpu", control=None):
    """The cell ``name`` cut to a tiny size on ``device``."""
    from portbench.lib import harness

    cell = harness.make_cell(bench, ROOT, name, seed, seconds, trace)
    cfg, tr = TINY[cell.config["system"]]
    cell.config.update(cfg)
    cell.traffic.update(tr)
    cell.device, cell.control = device, control
    return cell


@pytest.fixture
def tiny(bench):
    def make(name, **kw):
        return tiny_cell(bench, name, **kw)
    return make
