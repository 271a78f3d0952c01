"""The benchmark's driver: resolves a cell of ``BENCHMARK.json`` to its
files by name, checks for the card, hands the cell to its system's
driver (``portbench/lib/<system>.py``, named by the configuration's
``system`` key), reads the per-layer metrics through their readers
(``portbench/metrics/<metric>.py``), and prints the result line.

Nothing here knows a cell, a configuration, a mix or a metric by name:
a later cell is a set of new files and new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: top-level module names a run may not hold once its window has closed
#: (compared whole: the port's own name begins with the JAX package's)
FOREIGN = ("jax", "jaxlib", "flax", "antidote_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)


@dataclass
class Cell:
    """One run of one cell, as the system drivers see it."""

    name: str
    config_name: str
    traffic_name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    #: a control run (``--control NAME``): the reference in the
    #: program's place, with one guarantee broken; the benchmark's own
    #: runs never set it
    control: Optional[str] = None
    t_start: float = field(default_factory=time.perf_counter)
    #: per-run scratch (op logs, traces, client results), under TMPDIR
    scratch: str = ""


@dataclass
class Check:
    """One number compared against its limit: ``kind`` "max" holds when
    value <= limit, "min" when value >= limit."""

    name: str
    value: float
    limit: float
    kind: str = "max"

    @property
    def holds(self) -> bool:
        if self.kind == "max":
            return self.value <= self.limit
        return self.value >= self.limit


@dataclass
class Outcome:
    """What a system driver returns from one run."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    setup: Dict[str, float]
    memory_peak_bytes: int
    layer: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None


def cache_env(root: str) -> None:
    """Every build and kernel cache of the program in fixed directories
    inside the checkout, and no library loading JAX behind our back."""
    cache = os.path.join(root, "portbench", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def make_cell(bench: Dict[str, Any], root: str, workload: str, seed: int,
              seconds: float, trace: bool) -> Cell:
    """The cell named ``workload``, its configuration and traffic files
    read by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     wl["traffic"] + ".json"))
    return Cell(name=workload, config_name=wl["config"],
                traffic_name=wl["traffic"], config=config, traffic=traffic,
                chips=int(wl["chips"]), seed=seed, seconds=seconds,
                trace=trace)


def applies(metric: Dict[str, Any], cell: str,
            reported: Optional[set] = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or,
    with no ``workloads`` key, everywhere (a per-layer metric: wherever
    the end-to-end metric it moves is reported, ``reported``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def end_to_end(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer(bench: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"] if applies(m, cell, reported)]


def reader(name: str):
    """The per-layer metric's reader, ``portbench/metrics/<name>.py``
    (a file name may hold dots, so it is loaded by path)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_of(cell: Cell):
    return importlib.import_module(f"portbench.lib.{cell.config['system']}")


def foreign_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FOREIGN)


def nvidia_smi() -> Optional[Dict[str, str]]:
    keys = ("name", "clocks.sm", "clocks.mem", "power.draw", "power.limit",
            "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    return dict(zip(keys, (v.strip() for v in out.split(","))))


def host_facts(when: str) -> Dict[str, Any]:
    """The host around a window: cores, load and the card's clocks and
    power (printed on an earlier line; hosts differ between machines)."""
    return {"host": when, "cpu_count": os.cpu_count(),
            "cpus_usable": len(os.sched_getaffinity(0)),
            "loadavg": list(os.getloadavg()), "gpu": nvidia_smi()}


def emit(obj: Dict[str, Any]) -> None:
    print(json.dumps(obj), flush=True)


def run_cell(bench: Dict[str, Any], cell: Cell) -> Dict[str, Any]:
    """Runs ``cell`` through its system's driver; returns the result
    object (the keys the contract names, ``checks`` last)."""
    import torch

    system = system_of(cell)
    out = system.run(cell)
    metrics = {}
    if not cell.trace:
        for m in end_to_end(bench, cell.name):
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "layer": out.layer, "trace": out.trace}
        for m in per_layer(bench, cell.name):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = cell.device.startswith("cuda")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    res = {"correct": all(c.holds for c in out.checks),
           "attempted": int(out.attempted), "failed": int(out.failed),
           "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        res["breakdown"] = out.trace.breakdown()
    emit({"setup": out.setup})
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                              "kind": c.kind} for c in out.checks}
    return res


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="run the reference in the program's place with "
                        "one guarantee broken (a control run; the "
                        "benchmark's own runs never pass it)")
    return p.parse_args(argv)


def finish(bench: Dict[str, Any], cell: Cell) -> int:
    """Everything of a run after the look for the card: the host facts,
    the cell, the check that no JAX module was loaded, the compared
    numbers on standard error and the result line last on standard
    output.  Returns the exit code."""
    import shutil
    import tempfile

    cell.scratch = tempfile.mkdtemp(prefix="portbench_")
    try:
        emit(host_facts("before"))
        res = run_cell(bench, cell)
        emit(host_facts("after"))
    finally:
        shutil.rmtree(cell.scratch, ignore_errors=True)
    bad = foreign_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        rel = "<=" if c["kind"] == "max" else ">="
        print(f"check {name}: {c['value']} (limit {rel} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    emit(res)
    return 0


def main(argv, root: str, t_start: float) -> int:
    args = parse(argv)
    cache_env(root)
    try:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cell = make_cell(bench, root, args.workload, args.seed,
                         args.seconds, bool(args.trace))
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"portbench: cannot resolve the cell: {e!r}", file=sys.stderr)
        return 2
    cell.t_start, cell.control = t_start, args.control
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return finish(bench, cell)
