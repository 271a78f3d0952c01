"""A later change adds a configuration, a traffic mix and a per-layer
metric as files of their own and entries in BENCHMARK.json, and edits no
file that is there: the harness finds them by name.  The copy holds only
BENCHMARK.json and portbench/ (the port is found beside it), so the run
also shows that nothing reads the JAX package's benches, bench.py or
chip_smoke.py."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT

NEW_CONFIG = "orset-tiny"
NEW_TRAFFIC = "superstep-tiny"
NEW_METRIC = "store.steps_in_window"
NEW_CELL = "orset-tiny.superstep-tiny"


def digests(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digests(copy / "portbench")

    pb = copy / "portbench"
    cfg = json.loads((pb / "configs" / "orset-1m.json").read_text())
    cfg["keys"] = 1024
    (pb / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "superstep-stream.json").read_text())
    tr.update(batch=256, pool=4, warmup_steps=4)
    (pb / "traffic" / f"{NEW_TRAFFIC}.json").write_text(json.dumps(tr))
    (pb / "metrics" / f"{NEW_METRIC}.py").write_text(
        "def read(ctx):\n    return ctx['layer'].get('steps')\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": NEW_CONFIG, "source": "a test", "reduced": ["keys"],
        "file": f"portbench/configs/{NEW_CONFIG}.json", "why": "a test"})
    bench["workloads"].append({
        "name": NEW_CELL, "config": NEW_CONFIG, "traffic": NEW_TRAFFIC,
        "chips": 1, "why": "a test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index(
        "merges_per_s")]["workloads"].append(NEW_CELL)
    bench["per_layer"].append({
        "name": NEW_METRIC, "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "store",
        "moves": "merges_per_s", "workloads": [NEW_CELL]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(copy)!r}]\n"
        f"sys.path.append({ROOT!r})\n"
        "from portbench.lib import harness\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        "for trace in (False, True):\n"
        f"    c = harness.make_cell(bench, '.', {NEW_CELL!r}, 2**31 + 3, "
        "1.0, trace)\n"
        "    c.device = 'cpu'\n"
        "    assert harness.finish(bench, c) == 0\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=copy,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.splitlines()
             if x.startswith('{"correct"')]
    e2e, traced = lines
    assert e2e["correct"] and traced["correct"]
    assert set(e2e["metrics"]) == {"merges_per_s", "setup_s"}
    assert traced["metrics"][NEW_METRIC]["value"] > 0

    after = digests(copy / "portbench")
    assert {k: after[k] for k in before
            if not k.startswith("tests")} == {
        k: v for k, v in before.items() if not k.startswith("tests")}
    for absent in ("benches", "bench.py", "chip_smoke.py", "antidote_tpu"):
        assert not (copy / absent).exists()
