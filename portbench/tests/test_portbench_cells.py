"""Each cell of BENCHMARK.json, cut to a tiny size on the CPU, runs
through the harness (everything after the look for the card) and
prints the contract's result line last."""

import json

import pytest

from portbench.lib import harness
from portbench.tests.conftest import load_bench, with_cure_cells

CELLS = [w["name"] for w in with_cure_cells(load_bench())["workloads"]]


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_prints_the_contract_line(bench, tiny, capsys, name, trace):
    cell = tiny(name, trace=trace)
    assert harness.finish(bench, cell) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(res) == want + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        names = {m["name"] for m in harness.per_layer(bench, name)}
        assert set(res["metrics"]) <= names and res["metrics"]
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        for part in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][part]) <= 10
    else:
        names = [m["name"] for m in harness.end_to_end(bench, name)]
        assert list(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())
    earlier = [json.loads(x) for x in lines[:-1] if x.startswith("{")]
    assert {"before", "after"} <= {x.get("host") for x in earlier}
    assert any("setup" in x for x in earlier)


def test_every_cell_reports_setup_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.per_layer(bench, w["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)
