"""On the card: the command runs a short cell end to end and its
comparison holds; the control at the same size does not."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


def cli(*args):
    p = subprocess.run([sys.executable, "portbench/run.py", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    return p.returncode, p.stdout.strip().splitlines()[-1:] or [""], p.stderr


@pytest.mark.cuda
def test_the_superstep_cell_and_its_control_on_the_card(card):
    base = ["--workload", "orset-1m-superstep", "--seed", str(2 ** 31 + 11),
            "--seconds", "2", "--trace", "0"]
    rc, (last,), err = cli(*base)
    assert rc == 0, err[-3000:]
    assert json.loads(last)["correct"] is True
    rc, (last,), err = cli(*base, "--control", "stale_read")
    assert rc == 0, err[-3000:]
    assert json.loads(last)["correct"] is False
