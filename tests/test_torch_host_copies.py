"""The port's copies of the JAX package's host-only modules (vector
clocks, config, CRDTs, the host materializer's payloads, the span tracer
and flight recorder, the stats registry) equal their sources line for
line, but for the package name in their import statements: a change on
either side that is not carried over fails here."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["clocks/vc.py", "config.py", "crdt/__init__.py", "crdt/base.py",
          "crdt/counters.py", "crdt/registers.py", "crdt/sets.py",
          "crdt/flags.py", "crdt/maps.py", "crdt/rga.py",
          "mat/materializer.py", "obs/events.py", "obs/spans.py",
          "stats.py"]
_IMPORT = re.compile(r"^(\s*(?:from|import) )antidote_tpu\b")


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel), encoding="utf-8") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source(rel):
    src = _read("antidote_tpu", rel)
    want = [_IMPORT.sub(r"\1antidote_tpu_torch", line) for line in src]
    got = _read("antidote_tpu_torch", rel)
    assert len(got) == len(want), rel
    for n, (g, w) in enumerate(zip(got, want), 1):
        assert g == w, f"{rel}:{n}"
    # every import of the package names the port
    assert not any(_IMPORT.match(line) for line in got)
