"""The port's copies of the JAX package's host-only modules (vector
clocks, config, CRDTs, the host materializer's payloads, the span tracer
and flight recorder, the stats registry, the log records, the inter-DC
wire format, the metadata sender, the GST fold, the stable metadata
store, the hybrid clock, the commit hooks, the online probes, the op log
with its native core, checkpoints and partition log, the host store,
the partition manager, the read serve plane, the remote-call errors and
the coordinator) equal their sources line for line, but for the package
name in their import statements, and so do the single classes,
functions and assignments the port copied out of larger modules: a
change on either side that is not carried over fails here."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ["clocks/vc.py", "config.py", "crdt/__init__.py", "crdt/base.py",
          "crdt/counters.py", "crdt/registers.py", "crdt/sets.py",
          "crdt/flags.py", "crdt/maps.py", "crdt/rga.py",
          "mat/materializer.py", "obs/events.py", "obs/spans.py",
          "stats.py", "oplog/records.py", "interdc/wire.py",
          "interdc/termcodec.py", "meta/sender.py", "meta/gossip.py",
          "meta/stable_store.py", "txn/clock.py", "hooks.py",
          "obs/probe.py", "native/build.py", "native/oplog.cpp",
          "oplog/log.py", "oplog/checkpoint.py", "oplog/partition.py",
          "oplog/__init__.py", "mat/host_store.py", "txn/manager.py",
          "mat/serve.py", "cluster/remote.py", "txn/coordinator.py",
          "txn/__init__.py"]
#: (module, top-level class, function or assigned name) copied alone
EXCERPTS = [("txn/manager.py", "PartitionRetired"),
            ("oplog/log.py", "_fsync_dir"),
            ("cluster/link.py", "_raise_remote"),
            ("runtime.py", "COLLECTIVE_LOCK")]
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


def _excerpt(pkg, rel, name):
    path = os.path.join(REPO, pkg, rel)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for node in ast.parse(text).body:
        names = [getattr(node, "name", None)] + [
            getattr(t, "id", None) for t in getattr(node, "targets", ())]
        if name in names:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{pkg}/{rel} has no {name}")


@pytest.mark.parametrize("rel,name", EXCERPTS)
def test_excerpt_equals_its_source(rel, name):
    want = "\n".join(_IMPORT.sub(r"\1antidote_tpu_torch", line) for line
                     in _excerpt("antidote_tpu", rel, name).split("\n"))
    assert _excerpt("antidote_tpu_torch", rel, name) == want
    if name == "PartitionRetired":     # antidote_tpu/txn/manager.py:48-55
        lines = _read("antidote_tpu", rel)[47:55]
        assert want == "\n".join(lines).rstrip("\n")
