"""The port's copies of the JAX package's host-only modules (vector
clocks, config, CRDTs, the host materializer's payloads, the span tracer
and flight recorder, the stats registry, the log records, the inter-DC
wire format, the metadata sender, the GST fold, the stable metadata
store, the hybrid clock, the commit hooks, the online probes, the op log
with its native core, checkpoints and partition log, the host store,
the partition manager, the read serve plane, the remote-call errors,
the coordinator, and the inter-DC plane's pub/sub, gap repair, interest
routing, bounded-counter transfers and the observability it imports,
the TCP transport with its native publish hub, the node fabric in
Python and native, the wire protocol with its generated protobuf
modules and their schemas, and bench.py's native OR-Set baseline) equal
their sources line for line, but for the
package name in their import statements, and so do the single classes,
functions and assignments the port copied out of larger modules: a
change on either side that is not carried over fails here.  A copy
with a listed difference (``DIFFERS``) equals its source once that
difference is applied."""

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
          "obs/probe.py", "native/oplog.cpp",
          "oplog/log.py", "oplog/checkpoint.py", "oplog/partition.py",
          "oplog/__init__.py", "mat/host_store.py",
          "mat/serve.py", "cluster/remote.py", "txn/coordinator.py",
          "txn/__init__.py", "obs/pipeline.py", "obs/slo.py",
          "obs/fleet.py", "obs/nativeobs.py", "interdc/interest.py",
          "interdc/transport.py", "interdc/query.py", "interdc/sub_buf.py",
          "interdc/sender.py", "bcounter.py", "interdc/__init__.py",
          "native/tel_ring.h", "native/fabric.cpp", "native/nodelink.cpp",
          "interdc/tcp.py", "cluster/link.py",
          "cluster/__init__.py", "pb/antidote.proto",
          "pb/antidote_compat.proto", "pb/antidote_pb2.py",
          "pb/antidote_compat_pb2.py", "pb/codec.py", "pb/compat.py",
          "pb/client.py", "pb/server.py"]
#: copies with one permitted difference: (source lines, port lines)
#: pairs, each replacing its source lines once
DIFFERS = {
    # the library is built under a name of the process's own and
    # renamed into place: the module lock guards one process only, and
    # several node and DC processes build at first use
    "native/build.py": [
        (['        os.makedirs(_BUILD_DIR, exist_ok=True)'],
         ['        os.makedirs(_BUILD_DIR, exist_ok=True)',
          '        # build under a name of this process\'s own, then rename: the',
          '        # lock guards one process only, and a node or DC process',
          '        # loading the library while another builds it must never map',
          '        # a partial file',
          '        tmp = f"{out}.{os.getpid()}.tmp"']),
        (['        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",',
          '               "-pthread", src, "-o", out]'],
         ['        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",',
          '               "-pthread", src, "-o", tmp]']),
        # the rename is durable: the library fsynced before it, the
        # directory after it (durability_lint's atomic-publish rule)
        (['            return None'],
         ['            return None',
          '        # lock-ok: the lock exists to serialise this process\'s builds;',
          '        # nothing else takes it',
          '        publish(tmp, out)']),
        (['        return out'],
         ['        return out', '', '',
          'def publish(tmp: str, out: str) -> None:',
          '    """Renames a finished build into place, its bytes fsynced before the',
          '    rename and the directory after it: a crash never leaves a torn',
          '    library under the final name, which a later start would take as',
          '    built (this build and the CUDA kernels\' in ``_cuda.py``)."""',
          '    from antidote_tpu_torch.oplog.log import _fsync_dir',
          '',
          '    with open(tmp, "rb") as f:',
          '        os.fsync(f.fileno())',
          '    os.replace(tmp, out)',
          '    _fsync_dir(os.path.dirname(out), instant="build_dir_fsync")']),
    ],
    # the flusher's waiting frame drops the partition it flushed last
    # (a ring resize drops the partition, whose planes hold device
    # memory), and its device sync under the partition lock is audited
    "txn/manager.py": [
        (['                return',
          '            key, pm, plane = item',
          '            with self._lock:',
          '                self._queued.discard(key)',
          '            try:',
          '                with pm._lock:',
          '                    pm._wait_device_quiesce()',
          '                    plane.flush_gc_now()',
          '            except Exception:  # noqa: BLE001 — the drain must not die',
          '                import logging as _logging'],
         ['                return',
          '            self._flush_one(*item)',
          '            # the waiting frame must not keep the last partition flushed',
          '            # reachable: a ring resize drops it, and its planes hold',
          '            # device memory until every reference dies',
          '            del item']),
        (['',
          '                _logging.getLogger(__name__).exception(',
          '                    "background device flush failed")'],
         ['',
          '    def _flush_one(self, key, pm: "PartitionManager", plane) -> None:',
          '        with self._lock:',
          '            self._queued.discard(key)',
          '        try:',
          '            with pm._lock:',
          '                pm._wait_device_quiesce()',
          '                # lock-ok: the flusher\'s contract: the flush runs under',
          '                # the partition lock with readers quiesced, its device',
          '                # sync included',
          '                plane.flush_gc_now()',
          '        except Exception:  # noqa: BLE001 — the drain must not die',
          '            import logging as _logging',
          '',
          '            _logging.getLogger(__name__).exception(',
          '                "background device flush failed")']),
    ],
    # the build under the load lock is audited (concurrency_lint)
    "cluster/nativelink.py": [
        (['        from antidote_tpu_torch.native.build import ensure_built', ''],
         ['        from antidote_tpu_torch.native.build import ensure_built', '',
          '        # lock-ok: the lock exists to build and load the library once',
          '        # a process; nothing else takes it']),
    ],
    # the generated modules are never regenerated: the docstring says
    # why they are byte-identical in place of how to regenerate them
    "pb/__init__.py": [
        (['Regenerate ``antidote_pb2.py`` after editing ``antidote.proto``:',
          '``protoc --python_out=. antidote.proto`` in this directory.'],
         ['``antidote_pb2.py`` and ``antidote_compat_pb2.py`` are byte-identical',
          'copies of the JAX package\'s, never regenerated, and the ``.proto``',
          'files are never edited: each registers its file (``antidote.proto``,',
          'package ``antidotepb``; ``antidote_tpu/pb/antidote_compat.proto``,',
          'package ``antidotepb.compat``) in protobuf\'s default descriptor pool,',
          'which accepts a second registration only of the identical serialized',
          'descriptor.  A process that imports both packages (every parity test',
          'does) then shares one set of message classes between them, so the',
          'server\'s dispatch by ``type(req)`` and the codec\'s ``MSG_CODES`` see',
          'one class for both packages.']),
    ],
    # the JAX pin is gone (the console never touches the card, and
    # importing torch creates no CUDA context): the docstring says so
    "console.py": [
        (['    flag set NAME VALUE     set a runtime flag (bool/int/str inferred)'],
         ['    flag set NAME VALUE     set a runtime flag (bool/int/str inferred)',
          '',
          'The console only speaks TCP: it must come up instantly and never touch',
          '(or wait on) the card.  The package import pulls in torch, and',
          'importing torch creates no CUDA context; nothing here creates one.']),
        (['# the console only speaks TCP — it must come up instantly and never',
          '# touch (or wait on) an accelerator backend, so pin jax to CPU before',
          '# the package import pulls it in',
          'import jax',
          '',
          'jax.config.update("jax_platforms", "cpu")',
          ''],
         []),
    ],
}
#: copies whose bytes equal their source's: protobuf's generated modules
#: register their serialized descriptors in one pool (pb/__init__.py)
BYTES = ["pb/antidote_pb2.py", "pb/antidote_compat_pb2.py",
         "pb/antidote.proto", "pb/antidote_compat.proto",
         "native/orset_baseline.cpp"]
#: (module, top-level class, function or assigned name) copied alone
EXCERPTS = [("txn/manager.py", "PartitionRetired"),
            ("oplog/log.py", "_fsync_dir"),
            ("cluster/link.py", "_raise_remote"),
            ("runtime.py", "COLLECTIVE_LOCK"),
            ("runtime.py", "tune_runtime"),
            ("runtime.py", "_tuned")]
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


@pytest.mark.parametrize("rel", sorted(DIFFERS))
def test_copy_differs_only_as_listed(rel):
    want = [_IMPORT.sub(r"\1antidote_tpu_torch", line)
            for line in _read("antidote_tpu", rel)]
    for old, new in DIFFERS[rel]:
        at = [i for i in range(len(want))
              if want[i:i + len(old)] == old]
        assert len(at) == 1, (rel, old)
        want[at[0]:at[0] + len(old)] = new
    assert _read("antidote_tpu_torch", rel) == want


@pytest.mark.parametrize("rel", BYTES)
def test_copy_is_byte_identical(rel):
    with open(os.path.join(REPO, "antidote_tpu", rel), "rb") as a, \
            open(os.path.join(REPO, "antidote_tpu_torch", rel), "rb") as b:
        assert a.read() == b.read()


def test_orset_baseline_builds_and_runs_alike():
    """The copied native OR-Set baseline (bench.py's CPU yardstick)
    builds through each package's native/build.py with g++ and, fed the
    same seeded stream (bench.py's ``_baseline_stream`` shape), leaves
    the same count of live dots in both libraries."""
    import ctypes

    import numpy as np

    from antidote_tpu.native import build as jbuild
    from antidote_tpu_torch.native import build as tbuild

    rng = np.random.default_rng(1)
    n_ops, K = 20_000, 512
    arrays = (rng.integers(0, K, n_ops).astype(np.int64),
              (rng.random(n_ops) < 0.7).astype(np.uint8),
              rng.integers(0, 8, n_ops).astype(np.int32),
              rng.integers(0, 3, n_ops).astype(np.int32),
              np.arange(1, n_ops + 1, dtype=np.int64))
    types = (ctypes.c_int64, ctypes.c_uint8, ctypes.c_int32,
             ctypes.c_int32, ctypes.c_int64)
    live = []
    for build in (jbuild, tbuild):
        so = build.ensure_built("orset_baseline")
        assert so is not None, "g++ did not build orset_baseline.cpp"
        lib = ctypes.CDLL(so)
        lib.orset_baseline_run.restype = ctypes.c_double
        lib.orset_baseline_run.argtypes = [ctypes.c_int64] + [
            ctypes.POINTER(t) for t in types] + [
            ctypes.POINTER(ctypes.c_int64)]
        out = ctypes.c_int64(0)
        secs = lib.orset_baseline_run(
            n_ops, *(a.ctypes.data_as(ctypes.POINTER(t))
                     for a, t in zip(arrays, types)), ctypes.byref(out))
        assert secs >= 0
        live.append(out.value)
    assert live[0] == live[1] > 0
    assert tbuild.lib_path("orset_baseline").startswith(
        os.path.join(REPO, "antidote_tpu_torch", "native", "_build"))
