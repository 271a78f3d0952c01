"""The reference's remaining single-node suites against the port, on the
CPU: every case of tests/unit/test_read_serve.py, test_fused_read.py,
test_checkpoint.py, test_unlogged_evict.py, test_publish_horizon.py,
test_ckpt_segments.py, test_counter_fat_collapse.py,
test_coordinator_mocked.py, test_log_group.py, test_stream_cursor.py,
test_dep_gate.py, test_gate_adapt.py, test_gate_ring.py, test_obs.py,
test_stats.py, tests/device/test_device_plane.py and
tests/interdc/test_ship.py runs here on the port: the reference file's
own code, executed with its imports naming ``antidote_tpu_torch``
(tests/torch_refexec.py), its fixtures called as plain functions (its
autouse ones first, pytest's ``caplog`` from this test's request), and
every node, plane, store and gate it builds without a device on the CPU
(``torch_refexec.port_on_the_cpu``).  The reference file's own test
runs the JAX half of every case in the same suite, so each case runs
here on the port alone: it must pass, and wherever it committed writes
through the client API, a final read of every key it wrote at the join
of its commit VCs must not raise (the ``Recorder``; a case that leaves
its API open is read when it ends).  No case is retried.

tests/unit/test_fused_read.py runs with the port's mesh devices set to
eight ``cpu`` entries (``runtime.set_mesh_devices``), as the reference
runs it on tests/conftest.py's forced 8-device CPU mesh; its case's
``len(jax.devices())`` counts those entries (``torch_refexec.PORT_JAX``),
so the port half never imports jax.  The tracer samples nothing unless
a case sets its own rate, as the port's other parity files run it.

The later tests hold each repair the harness needed for these files:
the per-package ``tmp_path`` directory, the device patch over every
port module, parametrize values by expression, pytest's own fixtures
and autouse fixtures, a multi-line helper import, and the recorder over
an API a case builds over its own node."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from antidote_tpu_torch import runtime
from antidote_tpu_torch.obs.spans import tracer as ttracer

import torch_refexec as rx

FILES = [f"tests/unit/{n}.py" for n in (
    "test_read_serve", "test_fused_read", "test_checkpoint",
    "test_unlogged_evict", "test_publish_horizon", "test_ckpt_segments",
    "test_counter_fat_collapse", "test_coordinator_mocked",
    "test_log_group", "test_stream_cursor", "test_dep_gate",
    "test_gate_adapt", "test_gate_ring", "test_obs", "test_stats")] \
    + ["tests/device/test_device_plane.py", "tests/interdc/test_ship.py"]
#: the files whose cases run over a mesh of eight ``cpu`` entries
MESHED = ("tests/unit/test_fused_read.py",)
LOADER = rx.Loader(port=True)
CASES = [(rel, qual, params) for rel in FILES
         for qual, params in rx.cases(rel, LOADER)]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The reference code passes no device: everything it builds sits
    on the CPU; its tracer samples nothing."""
    rx.port_on_the_cpu(monkeypatch)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


@pytest.mark.parametrize("rel,qual,params", CASES,
                         ids=[rx.case_id(*c) for c in CASES])
def test_reference_case_on_the_port(rel, qual, params, tmp_path,
                                    monkeypatch, request):
    prev = runtime.set_mesh_devices(
        ["cpu"] * 8 if rel in MESHED else None)
    try:
        _jax, port_rec = rx.run_on_both(
            (None, LOADER), rel, qual, params, tmp_path, monkeypatch,
            jax=False, request=request)
    finally:
        runtime.set_mesh_devices(prev)
    rx.assert_finals(None, port_rec, False)


def _pytest_counts():
    """The cases pytest's own collection gives each file (the reference
    modules imported as pytest imports them, in a process of their
    own)."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", *FILES],
        cwd=rx.REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    ids = [ln.split("::")[0] for ln in out.stdout.splitlines()
           if "::" in ln]
    return [ids.count(f) for f in FILES]


def test_reference_cases_are_all_here():
    """The 17 files hold 262 cases with the native log backend built;
    every one is above, as many a file as pytest collects from it.
    test_log_group's ``BACKENDS`` names ``native`` only where that
    backend builds, so its count is asked of the backend the same way."""
    from antidote_tpu_torch.oplog.log import _NativeBackend

    got = [sum(r == f for r, _, _ in CASES) for f in FILES]
    log_group = 23 + (15 if _NativeBackend.load() else 0)
    assert got == [14, 5, 30, 8, 2, 19, 5, 11, log_group, 4, 19, 10, 9,
                   15, 13, 46, 14]
    assert got == _pytest_counts()


def test_port_halves_load_no_jax():
    """In a process of its own, every file executed for the port and
    test_fused_read's cases run (the one file whose cases ``import
    jax``) load neither jax nor the JAX package."""
    code = (
        "import pathlib, sys, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "from _pytest.monkeypatch import MonkeyPatch\n"
        "import torch_refexec as rx\n"
        "from antidote_tpu_torch import runtime\n"
        "mp = MonkeyPatch()\n"
        "rx.port_on_the_cpu(mp)\n"
        "runtime.set_mesh_devices(['cpu'] * 8)\n"
        "loader = rx.Loader(port=True)\n"
        f"for rel in {FILES!r}:\n"
        "    loader.module(rel)\n"
        f"rel = {MESHED[0]!r}\n"
        "for qual, params in rx.cases(rel, loader):\n"
        "    tmp = pathlib.Path(tempfile.mkdtemp())\n"
        "    with mp.context() as m:\n"
        "        rx.run_case(loader.module(rel), rel, qual, params, tmp, m,\n"
        "                    loader=loader)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'antidote_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=rx.REPO,
                         env=dict(os.environ, PYTHONPATH=rx.REPO),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


# ---------------------------------------------------------------------------
# the harness's repairs, each on a small reference-style file of its own


def _ref(tmp_path, name, body):
    """A reference-style test file under ``tmp_path`` (an absolute
    path, which torch_refexec joins onto the repo as itself)."""
    path = tmp_path / "ref" / name
    path.parent.mkdir(exist_ok=True)
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_each_half_gets_its_own_existing_tmp_path(tmp_path, monkeypatch):
    """A case that writes straight into ``tmp_path`` finds it made."""
    rel = _ref(tmp_path, "test_tmp.py", """
        def test_writes(tmp_path):
            (tmp_path / "f").write_text("x")
            assert tmp_path.name == "port"
        """)
    rx.run_on_both((None, rx.Loader(port=True)), rel, "test_writes", {},
                   tmp_path / "run", monkeypatch, jax=False)
    assert (tmp_path / "run" / "port" / "f").read_text() == "x"


def test_every_port_module_with_resolve_device_is_on_the_cpu(monkeypatch):
    """Each module that imported ``resolve_device`` is pointed at the
    CPU, not only the node and DC modules: a plane, a store and a gate
    built without a device land there."""
    import antidote_tpu_torch
    from antidote_tpu_torch.interdc import dep
    from antidote_tpu_torch.mat import device_plane, store

    patched = rx.port_on_the_cpu(monkeypatch)
    for name in ("antidote_tpu_torch.txn.node", "antidote_tpu_torch.entry",
                 "antidote_tpu_torch.mat.device_plane",
                 "antidote_tpu_torch.mat.store",
                 "antidote_tpu_torch.mat.rga_store",
                 "antidote_tpu_torch.mat.convert",
                 "antidote_tpu_torch.interdc.dep",
                 "antidote_tpu_torch.interdc.dc",
                 "antidote_tpu_torch.cluster.node"):
        assert name in patched, name
    assert device_plane.DevicePlane().device == torch.device("cpu")
    assert store.orset_shard_init(4, 2, 2, 2).dots.device.type == "cpu"
    assert dep.DependencyGate(None, "dc1", lambda: 0).device.type == "cpu"
    assert antidote_tpu_torch.resolve_device().type == "cpu"


def test_parametrize_values_by_expression(tmp_path):
    """``range``, arithmetic and a list computed at import expand as
    pytest expands them; a fixture's computed ``params`` too."""
    rel = _ref(tmp_path, "test_exprs.py", """
        import pytest

        SIDES = ["a"] + (["b"] if len("xy") == 2 else [])
        BIG = [10**9, 2 * 3]


        @pytest.fixture(params=SIDES)
        def side(request):
            return request.param


        @pytest.mark.parametrize("seed", range(3))
        def test_seed(seed, side):
            pass


        @pytest.mark.parametrize("n", BIG)
        def test_big(n):
            pass
        """)
    got = rx.cases(rel, rx.Loader(port=True))
    assert got == [("test_seed", {"side": s, "seed": i})
                   for s in ("a", "b") for i in range(3)] \
        + [("test_big", {"n": 10**9}), ("test_big", {"n": 6})]


def test_pytest_fixtures_and_autouse_fixtures(tmp_path, monkeypatch,
                                              request):
    """``caplog`` comes from the calling test's request, and an autouse
    fixture of the file runs before the case and is torn down after."""
    rel = _ref(tmp_path, "test_fixtures.py", """
        import logging

        import pytest

        RAN = []


        @pytest.fixture(autouse=True)
        def _around():
            RAN.append("up")
            yield
            RAN.append("down")


        def test_logs(caplog):
            assert RAN == ["up"]
            with caplog.at_level(logging.ERROR):
                logging.getLogger("refexec.t").error("boom")
            assert any("boom" in r.getMessage() for r in caplog.records)
        """)
    loader = rx.Loader(port=True)
    rx.run_on_both((None, loader), rel, "test_logs", {}, tmp_path / "run",
                   monkeypatch, jax=False, request=request)
    assert loader.module(rel).RAN == ["up", "down"]


def test_multiline_helper_import_names_the_same_package(tmp_path):
    """A parenthesized ``from tests.<...> import (`` over several lines
    loads the helper file for the same package, with line numbers kept;
    a case's bare ``import jax`` is the port's mesh devices."""
    rel = _ref(tmp_path, "test_helpers.py", """
        from tests.unit.test_checkpoint import (
            _commit,
            _mk_cfg,
        )


        def test_uses():
            import jax
            return jax, len(jax.devices())
        """)
    mod = rx.Loader(port=True).module(rel)
    assert mod._mk_cfg.__module__ == "ref_port_tests_unit_test_checkpoint"
    assert mod._commit.__module__ == mod._mk_cfg.__module__
    assert mod.test_uses.__code__.co_firstlineno == 8
    prev = runtime.set_mesh_devices(["cpu"] * 8)
    try:
        assert mod.test_uses() == (rx.PORT_JAX, 8)
    finally:
        runtime.set_mesh_devices(prev)


def test_recorder_follows_an_api_over_the_cases_own_node(tmp_path,
                                                         monkeypatch):
    """An ``AntidoteTPU(node=Node(...))`` the case builds is followed:
    closed, it is read before it closes; left open, it is read when the
    case ends."""
    rel = _ref(tmp_path, "test_own_node.py", """
        from antidote_tpu.api import AntidoteTPU
        from antidote_tpu.config import Config
        from antidote_tpu.txn.node import Node


        def _api(tmp_path, name):
            return AntidoteTPU(node=Node(dc_id="dc1", config=Config(
                n_partitions=1, data_dir=str(tmp_path / name))))


        def test_closed(tmp_path):
            api = _api(tmp_path, "a")
            api.update_objects_static(
                None, [(("k", "counter_pn", "b"), "increment", 3)])
            api.close()


        def test_left_open(tmp_path):
            api = _api(tmp_path, "b")
            api.update_objects_static(
                None, [(("k", "counter_pn", "b"), "increment", 4)])
        """)
    rx.port_on_the_cpu(monkeypatch)
    loader = rx.Loader(port=True)
    for qual, want in (("test_closed", 3), ("test_left_open", 4)):
        with monkeypatch.context() as mp:
            _jax, rec = rx.run_on_both((None, loader), rel, qual, {},
                                       tmp_path / qual, mp, jax=False)
        rx.assert_finals(None, rec, False)
        [(_dc, vals)] = rec.finals
        assert vals == ((repr(("k", "counter_pn", "b")), want),), qual
    for api in rec.live:
        api.close()
