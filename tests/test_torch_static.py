"""The reference's static passes held over the port
(``tests/torch_static.py``): ``concurrency_lint``, ``durability_lint``
and ``trace_lint`` re-pointed at ``antidote_tpu_torch/`` report nothing,
with ``synchronize`` counted as a device sync; the kernel-span parity
rule holds; no table still names the JAX package after the patch; and
each rule of the port's own fires on a planted violation."""

import os
import textwrap

import pytest

import torch_static as ts


@pytest.fixture
def at_port(monkeypatch):
    return ts.point_at_port(monkeypatch)


@pytest.mark.parametrize("name", sorted(ts.TABLES))
def test_lint_over_the_port_is_clean(at_port, name):
    mod, _moved = at_port[name]
    problems = mod.lint(ts.REPO)
    assert not problems, "\n".join(problems)


def test_every_table_is_repointed(at_port):
    """The tables the tools sweep by are re-pointed (each one this test
    names among them), and none of the three tools still names an
    ``antidote_tpu`` path."""
    for name, tables in ts.TABLES.items():
        mod, moved = at_port[name]
        assert set(tables) <= set(moved), (name, set(tables) - set(moved))
        assert ts.jax_paths(mod) == [], name
    cl = at_port["concurrency_lint"][0]
    assert cl.PACKAGE_DIR == ts.PORT
    assert cl._BLOCKING_ALWAYS["synchronize"] == "device sync"
    assert "block_until_ready" in cl._BLOCKING_ALWAYS


def test_patch_is_undone(monkeypatch):
    """The monkeypatch leaves the tools as they were for the JAX
    package's own lint tests."""
    with monkeypatch.context() as m:
        ts.point_at_port(m)
    for name in ts.TABLES:
        mod = ts.tool(name)
        assert set(ts.TABLES[name]) <= set(ts.jax_paths(mod)), name
    assert "synchronize" not in ts.tool("concurrency_lint")._BLOCKING_ALWAYS


def test_kernel_span_parity_holds():
    assert ts.kernel_span_parity() == []


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))


def _plant_device_sync(root, _monkeypatch):
    _write(root, f"{ts.PORT}/plane.py", """
        import threading

        import torch


        class Plane:
            def __init__(self):
                self._lock = threading.Lock()

            def _host(self):
                torch.cuda.synchronize()

            def flush(self):
                with self._lock:
                    self._host()
        """)
    return [p for p in ts.tool("concurrency_lint").lint(str(root))
            if "[lock-blocking]" in p and "device sync" in p]


def _plant_root_sync(root, _monkeypatch):
    """A wait in the package root, called under a lock from another
    subpackage: the lint follows the call into the root."""
    _write(root, f"{ts.PORT}/__init__.py", """
        import torch


        def to_host(tensors):
            torch.cuda.synchronize()
            return tensors
        """)
    _write(root, f"{ts.PORT}/interdc/gate.py", """
        import threading

        from antidote_tpu_torch import to_host


        class Gate:
            def __init__(self):
                self._lock = threading.Lock()

            def fixpoint(self, out):
                with self._lock:
                    return to_host(out)
        """)
    return [p for p in ts.tool("concurrency_lint").lint(str(root))
            if "[lock-blocking]" in p]


def _plant_kernel_span(root, _monkeypatch):
    _write(root, f"{ts.JAX}/mat/pallas_kernels.py", """
        @kernel_span("mat.pallas")
        def orset_read_packed(x):
            return x

        def helper(x):
            return profiler.wrap(x, name="fused_read", subsystem="mat")
        """)
    _write(root, f"{ts.PORT}/mat/gpu_kernels.py", """
        @kernel_span("mat.pallas")
        def orset_read_packed(x):
            return x

        def fused_read(x):
            return x
        """)
    return ts.kernel_span_parity(str(root))


def _plant_jax_table(_root, monkeypatch):
    mod = ts.tool("trace_lint")
    monkeypatch.setattr(mod, "_PLANTED_DIRS",
                        (os.path.join(ts.JAX, "meta"),), raising=False)
    return ts.jax_paths(mod)


@pytest.mark.parametrize("plant", [_plant_device_sync, _plant_root_sync,
                                   _plant_kernel_span, _plant_jax_table],
                         ids=["device-sync", "device-sync-in-package-root",
                              "kernel-span-parity", "jax-path-guard"])
def test_port_rule_fires_on_a_planted_violation(at_port, tmp_path,
                                                monkeypatch, plant):
    found = plant(tmp_path, monkeypatch)
    assert len(found) == 1, found


# ------------------------------------- the build helpers publish durably

def _record_publish(monkeypatch):
    """Records every fsync (by the path of its descriptor) and every
    os.replace, in order."""
    events = []
    fsync, replace = os.fsync, os.replace

    def fsync_(fd):
        events.append(("fsync", os.readlink(f"/proc/self/fd/{fd}")))
        return fsync(fd)

    def replace_(a, b):
        events.append(("replace", str(a), str(b)))
        return replace(a, b)

    monkeypatch.setattr(os, "fsync", fsync_)
    monkeypatch.setattr(os, "replace", replace_)
    return events


def _fake_compiler(monkeypatch):
    """``subprocess.run`` writing a few bytes where ``-o`` points."""
    import subprocess

    def run(cmd, **_kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF built")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info : built\n",
                                           "")

    monkeypatch.setattr(subprocess, "run", run)


def _build_native(tmp_path, monkeypatch):
    from antidote_tpu_torch.native import build

    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    return build.ensure_built("oplog")


def _build_cuda(tmp_path, monkeypatch):
    from antidote_tpu_torch import _cuda

    monkeypatch.setattr(_cuda, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: "nvcc")
    _cuda.build()
    return str(_cuda._lib_path())


@pytest.mark.parametrize("build", [_build_native, _build_cuda],
                         ids=["native", "cuda"])
def test_build_publishes_its_library_durably(tmp_path, monkeypatch, build):
    """The g++ and nvcc builds fsync the library under its temporary
    name, rename it into place, then fsync the build directory."""
    _fake_compiler(monkeypatch)
    events = _record_publish(monkeypatch)
    out = build(tmp_path, monkeypatch)
    assert os.path.exists(out)
    renames = [i for i, e in enumerate(events)
               if e[0] == "replace" and e[2] == out]
    assert len(renames) == 1, events
    at, tmp = renames[0], events[renames[0]][1]
    assert ("fsync", tmp) in events[:at], events
    assert ("fsync", str(tmp_path)) in events[at + 1:], events
