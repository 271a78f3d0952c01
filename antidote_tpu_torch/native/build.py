"""On-demand g++ build of the native components (no pip/pybind11 in this
environment — plain C ABI + ctypes)."""

from __future__ import annotations

import os
import subprocess
import threading

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")
_LOCK = threading.Lock()


def lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"lib{name}.so")


def _src_mtime(src: str) -> float:
    """Staleness input: the .cpp AND every shared header beside it —
    a ring-layout change in tel_ring.h must rebuild both planes."""
    m = os.path.getmtime(src)
    for f in os.listdir(_NATIVE_DIR):
        if f.endswith(".h"):
            m = max(m, os.path.getmtime(os.path.join(_NATIVE_DIR, f)))
    return m


def ensure_built(name: str) -> str | None:
    """Compile antidote_tpu/native/<name>.cpp into lib<name>.so if stale.
    Returns the .so path, or None if no compiler is available."""
    src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
    out = lib_path(name)
    with _LOCK:
        if os.path.exists(out) and os.path.getmtime(out) >= _src_mtime(src):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
               "-pthread", src, "-o", out]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (FileNotFoundError, subprocess.CalledProcessError):
            return None
        return out
