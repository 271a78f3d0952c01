"""Build and bind the port's hand-written CUDA kernels (every
``csrc/*.cu``: the OR-Set kernels and the dependency gate's fixpoint).

The sources are compiled by one ``nvcc`` call for ``sm_90a`` into one
shared library with a plain C interface, at first use, into
``_cuda_build/`` beside this file, and loaded with ``ctypes``.  The
library's name carries a hash of every source and the flags, so an
edited source is rebuilt and a stale build is never loaded.  Nothing
here runs at import: the CPU tests import every module on a machine
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SOURCES = sorted((_HERE / "csrc").glob("*.cu"))
_BUILD_DIR = _HERE / "_cuda_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
#: C entry points: name -> argtypes (every one returns a cudaError_t)
_SIGNATURES = {
    "antidote_orset_read": (_I, _P, _P, _P, _P, _P, _P, _P,
                            _I64, _I, _I, _I, _P),
    "antidote_orset_fold": (_I, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "antidote_orset_gc": (_I, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "antidote_gate_fixpoint": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P),
    "antidote_gate_probe": (_I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("antidote_tpu_torch: nvcc not found on PATH or "
                           "at /usr/local/cuda/bin; the CUDA kernels cannot "
                           "be built")
    return path


def _lib_path() -> Path:
    h = hashlib.sha1(" ".join(_NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"libantidote_kernels-{h.hexdigest()[:12]}.so"


def build() -> str | None:
    """Compile the sources unless their current library exists.  Returns
    the ptxas report (registers, shared memory and spills of each
    kernel), or None when nothing was compiled; raises with nvcc's
    output on failure."""
    path = _lib_path()
    if path.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a name of this process's own, then rename: another
    # process building the same source never sees a partial library
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        names = ", ".join(s.name for s in _SOURCES)
        raise RuntimeError(f"nvcc failed for {names} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return "\n".join(ln for ln in proc.stdout.splitlines()
                     if "ptxas info" in ln or "bytes stack frame" in ln)


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (the ptxas report of a
    build goes to stderr)."""
    global _lib
    with _lock:
        if _lib is None:
            report = build()
            if report is not None:
                names = ", ".join(s.name for s in _SOURCES)
                print(f"[antidote_tpu_torch] built {names}:\n{report}",
                      file=sys.stderr)
            cdll = ctypes.CDLL(str(_lib_path()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = ctypes.c_int
            cdll.antidote_error_string.argtypes = (ctypes.c_int,)
            cdll.antidote_error_string.restype = ctypes.c_char_p
            _lib = cdll
        return _lib


def call(fn: str, *args) -> None:
    """Call C entry ``fn``; raise if the CUDA error code it returns is
    not 0 (a refused launch never runs, and a later synchronize would
    not report it)."""
    cdll = lib()
    rc = getattr(cdll, fn)(*args)
    if rc != 0:
        msg = cdll.antidote_error_string(rc).decode()
        raise RuntimeError(f"{fn}: CUDA error {rc} ({msg})")
