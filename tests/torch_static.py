"""The reference's static passes (``tools/concurrency_lint.py``,
``tools/durability_lint.py``, ``tools/trace_lint.py``) run over the port.

The tools sweep ``antidote_tpu/`` through module-level tables: the
package directory, the declared locks and factory homes, the durable
write modules, the framed formats, the trace entry points and the rule
directories.  :func:`point_at_port` re-points every such table at
``antidote_tpu_torch/`` by monkeypatch, reading each tool's own values:
any module-level string, tuple, list, set or dict of a tool that names
an ``antidote_tpu`` path is rewritten, so a table a later change adds
to a tool follows without an edit here.  :func:`jax_paths` is the
guard: after the patch no table of the three tools names the JAX
package.  ``tools/`` itself is never edited.

Two rules are the port's own, the torch counterparts of JAX-keyed ones:

- ``synchronize`` (``torch.cuda.synchronize``, ``Event.synchronize``,
  ``Stream.synchronize``) joins concurrency_lint's ``_BLOCKING_ALWAYS``
  as a device sync, in the place of ``block_until_ready``.  Host copies
  (``.item()``, ``.cpu()``, ``.tolist()``) are not added, as the JAX
  rules do not flag ``np.asarray``.
- :func:`kernel_span_parity`: every public function under
  ``antidote_tpu/mat/`` or ``antidote_tpu/interdc/`` that carries
  ``@kernel_span`` or is wrapped by ``profiler.wrap`` has a same-named
  counterpart in the port's module that carries the port's
  ``kernel_span`` (``mat/pallas_kernels.py`` maps to
  ``mat/gpu_kernels.py``).  trace_lint's own kernel rule keys on
  ``@jax.jit``, which the port never uses.  Private names are exempt,
  as in that rule.  Both sources are read by AST; the JAX package is
  never imported.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
JAX, PORT = "antidote_tpu", "antidote_tpu_torch"

#: the tools and the tables each must have re-pointed (held by
#: test_torch_static; :func:`point_at_port` re-points every table that
#: names a JAX path, these and any other)
TABLES: Dict[str, Tuple[str, ...]] = {
    "concurrency_lint": ("PACKAGE_DIR", "KNOB_READ_DIRS",
                         "_DECLARED_LOCKS", "_FACTORY_ROUTED"),
    "durability_lint": ("PACKAGE_DIR", "_DURABLE_WRITE_MODULES",
                        "_DECLARED_IMMUTABLE", "_RECOVERY_PATHS",
                        "_FRAMED_FORMATS"),
    "trace_lint": ("ENTRY_POINTS", "_KERNEL_SPAN_DIRS", "_PUBLISH_DIR",
                   "_DECODE_DIRS", "_FUSED_DIRS", "_SYNC_DIR",
                   "_CKPT_DIR"),
}

#: the torch counterpart of ``block_until_ready``
DEVICE_SYNC = ("synchronize", "device sync")

#: JAX module -> the port's module holding its kernels' counterparts
#: (paths under each package); every other module maps to itself
KERNEL_MODULES = {"mat/pallas_kernels.py": "mat/gpu_kernels.py"}
KERNEL_DIRS = ("mat", "interdc")


def tool(name: str):
    """The tool module ``name`` of ``tools/``, imported as its own tests
    import it."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def _names_jax(s: str) -> bool:
    return s == JAX or s.startswith(JAX + "/") or s.startswith(JAX + os.sep)


def repoint(v):
    """``v`` with every string naming an ``antidote_tpu`` path (the
    package itself, or a path under it) naming the port's instead."""
    if isinstance(v, str):
        return PORT + v[len(JAX):] if _names_jax(v) else v
    if isinstance(v, dict):
        return {repoint(k): repoint(x) for k, x in v.items()}
    if isinstance(v, (tuple, list, set, frozenset)):
        return type(v)(repoint(x) for x in v)
    return v


def _tables(mod):
    """The module-level data of ``mod``: name -> value for every
    string, tuple, list, set or dict global (the docstring aside)."""
    return {n: v for n, v in vars(mod).items()
            if not n.startswith("__")
            and isinstance(v, (str, tuple, list, set, frozenset, dict))}


def jax_paths(mod) -> List[str]:
    """The tables of ``mod`` that still name an ``antidote_tpu`` path."""
    return sorted(n for n, v in _tables(mod).items() if repoint(v) != v)


def point_at_port(monkeypatch) -> dict:
    """Points the three tools at the port: every table naming the JAX
    package re-pointed, ``synchronize`` added as a device sync.
    Returns {tool name: (module, [re-pointed table names])}."""
    out = {}
    for name in TABLES:
        mod = tool(name)
        moved = []
        for attr, v in _tables(mod).items():
            new = repoint(v)
            if new != v:
                monkeypatch.setattr(mod, attr, new)
                moved.append(attr)
        out[name] = (mod, sorted(moved))
    monkeypatch.setitem(out["concurrency_lint"][0]._BLOCKING_ALWAYS,
                        *DEVICE_SYNC)
    return out


# ------------------------------------------------ the kernel-span parity

def _is_span(node: ast.expr) -> bool:
    """``kernel_span(...)`` / ``prof.kernel_span(...)`` (called or not)."""
    f = node.func if isinstance(node, ast.Call) else node
    return getattr(f, "attr", getattr(f, "id", None)) == "kernel_span"


def _is_wrap(node: ast.AST) -> bool:
    """A call ``<...>.profiler.wrap(...)`` / ``profiler.wrap(...)``."""
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                        ast.Attribute):
        return False
    owner = node.func.value
    return node.func.attr == "wrap" and getattr(
        owner, "attr", getattr(owner, "id", None)) == "profiler"


def spanned(tree: ast.Module) -> Set[str]:
    """Names of ``tree``'s profiled kernels: a def decorated with
    ``kernel_span``, a name assigned ``kernel_span(...)(...)``, and a
    ``profiler.wrap`` call's span (its constant ``name=``, else the
    function around the call)."""
    out: Set[str] = set()

    def walk(node, fn_name):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_span(d) for d in child.decorator_list):
                    out.add(child.name)
                walk(child, child.name)
                continue
            if isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call) and _is_span(child.value.func):
                out.update(t.id for t in child.targets
                           if isinstance(t, ast.Name))
            if _is_wrap(child):
                kw = {k.arg: k.value for k in child.keywords}
                name = kw.get("name")
                if isinstance(name, ast.Constant) and isinstance(
                        name.value, str):
                    out.add(name.value)
                elif fn_name is not None:
                    out.add(fn_name)
            walk(child, fn_name)

    walk(tree, None)
    return out


def _port_spanned(tree: ast.Module) -> Set[str]:
    """Names of ``tree``'s defs decorated with the port's kernel_span."""
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(_is_span(d) for d in n.decorator_list)}


def _parse(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def kernel_span_parity(root: str = REPO) -> List[str]:
    """Findings of the kernel-span parity rule over the checkout at
    ``root``: one a public profiled JAX kernel whose port counterpart is
    missing or carries no ``kernel_span``."""
    problems = []
    for d in KERNEL_DIRS:
        base = os.path.join(root, JAX, d)
        if not os.path.isdir(base):
            continue
        for fname in sorted(os.listdir(base)):
            if not fname.endswith(".py"):
                continue
            rel = f"{d}/{fname}"
            names = {n for n in spanned(_parse(os.path.join(base, fname)))
                     if not n.startswith("_")}
            if not names:
                continue
            port_rel = KERNEL_MODULES.get(rel, rel)
            port_path = os.path.join(root, PORT, port_rel)
            have = _port_spanned(_parse(port_path)) \
                if os.path.exists(port_path) else set()
            for n in sorted(names - have):
                problems.append(
                    f"{PORT}/{port_rel}::{n}: [kernel-span-parity] "
                    f"{JAX}/{rel}::{n} is profiled (kernel_span / "
                    f"profiler.wrap); its port counterpart is missing or "
                    f"carries no kernel_span")
    return problems
