"""Runs the JAX package's own test files against either package.

A reference test file is executed as it is for the JAX package, and a
second time with every import of ``antidote_tpu`` naming
``antidote_tpu_torch`` for the port.  Line numbers are kept, so a
failure points into the reference file.  Fixture decorators are
dropped and the fixtures called as plain (generator) functions;
``import causal_core`` and ``from tests.<...> import`` /
``from .conftest import`` name the same loader's copy of that file, so
a helper module is executed for the same package as its importer.  For
the port, ``__file__`` lies in tests/torch_procs/, so the reference's
subprocess drivers start the port's harnesses there (dc_proc.py,
node_proc.py) in place of the reference's.

:class:`Recorder` tallies, for one package and one case, every key the
case updated through the client API in a transaction that committed,
every committed update and every commit VC, and reads the final values
of those keys at the join of the commits on one live endpoint of each
DC whenever an endpoint closes after new commits (unless a member is
parked mid-resize); the last such snapshot is the case's final state.
:func:`assert_finals` holds a case's final states: a snapshot exists
wherever the case committed writes in this process and no read of it
raised;
for a compared case both packages committed the same updates in the
same order from the case's own thread and read equal values, and
otherwise each package's DCs read the same values.

Parametrize values and fixture ``params`` are evaluated as pytest
evaluates them: a literal as it stands, any other expression (``range``,
arithmetic, a module constant computed at import) in the module the
loader executed.  A case's autouse fixtures run before it; pytest's own
fixtures (``caplog``, ``capsys``) come from the calling test's
``request``.  For the port a bare ``import jax`` inside a case names
:data:`PORT_JAX`, whose ``devices()`` is the port's mesh devices, so no
port half loads jax; :func:`port_on_the_cpu` points every port module's
``resolve_device`` at the CPU.
"""

from __future__ import annotations

import ast
import inspect
import numbers
import os
import pkgutil
import re
import sys
import threading
import time
import types
from importlib import import_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCS = os.path.join(REPO, "tests", "torch_procs")

_IMPORT = re.compile(r"^(\s*(?:from|import) )antidote_tpu\b")
_FIXTURE = re.compile(r"^\s*@pytest\.fixture\b.*$")
_FROM_TESTS = re.compile(
    r"^(\s*)from (\.|tests\.[\w.]+\.)(\w+) import ([\w, ]+?)\s*$")
#: the first line of a parenthesized ``from tests.<...> import (``
_FROM_TESTS_OPEN = re.compile(
    r"^(\s*from (?:\.|tests\.[\w.]+\.)\w+ import )\(\s*$")
#: a case's own ``import jax`` (tests/unit/test_fused_read.py counts
#: ``jax.devices()``)
_IMPORT_JAX = re.compile(r"^(\s*)import jax\s*$")
#: name prefixes of a DC's own background threads that commit through
#: the client API (obs/probe.py's causal probe writes and retires its
#: probe elements): their commits are not the case's, and a final read
#: at their join would wait on probe traffic still in flight
_BACKGROUND = ("causal-probe-",)
#: the causal probe's keys (obs/probe.py's KEY_BUCKET), which it writes
#: in the background whoever calls it: no case's value
_PROBE_BUCKET = ("__obs__",)
_IMPORT_CAUSAL = re.compile(r"^(\s*)import causal_core as (\w+)\s*$")
#: the port's client API class is AntidoteGPU
_API_TPU = re.compile(r"^(\s*from antidote_tpu_torch\.api import .*)"
                      r"\bAntidoteTPU\b")


def cases(rel, loader=None):
    """(qualified test name, parameter dicts) of every test in a
    reference file, read from its syntax tree; each parametrized
    function gives one entry per parameter set, and so does each
    parameter of a fixture with ``params`` the test names (its value
    under the fixture's name).  A value that is neither a literal nor a
    module-level literal is evaluated in the file's module as ``loader``
    (by default a port loader) executes it, as pytest evaluates it at
    import: ``range(6)``, ``10**9``, a list computed at import."""
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    value = _evaluator(rel, tree, loader)
    fixture_params = {n.name: value(p) for n, p in _fixture_params(tree)}

    def params(fn):
        out = [{}]
        for arg in fn.args.args:
            if arg.arg in fixture_params:
                out = [dict(o, **{arg.arg: v}) for o in out
                       for v in fixture_params[arg.arg]]
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) \
                    and ast.unparse(dec.func) == "pytest.mark.parametrize":
                names = [n.strip() for n in
                         ast.literal_eval(dec.args[0]).split(",")]
                vals = list(value(dec.args[1]))
                if len(names) == 1:
                    vals = [(v,) for v in vals]
                out = [dict(o, **dict(zip(names, v)))
                       for o in out for v in vals]
        return out

    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and node.name.startswith("test_"):
            out += [(node.name, p) for p in params(node)]
        elif isinstance(node, ast.ClassDef) \
                and node.name.startswith("Test"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) \
                        and m.name.startswith("test_"):
                    out += [(f"{node.name}.{m.name}", p)
                            for p in params(m)]
    return out


def _evaluator(rel, tree, loader):
    """The value of a parametrize or ``params`` expression of ``rel``:
    a literal, a module-level name bound to a literal, or else the
    expression evaluated in the executed module."""
    #: module-level names a parametrize mark may name
    consts = {t.id: n.value for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    loader = loader or Loader(port=True)

    def value(expr):
        lit = consts.get(expr.id) if isinstance(expr, ast.Name) else expr
        try:
            return ast.literal_eval(lit)
        except (ValueError, TypeError, SyntaxError):
            pass
        return eval(compile(ast.Expression(expr), rel, "eval"),
                    loader.module(rel).__dict__)
    return value


def case_id(rel, qual, params):
    name = os.path.basename(rel)[:-3]
    if params:
        return f"{name}::{qual}[{'-'.join(map(str, params.values()))}]"
    return f"{name}::{qual}"


def _fixture_params(tree):
    """(fixture, its ``params`` expression) of each fixture with
    params."""
    for n in tree.body:
        if not isinstance(n, ast.FunctionDef):
            continue
        for d in n.decorator_list:
            if isinstance(d, ast.Call) \
                    and ast.unparse(d.func) == "pytest.fixture":
                for kw in d.keywords:
                    if kw.arg == "params":
                        yield n, kw.value


def fixture_names(rel, autouse=False):
    """The fixtures a file defines, in their order in the file (with
    ``autouse``, only those that run for every case)."""
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for n in tree.body:
        if not isinstance(n, ast.FunctionDef):
            continue
        decs = [d for d in n.decorator_list
                if ast.unparse(d).startswith("pytest.fixture")]
        if decs and (not autouse or any(
                isinstance(d, ast.Call) and any(
                    k.arg == "autouse" and ast.literal_eval(k.value)
                    for k in d.keywords) for d in decs)):
            out.append(n.name)
    return out


def _conftest(rel):
    """The conftest.py beside a reference file, if there is one."""
    conf = os.path.join(os.path.dirname(rel), "conftest.py")
    return conf if os.path.exists(os.path.join(REPO, conf)) else None


class Loader:
    """Reference test modules executed for one package."""

    def __init__(self, port: bool):
        self.port = port
        self._mods: dict = {}

    def module(self, rel):
        """The module of ``rel`` (a path under the repo root)."""
        if rel not in self._mods:
            self._mods[rel] = self._load(rel)
        return self._mods[rel]

    def _names(self, rel, names):
        mod = self.module(rel)
        return tuple(getattr(mod, n) for n in names)

    def _load(self, rel):
        path = os.path.join(REPO, rel)
        here = os.path.dirname(rel)
        with open(path, encoding="utf-8") as f:
            lines = _join_imports(f.read().split("\n"))
        src = []
        for ln in lines:
            m = _FROM_TESTS.match(ln)
            c = _IMPORT_CAUSAL.match(ln)
            j = _IMPORT_JAX.match(ln) if self.port else None
            if _FIXTURE.match(ln):
                ln = ""
            elif j:
                ln = f"{j.group(1)}jax = __port_jax__"
            elif m:
                indent, pkg, mod, names = m.groups()
                where = here if pkg == "." else pkg[:-1].replace(".", "/")
                names = [n.strip() for n in names.split(",")]
                ln = (f"{indent}{', '.join(names)}, = __ref_names__("
                      f"{os.path.join(where, mod + '.py')!r}, {names!r})")
            elif c:
                indent, alias = c.groups()
                ln = f"{indent}{alias} = __ref_module__('tests/causal_core.py')"
            elif self.port:
                ln = _IMPORT.sub(r"\1antidote_tpu_torch", ln)
                ln = _API_TPU.sub(r"\1AntidoteGPU as AntidoteTPU", ln)
            src.append(ln)
        name = f"ref_{'port' if self.port else 'jax'}_" \
            + rel[:-3].replace("/", "_")
        mod = types.ModuleType(name)
        mod.__file__ = os.path.join(PROCS, os.path.basename(rel)) \
            if self.port else path
        mod.__ref_names__ = self._names
        mod.__ref_module__ = self.module
        mod.__port_jax__ = PORT_JAX
        exec(compile("\n".join(src), path, "exec"), mod.__dict__)
        return mod


def _join_imports(lines):
    """``lines`` with each parenthesized ``from tests.<...> import (``
    over several lines put on its first line, the others left blank
    (line numbers kept)."""
    out = list(lines)
    for i, ln in enumerate(out):
        m = _FROM_TESTS_OPEN.match(ln)
        if not m:
            continue
        names, j = [], i + 1
        while ")" not in out[j]:
            names += [n.strip() for n in out[j].split(",") if n.strip()]
            out[j] = ""
            j += 1
        names += [n.strip() for n in out[j].split(")")[0].split(",")
                  if n.strip()]
        out[j] = ""
        out[i] = m.group(1) + ", ".join(names)
    return out


#: the port's stand-in for a case's ``import jax``: only ``devices()``,
#: the port's mesh devices (every card, or the list
#: ``runtime.set_mesh_devices`` set)
PORT_JAX = types.SimpleNamespace(
    devices=lambda: import_module("antidote_tpu_torch.runtime")
    .mesh_devices())


def port_on_the_cpu(monkeypatch):
    """Point ``resolve_device`` at the CPU in every module of the port
    that imported it (each module imported first, found by walking the
    package), so every node, plane, store and gate a reference case
    builds without a device sits on the CPU; returns the patched
    modules' names."""
    import torch

    pkg = import_module("antidote_tpu_torch")
    # the entry points first: bcounter alone meets interdc's cycle
    import_module("antidote_tpu_torch.interdc")
    import_module("antidote_tpu_torch.cluster")
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if not m.name.endswith("__main__"):
            import_module(m.name)
    orig = pkg.resolve_device

    def cpu(device=None):
        return torch.device("cpu" if device is None else device)

    out = []
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == pkg.__name__ \
                and getattr(mod, "resolve_device", None) is orig:
            monkeypatch.setattr(mod, "resolve_device", cpu)
            out.append(name)
    return sorted(out)


def run_case(mod, rel, qual, params, tmp_path, monkeypatch, loader=None,
             request=None):
    """Run one reference case from its executed module: fixtures of
    the file (and, with ``loader``, of the conftest.py beside it, from
    that loader) are called as plain functions and their generators
    finished after the case; a fixture with ``params`` gets a
    ``request`` whose ``param`` is the case's.  Any other name comes
    from the calling test's ``request`` (pytest's own ``capsys`` and
    ``caplog``).  The file's autouse fixtures (and its conftest's) run
    first, as pytest runs them."""
    fixtures = fixture_names(rel)
    conf = _conftest(rel) if loader is not None else None
    conf_fixtures = fixture_names(conf) if conf else []
    cls_name, _, fn_name = qual.rpartition(".")
    owner = getattr(mod, cls_name)() if cls_name else None
    fn = getattr(owner, fn_name) if owner else getattr(mod, fn_name)
    made, teardowns = {}, []

    def get(param):
        if param not in made:
            if param == "tmp_path":
                made[param] = tmp_path
            elif param == "monkeypatch":
                made[param] = monkeypatch
            elif param in params and param not in fixtures:
                made[param] = params[param]
            else:
                if param in fixtures:
                    fix = getattr(mod, param)
                elif param in conf_fixtures:
                    fix = getattr(loader.module(conf), param)
                elif request is not None:
                    made[param] = request.getfixturevalue(param)
                    return made[param]
                else:
                    raise LookupError(f"{rel}: no fixture {param!r}")
                fix_request = types.SimpleNamespace(
                    param=params.get(param))
                value = fix(*[fix_request if p == "request" else get(p)
                              for p in inspect.signature(fix).parameters])
                if inspect.isgenerator(value):
                    teardowns.append(value)
                    value = next(value)
                made[param] = value
        return made[param]

    try:
        for auto in (fixture_names(conf, autouse=True) if conf else []) \
                + fixture_names(rel, autouse=True):
            get(auto)
        fn(*[get(p) for p in inspect.signature(fn).parameters])
    finally:
        for gen in reversed(teardowns):
            for _ in gen:
                pass


def run_on_both(loaders, rel, qual, params, tmp_path, monkeypatch,
                jax=True, request=None):
    """Run one reference case on the JAX package (unless ``jax`` is
    false: the reference file's own test runs that half in the same
    suite), then on the port, each from its loader's module and in its
    own subdirectory of ``tmp_path`` (made here, as pytest makes
    ``tmp_path``); returns the two recorders, None for a half not run.
    A recorder that saw commits after its last snapshot, with an
    endpoint the case left open, reads once more when the case ends."""
    recs = []
    for port in range(2):
        if not port and not jax:
            recs.append(None)
            continue
        pkg = ("antidote_tpu", "antidote_tpu_torch")[port]
        rec = Recorder(pkg, monkeypatch)
        where = tmp_path / ("port" if port else "jax")
        where.mkdir(parents=True, exist_ok=True)
        run_case(loaders[port].module(rel), rel, qual, params, where,
                 monkeypatch, loaders[port], request)
        if rec.fresh and rec.live:
            rec.snapshot()
        recs.append(rec)
    return recs


def canon(v, type_name=None):
    """A value in a form both packages give alike: integers as ints,
    an rga's elements in their sequence order, other lists and sets as
    sorted multisets (their element order can depend on arrival order,
    which differs between runs), dicts by sorted key (a map's entry
    keyed ``(name, type)`` by its own type)."""
    if isinstance(v, bool) or v is None or isinstance(v, (str, bytes)):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, dict):
        return tuple(sorted((repr(canon(k)), canon(x, _entry_type(k)))
                            for k, x in v.items()))
    if type_name == "rga" and isinstance(v, (list, tuple)):
        return tuple(canon(x) for x in v)
    if isinstance(v, (list, tuple, set, frozenset)):
        return tuple(sorted((canon(x) for x in v), key=repr))
    return repr(v)


def _entry_type(k):
    """The nested type of a map entry's key ``(name, type)``."""
    if isinstance(k, tuple) and len(k) == 2 and isinstance(k[1], str):
        return k[1]
    return None


class Recorder:
    """Patches one package's client API (``api_cls`` and its
    subclasses' overrides) to record committed keys and commit VCs, and
    the endpoint classes (a ``DataCenter``, a ``NodeServer``, and a
    client API object the case builds over a node of its own) to track
    which are live.  An endpoint's ``close``, or a federated member's
    ``NodeInterDc.close``, after new commits takes a snapshot: every recorded key read at the join of the commits on
    one live endpoint of each DC (within the endpoint's own
    ``clock_wait_timeout_s``), before it closes; none while a member
    is parked mid-resize.  ``finals`` is the last snapshot."""

    def __init__(self, pkg_name, monkeypatch):
        p = self.pkg = pkg_name
        self.vc_cls = import_module(p + ".clocks").VC
        self.keys: dict = {}
        self.commits: list = []
        self.finals = None
        self.live: list = []
        self.fresh = False
        #: every committed update, as text (a static update's, or an
        #: interactive transaction's at its commit)
        self.ops: list = []
        #: id -> (transaction, its updates) of a transaction that
        #: updated something and has not committed yet
        self._writers: dict = {}
        #: every commit came from the thread that runs the case
        self.sequential = True
        self._case_thread = threading.get_ident()
        self._lock = threading.Lock()
        api = import_module(p + ".api")
        api_cls = getattr(api, "AntidoteGPU", None) \
            or getattr(api, "AntidoteTPU")
        dc_cls = import_module(p + ".interdc.dc").DataCenter
        srv_cls = import_module(p + ".cluster.node").NodeServer
        fed_cls = import_module(p + ".cluster.federation").NodeInterDc
        rec = self

        def keys_of(updates, tx=None):
            updates = [u for u in updates
                       if tuple(u[0])[2:] != _PROBE_BUCKET]
            ops = [repr((tuple(u[0]),) + tuple(canon(x) for x in u[1:]))
                   for u in updates]
            keys = [tuple(u[0]) for u in updates]
            if tx is not None:
                with rec._lock:
                    entry = rec._writers.setdefault(id(tx), (tx, [], []))
                    entry[1].extend(ops)
                    entry[2].extend(keys)
            return ops, keys

        def commit(vc, tx=None, ops=(), keys=()):
            if threading.current_thread().name.startswith(_BACKGROUND):
                # a DC's own background writer, not the case's
                return vc
            with rec._lock:
                if tx is not None:
                    # a read-only transaction's commit (a static
                    # read's own, on a multi-node coordinator) writes
                    # nothing
                    entry = rec._writers.pop(id(tx), None)
                    if entry is None:
                        return vc
                    ops, keys = entry[1], entry[2]
                if isinstance(vc, rec.vc_cls):
                    for key in keys:
                        rec.keys.setdefault(key, None)
                    rec.commits.append(vc)
                    rec.ops.extend(ops)
                    rec.fresh = True
                    if threading.get_ident() != rec._case_thread:
                        rec.sequential = False
            return vc

        for cls in (api_cls, dc_cls):
            orig = {n: cls.__dict__[n] for n in (
                "update_objects", "update_objects_static",
                "commit_transaction") if n in cls.__dict__}

            def wrap(name, f):
                if name == "update_objects":
                    def g(self, updates, tx, *a, **k):
                        keys_of(updates, tx)
                        return f(self, updates, tx, *a, **k)
                elif name == "update_objects_static":
                    def g(self, clock, updates, *a, **k):
                        ops, keys = keys_of(updates)
                        return commit(f(self, clock, updates, *a, **k),
                                      ops=ops, keys=keys)
                else:
                    def g(self, tx, *a, **k):
                        return commit(f(self, tx, *a, **k), tx)
                return g

            for n, f in orig.items():
                monkeypatch.setattr(cls, n, wrap(n, f))

        def own_node(self, a, k):
            """A client API object the case built over a node of its
            own: one built without a node, or one the case's own code
            built over a ``Node`` it made (not a DataCenter, nor the
            API a NodeServer or a federated member builds over its
            node)."""
            if type(self) is not api_cls:
                return False
            if k.get("node", a[3] if len(a) > 3 else None) is None:
                return True
            # new_init's caller: the code that called the constructor
            caller = sys._getframe(2).f_globals.get("__name__", "")
            return caller.startswith("ref_")

        for cls, endpoint in ((dc_cls, None), (srv_cls, None),
                              (api_cls, own_node)):
            init, close = cls.__init__, cls.close

            def new_init(self, *a, _init=init, _ep=endpoint, **k):
                _init(self, *a, **k)
                if _ep is None or _ep(self, a, k):
                    with rec._lock:
                        rec.live.append(self)

            def new_close(self, *a, _close=close, _ep=endpoint, **k):
                if _ep is None or self in rec.live:
                    if rec.fresh:
                        rec.snapshot()
                    with rec._lock:
                        if self in rec.live:
                            rec.live.remove(self)
                return _close(self, *a, **k)

            monkeypatch.setattr(cls, "__init__", new_init)
            monkeypatch.setattr(cls, "close", new_close)

        # a federated member's inter-DC layer closes before its
        # NodeServer: the snapshot reads while replication still runs
        fed_close = fed_cls.close

        def new_fed_close(self, *a, **k):
            if rec.fresh:
                rec.snapshot()
            return fed_close(self, *a, **k)

        monkeypatch.setattr(fed_cls, "close", new_fed_close)

    def snapshot(self):
        with self._lock:
            live = list(self.live)
            if any(_parked(ep) for ep in live):
                # a member mid-resize parks every read until the resize
                # is driven on: the next close (fresh stays set) reads
                return
            self.fresh = False
            keys = list(self.keys)
            commits = list(self.commits)
        if not keys:
            return
        target = self.vc_cls()
        for vc in commits:
            target = target.join(vc)
        by_dc = {}
        for ep in live:
            api = getattr(ep, "api", ep)
            node = getattr(ep, "node", None)
            if api is None or node is None:
                continue
            by_dc.setdefault(repr(node.dc_id), (api, node))
        out = []
        for dc, (api, node) in sorted(by_dc.items()):
            try:
                wait_covered(node, target)
                vals, _ = api.read_objects_static(target, keys)
                got = tuple((repr(k), canon(v, k[1]))
                            for k, v in zip(keys, vals))
            except Exception as e:  # noqa: BLE001 — assert_finals fails it
                got = f"{type(e).__name__}: {e}"
            out.append((dc, got))
        self.finals = tuple(out)


def wait_covered(node, target):
    """Under GentleRain (``txn_prot="gr"``) a static read at a client
    clock waits only for its own DC's entry and reads at a snapshot
    whose every entry is the scalar GST, the min over the stable
    snapshot's entries (reference gr_snapshot_obtain), so a commit is
    visible only once that scalar reaches every entry of its commit VC.
    A final read must first wait, within the node's
    ``clock_wait_timeout_s``, until the DC's stable snapshot covers
    ``target`` and its scalar GST covers every entry of ``target``: a
    stable snapshot that covers ``target`` entry by entry can still hold
    a scalar below a commit's own time, while another DC's entry lags
    (test_gr_final_read_waits_for_the_scalar_gst).  Clock-SI reads wait
    for every entry themselves."""
    if node.config.txn_prot != "gr":
        return
    deadline = time.monotonic() + node.config.clock_wait_timeout_s
    top = max(dict(target).values(), default=0)
    while True:
        st = type(target)(node.stable_vc())
        if st.ge(target) and min(dict(st).values(), default=0) >= top:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"stable snapshot never covered {target}")
        time.sleep(0.005)


def _causal_order(rec):
    """For each commit, the earlier commits its commit VC dominates:
    which of them it saw (a txn of another DC committed before it but
    not yet replicated is concurrent with it)."""
    vcs = rec.commits
    return [frozenset(j for j in range(i) if vcs[i].ge(vcs[j]))
            for i in range(len(vcs))]


def comparable(jax_rec, port_rec):
    """Both packages committed the same updates in the same order, each
    from the thread that runs the case, with the same causal order
    among them: their final states must then be equal."""
    return (jax_rec.sequential and port_rec.sequential
            and jax_rec.ops == port_rec.ops
            and _causal_order(jax_rec) == _causal_order(port_rec))


def assert_finals(jax_rec, port_rec, compared):
    """Every recorder that saw the case write keys holds a final
    snapshot, and no read of it raised.  A ``compared`` case (its JAX
    half ran) must be :func:`comparable` and read equal final values
    in both packages.  Otherwise (a case with concurrent writers:
    threads that run until a stop event, chaos with random aborts, DCs
    racing their replication, which commit different updates, or the
    same ones at other snapshots, in any two runs) each package's DCs
    must read the same values."""
    for rec in (jax_rec, port_rec):
        if rec is None:
            continue
        assert not rec.keys or rec.finals is not None, (
            f"{rec.pkg}: the case wrote {len(rec.keys)} keys and no "
            f"snapshot read them")
        raised = [(dc, v) for dc, v in rec.finals or ()
                  if isinstance(v, str)]
        assert not raised, (rec.pkg, raised)
    if compared:
        assert comparable(jax_rec, port_rec), (
            "the packages no longer commit the same updates in the same "
            "causal order from the case's thread", jax_rec.ops[:5],
            port_rec.ops[:5])
        assert jax_rec.keys and jax_rec.finals == port_rec.finals, \
            _pair_diff(jax_rec.finals, port_rec.finals)
        return
    for rec in (jax_rec, port_rec):
        if rec is not None and rec.finals:
            assert len({vals for _, vals in rec.finals}) == 1, (
                rec.pkg, _diff(rec.finals))


def _parked(ep):
    """A live member of a cluster resize: parked, or its txn gate
    frozen."""
    gate = getattr(getattr(ep, "node", None), "txn_gate", None)
    return bool(getattr(ep, "_resize_parking", False)
                or getattr(gate, "_frozen", False))


def _diff(finals):
    """The keys whose values differ between the DCs of a snapshot."""
    rows = [dict(vals) for _, vals in finals]
    return {k: [r.get(k) for r in rows] for k in rows[0]
            if len({repr(r.get(k)) for r in rows}) > 1}


def _pair_diff(a, b):
    """Where two snapshots differ: per DC, the keys whose values
    differ."""
    out = {}
    for (dc, x), (_, y) in zip(a or (), b or ()):
        dx, dy = dict(x), dict(y)
        out[dc] = {k: (dx.get(k), dy.get(k)) for k in dx
                   if dx.get(k) != dy.get(k)}
    return out
