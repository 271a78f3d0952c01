"""The port's client front end (antidote_tpu_torch.pb: the native
``ApbTerm`` protocol and the upstream antidote_pb codes on one port, and
antidote_tpu_torch.console) against the JAX package's, on the CPU.

- Every case of tests/pb/test_pb_client.py, test_pb_compat.py and
  test_admin.py runs here on the port: the reference file's own code,
  executed with its imports naming ``antidote_tpu_torch``
  (tests/torch_refexec.py), every ``AntidoteGPU`` and ``DataCenter`` it
  builds without a device on the CPU.  The reference file's own test
  runs the JAX half in the same suite; here it runs too where it adds a
  comparison (``COMPARED``: the case sends the same requests in the
  same order from one thread), and every response the case's clients
  decode must then be equal in both packages but for the fields that
  carry a wall clock or a server token (``_masked``).
- A seeded request tape holding every request code of both protocols
  goes once to a JAX ``PbServer`` over ``AntidoteTPU`` and once to a
  port ``PbServer`` over ``AntidoteGPU(device="cpu")``: the response
  frames are equal byte for byte, but for the masked fields, which are
  compared by shape.
- The port's console (``python -m antidote_tpu_torch.console``, a
  subprocess) against a JAX server and the JAX console against a port
  server print the same output but for clocks; the port's console
  process loads no module of jax or the JAX package and creates no CUDA
  context.

Both tracers sample nothing (the JAX kernel-span fallback breaks
sampled device reads, ROADMAP §3)."""

import json
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from antidote_tpu.api import AntidoteTPU
from antidote_tpu.config import Config as JConfig
from antidote_tpu.interdc import InProcBus as JInProcBus
from antidote_tpu.interdc.dc import DataCenter as JDataCenter
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu.pb import client as jclient
from antidote_tpu.pb.server import PbServer as JPbServer
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.interdc import InProcBus
from antidote_tpu_torch.interdc import dc as tdc_mod
from antidote_tpu_torch.interdc import termcodec
from antidote_tpu_torch.interdc.dc import DataCenter
from antidote_tpu_torch.obs.spans import tracer as ttracer
from antidote_tpu_torch.pb import antidote_compat_pb2 as cpb
from antidote_tpu_torch.pb import antidote_pb2 as pb
from antidote_tpu_torch.pb import client as tclient
from antidote_tpu_torch.pb import codec, compat
from antidote_tpu_torch.pb.server import PbServer
from antidote_tpu_torch.txn import node as tnode_mod

import torch_refexec as rx

REPO = rx.REPO
FILES = ("tests/pb/test_pb_client.py", "tests/pb/test_pb_compat.py",
         "tests/pb/test_admin.py")
CASES = [(rel, qual, params) for rel in FILES
         for qual, params in rx.cases(rel)]
#: the cases whose JAX half is compared with the port's, response for
#: response: one thread sends the same requests in the same order to a
#: server over one node (tests/pb's term codec and framing cases send
#: nothing, the two-DC cases read at replication's pace, and
#: test_flag_persists_across_dc_restart has no client)
COMPARED = {
    "test_pb_client::TestEveryCrdtType.test_counter_pn",
    "test_pb_client::TestEveryCrdtType.test_counter_fat",
    "test_pb_client::TestEveryCrdtType.test_counter_b",
    "test_pb_client::TestEveryCrdtType.test_sets[set_aw]",
    "test_pb_client::TestEveryCrdtType.test_sets[set_rw]",
    "test_pb_client::TestEveryCrdtType.test_set_go",
    "test_pb_client::TestEveryCrdtType.test_register_lww",
    "test_pb_client::TestEveryCrdtType.test_register_mv",
    "test_pb_client::TestEveryCrdtType.test_flags[flag_ew-False]",
    "test_pb_client::TestEveryCrdtType.test_flags[flag_dw-False]",
    "test_pb_client::TestEveryCrdtType.test_map_rr",
    "test_pb_client::TestEveryCrdtType.test_map_go",
    "test_pb_client::TestEveryCrdtType.test_rga",
    "test_pb_client::TestTxnLifecycle.test_interactive_txn",
    "test_pb_client::TestTxnLifecycle.test_abort",
    "test_pb_client::TestTxnLifecycle.test_txn_properties",
    "test_pb_client::TestTxnLifecycle.test_static_read_honors_properties",
    "test_pb_client::TestTxnLifecycle.test_unknown_txid_is_error",
    "test_pb_client::TestTxnLifecycle.test_bad_type_is_error",
    "test_pb_client::TestTxnLifecycle.test_connection_drop_aborts_open_txn",
    "test_pb_client::TestTxnLifecycle.test_descriptor_on_plain_node_errors",
    "test_pb_compat::test_interactive_session_counter_set_reg_flag",
    "test_pb_compat::test_static_update_and_map",
    "test_pb_compat::test_native_and_compat_share_one_port",
    "test_pb_compat::test_unknown_type_returns_error_resp",
    "test_pb_compat::test_interactive_error_and_abort_flow",
    "test_admin::test_create_dc_over_wire",
    "test_admin::test_admin_status_shape",
    "test_admin::test_runtime_flag_toggle_applies_to_logs",
    "test_admin::test_console_commands",
}
LOADERS = (rx.Loader(port=False), rx.Loader(port=True))
_FOREIGN = ("jax", "jaxlib", "antidote_tpu")


def _cpu(device=None):
    return torch.device("cpu" if device is None else device)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The reference code passes no device: every port node and DC it
    builds sits on the CPU; both tracers sample nothing."""
    monkeypatch.setattr(tnode_mod, "resolve_device", _cpu)
    monkeypatch.setattr(tdc_mod, "resolve_device", _cpu)
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


# ------------------------------------------------ the masked fields

def _vc_shape(vc):
    return sorted(vc) if isinstance(vc, dict) else vc


def _token_shape(token):
    return _vc_shape(termcodec.decode(token)) if token else None


def _masked(msg):
    """(full message name, its bytes with every field that carries a
    wall clock or a server token cleared, those fields' shapes).  The
    fields, by message:

    - ``antidotepb.ApbStartTransactionResp.txid``: a server token
      (uuid4), shape its length;
    - ``antidotepb.ApbCommitResp.commit_clock`` and
      ``antidotepb.ApbStaticReadObjectsResp.commit_clock``: a VC of the
      node's wall clock, shape its DCs;
    - ``antidotepb.ApbAdminStatusResp.info``'s ``clock_us`` (the wall
      clock, shape its type) and ``stable_vc`` (shape its DCs);
    - ``antidotepb.compat.ApbStartTransactionResp.transaction_descriptor``:
      a server token, shape its length;
    - ``antidotepb.compat.ApbCommitResp.commit_time`` and
      ``antidotepb.compat.ApbStaticReadObjectsResp.committime.commit_time``:
      a commit VC as a clock token, shape its DCs."""
    name = msg.DESCRIPTOR.full_name
    m = type(msg)()
    m.CopyFrom(msg)
    shape = {}
    if name == "antidotepb.ApbStartTransactionResp":
        shape["txid"] = len(m.txid)
        m.txid = b""
    elif name in ("antidotepb.ApbCommitResp",
                  "antidotepb.ApbStaticReadObjectsResp"):
        if m.HasField("commit_clock"):
            shape["commit_clock"] = _vc_shape(
                codec.term_from_pb(m.commit_clock))
            m.ClearField("commit_clock")
    elif name == "antidotepb.ApbAdminStatusResp" and m.HasField("info"):
        info = codec.term_from_pb(m.info)
        shape["clock_us"] = type(info.pop("clock_us")).__name__
        shape["stable_vc"] = _vc_shape(info.pop("stable_vc"))
        m.ClearField("info")
        codec.term_to_pb(info, m.info)
    elif name == "antidotepb.compat.ApbStartTransactionResp":
        shape["transaction_descriptor"] = len(m.transaction_descriptor)
        m.transaction_descriptor = b""
    elif name == "antidotepb.compat.ApbCommitResp":
        shape["commit_time"] = _token_shape(m.commit_time)
        m.commit_time = b""
    elif name == "antidotepb.compat.ApbStaticReadObjectsResp":
        shape["commit_time"] = _token_shape(m.committime.commit_time)
        m.committime.commit_time = b""
    return name, m.SerializeToString(), shape


def _decode(proto, code, body):
    """A response frame's message.  Its protocol is its request's: the
    two protocols' response codes overlap (107 and 108)."""
    if proto == "native":
        return codec.decode_msg(code, body)
    msg = getattr(cpb, {v: k for k, v in compat.CODES.items()}[code])()
    msg.ParseFromString(body)
    return msg


def _frame_masked(proto, code, body):
    """A response frame as (code, masked bytes, shapes)."""
    _name, masked, shape = _masked(_decode(proto, code, body))
    return code, masked, shape


# ------------------------------------------------- the reference suites

class _Responses:
    """Every response one package's clients decode in a case: the
    native client's (``PbClient._call``, errors included) and the
    compat session helper's (the executed module's ``_recv``)."""

    def __init__(self, client_mod, loader, monkeypatch):
        self.got = []
        call = client_mod.PbClient._call
        rec = self

        def recorded(cl, msg):
            try:
                resp = call(cl, msg)
            except client_mod.PbServerError as e:
                rec.got.append(("error", str(e)))
                raise
            rec.got.append(_masked(resp))
            return resp

        monkeypatch.setattr(client_mod.PbClient, "_call", recorded)
        mod = loader.module("tests/pb/test_pb_compat.py")
        recv = mod._recv

        def recv_recorded(sock):
            resp = recv(sock)
            rec.got.append(_masked(resp))
            return resp

        monkeypatch.setattr(mod, "_recv", recv_recorded)


@pytest.mark.parametrize("rel,qual,params", CASES,
                         ids=[rx.case_id(*c) for c in CASES])
def test_reference_case_on_both(rel, qual, params, tmp_path, monkeypatch,
                                request):
    compared = rx.case_id(rel, qual, params) in COMPARED
    got = []
    for port, client_mod in enumerate((jclient, tclient)):
        if not port and not compared:
            continue
        rec = _Responses(client_mod, LOADERS[port], monkeypatch)
        rx.run_case(LOADERS[port].module(rel), rel, qual, params,
                    tmp_path / ("port" if port else "jax"), monkeypatch,
                    LOADERS[port], request)
        got.append(rec.got)
    if compared:
        assert got[0] and got[0] == got[1]


def test_reference_cases_are_all_here():
    """tests/pb holds 63 cases in 3 files; every one is above, 30 of
    them compared response for response across the packages."""
    assert len(CASES) == 63
    assert [sum(r == rel for r, _, _ in CASES) for rel in FILES] \
        == [26, 31, 6]
    ids = {rx.case_id(*c) for c in CASES}
    assert len(COMPARED) == 30 and COMPARED <= ids


def test_copies_share_the_message_classes():
    """The generated modules are byte-identical copies, so both packages
    share protobuf's message classes (one descriptor pool)."""
    from antidote_tpu.pb import antidote_compat_pb2 as jcpb
    from antidote_tpu.pb import antidote_pb2 as jpb

    for ours, theirs in ((pb, jpb), (cpb, jcpb)):
        with open(ours.__file__, "rb") as a, open(theirs.__file__, "rb") as b:
            assert a.read() == b.read()
    assert pb.ApbStartTransaction is jpb.ApbStartTransaction
    assert cpb.ApbReadObjects is jcpb.ApbReadObjects


def test_front_end_leaves_jax_out():
    """In a fresh interpreter, importing the wire protocol and the
    console loads no module of jax or the JAX package."""
    code = ("import sys\n"
            "import antidote_tpu_torch.pb, antidote_tpu_torch.console\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {_FOREIGN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------ the request tape

#: every type the codec carries, with the ops the tape draws for it:
#: (op name, argument maker taking the rng)
def _e(rng):
    return b"e%d" % int(rng.integers(6))


def _n(rng):
    return int(rng.integers(1, 40))


OPS = {
    "counter_pn": [("increment", _n), ("decrement", _n)],
    "counter_fat": [("increment", _n), ("decrement", _n),
                    ("reset", lambda r: ())],
    "counter_b": [("increment", lambda r: (_n(r), "dc1")),
                  ("decrement", lambda r: (int(r.integers(1, 30)), "dc1"))],
    "set_aw": [("add", _e), ("add_all", lambda r: [_e(r), _e(r)]),
               ("remove", _e)],
    "set_rw": [("add", _e), ("remove_all", lambda r: [_e(r)]),
               ("add_all", lambda r: [_e(r), _e(r)])],
    "set_go": [("add", _e), ("add_all", lambda r: [_e(r), _e(r)])],
    "register_lww": [("assign", _e)],
    "register_mv": [("assign", _e)],
    "flag_ew": [("enable", lambda r: ()), ("disable", lambda r: ())],
    "flag_dw": [("enable", lambda r: ()), ("disable", lambda r: ())],
    "map_rr": [("update", lambda r: ((b"f%d" % int(r.integers(2)),
                                      "counter_fat"),
                                     ("increment", _n(r)))),
               ("update", lambda r: ((b"t", "set_aw"), ("add", _e(r)))),
               ("remove", lambda r: (b"f0", "counter_fat"))],
    "map_go": [("update", lambda r: ((b"n%d" % int(r.integers(2)),
                                      "counter_pn"),
                                     ("increment", _n(r))))],
    "rga": [("add_right", lambda r: (0, _e(r))),
            ("remove", lambda r: 1)],
}
COMPAT_TYPES = (cpb.COUNTER, cpb.ORSET, cpb.LWWREG, cpb.MVREG, cpb.RWSET,
                cpb.FATCOUNTER, cpb.FLAG_EW, cpb.FLAG_DW)


def _bound(rng, tname):
    return (f"{tname}_{int(rng.integers(3))}", tname, b"bkt")


class _Ctx:
    """One server's side of the tape: its tokens and clocks, which
    later requests echo."""

    def __init__(self):
        self.txid = b""
        self.clock = pb.ApbTerm(none=True)
        self.descriptor = b""
        self.ctoken = b""


def _native_update(rng, n):
    ups = []
    for _ in range(n):
        tname = list(OPS)[int(rng.integers(len(OPS)))]
        op, arg = OPS[tname][int(rng.integers(len(OPS[tname])))]
        ups.append((_bound(rng, tname), op, arg(rng)))
    return ups


def _fill(req, ups):
    for bo, op, param in ups:
        u = req.updates.add()
        codec.bound_to_pb(bo, u.object)
        u.operation = op
        codec.term_to_pb(param, u.parameter)
    return req


def _compat_bound(rng, t):
    b = cpb.ApbBoundObject()
    b.key = b"k%d_%d" % (t, int(rng.integers(2)))
    b.type = t
    b.bucket = b"bkt"
    return b


def _compat_op(rng, u, t):
    """One upstream update of type ``t`` into ``u`` (an ApbUpdateOp)."""
    u.boundobject.CopyFrom(_compat_bound(rng, t))
    op = u.operation
    if t in (cpb.COUNTER, cpb.FATCOUNTER):
        op.counterop.inc = int(rng.integers(-5, 20))
    elif t in (cpb.ORSET, cpb.RWSET):
        op.setop.optype = cpb.ApbSetUpdate.ADD
        op.setop.adds.extend([_e(rng), _e(rng)])
        if rng.random() < 0.3:
            op.setop.rems.append(_e(rng))
    elif t in (cpb.LWWREG, cpb.MVREG):
        op.regop.value = _e(rng)
    else:
        op.flagop.value = bool(rng.random() < 0.7)


def _tape(seed=17, rounds=40):
    """A seeded tape of request makers, each ``make(ctx) -> (protocol,
    message)``.  Every request code of both protocols appears: static
    and interactive transactions over every type ``OPS`` lists (RYW
    reads, commits, aborts, properties), an unknown txid, a bad type,
    admin status, flags, create_dc and the descriptor calls (a plain
    node refuses them) on the native side; interactive and static
    sessions, a map, an unknown descriptor and an abort on the upstream
    side."""
    rng = np.random.default_rng(seed)
    tape = []

    def add(fn):
        tape.append(fn)

    for r in range(rounds):
        kind = int(rng.integers(6))
        if kind == 0:
            ups = _native_update(rng, int(rng.integers(1, 4)))

            def f(ctx, ups=ups):
                req = _fill(pb.ApbStaticUpdateObjects(), ups)
                req.clock.CopyFrom(ctx.clock)
                return "native", req
            add(f)
            objs = [u[0] for u in ups]

            def g(ctx, objs=objs):
                req = pb.ApbStaticReadObjects()
                req.clock.CopyFrom(ctx.clock)
                for bo in objs:
                    codec.bound_to_pb(bo, req.objects.add())
                return "native", req
            add(g)
        elif kind == 1:
            certify = int(rng.integers(3))
            ups = _native_update(rng, int(rng.integers(1, 3)))
            end = ("commit", "abort")[int(rng.random() < 0.25)]

            def start(ctx, certify=certify):
                req = pb.ApbStartTransaction()
                req.clock.CopyFrom(ctx.clock)
                req.properties.certify = certify
                return "native", req
            add(start)
            for step in ("read", "update", "read"):
                def h(ctx, step=step, ups=ups):
                    if step == "update":
                        return "native", _fill(
                            pb.ApbUpdateObjects(txid=ctx.txid), ups)
                    req = pb.ApbReadObjects(txid=ctx.txid)
                    for bo, _op, _p in ups:
                        codec.bound_to_pb(bo, req.objects.add())
                    return "native", req
                add(h)

            def fin(ctx, end=end):
                cls = pb.ApbCommitTransaction if end == "commit" \
                    else pb.ApbAbortTransaction
                return "native", cls(txid=ctx.txid)
            add(fin)
        elif kind == 2:
            ts = [COMPAT_TYPES[int(i)] for i in
                  rng.integers(len(COMPAT_TYPES), size=3)]
            seeds = [int(x) for x in rng.integers(1 << 30, size=3)]
            end = int(rng.random() < 0.2)

            def cstart(ctx):
                req = cpb.ApbStartTransaction()
                if ctx.ctoken:
                    req.timestamp = ctx.ctoken
                req.properties.SetInParent()
                return "compat", req
            add(cstart)

            def cupd(ctx, ts=ts, seeds=seeds):
                req = cpb.ApbUpdateObjects()
                req.transaction_descriptor = ctx.descriptor
                for t, s in zip(ts, seeds):
                    _compat_op(np.random.default_rng(s),
                               req.updates.add(), t)
                return "compat", req
            add(cupd)

            def cread(ctx, ts=ts, seeds=seeds):
                req = cpb.ApbReadObjects()
                req.transaction_descriptor = ctx.descriptor
                for t, s in zip(ts, seeds):
                    req.boundobjects.add().CopyFrom(
                        _compat_bound(np.random.default_rng(s), t))
                return "compat", req
            add(cread)

            def cend(ctx, end=end):
                cls = (cpb.ApbCommitTransaction,
                       cpb.ApbAbortTransaction)[end]
                req = cls()
                req.transaction_descriptor = ctx.descriptor
                return "compat", req
            add(cend)
        elif kind == 3:
            t = COMPAT_TYPES[int(rng.integers(len(COMPAT_TYPES)))]
            s = int(rng.integers(1 << 30))
            gmap = bool(rng.random() < 0.5)

            def csu(ctx, t=t, s=s, gmap=gmap):
                req = cpb.ApbStaticUpdateObjects()
                req.transaction.SetInParent()
                if ctx.ctoken:
                    req.transaction.timestamp = ctx.ctoken
                rr = np.random.default_rng(s)
                if gmap:
                    u = req.updates.add()
                    u.boundobject.CopyFrom(_compat_bound(rr, cpb.GMAP))
                    nest = u.operation.mapop.updates.add()
                    nest.key.key = b"hits%d" % int(rr.integers(2))
                    nest.key.type = cpb.COUNTER
                    nest.update.counterop.inc = int(rr.integers(1, 9))
                else:
                    _compat_op(rr, req.updates.add(), t)
                return "compat", req
            add(csu)

            def csr(ctx, t=t, s=s, gmap=gmap):
                req = cpb.ApbStaticReadObjects()
                req.transaction.timestamp = ctx.ctoken
                rr = np.random.default_rng(s)
                req.objects.add().CopyFrom(
                    _compat_bound(rr, cpb.GMAP if gmap else t))
                return "compat", req
            add(csr)
        elif kind == 4:
            name = ("sync_log", "certify", "txn_prot", "nope")[
                int(rng.integers(4))]
            value = {"sync_log": bool(rng.random() < 0.5),
                     "certify": True, "txn_prot": "clocksi",
                     "nope": 1}[name]

            def adm(ctx):
                return "native", pb.ApbAdminStatus()
            add(adm)

            def getf(ctx, name=name):
                return "native", pb.ApbGetFlag(name=name)
            add(getf)

            def setf(ctx, name=name, value=value):
                req = pb.ApbSetFlag(name=name)
                codec.term_to_pb(value, req.value)
                return "native", req
            add(setf)
        else:
            # the error paths: an unknown txid (native, compat), a bad
            # type, the descriptor calls of a plain node, create_dc
            nodes = ([], ["dc1"], ["dc1", "other@host"])[
                int(rng.integers(3))]

            def bad(ctx, which=int(rng.integers(5)), nodes=nodes):
                if which == 0:
                    req = pb.ApbReadObjects(txid=b"nope")
                    codec.bound_to_pb(("k", "counter_pn", b"b"),
                                      req.objects.add())
                    return "native", req
                if which == 1:
                    return "native", _fill(pb.ApbStaticUpdateObjects(), [
                        (("k", "no_such_type", b"b"), "op", 1)])
                if which == 2:
                    req = cpb.ApbCommitTransaction()
                    req.transaction_descriptor = b"nope"
                    return "compat", req
                if which == 3:
                    return "native", pb.ApbGetConnectionDescriptor()
                return "native", pb.ApbCreateDc(nodes=nodes)
            add(bad)
            if r % 2:
                def conn(ctx):
                    return "native", pb.ApbConnectToDcs(descriptors=[b""])
                add(conn)

    # every code at least once, whatever the draws
    add(lambda ctx: ("native", pb.ApbGetConnectionDescriptor()))
    add(lambda ctx: ("native", pb.ApbConnectToDcs(descriptors=[b""])))
    add(lambda ctx: ("native", pb.ApbCreateDc(nodes=[])))
    add(lambda ctx: ("native", pb.ApbAdminStatus()))
    # a code neither protocol registers: the native error reply
    add(lambda ctx: ("raw", (23, b"")))
    return tape


def _send_tape(port, tape):
    """Sends the tape over one connection; returns every response
    frame as (protocol, code, bytes)."""
    ctx = _Ctx()
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        for make in tape:
            proto, msg = make(ctx)
            if proto == "native":
                s.sendall(codec.encode_msg(msg))
            elif proto == "raw":
                proto, (code, body) = "native", msg
                s.sendall(struct.pack(">IB", len(body) + 1, code) + body)
            else:
                body = msg.SerializeToString()
                s.sendall(struct.pack(">IB", len(body) + 1,
                                      compat.CODES[type(msg).__name__])
                          + body)
            code, body = codec.read_frame(s)
            out.append((proto, code, body))
            resp = _decode(proto, code, body)
            if proto == "compat":
                name = type(resp).__name__
                if name == "ApbStartTransactionResp":
                    ctx.descriptor = resp.transaction_descriptor
                elif name == "ApbCommitResp" and resp.commit_time:
                    ctx.ctoken = resp.commit_time
                elif name == "ApbStaticReadObjectsResp":
                    ctx.ctoken = resp.committime.commit_time
                continue
            if isinstance(resp, pb.ApbStartTransactionResp):
                ctx.txid = resp.txid
            elif isinstance(resp, pb.ApbCommitResp) and resp.success:
                ctx.clock.CopyFrom(resp.commit_clock)
    return out


def test_request_tape_gives_equal_frames(tmp_path):
    """The tape through a JAX server and a port server: equal response
    frames, byte for byte but for the masked fields (``_masked``),
    whose shapes are equal; every request code of both protocols was
    sent."""
    tape = _tape()
    cfg = dict(n_partitions=4)
    jdb = AntidoteTPU(dc_id="dc1", config=JConfig(**cfg),
                      data_dir=str(tmp_path / "jax"))
    tdb = AntidoteGPU(dc_id="dc1", config=Config(**cfg),
                      data_dir=str(tmp_path / "port"), device="cpu")
    got = []
    try:
        for srv_cls, db in ((JPbServer, jdb), (PbServer, tdb)):
            srv = srv_cls(db, port=0).start()
            try:
                got.append(_send_tape(srv.port, tape))
            finally:
                srv.stop()
    finally:
        jdb.close()
        tdb.close()
    jax_frames, port_frames = got
    assert len(jax_frames) == len(port_frames) == len(tape)
    masked = [[_frame_masked(*f) for f in side] for side in got]
    for i, (j, t) in enumerate(zip(*masked)):
        assert j == t, (i, j, t)
    # where nothing is masked, the frames are the same bytes
    same = [a == b for a, b in zip(jax_frames, port_frames)]
    assert all(s or m[2] for s, m in zip(same, masked[1]))
    # the tape reached every code of both protocols
    sent = set()
    ctx = _Ctx()
    for make in tape:
        proto, msg = make(ctx)
        if proto != "raw":
            sent.add(codec.MSG_CODES[type(msg)] if proto == "native"
                     else compat.CODES[type(msg).__name__])
    assert sent == set(range(10, 23)) | set(compat._REQUESTS)
    codes = {(p, c) for p, c, _ in port_frames}
    assert {("compat", 0), ("native", 100)} <= codes
    failed = sum(not _succeeded(*f) for f in port_frames)
    assert 0 < failed < len(port_frames) // 2


def _succeeded(proto, code, body):
    msg = _decode(proto, code, body)
    if type(msg).__name__ == "ApbErrorResp":
        return False
    if type(msg).__name__ == "ApbStaticReadObjectsResp" \
            and proto == "compat":
        return msg.objects.success
    return msg.success


def test_tape_types_read_back_plain(tmp_path):
    """Values a port node serves after a flush to its planes and a GC
    (the value caches emptied), and its admin status, are plain Python
    terms the codec carries: no numpy or torch scalar reaches the
    wire."""
    db = AntidoteGPU(dc_id="dc1", config=Config(n_partitions=2),
                     data_dir=str(tmp_path), device="cpu")
    try:
        rng = np.random.default_rng(3)
        ups = [(_bound(rng, t), op, arg(rng)) for t in OPS
               for op, arg in OPS[t][:1]]
        ct = db.update_objects_static(None, ups)
        for pm in db.node.partitions:
            pm.device.flush()
            pm.device.gc(db.node.stable_vc())
            with pm._lock:
                pm._val_cache.clear()
        vals, _ = db.read_objects_static(ct, [u[0] for u in ups])
        for v in vals + [db.admin_status()]:
            codec.term_to_pb(v)
    finally:
        db.close()


# ---------------------------------------------------------- the consoles

#: runs ``python -m antidote_tpu_torch.console ARGS`` and, at exit,
#: writes to stderr the modules of jax or the JAX package it loaded and
#: whether it created a CUDA context
_PROBE = (
    "import atexit, json, runpy, sys\n"
    "def _report():\n"
    "    import torch\n"
    f"    bad = sorted(m for m in sys.modules if m.split('.')[0] in {_FOREIGN!r})\n"
    "    sys.stderr.write('\\nPROBE ' + json.dumps({'foreign': bad, "
    "'cuda': torch.cuda.is_initialized()}) + '\\n')\n"
    "atexit.register(_report)\n"
    "sys.argv[0] = 'antidote_tpu_torch.console'\n"
    "runpy.run_module('antidote_tpu_torch.console', run_name='__main__',"
    " alter_sys=True)\n")


def _consoles(runs):
    """Console commands, each in its own process, all at once: ``runs``
    holds (port's console?, server port, arguments); returns (exit
    code, stdout, the port's probe or None, stderr) of each."""
    procs = []
    for port_pkg, srv_port, args in runs:
        cmd = [sys.executable, "-c", _PROBE] if port_pkg else \
            [sys.executable, "-m", "antidote_tpu.console"]
        procs.append(subprocess.Popen(
            cmd + ["--port", str(srv_port), *args], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        probe = None
        for ln in stderr.splitlines():
            if ln.startswith("PROBE "):
                probe = json.loads(ln[6:])
        out.append((p.returncode, stdout, probe, stderr))
    return out


def _unclocked(cmd, text):
    """A console's output without its clocks: ``status``'s
    ``clock_us`` and ``stable_vc`` values."""
    if cmd != "status":
        return text
    st = json.loads(text)
    st["clock_us"] = type(st["clock_us"]).__name__
    st["stable_vc"] = sorted(st["stable_vc"])
    return st


def test_consoles_against_each_others_servers(tmp_path):
    """The port's console against a JAX DC's server, and the JAX
    console against a port DC's: ``status``, ``ring``, ``flag set`` /
    ``get`` and ``descriptor FILE`` print the same but for clocks, and
    the descriptor files are the same bytes.  Each port console process
    exits 0, loads no jax and creates no CUDA context."""
    jdc = JDataCenter("dcA", JInProcBus(), config=JConfig(
        n_partitions=2, data_dir=str(tmp_path / "jax")))
    tdc = DataCenter("dcA", InProcBus(), config=Config(
        n_partitions=2, data_dir=str(tmp_path / "port")), device="cpu")
    servers = [JPbServer(jdc, port=0).start(), PbServer(tdc, port=0).start()]
    try:
        for dc in (jdc, tdc):
            dc.update_objects_static(None, [
                (("k", "counter_pn", "b"), "increment", 4),
                (("s", "set_aw", "b"), "add", b"x")])
        files = [str(tmp_path / "t.desc"), str(tmp_path / "j.desc")]
        # in waves of commands that do not depend on each other's
        # effects: the port's console at the JAX server beside the JAX
        # console at the port's server
        waves = [[("status",), ("ring",), ("descriptor", "F")],
                 [("flag", "set", "sync_log", "on")],
                 [("flag", "get", "sync_log")]]
        for wave in waves:
            runs = [(side == 0, servers[side].port,
                     [files[side] if a == "F" else a for a in args])
                    for args in wave for side in (0, 1)]
            got = _consoles(runs)
            for args, (t, j) in zip(wave, zip(got[::2], got[1::2])):
                assert t[0] == 0 and j[0] == 0, (t[3], j[3])
                assert t[2] == {"foreign": [], "cuda": False}, t[2]
                if args[0] == "descriptor":
                    assert t[1].replace(files[0], "F") \
                        == j[1].replace(files[1], "F")
                else:
                    assert _unclocked(args[0], t[1]) \
                        == _unclocked(args[0], j[1])
        blobs = [open(f, "rb").read() for f in files]
        assert blobs[0] == blobs[1]
        assert codec.descriptor_from_bytes(blobs[0]).dc_id == "dcA"
    finally:
        for s in servers:
            s.stop()
        jdc.close()
        tdc.close()
