"""The port's TCP inter-DC transport (antidote_tpu_torch.interdc.tcp:
the pub and query channels, the staged zero-copy fan-out and the native
publish hub built from native/fabric.cpp) against the JAX package's, on
the CPU.

- Every case of tests/interdc/test_tcp_transport.py runs here on the
  port: the reference file's own code, executed with its imports
  naming ``antidote_tpu_torch`` (tests/torch_refexec.py), every port
  ``DataCenter`` built without a device on the CPU; the cross-process
  cases drive the port's DC harness (tests/torch_procs/dc_proc.py).
  The reference file's own test runs the JAX half of every case in the
  same suite; it runs here too where it adds a comparison
  (``COMPARED``: both packages commit the same updates in the same
  order, and the final values of the keys the case wrote in this
  process are equal).  The other cases (cross-process, or writing
  nothing in this process) run on the port alone.
- The TCP half of tests/multidc/test_interest_routing.py's
  ``TestLiveRehelloTcp`` (the port ran only its in-process half
  before) runs on the port and must pass.  The port's widen backfill
  enqueues into a gate under the DC's delivery lock, so the
  reference-side race of its in-process half (ROADMAP §3) is gone
  from the port.
- Config 12's publish storm (benches/config12_fabric.py:180-237):
  the same frames through each package's transport to 8 framed
  subscribers, in every fan-out mode (legacy, staged, native hub): the
  bytes every subscriber receives are identical, frame for frame.
- A JAX DC process and a port DC process replicate each other's
  writes over TCP (the wire is the package-neutral term codec).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from importlib import import_module

import pytest
import torch

from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.interdc import dc as tdc_mod
from antidote_tpu_torch.obs.spans import tracer as ttracer

import torch_refexec as rx

REPO = rx.REPO
TCP = "tests/interdc/test_tcp_transport.py"
ROUTING = "tests/multidc/test_interest_routing.py"
REHELLO = "TestLiveRehelloTcp.test_tcp_live_rehello_matches_inproc"
CASES = [(TCP, qual, params) for qual, params in rx.cases(TCP)] \
    + [(ROUTING, REHELLO, {})]
PKGS = ("antidote_tpu", "antidote_tpu_torch")
#: the cases whose JAX half is compared with the port's, value for value
COMPARED = {
    "test_tcp_transport::TestTcpInProcess.test_counter_replicates_over_sockets",
    "test_tcp_transport::TestTcpInProcess.test_log_repair_rpc_over_sockets",
    "test_tcp_transport::TestTcpInProcess.test_orset_replicates_and_merges",
    "test_tcp_transport::TestTcpNewTypes.test_flag_dw_and_set_go_replicate_over_sockets",
    "test_tcp_transport::TestTcpNewTypes.test_rwset_and_map_replicate_over_sockets",
}
LOADERS = (rx.Loader(port=False), rx.Loader(port=True))


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """Port DCs built without a device sit on the CPU; both tracers
    sample nothing (ROADMAP §3)."""
    monkeypatch.setattr(
        tdc_mod, "resolve_device",
        lambda device=None: torch.device("cpu" if device is None
                                         else device))
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


@pytest.mark.parametrize("rel,qual,params", CASES,
                         ids=[rx.case_id(*c) for c in CASES])
def test_reference_case_on_both(rel, qual, params, tmp_path, monkeypatch):
    compared = rx.case_id(rel, qual, params) in COMPARED
    jax_rec, port_rec = rx.run_on_both(LOADERS, rel, qual, params,
                                       tmp_path, monkeypatch, jax=compared)
    rx.assert_finals(jax_rec, port_rec, compared)


def test_reference_cases_are_all_here():
    """test_tcp_transport.py holds 18 cases; all run above, five of
    them compared value for value, and the interest-routing file's TCP
    case with them."""
    assert len(CASES) == 19
    assert REHELLO in dict((q, r) for r, q, _ in CASES)
    assert len(COMPARED) == 5
    assert COMPARED <= {rx.case_id(*c) for c in CASES}


# ------------------------------------------------- config 12's publish storm

def _recv_frames(sub, n, out):
    sub.settimeout(30)
    for _ in range(n):
        hdr = b""
        while len(hdr) < 4:
            more = sub.recv(4 - len(hdr))
            if not more:
                return
            hdr += more
        want = int.from_bytes(hdr, "big")
        buf = b""
        while len(buf) < want:
            more = sub.recv(want - len(buf))
            if not more:
                return
            buf += more
        out.append(buf)


def _storm(pkg, native_pub, frames, n_subs=8, wave=64):
    """benches/config12_fabric.py:drive_publish for one package: every
    frame published once, in waves under the bounded queues, to
    ``n_subs`` framed subscribers; returns (per-subscriber frames,
    whether the native hub carried them)."""
    termcodec = import_module(pkg + ".interdc.termcodec")
    tcp = import_module(pkg + ".interdc.tcp")
    wire = import_module(pkg + ".interdc.wire")
    bus = tcp.TcpTransport(native_pub=native_pub)
    try:
        bus.register(wire.DcDescriptor(dc_id="bench", n_partitions=1),
                     lambda *_a: None)
        (pub_addr,), _ = bus.local_addrs()
        subs, got = [], [[] for _ in range(n_subs)]
        for i in range(n_subs):
            s = socket.create_connection(tuple(pub_addr), timeout=5)
            tcp._send_frame(s, termcodec.encode(f"sub{i}"))
            subs.append(s)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if bus._hub is not None:
                if bus._hub_lib.fab_sub_count(bus._hub) == n_subs:
                    break
            elif len(bus._subscribers) == n_subs:
                break
            time.sleep(0.01)
        readers = [threading.Thread(target=_recv_frames,
                                    args=(s, len(frames), got[i]),
                                    daemon=True)
                   for i, s in enumerate(subs)]
        for r in readers:
            r.start()
        for sent, f in enumerate(frames, 1):
            bus.publish("bench", f)
            if sent % wave == 0 or sent == len(frames):
                end = time.monotonic() + 30
                while min(len(g) for g in got) < sent \
                        and time.monotonic() < end:
                    time.sleep(0.001)
        for r in readers:
            r.join(timeout=30)
        for s in subs:
            s.close()
        return got, bus._hub is not None
    finally:
        bus.close()


@pytest.mark.parametrize("mode", [False, "python", "auto"],
                         ids=["legacy", "staged", "native_hub"])
def test_publish_storm_bytes_equal(mode):
    frames = [b"frame-%04d-" % i + b"x" * (64 + 7 * (i % 41))
              for i in range(256)]
    runs = [_storm(pkg, mode, frames) for pkg in PKGS]
    for got, hub in runs:
        assert hub == (mode == "auto")
        for sub in got:
            assert sub == frames
    assert runs[0][0] == runs[1][0]


# --------------------------------------------- a JAX DC and a port DC

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Dc:
    """One DC process: the JAX package's harness
    (tests/interdc/dc_proc.py) or the port's (tests/torch_procs/)."""

    def __init__(self, harness, dc_id, data_dir):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.p = subprocess.Popen(
            [sys.executable, harness, dc_id, data_dir,
             str(_free_port()), str(_free_port())],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        assert self.recv().get("ready")

    def recv(self):
        line = self.p.stdout.readline()
        if not line:
            raise RuntimeError("DC process died")
        return json.loads(line)

    def send(self, **req):
        self.p.stdin.write(json.dumps(req) + "\n")
        self.p.stdin.flush()
        resp = self.recv()
        assert "error" not in resp, resp
        return resp

    def stop(self):
        if self.p.poll() is None:
            try:
                self.send(cmd="exit")
            except (OSError, RuntimeError, AssertionError):
                self.p.kill()
        try:
            self.p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.p.kill()
            self.p.wait(timeout=10)


def test_jax_dc_and_port_dc_replicate_over_tcp(tmp_path):
    """dc1 runs the JAX package, dc2 the port, each in its own process
    over the TCP transport: each reads the other's counter and OR-Set
    writes at the writer's commit clock, and a write that depends on
    the other DC's lands at both."""
    jax_dc = _Dc(os.path.join(REPO, "tests", "interdc", "dc_proc.py"),
                 "dc1", str(tmp_path / "dc1"))
    port_dc = _Dc(os.path.join(rx.PROCS, "dc_proc.py"), "dc2",
                  str(tmp_path / "dc2"))
    dcs = (jax_dc, port_dc)
    try:
        assert port_dc.send(cmd="modules") == {"device": "cpu",
                                               "foreign": []}
        descs = [d.send(cmd="descriptor")["desc"] for d in dcs]
        jax_dc.send(cmd="connect", desc=descs[1])
        port_dc.send(cmd="connect", desc=descs[0])
        ct = None
        for i, (writer, reader) in enumerate((dcs, dcs[::-1]) * 2):
            ct = writer.send(cmd="update", key="ik", type="counter_pn",
                             op="increment", arg=i + 1, clock=ct)["clock"]
            ct = writer.send(cmd="update", key="is", type="set_aw",
                             op="add", arg=f"e{i}", clock=ct)["clock"]
            r = reader.send(cmd="read", key="ik", type="counter_pn",
                            clock=ct)
            assert r["value"] == sum(range(1, i + 2)), r
        for d in dcs:
            assert d.send(cmd="read", key="is", type="set_aw",
                          clock=ct)["value"] == ["e0", "e1", "e2", "e3"]
            assert d.send(cmd="read", key="ik", type="counter_pn",
                          clock=ct)["value"] == 10
    finally:
        for d in dcs:
            d.stop()
