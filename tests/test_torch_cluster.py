"""The port's multi-process DC (antidote_tpu_torch.cluster: NodeServer,
the node fabric in Python and native, ClusterStablePlane gossip, live
handoff, resize and the federation of multi-node DCs) against the JAX
package's, on the CPU.

Every case of tests/cluster/test_*.py runs here on the port: the
reference file's own code, executed with its imports of
``antidote_tpu`` naming ``antidote_tpu_torch`` (tests/torch_refexec.py),
every port ``NodeServer`` and ``DataCenter`` built without a device on
the CPU, and the cross-process cases driving the port's node harness
(tests/torch_procs/node_proc.py).  The reference file's own test runs
the JAX half of every case in the same suite.  The JAX half runs here
too where it adds a comparison:

- ``COMPARED``: both packages commit the same updates in the same
  causal order from the case's own thread, and the final value of
  every key the case wrote through the client API in this process,
  read at the join of its commit VCs on one live member of each DC,
  must be equal (tests/torch_refexec.py:assert_finals).  A guard holds
  the number of such cases.
- ``BOTH``: the causal checker's cases (tests/causal_core.py) outside
  the ``[ring]`` placement: their reads race their writers, so no two
  runs read the same values, but the checker's verdict on the
  reference under the same load stands beside the port's.
  ``test_causal_checker_holds_to_reference`` loops the case where the
  checker fails most often on both packages.  Their JAX half runs with
  the two reference faults the port repairs (ROADMAP §3) repaired the
  port's way by ``_repaired_reference``: a restarted member otherwise
  ships a transaction staged in the window before its inter-DC layer
  exists as a bare commit, and every remote DC misses its updates for
  good, whatever the port does.

Every other case (cross-process cases, whose values live in the
children and are held by the reference's own exact asserts; cases with
concurrent writers; cases that write nothing in this process) runs on
the port alone, where each DC of the port must read the same final
values.  ``test_causal_visibility_federation[ring]`` and
``test_full_elasticity_soak`` are known reference-side flakes (ROADMAP
§3; ``[ring]``'s JAX half can abort its process inside XLA), whose
port half runs here and must pass.  The four answer-plane cases that ask
the same read twice run on both halves with the race between a reply
and its publish removed (``HOLDS``: the second ask waits for the
first's answer to be published; ``test_answer_plane_repeat_waits_for_the_publish``
drives that race in each package).  No case is retried.
"""

import glob
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.cluster import node as tnode_mod
from antidote_tpu_torch.interdc import dc as tdc_mod
from antidote_tpu_torch.obs.spans import tracer as ttracer

import torch_refexec as rx

FILES = sorted(os.path.relpath(p, rx.REPO) for p in glob.glob(
    os.path.join(rx.REPO, "tests", "cluster", "test_*.py")))
CASES = [(rel, qual, params) for rel in FILES
         for qual, params in rx.cases(rel)]
#: the cases whose JAX half is compared with the port's, value for value
COMPARED = {
    "test_cluster::TestClusterStablePlane.test_one_stable_snapshot_covers_both_nodes",
    "test_cluster::TestCrossNodeTransactions.test_cross_node_multipartition_2pc",
    "test_cluster::TestCrossNodeTransactions.test_exact_downstream_state_crosses_nodes",
    "test_cluster::TestCrossNodeTransactions.test_remote_certification_aborts",
    "test_cluster::TestCrossNodeTransactions.test_remote_coordinator_writes_remote_partition",
    "test_cluster::TestCrossNodeTransactions.test_writes_on_both_nodes_one_view",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_gap_repair_range_read",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_handoff_byte_read",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_ring_change_invalidates_published_answers",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_snap_read_at_clock",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_snap_read_clockless_never_published",
    "test_fabric_interop::TestAnswerPlaneDifferential.test_truncation_hook_is_wired",
    "test_fabric_interop::TestExactlyOnceAcrossBoundary.test_same_rid_retry_of_published_read",
    "test_fabric_interop::TestFabricRouting.test_python_cluster_answer_plane_stays_cold",
    "test_federation::TestFederatedGapRepair.test_lost_frames_repair_from_owning_node",
    "test_federation::TestFederatedMemberRestart.test_member_restart_reobserves_and_catches_up",
    "test_federation::TestFederatedReplication.test_cross_dc_causal_chain",
    "test_federation::TestFederatedReplication.test_write_on_each_node_reads_everywhere",
    "test_federation_handoff::test_replication_and_repair_survive_handoff",
    "test_handoff::test_crash_between_cutover_and_replan_resolves_via_journal",
    "test_handoff::test_donor_blip_mid_streamed_pull_resumes_at_ack",
    "test_handoff::test_former_owner_restart_honors_transfer",
    "test_handoff::test_install_applied_but_reply_lost_retires_old_owner",
    "test_handoff::test_install_in_doubt_parks_then_retry_resolves",
    "test_handoff::test_install_never_applied_resumes_ownership",
    "test_handoff::test_moved_partition_serves_history_and_new_writes",
    "test_handoff::test_multi_partition_remote_read_is_one_rpc_per_owner",
    "test_handoff::test_python_fabric_multi_partition_read",
    "test_handoff::test_restart_with_receiver_down_parks_in_doubt",
    "test_handoff::test_truncated_donor_handoff_recovers_full_state[False]",
    "test_handoff::test_truncated_donor_handoff_recovers_full_state[True]",
    "test_handoff::test_wide_txn_2pc_batches_per_owner",
    "test_owner_downstream::test_mixed_local_remote_txn_converges",
    "test_owner_downstream::test_mvreg_assign_remote_owner_generated",
    "test_owner_downstream::test_read_your_raw_writes_in_same_txn",
    "test_owner_downstream::test_remote_set_add_remove_generates_at_owner",
    "test_resize::test_freeze_refusal_unwinds_frozen_members",
    "test_resize::test_member_crash_after_commit_restarts_at_new_width",
    "test_resize::test_member_crash_mid_resize_recovers",
    "test_resize::test_rebalance_redrive_after_refused_broadcast",
    "test_resize::test_redrive_rebalance_settles_in_doubt_old_owner",
    "test_resize::test_resize_then_rebalance_moves_children",
    "test_resize::test_same_width_redrive_abort_leaves_cluster_serving",
}
#: the causal checker's cases whose JAX half runs beside the port's
BOTH = {
    "test_causal_federation::test_causal_visibility_federation[none]",
    "test_causal_federation::test_causal_visibility_across_member_restart",
    "test_causal_resize::test_causal_visibility_through_rebalance",
    "test_causal_resize::test_causal_visibility_through_resize",
}
LOADERS = (rx.Loader(port=False), rx.Loader(port=True))


def _cpu(device=None):
    return torch.device("cpu" if device is None else device)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The reference code passes no device: every port member and DC
    it builds sits on the CPU; both tracers sample nothing (the JAX
    kernel-span fallback breaks sampled device reads, ROADMAP §3)."""
    monkeypatch.setattr(tnode_mod, "resolve_device", _cpu)
    monkeypatch.setattr(tdc_mod, "resolve_device", _cpu)
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


def _repaired_reference(monkeypatch):
    """The JAX package's two faults behind the causal checker's
    failures (ROADMAP §3), repaired in this process as the port repairs
    them: every stable source's own-DC entry stays below a pending
    commit (``min_prepared - 1``, the port's ``txn.node.stable_time``),
    and a member's inter-DC layer feeds each slice's new sender the log
    records of the transactions already open on the slice (the port's
    ``NodeInterDc._tap_log``).  The partitions' locks are held from
    before the senders are made until they are fed, so no append falls
    between."""
    from antidote_tpu.cluster import federation as jfed
    from antidote_tpu.txn.manager import PartitionManager as JPM

    min_prepared = JPM.min_prepared
    monkeypatch.setattr(JPM, "min_prepared",
                        lambda self: min_prepared(self) - 1)
    init, gate_from_config = jfed.NodeInterDc.__init__, jfed.gate_from_config
    wiring = threading.local()

    def feed_open_txns():
        nid, pms = wiring.nid, wiring.pms
        wiring.nid = None
        for p, sender in nid.senders.items():
            pm = nid.node.partitions[p]
            open_txids = set(pm._staged) | set(pm.prepared)
            if open_txids:
                for rec in pm.log.records():
                    if rec.txid in open_txids and rec.op_id.dc == nid.dc_id:
                        sender.on_append(rec)
        for pm in pms:
            pm._lock.release()

    def new_init(self, srv, bus, *a, **k):
        node = srv.node
        pms = [node.partitions[p] for p in node.local_partition_indices()]
        for pm in pms:
            pm._lock.acquire()
        wiring.nid, wiring.pms = self, pms
        try:
            init(self, srv, bus, *a, **k)
        finally:
            if getattr(wiring, "nid", None) is self:
                feed_open_txns()

    def new_gate(*a, **k):
        # the first gate comes right after the senders' loop
        if getattr(wiring, "nid", None) is not None:
            feed_open_txns()
        return gate_from_config(*a, **k)

    monkeypatch.setattr(jfed.NodeInterDc, "__init__", new_init)
    monkeypatch.setattr(jfed, "gate_from_config", new_gate)


FABRIC = "tests/cluster/test_fabric_interop.py"


def _publish_before_repeat(loader, monkeypatch):
    """test_fabric_interop's ``_ask_twice`` with its race removed, for
    the package of ``loader``: the node's worker replies to the first
    ask (``nl_reply``) before it publishes the answer (``nl_publish``),
    in both packages, so a repeat that reaches the event thread between
    the two enters Python and "was not answered natively".  Here the
    first ask returns once its answer is published, and then the
    reference's own checks run."""
    cls = loader.module(FABRIC).TestAnswerPlaneDifferential

    def ask_twice(self, asker, owner, kind, payload):
        c0 = owner.link.fabric_counters()
        r1 = asker.link.request(owner.node_id, kind, payload)
        deadline = time.monotonic() + 10.0
        while owner.link.fabric_counters()["published"] \
                <= c0["published"] and time.monotonic() < deadline:
            time.sleep(0.001)
        mid = owner.link.fabric_counters()["native_answered"]
        r2 = asker.link.request(owner.node_id, kind, payload)
        c1 = owner.link.fabric_counters()["native_answered"]
        assert mid == c0["native_answered"], \
            f"{kind}: first ask must take the Python path"
        assert c1 == mid + 1, f"{kind}: repeat was not answered natively"
        return r1, r2

    monkeypatch.setattr(cls, "_ask_twice", ask_twice)


#: cases run with a timing race of the reference case removed, on both
#: packages (ROADMAP §3)
HOLDS = {f"test_fabric_interop::TestAnswerPlaneDifferential.{q}":
         _publish_before_repeat for q in (
             "test_snap_read_at_clock", "test_gap_repair_range_read",
             "test_handoff_byte_read",
             "test_ring_change_invalidates_published_answers")}


@pytest.mark.parametrize("rel,qual,params", CASES,
                         ids=[rx.case_id(*c) for c in CASES])
def test_reference_case_on_both(rel, qual, params, tmp_path, monkeypatch):
    cid = rx.case_id(rel, qual, params)
    compared = cid in COMPARED
    if cid in BOTH:
        _repaired_reference(monkeypatch)
    if cid in HOLDS:
        for loader in LOADERS:
            HOLDS[cid](loader, monkeypatch)
    jax_rec, port_rec = rx.run_on_both(
        LOADERS, rel, qual, params, tmp_path, monkeypatch,
        jax=compared or cid in BOTH)
    rx.assert_finals(jax_rec, port_rec, compared)


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_answer_plane_repeat_waits_for_the_publish(port, tmp_path,
                                                   monkeypatch):
    """The race ``HOLDS`` removes, driven in each package: with every
    publish held back 0.3 s after its reply, the reference's
    ``_ask_twice`` sends its repeat before the answer is published, and
    the repeat enters Python; with ``_publish_before_repeat`` the same
    case passes."""
    pkg = ("antidote_tpu", "antidote_tpu_torch")[port]
    lib = importlib.import_module(f"{pkg}.cluster.nativelink")._load()
    publish = lib.nl_publish

    def late(*a):
        time.sleep(0.3)
        return publish(*a)

    monkeypatch.setattr(lib, "nl_publish", late)
    loader = rx.Loader(port=bool(port))
    case = ("TestAnswerPlaneDifferential.test_snap_read_at_clock", {})
    with pytest.raises(AssertionError, match="not answered natively"):
        rx.run_case(loader.module(FABRIC), FABRIC, *case,
                    tmp_path / "raced", monkeypatch, loader=loader)
    _publish_before_repeat(loader, monkeypatch)
    rx.run_case(loader.module(FABRIC), FABRIC, *case, tmp_path / "held",
                monkeypatch, loader=loader)


def test_reference_cases_are_all_here():
    """tests/cluster holds 83 cases in 12 files; every one is above,
    43 of them compared value for value across the packages."""
    assert len(FILES) == 12
    assert len(CASES) == 83
    ids = {rx.case_id(*c) for c in CASES}
    assert len(COMPARED) == 43 and COMPARED <= ids
    assert BOTH <= ids and not BOTH & COMPARED


#: the causal checker's case that fails most often, in both packages
LOOP = ("tests/cluster/test_causal_federation.py",
        "test_causal_visibility_across_member_restart")
LOOP_RUNS = 3


def test_causal_checker_holds_to_reference(tmp_path, monkeypatch):
    """The restart case (the checker's highest failure rate, ROADMAP
    §3), run LOOP_RUNS times on each package, alternating: the port
    breaks causal visibility at most once more than the reference
    does in the same loop.  The checker's own failures (an
    AssertionError) are counted; any other error fails the test."""
    rel, qual = LOOP
    fails = [[], []]
    for i in range(LOOP_RUNS):
        for port in range(2):
            try:
                rx.run_case(LOADERS[port].module(rel), rel, qual, {},
                            tmp_path / f"{i}_{port}", monkeypatch)
            except AssertionError as e:
                fails[port].append(str(e)[:300])
    assert len(fails[1]) <= len(fails[0]) + 1, fails


# ------------------------------ the stable snapshot's own-DC entry

def test_stable_time_excludes_a_pending_commit(tmp_path):
    """A transaction commits at the max of its prepare times, so while
    it is pending, its max-prepare partition's ``min_prepared`` equals
    its commit time.  The port's stable snapshot stays below that time
    (``txn.node.stable_time``; the JAX package's includes it, ROADMAP
    §3): a device GC at the snapshot leaves the commit above the
    plane's base, and a read at the commit VC, with the value cache
    empty, sees it."""
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.config import Config

    api = AntidoteGPU("dc1", config=Config(n_partitions=2),
                      data_dir=str(tmp_path), device="cpu")
    node = api.node
    try:
        obj = ("k", "set_aw", "b")
        # a first commit gives the partition's set_aw plane its columns
        api.update_objects_static(None, [(obj, "add", b"w")])
        tx = api.start_transaction()
        api.update_objects([(obj, "add", b"x")], tx)
        pm = node.partitions[tx.partitions[0]]
        pt = pm.prepare(tx.txid, tx.snapshot_vc)
        stable = node.stable_vc_provider()
        assert stable.get_dc("dc1") < pt
        pm.device.gc(stable)
        pm.commit(tx.txid, pt, tx.snapshot_vc)
        with pm._lock:
            pm._val_cache.clear()
        vals, _ = api.read_objects_static(
            tx.snapshot_vc.set_dc("dc1", pt), [obj])
        assert sorted(vals[0]) == [b"w", b"x"]
    finally:
        node.close()


def test_cluster_stable_sources_exclude_a_pending_commit(tmp_path):
    """The multi-node DC's stable sources (``ClusterStablePlane``'s
    local fold, and a federated member's gate-aware sources) stay below
    a pending prepare of their member's partition."""
    from antidote_tpu_torch.cluster import NodeServer, create_dc_cluster
    from antidote_tpu_torch.cluster.federation import NodeInterDc
    from antidote_tpu_torch.config import Config
    from antidote_tpu_torch.interdc import InProcBus

    servers = [NodeServer(f"n{i}", data_dir=str(tmp_path / f"n{i}"),
                          config=Config(n_partitions=4,
                                        heartbeat_s=0.005),
                          device="cpu") for i in (1, 2)]
    nid = None
    try:
        create_dc_cluster("dc1", 4, servers)
        srv = servers[0]
        pm = srv.node.partitions[srv.node.local_partition_indices()[0]]
        tx = srv.api.start_transaction()
        pt = pm.prepare(tx.txid, tx.snapshot_vc)
        assert srv.plane.local_summary().get_dc("dc1") < pt
        nid = NodeInterDc(srv, InProcBus())
        assert srv.plane.local_summary().get_dc("dc1") < pt
        pm.abort(tx.txid)
        srv.api.abort_transaction(tx)
    finally:
        if nid is not None:
            nid.close()
        for s in servers:
            s.close()


def test_member_sender_ships_txns_staged_before_it(tmp_path, monkeypatch):
    """A member serves its partitions' RPCs before its inter-DC layer
    exists (a restarted member comes back assembled).  A transaction
    staged and prepared in that window reaches the slice's sender whole:
    its commit ships the update with the commit record (the JAX
    module ships the bare commit, and every remote DC misses the
    update, ROADMAP §3)."""
    from antidote_tpu_torch.cluster import NodeServer, create_dc_cluster
    from antidote_tpu_torch.cluster.federation import NodeInterDc
    from antidote_tpu_torch.config import Config
    from antidote_tpu_torch.interdc import InProcBus
    from antidote_tpu_torch.interdc import sender as sender_mod

    servers = [NodeServer(f"n{i}", data_dir=str(tmp_path / f"n{i}"),
                          config=Config(n_partitions=4,
                                        heartbeat_s=0.005),
                          device="cpu") for i in (1, 2)]
    nid = None
    try:
        create_dc_cluster("dc1", 4, servers)
        srv = servers[0]
        p = srv.node.local_partition_indices()[0]
        key = next(f"k{i}" for i in range(1000)
                   if srv.node.partition_index(f"k{i}") == p)
        tx = srv.api.start_transaction()
        srv.api.update_objects([((key, "set_aw", "b"), "add", b"x")], tx)
        pm = srv.node.partitions[p]
        pt = pm.prepare(tx.txid, tx.snapshot_vc)
        shipped = []
        from_ops = sender_mod.InterDcTxn.from_ops

        def spy(*a, **k):
            txn = from_ops(*a, **k)
            shipped.append([r.kind() for r in txn.records])
            return txn

        monkeypatch.setattr(sender_mod.InterDcTxn, "from_ops", spy)
        nid = NodeInterDc(srv, InProcBus())
        pm.commit(tx.txid, pt, tx.snapshot_vc)
        assert shipped == [["update", "commit"]]
    finally:
        if nid is not None:
            nid.close()
        for s in servers:
            s.close()


# ------------------------------------- the port and its children, jax-free

_FOREIGN = ("jax", "jaxlib", "antidote_tpu")


def test_every_port_module_leaves_jax_out():
    """Importing every module of the port (each found by walking the
    package) loads neither jax nor the JAX package."""
    code = (
        # the package entry points first: bcounter.py imported alone
        # meets interdc/__init__'s import cycle (in both packages)
        "import importlib, pkgutil, sys, antidote_tpu_torch as p\n"
        "import antidote_tpu_torch.interdc, antidote_tpu_torch.cluster\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FOREIGN!r}]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=rx.REPO,
                         env=dict(os.environ, PYTHONPATH=rx.REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_node_process_leaves_jax_out(tmp_path):
    """``python -m antidote_tpu_torch.cluster`` serves on the CPU with
    ``--device cpu`` and stops on SIGTERM; no module it imported (every
    import, from ``-X importtime``) is jax's or the JAX package's."""
    # the import report is larger than a pipe holds: it goes to a file
    with open(tmp_path / "stderr", "w+") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "antidote_tpu_torch.cluster", "n1", "--device", "cpu",
             "--n-partitions", "2", "--data-dir", str(tmp_path / "n1")],
            cwd=rx.REPO, env=dict(os.environ, PYTHONPATH=rx.REPO),
            stdout=subprocess.PIPE, stderr=errf, text=True)
        try:
            line = proc.stdout.readline()
            assert line.startswith("node n1 serving on 127.0.0.1:"), line
            assert "(assembled=False)" in line
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        errf.seek(0)
        err = errf.read()
    assert proc.returncode == 0, err[-2000:]
    mods = [ln.rsplit("|", 1)[1].strip() for ln in err.splitlines()
            if ln.startswith("import time:") and "|" in ln]
    assert "antidote_tpu_torch.cluster.node" in mods
    assert not [m for m in mods if m.split(".")[0] in _FOREIGN]


def test_node_harness_reports_cpu_native_and_no_jax(tmp_path):
    """The port's node harness (which the reference's cross-process
    cases drive above) runs its member on the CPU over the native
    fabric and never loads jax."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(rx.PROCS, "node_proc.py"), "n1",
         str(tmp_path / "n1"), "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert json.loads(proc.stdout.readline())["ready"]
        proc.stdin.write(json.dumps({"cmd": "modules"}) + "\n")
        proc.stdin.flush()
        got = json.loads(proc.stdout.readline())
        proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
        proc.stdin.flush()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert got == {"device": "cpu", "fabric": "native", "foreign": []}
