"""The port's op log (antidote_tpu_torch.oplog: DurableLog over the native
core or its pure-Python twin, the group-commit plane, the truncation
marker, CheckpointStore and PartitionLog recovery) against the JAX
package's on the same record streams.  Raw payload logs and builtin-only
checkpoint documents must be byte-identical files; PartitionLog records
are pickles naming each package's own classes, so there the decoded
records, watermarks and recovered payloads must be equal.  A torn tail
recovers to the same prefix in both."""

import os
import time

import numpy as np
import pytest

from antidote_tpu.clocks import VC as JVC
from antidote_tpu.oplog import checkpoint as jck
from antidote_tpu.oplog import log as jlog
from antidote_tpu.oplog.partition import PartitionLog as JPartitionLog
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.oplog import checkpoint as tck
from antidote_tpu_torch.oplog import log as tlog
from antidote_tpu_torch.oplog.partition import PartitionLog

BACKENDS = ("python", "native")


def _native(mod):
    """The native core of ``mod``'s log, built if need be.  Test workers
    that start together may build the same library at once, so a load
    that finds it half-written is tried again."""
    for _ in range(50):
        lib = mod._NativeBackend.load()
        if lib is not None:
            return lib
        time.sleep(0.1)
    raise AssertionError(f"{mod.__name__}: the native log core does not "
                         "build or load")


@pytest.fixture(params=BACKENDS)
def backend(request):
    if request.param == "native":
        _native(jlog)
        _native(tlog)
    return request.param


def _logs(tmp_path, backend, group=False):
    """A JAX DurableLog and a port DurableLog on files of their own."""
    j = jlog.DurableLog(str(tmp_path / "log.jax"), backend=backend,
                        group=jlog.GroupSettings(enabled=group))
    t = tlog.DurableLog(str(tmp_path / "log.port"), backend=backend,
                        group=tlog.GroupSettings(enabled=group))
    assert j.backend_name == t.backend_name == backend
    return j, t


def _payloads(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(1, 300)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


def _drive(log, payloads, group):
    """Appends singly and in batches of three, syncing every 25 records
    (under group commit: a durability ticket and its wait); returns the
    offsets."""
    offs, i = [], 0
    while i < len(payloads):
        if i % 7 == 3:
            first = log.append_batch(payloads[i:i + 3])
            offs.append(first)
            i += 3
        else:
            offs.append(log.append(payloads[i]))
            i += 1
        if i % 25 < 3:
            if group:
                log.wait_durable(log.durability_ticket())
            else:
                log.sync()
    log.flush()
    return offs


def _state(log):
    return log.end_offset(), log.truncated_base, list(log.scan())


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("group", [False, True])
def test_durable_log_matches_jax(tmp_path, backend, group):
    j, t = _logs(tmp_path, backend, group)
    payloads = _payloads(1, 200)
    assert _drive(j, payloads, group) == _drive(t, payloads, group)
    assert _state(j) == _state(t)
    assert [b for _o, b in t.scan()] == payloads
    for off, _b in list(t.scan())[::17]:
        assert j.read(off) == t.read(off)
    j.close()
    t.close()
    _same_files(j.path, t.path)


def test_torn_tail_recovers_the_same_prefix(tmp_path, backend):
    j, t = _logs(tmp_path, backend)
    payloads = _payloads(2, 40)
    offs = _drive(t, payloads, False)
    _drive(j, payloads, False)
    j.close()
    t.close()
    size = os.path.getsize(t.path)
    # every byte of the last two records and the header of the third
    # from the end, and garbage past a whole log
    cuts = list(range(offs[-3], size)) + [offs[-3] + 3]
    for cut in cuts:
        for src in (j.path, t.path):
            with open(src, "rb") as f, open(src + ".torn", "wb") as g:
                g.write(f.read()[:cut])
        jt = jlog.DurableLog(j.path + ".torn", backend=backend)
        tt = tlog.DurableLog(t.path + ".torn", backend=backend)
        assert _state(jt) == _state(tt), cut
        assert jt.append(b"after") == tt.append(b"after")
        jt.close()
        tt.close()
        _same_files(j.path + ".torn", t.path + ".torn")
    with open(t.path, "ab") as f:
        f.write(b"\x50\x00\x00\x00\xde\xad\xbe\xefPARTIAL")
    tt = tlog.DurableLog(t.path, backend=backend)
    assert [b for _o, b in tt.scan()] == payloads
    tt.close()


def test_truncation_marker_matches_jax(tmp_path, backend):
    j, t = _logs(tmp_path, backend)
    payloads = _payloads(3, 100)
    offs = _drive(j, payloads, False)
    _drive(t, payloads, False)
    assert j.truncate_below(offs[40]) == t.truncate_below(offs[40])
    assert _state(j) == _state(t)
    assert t.truncated_base == offs[40]
    more = _payloads(4, 10)
    _drive(j, more, False)
    _drive(t, more, False)
    # a staged truncation with appends landing during its tail copy
    sj, st = j.stage_truncate_below(offs[70]), t.stage_truncate_below(
        offs[70])
    for p in more[:5]:
        assert j.append(p) == t.append(p)
    assert j.commit_truncate(sj) == t.commit_truncate(st)
    assert _state(j) == _state(t)
    j.close()
    t.close()
    _same_files(j.path, t.path)
    j = jlog.DurableLog(j.path, backend=backend)
    t = tlog.DurableLog(t.path, backend=backend)
    assert _state(j) == _state(t)
    assert t.truncated_base == offs[70]
    j.close()
    t.close()
    # a marker torn at every byte reads as base 0 in both
    with open(t.path, "rb") as f:
        raw = f.read()
    for cut in range(tlog.TRUNC_MARKER_LEN):
        p = str(tmp_path / f"torn{cut}")
        with open(p, "wb") as f:
            f.write(raw[:cut])
        assert jlog._peek_trunc_base(p) == tlog._peek_trunc_base(p) == 0


def _doc(i, n_keys):
    """A builtin-only checkpoint document: its pickle is the same bytes
    in both packages."""
    return {"version": 1, "partition": 0, "cut_offset": 100 * i,
            "op_counters": {"dc1": 3 * i}, "max_commit_vc": {"dc1": i},
            "commit_watermarks": {}, "repair_floors": {}, "op_floors": {},
            "pending": [], "pending_floor": 0,
            "keys": {f"k{k}": ("counter_pn", k * i, {"dc1": i})
                     for k in range(n_keys)},
            "delta": {f"k{k}": ("counter_pn", k * i, {"dc1": i})
                      for k in range(0, n_keys, i)},
            "clock": {"dc1": i}, "wall_us": 1_000 + i}


@pytest.mark.parametrize("segmented", [False, True])
def test_checkpoint_store_matches_jax(tmp_path, segmented):
    stores = []
    for pkg, name in ((jck, "jax"), (tck, "port")):
        os.makedirs(tmp_path / name)
        stores.append(pkg.CheckpointStore(
            str(tmp_path / name / "p0.log.ckpt"),
            pkg.CheckpointSettings(segmented=segmented,
                                   seg_waste_frac=0.6)))
    js, ts = stores
    for i in range(1, 5):
        prev = (js.load_doc() or {}).get("segments", [])
        for st in stores:
            doc = _doc(i, 24)
            doc["prev_segments"] = list(prev)
            st.persist(doc)
        names = sorted(os.listdir(tmp_path / "jax"))
        assert names == sorted(os.listdir(tmp_path / "port"))
        for n in names:
            _same_files(tmp_path / "jax" / n, tmp_path / "port" / n)
        got = ts.load_doc()
        assert got == js.load_doc()
        assert len(got["keys"]) == 24
    with open(ts.path, "rb") as f:
        raw = f.read()
    for cut in range(len(raw)):
        assert jck.CheckpointStore._parse(raw[:cut]) is None
        assert tck.CheckpointStore._parse(raw[:cut]) is None


def _stream(plog, vc_cls, seed, n_txns, start=0):
    """A seeded committed history through PartitionLog's append API:
    multi-update txns committed, some aborted, one left open."""
    rng = np.random.default_rng(seed)
    for i in range(start, start + n_txns):
        txid = ("dc1", i)
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, 6))
            plog.append_update("dc1", txid, f"k{k}", "counter_pn",
                               int(rng.integers(1, 9)))
        r = rng.random()
        if r < 0.15:
            plog.append_abort("dc1", txid)
        elif r < 0.9:
            plog.append_prepare("dc1", txid, 10 * i)
            plog.append_commit("dc1", txid, 10 * i + 1,
                               vc_cls({"dc1": 10 * i, "dc2": i}),
                               certified=bool(r < 0.8))
    plog.append_update("dc1", ("dc1", "open"), "k0", "counter_pn", 100)


def _pl(p):
    return (p.key, p.type_name, p.effect, p.commit_dc, p.commit_time,
            dict(p.snapshot_vc), p.txid, p.certified)


def _recovered(plog):
    return dict(records=list(plog.records()), ops=dict(plog.op_counters),
                max_vc=dict(plog.max_commit_vc), keys=plog.keys_seen,
                suffix=[(s, _pl(p)) for s, p in plog.suffix_payloads()],
                committed=[(i, _pl(p)) for i, p in plog.committed_payloads()],
                k3=[(i, _pl(p)) for i, p in plog.committed_payloads(key="k3")])


@pytest.mark.parametrize("torn", [False, True])
def test_partition_log_recovery_matches_jax(tmp_path, backend, torn):
    paths = str(tmp_path / "p0_jax.log"), str(tmp_path / "p0_port.log")
    j = JPartitionLog(paths[0], partition=0, backend=backend)
    t = PartitionLog(paths[1], partition=0, backend=backend)
    _stream(j, JVC, 5, 40)
    _stream(t, VC, 5, 40)
    assert _recovered(j) == _recovered(t)
    j.close()
    t.close()
    if torn:
        # cut both files inside their last record: the record sizes
        # differ (each pickle names its own package), the record
        # boundaries do not
        for p in paths:
            log = (jlog if p == paths[0] else tlog).DurableLog(p)
            last = [o for o, _b in log.scan()][-1]
            log.close()
            with open(p, "r+b") as f:
                f.truncate(last + 5)
    j = JPartitionLog(paths[0], partition=0, backend=backend)
    t = PartitionLog(paths[1], partition=0, backend=backend)
    got = _recovered(t)
    assert _recovered(j) == got
    assert len(got["records"]) > 100
    j.close()
    t.close()


def test_checkpointed_partition_log_matches_jax(tmp_path, backend):
    """A cut with a txn pending across it, its truncation, a suffix,
    then a restart that recovers from the checkpoint: the same seeds,
    watermarks, pending prefeed and suffix payloads in both."""
    logs = []
    for pkg, PL, vc_cls, name in ((jck, JPartitionLog, JVC, "jax"),
                                  (tck, PartitionLog, VC, "port")):
        path = str(tmp_path / f"p0_{name}.log")

        def store(pkg=pkg, path=path):
            return pkg.CheckpointStore(path + ".ckpt",
                                       pkg.CheckpointSettings())

        plog = PL(path, partition=0, backend=backend, checkpoint=store())
        _stream(plog, vc_cls, 9, 30)
        plog.append_update("dc1", ("dc1", "x"), "k5", "counter_pn", 7)
        doc = plog.capture_cut()
        doc["keys"] = {"k1": ("counter_pn", 11, vc_cls({"dc1": 5}))}
        plog.persist_checkpoint(doc)
        plog.adopt_checkpoint(doc, plog.stage_truncation(doc))
        assert plog.log.truncated_base > 0
        plog.append_prepare("dc1", ("dc1", "x"), 9_000)
        plog.append_commit("dc1", ("dc1", "x"), 9_001,
                           vc_cls({"dc1": 9_000}))
        _stream(plog, vc_cls, 10, 10, start=100)
        plog.close()
        plog = PL(path, partition=0, backend=backend, checkpoint=store())
        assert plog.suffix_start > 0
        logs.append(plog)
    j, t = logs
    got = _recovered(t)
    assert _recovered(j) == got
    assert ("k5", "counter_pn", 7) in [s[1][:3] for s in got["suffix"]]
    assert {k: (tn, s, dict(v)) for k, (tn, s, v) in t.ckpt_seeds.items()} \
        == {k: (tn, s, dict(v)) for k, (tn, s, v) in j.ckpt_seeds.items()}
    for p in logs:
        p.close()
