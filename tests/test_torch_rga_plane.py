"""The port's RGA device plane (``device_plane.RgaPlane`` behind
``DevicePlane``) on the CPU against the JAX package's: a flush longer
than a new document's window or delete lanes lands, and reads what the
JAX package's host CRDT reads (the JAX plane raises there); a partition
of documents in tiers of different sizes, edited at three DCs with lag
(actors arriving out of string order), folded at the GST through
``gc_ops`` and opened at snapshots, reads what the JAX plane beside it
and the JAX package's host CRDT read, row for row, tombstones included;
and the plane's host spans and counters (its waits for the card by
site, its document appends and their rows)."""

import pytest

import torch_docs as td
import torch_parity as tp
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.mat import device_plane as dpm
from antidote_tpu_torch.mat import rga_store
from antidote_tpu_torch.mat.ingest import IngestSettings
from antidote_tpu_torch.mat.materializer import Payload
from antidote_tpu_torch.obs.prof import profiler


@pytest.fixture(autouse=True)
def _unsampled_jax_tracer(monkeypatch):
    """No sampled txn spans in the JAX package, whose kernel spans fetch
    a value inside a jitted store call under one and raise (as in
    tests/test_torch_device_plane.py)."""
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)


def _plane(**kw):
    """A DevicePlane on the CPU, its coalescing window off."""
    return dpm.DevicePlane(device="cpu",
                           ingest_settings=IngestSettings(coalesce_us=0),
                           **kw)


def _burst(n_ins, n_del, doc="doc"):
    """One author's ``n_ins`` inserts typed left to right, then deletes
    of every third of the first ``3 * n_del``: payloads in commit
    order."""
    out, ct = [], 0

    def pay(eff):
        nonlocal ct
        ct += 1
        return Payload(key=doc, type_name="rga", effect=eff,
                       commit_dc="dc0", commit_time=ct,
                       snapshot_vc=VC({"dc0": ct - 1} if ct > 1 else {}))
    ref = (0, "")
    for i in range(n_ins):
        uid = (i + 1, "a")
        out.append(pay(("ins", uid, ref, 32 + i % 95)))
        ref = uid
    out += [pay(("rm", (3 * i + 1, "a"))) for i in range(n_del)]
    return out


@pytest.mark.parametrize("n_ins,n_del,flush_ops", [
    (179, 77, 256), (1024, 0, 1024)], ids=["deletes-past-md", "burst"])
def test_a_flush_longer_than_a_new_documents_lanes_lands(n_ins, n_del,
                                                         flush_ops):
    """A padded block larger than the whole window (1,024 inserts, a
    bucket of 1,024 over ``nw`` 256) or the whole delete lanes (77
    deletes, a bucket of 128 over ``md`` 64) into a fresh document: the
    plane grows the document first, and the flush lands: the document
    reads what the JAX package's host CRDT reads."""
    dp = _plane(flush_ops=flush_ops)
    payloads = _burst(n_ins, n_del)
    for p in payloads:
        dp.stage(p.key, "rga", p, None)
    assert dp.pending() == 0
    st = dp.planes["rga"].st[0]
    assert st.nw >= rga_store._append_bucket(n_ins)
    assert st.md >= rga_store._append_bucket(n_del)
    assert dp.read("doc", "rga", None) == tp.jax_rga_read(payloads, "doc",
                                                          None)


def _run(history, stage, read, read_every=1):
    """``history`` (torch_docs.docs_history) staged op by op, each
    payload with the tick's GST by ``stage(p, gst)``, one document
    opened every ``read_every``-th tick at DC 0's snapshot of the tick
    before, then every document at the last snapshot, each by
    ``read(doc, vc)``; returns [(doc, vc, read)]."""
    docs = sorted({p.key for ps, _, _ in history for p in ps})
    reads = []
    for t, (payloads, _snap, gst) in enumerate(history):
        for p in payloads:
            stage(p, gst)
        if t and t % read_every == 0:
            doc, vc = docs[t % len(docs)], history[t - 1][1]
            reads.append((doc, vc, read(doc, vc)))
    vc = history[-1][1]
    for doc in docs:
        reads.append((doc, vc, read(doc, vc)))
    return reads


@pytest.mark.parametrize("seed", [5, 6])
def test_a_partition_of_documents_reads_as_the_host_crdt(monkeypatch, seed):
    """The port's plane and the JAX package's, driven alike (torch_parity
    .Pair): every open reads the same in both, and what the JAX
    package's host CRDT reads at that snapshot."""
    remaps = []
    remap = rga_store.rga_remap_actors
    monkeypatch.setattr(rga_store, "rga_remap_actors",
                        lambda st, perm: remaps.append(1) or remap(st, perm))
    history = td.docs_history(seed)
    pair = tp.Pair(flush_ops=16, gc_ops=64)

    def read(doc, vc):
        raised, got = pair.call("read_many", [doc], "rga", vc=vc)
        assert not raised
        return got[doc]
    reads = _run(history, pair.stage, read)
    # every document met its actors out of string order, and folded
    assert len(remaps) >= 8
    assert all(dp.planes["rga"]._has_base for dp in (pair.t, pair.j))
    assert all(rev == ["dc-a", "dc-b", "dc-c"]
               for rev in pair.t.planes["rga"].rev_actors)
    assert pair.t_ev == pair.j_ev == [] and not pair.t.host_only
    for doc, vc, got in reads:
        want = tp.jax_rga_read(pair.ops, doc, vc)
        assert len(got) == len(want)
        assert [g == w for g, w in zip(got, want)] == [True] * len(want)
    assert any(not v for _doc, _vc, got in reads for _u, _e, v in got)


def test_the_plane_keeps_its_spans_and_counts_its_waits():
    """Each append waits once (its ``ok``) and carries its rows; a
    refused one refits the document (its fold and its counters: a wait
    each) and appends again; a GC waits once a document, a read once."""
    waits, appends = dpm.rga_plane_waits, dpm.rga_plane_appends
    sites = ("append", "fold", "read")
    before = [waits.value(site=s) for s in sites]
    n0, rows0 = appends.value(what="appends"), appends.value(what="rows")
    history = td.docs_history(7, ticks=12)
    dp = _plane(flush_ops=16, gc_ops=96)
    plane = dp.planes["rga"]
    refits = []
    refit = plane._refit

    def counted(st, n_ins, n_del):
        w0 = waits.value(site="append")
        out = refit(st, n_ins, n_del)
        refits.append((n_ins + n_del, waits.value(site="append") - w0))
        return out
    plane._refit = counted
    profiler.reset()
    profiler.configure(detail=True)
    try:
        reads = _run(history, lambda p, gst: dp.stage(p.key, "rga", p, gst),
                     lambda doc, vc: dp.read_many([doc], "rga", vc)[doc],
                     read_every=3)
        spans = profiler.host_spans()["spans"]
    finally:
        profiler.configure(detail=False)
        profiler.reset()
    names = [s[0] for s in spans]
    folds = names.count("rga_plane.fold")
    assert names.count("rga_plane.decode") == len(reads)
    assert folds >= 2 and names.count("rga_plane.append") >= 2
    append_w, fold_w, read_w = (waits.value(site=s) - b
                                for s, b in zip(sites, before))
    staged = sum(len(ps) for ps, _, _ in history)
    assert refits and all(w in (1, 2) for _r, w in refits)
    assert appends.value(what="rows") - rows0 \
        == staged + sum(r for r, _w in refits)
    assert append_w == appends.value(what="appends") - n0 \
        + sum(w for _r, w in refits)
    assert read_w == len(reads)
    assert fold_w == folds * len(plane.st)
