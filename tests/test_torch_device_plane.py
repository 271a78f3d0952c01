"""The port's live device plane (antidote_tpu_torch.mat.device_plane) against
the JAX package's, on the CPU: the same seeded committed-op stream
(torch_parity.StreamGen, converted payload by payload) through both
DevicePlanes must leave equal evictions and exported states, directories,
state tensors (values and dtypes) and reads, raise ReadBelowBase alike,
move the INGEST_* counters alike, and read what the port's own CRDTs
(the host oracle) give for every key still on the device."""

import functools

import numpy as np
import pytest
import torch

import torch_parity as tp
from antidote_tpu import stats as jstats
from antidote_tpu.mat import device_plane as jdpm
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch import stats as tstats
from antidote_tpu_torch.clocks import VC
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.mat import device_plane as tdpm

TYPES = ["counter_pn", "set_aw", "register_mv", "register_lww", "flag_ew",
         "set_rw", "flag_dw", "set_go", "map_go", "map_rr", "rga"]
#: test_stream_oracle_equivalence's plane sizes: every directory grows
PLANE_KW = dict(key_capacity=4, n_lanes=4, n_slots=2, flush_ops=16,
                gc_ops=48)
INGEST_COUNTERS = ("ingest_dispatches", "ingest_coalesced_ops",
                   "ingest_h2d_bytes")
FLUSH_KINDS = ("rows", "window", "budget", "read", "gc", "grow", "explicit")


@pytest.fixture(autouse=True)
def _unsampled_jax_tracer(monkeypatch):
    """No sampled txn spans in the JAX package: under a sampled span its
    kernel spans fetch a value inside a jitted store call and raise, as
    antidote_tpu/obs/prof.py cannot tell a jit trace apart without
    ``jax.core.trace_state_clean`` (tests/unit/test_obs_prof.py)."""
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)


@pytest.fixture(autouse=True)
def _repaired_jax_emergency_fold(monkeypatch):
    """The JAX plane with the port's repair of its unlogged emergency
    fold (ROADMAP §3): the ring folds at the join of the staged commit
    VCs (the base the flush raises to) in place of the infinite horizon,
    which would raise the device base VC to infinity and hide every
    later op from reads; and once the retried rows land, the ring folds
    once more at that horizon, so they join the base instead of hiding
    under it.  The JAX flush is left as it is; its fold and append are
    wrapped to do the same."""
    fold = jdpm._PlaneBase._run_device_gc

    def run_device_gc(self, gst):
        if np.all(np.asarray(gst) >= jdpm._VC_INF):
            pairs = self._ss_pairs(self._ring_vc_bound)
            if pairs is not None:
                gst = self._dense_vc(pairs)
            self.__dict__["_emergency_horizon"] = gst
        fold(self, gst)

    def repaired(append):
        def append_rows(self, rows):
            gst = self.__dict__.pop("_emergency_horizon", None)
            out = append(self, rows)
            if gst is not None:
                fold(self, gst)
            return out
        return append_rows

    monkeypatch.setattr(jdpm._PlaneBase, "_run_device_gc", run_device_gc)
    for cls in (jdpm._PlaneBase, jdpm.RgaPlane):
        monkeypatch.setattr(cls, "_append_rows",
                            repaired(cls.__dict__["_append_rows"]))


def _counters(reg):
    return ([getattr(reg, c).value() for c in INGEST_COUNTERS]
            + [reg.ingest_flushes.value(kind=k) for k in FLUSH_KINDS])


#: a JAX DevicePlane and the port's on the CPU at PLANE_KW, driven alike
Pair = functools.partial(tp.Pair, **PLANE_KW)


def _planes(dp):
    """(name, plane) of every flat plane, map sub-plane and presence."""
    out = []
    for tn, p in dp.planes.items():
        if hasattr(p, "_subs"):
            out += [(f"{tn}/{n}", s) for n, s in sorted(p._subs.items())]
            if p._presence is not None:
                out.append((f"{tn}/presence", p._presence))
        else:
            out.append((tn, p))
    return out


_DIRS = ("key_index", "capacity", "elem_index", "rev_elems", "n_slots",
         "actors_sorted", "rev_vals", "actor_index", "rev_actors",
         "_base_vc", "_has_base", "rows", "pending_keys", "_ops_since_gc")


def _directory(p, mod):
    d = {a: getattr(p, a) for a in _DIRS if hasattr(p, a)}
    d["rev_keys"] = ["<evicted>" if k is mod._Evicted else k
                     for k in p.rev_keys]
    d["dc_ids"] = p.domain.dc_ids
    d["d"] = p.domain.d
    return d


def assert_planes_equal(pair):
    assert pair.t_ev == pair.j_ev
    assert pair.t.host_only == pair.j.host_only
    jp, tpl = _planes(pair.j), _planes(pair.t)
    assert [n for n, _ in tpl] == [n for n, _ in jp]
    for (name, j), (_, t) in zip(jp, tpl):
        assert _directory(t, tdpm) == _directory(j, jdpm), name
        if isinstance(t.st, dict):           # RGA documents
            assert sorted(t.st) == sorted(j.st), name
            for i in t.st:
                tp.assert_state_equal(j.st[i], t.st[i])
        else:
            tp.assert_state_equal(j.st, t.st)
    for tn in TYPES:
        jm, tm = pair.j.planes[tn], pair.t.planes[tn]
        if hasattr(tm, "fields"):
            assert tm.fields == jm.fields


def _oracle(type_name, ops, key, rv):
    cls = get_type(type_name)
    st = cls.new()
    for p in ops:
        if p.key == key and (rv is None or p.commit_vc().le(rv)):
            st = cls.update(p.effect, st)
    return st


def check_reads(pair, gen, type_name, rvs, oracle=True):
    """read and read_many at every VC of ``rvs`` agree in both packages;
    with ``oracle``, every key never evicted reads the host oracle's
    value.  Returns the count of oracle checks."""
    cls = get_type(type_name)
    evicted = {k for k, _t, _s in pair.t_ev}
    n_oracle = 0
    for rv in rvs:
        raised, many = pair.call("read_many", list(gen.keys), type_name,
                                 vc=rv)
        for key in gen.keys:
            r, v = pair.call("read", key, type_name, vc=rv)
            if r:
                continue
            assert not raised and many[key] == v
            if oracle and key not in evicted:
                assert cls.value(v) == cls.value(
                    _oracle(type_name, pair.ops, key, rv)), (key, rv)
                n_oracle += 1
    return n_oracle


def run_stream(pair, gen, type_name, n_ops, lag=40):
    """``n_ops`` stream ops staged on both planes, the stable VC
    ``lag`` ticks behind each DC's clock (None: no stable VC); returns
    the snapshots taken every 37 ops."""
    snaps = []
    for i in range(n_ops):
        p = gen.next_op(type_name)
        stable = None if lag is None else VC(
            {d: max(t - lag, 0) for d, t in gen.clock.items()})
        pair.stage(p, stable)
        if i % 37 == 0:
            snaps.append(gen.snapshot())
    return snaps


#: (packed ingest, unlogged export, plane sizes, stable lag): the unlogged
#: plane at test_stream_oracle_equivalence's sizes, where hot keys
#: overflow their 4 lanes and the ring folds in an emergency; the
#: log-replay plane on the per-column path with 8 lanes, a GC every
#: flush and the stable VC a few ops behind, where no key overflows
MODES = {
    "packed-export": (True, True, {}, 40),
    "columns-log-replay": (False, False, {"n_lanes": 8, "gc_ops": 16}, 12),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("type_name", TYPES)
def test_plane_matches_jax(type_name, mode):
    """Both planes leave equal evictions, exported states, directories,
    state tensors and reads, and move the INGEST_* counters alike.  Both
    read the CRDT oracle at every snapshot, for every key the plane
    kept: the log-replay plane keeps every key, and the unlogged plane's
    emergency fold takes its retried rows into the raised base (the
    port's repair, the JAX half's by ``_repaired_jax_emergency_fold``)."""
    ingest, export, kw, lag = MODES[mode]
    before = (_counters(jstats.registry), _counters(tstats.registry))
    gen = tp.StreamGen(seed=7)
    pair = Pair(export=export, ingest=ingest, **kw)
    snaps = run_stream(pair, gen, type_name, 300, lag=lag)
    assert_planes_equal(pair)
    n = check_reads(pair, gen, type_name, [None, gen.snapshot()] + snaps)
    if not export:
        assert pair.t_ev == [] and n >= 2 * len(gen.keys)
    pair.call("gc", vc=gen.snapshot())
    pair.call("flush")
    assert_planes_equal(pair)
    check_reads(pair, gen, type_name, [None, gen.snapshot(), snaps[-1]])
    for key in gen.keys:
        assert pair.t.owns(type_name, key) == pair.j.owns(type_name, key)
        assert pair.t.state_exact(type_name, key) == \
            pair.j.state_exact(type_name, key)
    assert pair.t.pending() == pair.j.pending() == 0
    after = (_counters(jstats.registry), _counters(tstats.registry))
    assert [a - b for a, b in zip(after[1], before[1])] == \
        [a - b for a, b in zip(after[0], before[0])]


@pytest.mark.parametrize("type_name", ["register_lww", "set_rw", "map_rr",
                                       "rga"])
def test_growth_of_keys_dcs_and_slots(type_name):
    """Ten DCs outgrow the 8-column clock domain, 12 keys the key
    directory and 9 elements the slots, on both planes alike."""
    dcs = tuple(f"dc{i}" for i in range(10))
    gen = tp.StreamGen(seed=3, dcs=dcs, keys=12, elems=9)
    pair = Pair(export=True)
    run_stream(pair, gen, type_name, 120, lag=60)
    assert_planes_equal(pair)
    # the GC covers the emergency folds' retried rows (see
    # test_plane_matches_jax) before the oracle reads
    pair.call("gc", vc=gen.snapshot())
    flat = [p for _n, p in _planes(pair.t)]
    assert max(p.domain.d for p in flat) == 16
    if type_name != "rga":
        assert max(p.capacity for p in flat) >= 8
    check_reads(pair, gen, type_name, [None, gen.snapshot()])


@pytest.mark.parametrize("export", [True, False])
@pytest.mark.parametrize("type_name", ["counter_pn", "set_aw", "map_go"])
def test_hot_key_overflow_evicts(type_name, export):
    """With no stable VC, two hot keys take 8 rows a flush each into 4
    lanes: the rows overflow even after the unlogged plane's emergency
    fold, and the keys evict — with their exported state when there is
    no log, without it when there is.  Both packages alike."""
    gen = tp.StreamGen(seed=5, keys=2)
    pair = Pair(export=export)
    run_stream(pair, gen, type_name, 120, lag=None)
    pair.call("flush")
    assert_planes_equal(pair)
    assert pair.t_ev
    assert all((s is not None) == export for _k, _t, s in pair.t_ev)
    assert pair.t.host_only == {k for k, _t, _s in pair.t_ev}
    check_reads(pair, gen, type_name, [None])


@pytest.mark.parametrize("type_name", ["counter_pn", "set_aw", "register_mv",
                                       "register_lww", "flag_ew", "set_go"])
def test_seed_state_round_trips(type_name):
    """seed_effects(read()) seeded onto an empty plane and folded at the
    seed frontier reads back the same state."""
    gen = tp.StreamGen(seed=9)
    pair = Pair()
    run_stream(pair, gen, type_name, 150)
    vc = gen.snapshot()
    fresh = tdpm.DevicePlane(device="cpu", **PLANE_KW)
    n = 0
    for key in gen.keys:
        if not pair.t.owns(type_name, key):
            continue
        state = pair.t.read(key, type_name, None)
        assert fresh.seed_state(key, type_name, state, vc)
        fresh.gc(vc)
        assert fresh.read(key, type_name, None) == state
        n += 1
    assert n > 0


@pytest.mark.parametrize("type_name", ["map_go", "set_rw", "rga"])
def test_seed_state_refused(type_name):
    """Types with no state->effects decoding stay on the host path."""
    gen = tp.StreamGen(seed=9)
    pair = Pair()
    run_stream(pair, gen, type_name, 40)
    key = next(k for k in gen.keys if pair.t.owns(type_name, k))
    state = pair.t.read(key, type_name, None)
    fresh = tdpm.DevicePlane(device="cpu", **PLANE_KW)
    assert not fresh.seed_state(key, type_name, state, gen.snapshot())


def test_fused_read_counts_one_dispatch():
    """fused_read over the captures of two types' batched reads counts
    one read dispatch in both packages and returns what the separate
    reads return."""
    gen = tp.StreamGen(seed=13)
    pair = Pair()
    for _ in range(80):
        for tn in ("set_aw", "counter_pn", "register_lww"):
            pair.stage(gen.next_op(tn), None)
    rv = gen.snapshot()
    got = []
    for dp, mod, conv in ((pair.j, jdpm, tp.jax_vc),
                          (pair.t, tdpm, lambda v: v)):
        caps = [dp.planes[tn].read_many_begin(list(gen.keys), conv(v))
                for tn in ("set_aw", "counter_pn", "register_lww")
                for v in (None, rv)]
        n0 = mod.read_dispatch_count()
        fused = mod.fused_read([c.split for c in caps])
        assert mod.read_dispatch_count() == n0 + 1
        assert fused == [c() for c in caps]
        assert mod.read_dispatch_count() == n0 + 1 + len(caps)
        got.append(fused)
    assert got[0] == got[1]
    assert all(c.device == torch.device("cpu") for c in caps)


@pytest.mark.parametrize("type_name", ["set_aw", "counter_pn", "register_mv",
                                       "register_lww", "set_rw", "set_go",
                                       "map_go", "rga"])
def test_capture_then_append_reads_the_captured_value(type_name):
    """A read_begin / read_many_begin capture, then more ops staged and
    flushed to the same keys and one key evicted (its rows purged), then
    the capture run: it returns the value at capture.  The port's stores
    update in place, so this holds only because the capture enqueues the
    fold."""
    gen = tp.StreamGen(seed=17, keys=3, elems=40)
    dp = tdpm.DevicePlane(device="cpu", **{**PLANE_KW, "n_lanes": 8})
    evicted = []
    dp.set_evict_handler(lambda k, t, s=None: evicted.append(k))

    def stage(n):
        for _ in range(n):
            p = gen.next_op(type_name)
            dp.stage(p.key, type_name, p, VC(
                {d: max(t - 12, 0) for d, t in gen.clock.items()}))

    stage(30)
    plane = dp.planes[type_name]
    want = {k: dp.read(k, type_name, None) for k in gen.keys}
    one = plane.read_begin(gen.keys[0], None)
    many = plane.read_many_begin(list(gen.keys), None)
    stage(12)
    dp.flush()
    plane.evict(gen.keys[1])
    assert gen.keys[1] in evicted
    assert any(dp.read(k, type_name, None) != want[k]
               for k in (gen.keys[0], gen.keys[2]))
    assert one() == want[gen.keys[0]]
    assert many() == want


def test_place_on_moves_every_plane():
    """place_on moves existing state, and builds later map sub-planes
    and RGA documents on the new device (the meta device stands in for a
    second card: it keeps shapes, not values)."""
    gen = tp.StreamGen(seed=21)
    dp = tdpm.DevicePlane(device="cpu", **PLANE_KW)
    for tn in ("set_aw", "rga"):
        for _ in range(10):
            p = gen.next_op(tn)
            dp.stage(p.key, tn, p, None)
    dp.flush()
    dp.place_on("meta")
    meta = torch.device("meta")
    assert dp.device == meta
    assert dp.planes["set_aw"].st.ops.device == meta
    assert dp.planes["map_go"]._presence.st.valid.device == meta
    assert dp.planes["rga"].st and all(
        s.wn.device == meta for s in dp.planes["rga"].st.values())
    sub = dp.planes["map_rr"]._sub("set_aw")
    assert sub.st.ops.device == meta and sub.device == meta
    dp.planes["rga"]._key_idx("new-doc")
    assert all(s.wn.device == meta for s in dp.planes["rga"].st.values())
