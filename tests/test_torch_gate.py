"""The port's dependency gate (antidote_tpu_torch.interdc.dep and
gate_kernels) against the JAX package's, on the CPU: the ring programs
on the same seeded ring states (values and dtypes equal), and whole
DependencyGates of both packages fed the same scenarios in host, ring
and repack modes, which must apply the same txns in the same order,
leave the same queues and clocks, move the GATE_* counters alike and
feed equal GSTs to their stable-time trackers."""

from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu import stats as jstats
from antidote_tpu.clocks import VC as JVC
from antidote_tpu.interdc import dep as jdep
from antidote_tpu.interdc import gate_kernels as jgk
from antidote_tpu.interdc.wire import InterDcTxn as JTxn
from antidote_tpu.meta.gossip import StableTimeTracker as JTracker
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu.txn.manager import PartitionRetired as JRetired
from antidote_tpu_torch import stats as tstats
from antidote_tpu_torch.clocks import VC as TVC
from antidote_tpu_torch.interdc import dep as tdep
from antidote_tpu_torch.interdc import gate_kernels as tgk
from antidote_tpu_torch.interdc import synth
from antidote_tpu_torch.interdc.wire import InterDcTxn as TTxn
from antidote_tpu_torch.meta.gossip import StableTimeTracker as TTracker
from antidote_tpu_torch.txn.manager import PartitionRetired as TRetired
from benches.config5_gst import _gate_cascade

BIG_SS = np.int64(2**62)
COUNTERS = ("gate_h2d_bytes", "gate_d2h_bytes", "gate_admitted_batched",
            "gate_coalesced", "gate_ring_rebuilds")
#: gate kwargs of each mode; adapt=False pins the path (the picker times
#: real passes)
MODES = {
    "host": dict(batch_threshold=10**9, adapt=False),
    "ring": dict(batch_threshold=0, adapt=False, device_ring=True),
    "repack": dict(batch_threshold=0, adapt=False, device_ring=False),
}


@pytest.fixture(autouse=True)
def _unsampled_jax_tracer(monkeypatch):
    """No sampled txn spans in the JAX package (its kernel spans would
    fetch a value inside a jitted ring program and raise;
    tests/test_torch_device_plane.py says why)."""
    monkeypatch.setattr(jtracer, "sample_rate", 0.0)


# ---------------------------------------------------------- ring states

STATES = {
    "mixed_c64_d16": lambda: synth.ring_state(1, 64, 16),
    "mixed_c32_d8": lambda: synth.ring_state(2, 32, 8),
    "dense_c8_d8": lambda: synth.ring_state(3, 8, 8, dead=0.0, pings=0.0),
    "pings_c16_d8": lambda: synth.ring_state(4, 16, 8, pings=0.6),
    "dead_c64_d8": lambda: synth.ring_state(5, 64, 8, dead=0.6),
    "chain_c64_d8": lambda: synth.ring_state(6, 64, 8, chain=True),
    "chain_c32_d16": lambda: synth.ring_state(7, 32, 16, chain=True),
    "stall_c16_d8": lambda: synth.ring_state(8, 16, 8, stall=True),
    # wider than any CTA's shared memory holds the kernel's tables
    "mixed_c64_d16384": lambda: synth.ring_state(9, 64, 16_384),
    # nine dependencies a txn: more failing columns than the kernel's
    # witnesses
    "wide_cascade_n16": lambda: synth.probe_state(
        synth.gate_cascade(16, 4, fanout=9), 16, 10**12),
}


def assert_same(got, want, what=""):
    """A port tensor (or None) equals a JAX array: values and dtype."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("state", STATES)
def test_ring_fixpoint_matches_jax(state):
    arrays = STATES[state]()
    want = jgk.ring_fixpoint(*map(jnp.asarray, arrays))
    ring, pvc = tgk.ring_from_numpy(arrays, "cpu")
    got = tgk.ring_fixpoint(*tgk.ring_rows(ring), pvc)
    for name, g, w in zip(("applied", "rounds", "pvc", "new_live", "count"),
                          got, want):
        assert_same(g, w, name)
    if state.startswith("chain"):
        assert int(got[1].max()) == int(got[4]) - 1 > 8  # a txn a round
    if state.startswith("stall"):
        assert int(got[4]) == 0 and torch.equal(got[2], pvc)


@pytest.mark.parametrize("d", [8, 512, 16_384])
@pytest.mark.parametrize("n", [1, 64, 256, 2_048, 4_096])
def test_fixpoint_geometry(n, d):
    """The kernel's launch from (n, d) alone: one CTA of a warp a row
    (at least 2, at most 16 warps) up to the small ring's 256 rows, a
    16-CTA cluster of 1,024 threads at the cascade's 2,048 and above;
    each CTA's shared memory within the H100's 232,448 bytes.  Where
    they fit, the whole clock (int64) and a CTA's column slice of both
    parities of the blocked minima (int32) are in shared memory, with
    both parities of the advance maxima (int64) there too on one CTA
    and in 2 d words of global scratch in a cluster; all of them go to
    global scratch where they do not fit (one CTA at d = 16,384).  A
    CTA's rows' state (76 bytes a row) follows in shared memory, and
    then no row scratch is allocated."""
    g = tgk.fixpoint_geometry(n, d)
    if n <= 256:
        assert (g.ctas, g.threads) == (1, min(512, 32 * max(2, n)))
    else:
        assert (g.ctas, g.threads) == (16, 1024)
    assert 0 < g.smem <= 232_448
    cols = -(-d // g.ctas)                 # a CTA's slice of the columns
    prog = 76 * -(-n // g.ctas)
    assert g.row_scratch == 0
    if g.ctas == 1 and d == 16_384:
        assert g.tables == "global" and g.smem == 16 + prog
        # every CTA's clock, then both parities of both tables
        assert g.scratch == g.ctas * d + 2 * d + d
    elif g.ctas == 1:
        assert g.tables == "shared" and g.scratch == 0
        assert g.smem == 16 + 8 * d + 2 * 8 * d + 2 * 4 * d + prog
    else:
        assert g.tables == "shared" and g.scratch == 2 * d
        assert g.smem == 16 + 8 * d + 2 * 4 * cols + prog


@pytest.mark.parametrize("n,d,ctas,tables", [(256, 7_000, 1, "shared"),
                                             (257, 23_001, 4, "shared"),
                                             (256, 7_300, 1, "global")])
def test_fixpoint_geometry_rows_past_shared_memory(n, d, ctas, tables):
    """Where the tables leave too little shared memory for a CTA's rows'
    state, the rows go to 8 n words of global scratch and the CTA's
    shared memory holds the tables alone; where the tables themselves
    go global, the rows fit again."""
    g = tgk.fixpoint_geometry(n, d)
    assert (g.ctas, g.tables) == (ctas, tables)
    assert g.smem <= 232_448
    if tables == "shared":
        cols = -(-d // ctas)
        adv = 2 * 8 * d if ctas == 1 else 0
        assert g.smem == 16 + 8 * d + adv + 2 * 4 * cols
        assert g.smem + 76 * -(-n // ctas) > 232_448
        assert g.row_scratch == 8 * n
    else:
        assert g.smem == 16 + 76 * n and g.row_scratch == 0


def padded(seed, n, n_pad, d):
    """dep.py's repack form: a ring state's live rows packed at the
    front, padding rows as the repack path builds them."""
    ss, origin, pos, ts, ping, live, pvc = synth.ring_state(seed, n, d,
                                                            dead=0.0)
    out = (np.zeros((n_pad, d), np.int64), np.zeros(n_pad, np.int32),
           np.full(n_pad, np.iinfo(np.int32).max // 2, np.int32),
           np.zeros(n_pad, np.int64), np.zeros(n_pad, bool))
    out[0][n:, 1] = BIG_SS
    for dst, src in zip(out, (ss, origin, pos, ts, ping)):
        dst[:n] = src[:n]
    return out + (pvc,)


@pytest.mark.parametrize("seed,n,n_pad,d", [(11, 5, 8, 8), (12, 20, 32, 8),
                                            (13, 40, 64, 16)])
def test_gate_fixpoint_and_ready_mask_match_jax(seed, n, n_pad, d):
    arrays = padded(seed, n, n_pad, d)
    want = jdep.gate_fixpoint(*map(jnp.asarray, arrays))
    got = tdep.gate_fixpoint(*map(torch.from_numpy, arrays))
    for name, g, w in zip(("applied", "rounds", "pvc"), got, want):
        assert_same(g, w, name)
    assert not got[0][n:].any()           # sentinel rows never apply
    ss, origin, pvc = arrays[0], arrays[1], arrays[5]
    assert_same(tdep.ready_mask(*map(torch.from_numpy, (ss, origin, pvc))),
                jdep.ready_mask(*map(jnp.asarray, (ss, origin, pvc))))


def test_ring_append_retire_gather_match_jax():
    """Appends and retires with padding slots (dropped), then gathers
    that grow, widen d_pad and shrink: the port's ring rows equal JAX's
    after every step."""
    rng = np.random.default_rng(0)
    cap, d = 16, 8
    jring = jgk.ring_alloc(cap, d)
    tring = tgk.ring_alloc(cap, d, "cpu")

    def same(jr, tr, what):
        for name, g, w in zip(("ss", "origin", "pos", "ts", "ping", "live"),
                              tgk.ring_rows(tr), jr):
            assert_same(g, w, f"{what}: {name}")

    def append(jr, tr, slots, k_pad, cap, d):
        k = len(slots)
        s = np.full(k_pad, cap, np.int32)
        s[:k] = slots
        u = (rng.integers(0, 1000, (k_pad, d)).astype(np.int64),
             rng.integers(0, d, k_pad).astype(np.int32),
             rng.integers(0, 50, k_pad).astype(np.int32),
             rng.integers(0, 1000, k_pad).astype(np.int64),
             rng.random(k_pad) < 0.3)
        jr = jgk.ring_append(*jr, jnp.asarray(s), *map(jnp.asarray, u))
        tr = tgk.ring_append(*tr, torch.from_numpy(s),
                             *map(torch.from_numpy, u))
        return jr, tr

    jring, tring = append(jring, tring, [3, 0, 7, 15], 8, cap, d)
    same(jring, tring, "append")
    jring, tring = append(jring, tring, [1, 2, 4, 5, 6, 8, 9], 8, cap, d)
    same(jring, tring, "second append")
    s = np.full(8, cap, np.int32)
    s[:3] = [0, 5, 9]
    jring = jring[:5] + (jgk.ring_retire(jring[5], jnp.asarray(s)),)
    tring = tring[:5] + (tgk.ring_retire(tring[5], torch.from_numpy(s)),)
    same(jring, tring, "retire")
    for new_cap, new_d, n_live in ((32, 16, 8), (8, 16, 8), (16, 8, 5)):
        live_slots = np.nonzero(np.asarray(jring[5]))[0]
        idx = np.zeros(new_cap, np.int32)
        idx[:n_live] = live_slots[:n_live]
        jring = jgk.ring_gather(*jring[:5], jnp.asarray(idx),
                                np.asarray(n_live, np.int32), new_d=new_d)
        tring = tgk.ring_gather(*tring[:5], torch.from_numpy(idx), n_live,
                                new_d=new_d)
        same(jring, tring, f"gather to {new_cap} x {new_d}")
        jring, tring = append(jring, tring, [new_cap - 1], 8, new_cap,
                              jring[0].shape[1])
        same(jring, tring, f"append after gather to {new_cap}")


# ------------------------------------------------------------ the gates


class FakePM:
    def __init__(self, poison=(), exc=None):
        self.applied = []
        self.poison, self.exc = set(poison), exc

    def heal(self):
        self.poison.clear()

    def apply_remote(self, records, dc_id, ts, snapshot_vc):
        if (dc_id, ts) in self.poison:
            raise self.exc(f"handoff {dc_id}@{ts}")
        self.applied.append((dc_id, ts))


class Clock:
    def __init__(self, t=10**9):
        self.t = t

    def __call__(self):
        return self.t


class Side:
    """One package's gate, fake PM, tracker and txn constructors."""

    def __init__(self, pkg, mode, pm_kw=None, clock=None, **kw):
        self.pkg = pkg
        jax_side = pkg == "jax"
        self.txn_cls, self.vc_cls = (JTxn, JVC) if jax_side else (TTxn, TVC)
        self.reg = (jstats if jax_side else tstats).registry
        pm_kw = dict(pm_kw or {})
        if pm_kw:
            pm_kw["exc"] = JRetired if jax_side else TRetired
        self.pm = FakePM(**pm_kw)
        self.clock = clock or Clock()
        kw = {"coalesce_us": 0, **MODES[mode], **kw}
        if jax_side:
            self.gate = jdep.DependencyGate(self.pm, "dc_self", self.clock,
                                            **kw)
        else:
            self.gate = tdep.DependencyGate(self.pm, "dc_self", self.clock,
                                            device="cpu", **kw)
        tracker_cls = JTracker if jax_side else TTracker
        self.tracker = tracker_cls("dc_self", n_partitions=1)
        self.gate.on_clock_update = lambda: self.tracker.put(
            0, self.gate.partition_vc())

    def txn(self, origin, ts, snap, ping=False):
        return self.txn_cls(
            dc_id=origin, partition=0, prev_log_opid=0,
            snapshot_vc=None if ping else self.vc_cls(snap), timestamp=ts,
            records=[] if ping else ["r"])

    def counters(self):
        reg = self.reg
        out = {k: reg.gate_dispatches.value(kind=k)
               for k in jdep.GATE_DISPATCH_KINDS}
        out.update({c: getattr(reg, c).value() for c in COUNTERS})
        return out

    def state(self):
        g = self.gate
        return dict(applied=list(self.pm.applied),
                    left={o: [t.timestamp for t in q]
                          for o, q in g.queues.items() if q},
                    vc=dict(g.applied_vc),
                    gst=dict(self.tracker.get_stable_snapshot()))


def run_both(mode, drive, pm_kw=None, **kw):
    """``drive(side)`` on a JAX side and a port side of ``mode``; their
    applied lists (in order), leftovers, clocks, GSTs and GATE_* deltas
    must be equal.  Returns the port's side."""
    out = {}
    for pkg in ("jax", "torch"):
        side = Side(pkg, mode, pm_kw, **kw)
        c0 = side.counters()
        drive(side)
        c1 = side.counters()
        out[pkg] = (side, side.state(),
                    {k: c1[k] - c0[k] for k in c0})
    (_, js, jc), (tside, ts, tc) = out["jax"], out["torch"]
    assert ts == js
    assert tc == jc
    return tside


def feed(side, queues):
    for origin, specs in queues.items():
        side.gate.queues[origin] = deque(side.txn(*s) for s in specs)
    side.gate.process_queues()


def random_scenario(seed, n_origins=6, q_len=8):
    """tests/unit/test_dep_gate.py's scenario, as txn specs."""
    rng = np.random.default_rng(seed)
    origins = [f"dc{i}" for i in range(n_origins)]
    queues = {}
    for oi, origin in enumerate(origins):
        txns = []
        base = 100 * (oi + 1)
        for p in range(q_len):
            ts = base + 50 * p + int(rng.integers(0, 10))
            if rng.random() < 0.15:
                txns.append((origin, ts, {}, True))
                continue
            snap = {}
            for dep_oi in rng.choice(n_origins, size=2, replace=False):
                dep = origins[dep_oi]
                if dep == origin:
                    continue
                snap[dep] = 100 * (dep_oi + 1) + 50 * int(
                    rng.integers(0, q_len // 2))
            snap[origin] = ts - 1
            txns.append((origin, ts, snap))
        queues[origin] = txns
    return queues


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_random_scenario_matches_jax(seed, mode):
    run_both(mode, lambda s: feed(s, random_scenario(seed)))


def cascade_specs(N, q_len=8):
    origins = synth.origin_names(N)
    queues = {o: [] for o in origins}
    for row in synth.gate_cascade(N, q_len):
        t = synth.make_txn(row, origins)
        queues[t.dc_id].append((t.dc_id, t.timestamp, dict(t.snapshot_vc)))
    return queues


def test_cascade_recipe_is_the_bench_s():
    assert synth.gate_cascade(16) == _gate_cascade(16)
    assert synth.gate_cascade(5, 3) == _gate_cascade(5, 3)


@pytest.mark.parametrize("mode", MODES)
def test_cascade_matches_jax(mode):
    side = run_both(mode, lambda s: feed(s, cascade_specs(16)))
    assert not side.gate.pending() and len(side.pm.applied) == 16 * 8
    # every origin applied in FIFO order
    for o, specs in cascade_specs(16).items():
        assert [t for dc, t in side.pm.applied if dc == o] == \
            [s[1] for s in specs]


@pytest.mark.parametrize("coalesce_us", [0, 2000])
@pytest.mark.parametrize("mode", MODES)
def test_steady_stream_matches_jax(mode, coalesce_us):
    """The steady-stream probe at N = 16 with a fixed clock: one txn an
    enqueue, phase-major, then process_queues until drained."""
    N, q_len = 16, 4
    origins = synth.origin_names(N)
    rows = synth.gate_cascade(N, q_len)
    arrival = sorted(range(len(rows)), key=lambda i: (rows[i][1], rows[i][0]))

    def drive(side):
        for i in arrival:
            side.gate.enqueue(synth.make_txn(rows[i], origins, side.txn_cls,
                                             side.vc_cls))
        for _ in range(16 * q_len):
            if not side.gate.pending():
                break
            side.gate.process_queues()
        assert not side.gate.pending()

    run_both(mode, drive, coalesce_us=coalesce_us)


@pytest.mark.parametrize("mode", MODES)
def test_blocked_head_cross_block_matches_jax(mode):
    """tests/unit/test_dep_gate.py:159-195: two origins whose heads each
    need a time only the other's blocked stream provides drain through
    the blocked-head ts - 1 rule."""
    kw = {"batch_threshold": 100 if mode == "host" else 4}
    side = run_both(mode, lambda s: feed(s, {
        "dcA": [("dcA", 61, {"dcB": 50}), ("dcA", 70, {"dcB": 50})],
        "dcB": [("dcB", 55, {"dcA": 60}), ("dcB", 66, {"dcA": 60})]}), **kw)
    assert len(side.pm.applied) == 4
    assert side.gate.applied_vc.get_dc("dcA") == 70


@pytest.mark.parametrize("mode", MODES)
def test_exclusive_ping_advance_matches_jax(mode):
    def drive(side):
        feed(side, {"a": [("a", 150, {"b": 500})],
                    "b": [("b", 500, {}, True)]})
        assert side.pm.applied == [] and side.gate.pending() == 1
        assert side.gate.applied_vc.get_dc("b") == 499
        side.gate.enqueue(side.txn("b", 500, {}))
        side.gate.process_queues()

    side = run_both(mode, drive)
    assert sorted(side.pm.applied) == [("a", 150), ("b", 500)]


@pytest.mark.parametrize("mode", MODES)
def test_partition_retired_mid_wave_matches_jax(mode):
    """A PM that raises PartitionRetired partway through a wave: the
    remainder is re-queued (the clock does not fold over it), the ring
    retires the wave's admitted slots at the next sync, and the gate
    drains once healed."""
    queues = {"a": [("a", 100, {})], "b": [("b", 200, {"a": 100})],
              "c": [("c", 300, {})], "d": [("d", 400, {"b": 200})]}

    def drive(side):
        feed(side, queues)
        assert ("b", 200) not in side.pm.applied and side.gate.pending()
        assert side.gate.applied_vc.get_dc("b") < 200
        side.pm.heal()
        side.gate.process_queues()
        assert not side.gate.pending()

    side = run_both(mode, drive, pm_kw={"poison": [("b", 200)]})
    assert len(side.pm.applied) == 4


def test_ring_growth_and_new_origins_match_jax():
    """The ring grows past ring_capacity, and origins that first arrive
    after the bulk load widen d_pad through a gather."""
    def drive(side):
        g = side.gate
        for i in range(12):
            g.queues[f"o{i}"] = deque([side.txn(f"o{i}", 100 + i,
                                                {"z": 5000})])
        g.process_queues()                       # bulk load, all blocked
        for i in range(12, 40):                  # new origins: widen
            g.enqueue(side.txn(f"o{i}", 100 + i, {"z": 5000}))
        g.process_queues()
        g.enqueue(side.txn("z", 5000, {}))
        g.process_queues()
        assert not g.pending() and len(side.pm.applied) == 41
        g.enqueue(side.txn("late", 9000, {}))    # compaction
        g.process_queues()

    side = run_both("ring", drive, ring_capacity=8)
    assert side.gate._ring.cap == 8 and side.gate._ring.d_pad == 64


def test_stable_time_tracker_matches_jax():
    j = JTracker("dc_self", n_partitions=3)
    t = TTracker("dc_self", n_partitions=3)
    rng = np.random.default_rng(3)
    for _ in range(20):
        p = int(rng.integers(0, 3))
        vc = {f"dc{i}": int(rng.integers(0, 10**6)) for i in range(4)}
        j.put(p, JVC(vc))
        t.put(p, TVC(vc))
        assert dict(t.get_stable_snapshot()) == dict(j.get_stable_snapshot())
