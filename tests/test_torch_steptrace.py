"""The port's host spans (antidote_tpu_torch/obs/prof.py) and the
benchmark's split of the superstep's idle time by them
(portbench/lib/steptrace.py), on the CPU.

A wrapped call that is not timed walks none of its arguments and keeps
no span; under ``detail`` one superstep keeps its step, its frontier and
its kernels' dispatches, nested, on the clock torch.profiler's events
carry; a capture labels the same spans in its trace; the buffer is
bounded and counts what it drops, from any number of threads.  The gap
rule names each idle gap by the innermost span over its middle, and the
three readings add up to the window's idle time.  The card's clock is
held in tests/test_torch_cuda.py."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from antidote_tpu_torch import entry
from antidote_tpu_torch.mat import store
from antidote_tpu_torch.obs import prof
from antidote_tpu_torch.obs.prof import DeviceProfiler, profiler
from antidote_tpu_torch.obs.spans import tracer
from portbench.lib import steptrace
from portbench.lib.trace import Window

K, B = 64, 32


@pytest.fixture(autouse=True)
def _isolate():
    saved = (tracer.sample_rate, profiler.enabled, profiler.detail)
    tracer.sample_rate = 0.0
    profiler.reset()
    yield
    tracer.sample_rate, en, det = saved
    profiler.configure(enabled=en, detail=det)
    profiler.reset()


def _shard_and_batches(n, seed=5):
    rng = np.random.default_rng(seed)
    clock = np.zeros(3, dtype=np.int32)
    st = store.orset_shard_init(K, 8, 8, 8, dtype=torch.int32,
                                device="cpu")
    return st, [entry.make_batch(rng, K, B, 8, 3, clock, obs_lag=2,
                                 device="cpu") for _ in range(n)]


def _names(spans):
    return [s[0] for s in spans]


def test_nothing_is_kept_while_the_profiler_is_not_timing():
    st, (b,) = _shard_and_batches(1)
    assert not profiler.timing()
    assert profiler.span("probe") is prof._NO_SPAN
    with profiler.span("probe"):
        entry.superstep(st, b, gc=True)
    kept = profiler.host_spans()
    assert kept["spans"] == [] and kept["dropped"] == 0
    assert profiler.snapshot()["kernels"]["orset_append"]["calls"] == 1


@pytest.mark.parametrize("gc", [True, False], ids=["gc_step", "plain_step"])
def test_one_superstep_keeps_its_phases_nested(gc):
    st, (b,) = _shard_and_batches(1)
    profiler.configure(detail=True)
    entry.superstep(st, b, gc=gc)
    spans = profiler.host_spans()["spans"]
    want = ["orset_append", "superstep.frontier"]
    want += ["orset_gc_packed"] if gc else []
    want += ["orset_read_packed", "superstep"]
    assert _names(spans) == want            # in the order they ended
    (_, s0, e0, d0), = [s for s in spans if s[0] == "superstep"]
    assert d0 == 0
    prev = s0
    for name, s, e, d in spans[:-1]:
        assert d == 1, name
        assert s0 <= s <= e <= e0, name
        assert s >= prev, name              # one after another
        prev = e


def test_a_span_encloses_the_op_it_times_on_the_profilers_clock():
    profiler.configure(detail=True)
    x = torch.arange(1 << 16, dtype=torch.float32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        for _ in range(5):
            with profiler.span("clock_probe"):
                x.mul(3)
    ops = sorted((e.start_ns(), e.end_ns())
                 for e in p.profiler.kineto_results.events()
                 if e.name() == "aten::mul")
    spans = [s for s in profiler.host_spans()["spans"]
             if s[0] == "clock_probe"]
    assert len(ops) == len(spans) == 5
    for (_, t0, t1, _), (s, e) in zip(spans, ops):
        assert t0 <= s <= e <= t1, (t0, s, e, t1)


def test_a_capture_labels_the_same_spans_in_its_trace(tmp_path):
    st, (b,) = _shard_and_batches(1)
    out = str(tmp_path / "cap")
    with prof.profile(out):
        assert profiler.timing()
        entry.superstep(st, b, gc=False)
    (name,) = os.listdir(out)
    with open(os.path.join(out, name)) as f:
        labels = {e.get("name") for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"}
    assert {"superstep", "superstep.frontier", "kernel:orset_append",
            "kernel:orset_read_packed"} <= labels
    assert set(_names(profiler.host_spans()["spans"])) == {
        "superstep", "superstep.frontier", "orset_append",
        "orset_read_packed"}


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(prof, "HOST_SPANS_CAP", 4)
    p = DeviceProfiler()
    p.configure(detail=True)
    for i in range(10):
        with p.span(f"s{i}"):
            pass
    kept = p.host_spans()
    assert _names(kept["spans"]) == ["s6", "s7", "s8", "s9"]
    assert kept["dropped"] == 6
    assert 0 < kept["dropped_until_ns"] <= kept["spans"][0][1]
    assert "host_spans" not in p.snapshot()
    p.reset()
    assert p.host_spans() == {"spans": [], "dropped": 0,
                              "dropped_until_ns": 0}


def test_a_timed_calls_bookkeeping_lies_inside_its_kernel_span(
        monkeypatch):
    at = {"_leaves": [], "_sig": [], "_nbytes": []}
    for name in at:
        real = getattr(prof, name)

        def stamped(*a, _real=real, _name=name):
            at[_name].append(time.time_ns())
            return _real(*a)
        monkeypatch.setattr(prof, name, stamped)
    st, (b,) = _shard_and_batches(1)
    profiler.configure(detail=True)
    entry.superstep(st, b, gc=False)
    kernels = [s for s in profiler.host_spans()["spans"]
               if s[0] in ("orset_append", "orset_read_packed")]
    assert len(kernels) == 2
    assert all(len(ts) >= 2 for ts in at.values()), at
    for t in sum(at.values(), []):
        assert any(s <= t <= e for _, s, e, _ in kernels), t


def test_spans_from_many_threads_are_all_counted(monkeypatch):
    monkeypatch.setattr(prof, "HOST_SPANS_CAP", 512)
    p = DeviceProfiler()
    p.configure(detail=True)
    n_threads, per = 12, 300
    errors = []

    def work():
        try:
            for _ in range(per):
                with p.span("outer"):
                    with p.span("inner"):
                        pass
        except Exception as e:              # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    kept = p.host_spans()
    assert len(kept["spans"]) + kept["dropped"] == 2 * n_threads * per
    assert len(kept["spans"]) == 512
    assert all(d == (name == "inner") for name, _, _, d in kept["spans"])


def test_an_untimed_call_walks_none_of_its_arguments(monkeypatch):
    from antidote_tpu_torch import stats

    walked = {"_leaves": 0, "_sig": 0, "_nbytes": 0}
    for name in walked:
        real = getattr(prof, name)

        def counted(*a, _real=real, _name=name):
            walked[_name] += 1
            return _real(*a)
        monkeypatch.setattr(prof, name, counted)
    st, (b,) = _shard_and_batches(1)
    c0 = stats.registry.kernel_calls.value(kernel="orset_append",
                                           subsystem="mat.store")
    entry.superstep(st, b, gc=True)
    assert walked == {"_leaves": 0, "_sig": 0, "_nbytes": 0}
    assert stats.registry.kernel_calls.value(
        kernel="orset_append", subsystem="mat.store") == c0 + 1
    kern = profiler.snapshot()["kernels"]["orset_append"]
    assert kern["calls"] == 1 and kern["compile_misses"] == 0
    assert kern["dispatch_total_s"] > 0
    profiler.configure(detail=True)         # timed: the census walks
    entry.superstep(st, b, gc=True)
    assert min(walked.values()) > 0
    assert profiler.snapshot()["kernels"]["orset_append"][
        "compile_misses"] == 1


# ---------------------------------------------------------------- gap rule

def test_the_gap_rule_names_each_gap_by_its_innermost_span():
    # device busy [10, 20], [30, 40], [70, 80]; window [0, 100]
    dev = [(10, 20), (30, 40), (72, 80), (70, 75)]
    spans = [
        ("superstep", 5, 60, 0),
        ("orset_append", 18, 35, 1),        # holds gap 20-30's middle
        ("superstep.frontier", 40, 58, 1),  # holds gap 40-70's middle
        ("superstep", 62, 95, 0),           # holds the tail 80-100's
    ]
    s = steptrace.split_gaps(dev, spans, 0, 100)
    # the head 0-10 (middle 5, the first step's start) is under a span
    assert s["idle_ns"] == {"append": 10, "superstep_rest": 10 + 30 + 20,
                            "outside_program": 0}
    assert s["busy_ns"] == 30 and s["window_ns"] == 100
    # the head gap's middle before every span, a gap under none
    s = steptrace.split_gaps(dev, spans[1:3], 0, 100)
    assert s["idle_ns"] == {"append": 10, "superstep_rest": 30,
                            "outside_program": 10 + 20}
    assert sum(s["idle_ns"].values()) == s["window_ns"] - s["busy_ns"]
    assert steptrace.split_gaps([], spans, 0, 100) is None


def test_the_gap_rule_ignores_spans_that_ended_before_the_middle():
    dev = [(0, 10), (50, 60)]
    spans = [("orset_append", 1, 12, 1),    # short but over by 30
             ("superstep", 0, 100, 0)]
    s = steptrace.split_gaps(dev, spans, 0, 60)
    assert s["idle_ns"] == {"append": 0, "superstep_rest": 40,
                            "outside_program": 0}


class _OlderEvent:
    """An event of a torch whose profiler events carry no category."""

    def __init__(self, device, annotation):
        self._device, self._annotation = device, annotation

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


@pytest.mark.parametrize("device,annotation,want", [
    (torch.autograd.DeviceType.CUDA, False, True),
    (torch.autograd.DeviceType.CUDA, True, False),
    (torch.autograd.DeviceType.CPU, False, False),
], ids=["card_op", "card_annotation", "host_event"])
def test_device_ops_without_a_category_are_the_cards_events(
        device, annotation, want):
    ev = _OlderEvent(device, annotation)
    assert steptrace.is_device_op(ev, steptrace.DEVICE_CATS) is want


def _traced_steps(tmp_path, n=12):
    st, batches = _shard_and_batches(n)
    win = Window(str(tmp_path), cuda=False, host=False)
    profiler.configure(detail=True)
    win.start()
    for i, b in enumerate(batches):
        st, _, _ = entry.superstep(st, b, gc=(i + 1) % 4 == 0)
    win.stop()
    profiler.configure(detail=False)
    return {"cell": None, "layer": {}, "trace": win}


def test_the_readings_add_up_to_the_windows_idle_time(tmp_path):
    ctx = _traced_steps(tmp_path)
    s = steptrace.split(ctx)
    assert s["steps"] == 12 and s["step_host_ns"] > 0
    idle = sum(steptrace.idle_ms(ctx, k) for k in steptrace.LABELS)
    assert idle * s["steps"] / 1e3 == pytest.approx(
        (s["window_ns"] - s["busy_ns"]) / 1e9)
    win = ctx["trace"]
    assert abs(idle * s["steps"] / 1e3 - (win.window_s - win.busy_s)) \
        <= 0.02 * win.window_s
    assert steptrace.split(ctx) is s        # one split for every reader


def test_no_reading_without_spans_or_past_a_drop(tmp_path, monkeypatch):
    ctx = _traced_steps(tmp_path)
    kept = profiler.host_spans()
    lo = ctx["trace"].prof.profiler.kineto_results.trace_start_ns()
    dropped = dict(kept, dropped=1, dropped_until_ns=lo + 1)
    monkeypatch.setattr(profiler, "host_spans", lambda: dropped)
    assert steptrace.split(dict(ctx)) is None
    before = dict(kept, dropped=1, dropped_until_ns=lo - 1)
    monkeypatch.setattr(profiler, "host_spans", lambda: before)
    assert steptrace.split(dict(ctx)) is not None
    # a program without host spans: no reading, no error
    monkeypatch.delattr(DeviceProfiler, "host_spans")
    monkeypatch.delattr(profiler, "host_spans")
    assert steptrace.split(dict(ctx)) is None
    assert steptrace.split({"trace": None}) is None
