"""The port's device profiler (antidote_tpu_torch/obs/prof.py) held to
what tests/unit/test_obs_prof.py pins for the JAX one: a disabled
profiler is a passthrough that counts nothing, the signature counters
count once per new argument signature of a timed call (the port's
census follows timed calls alone), a sampled call's kernel span
joins its transaction's trace tree, unsampled calls record no span,
the buffer high-watermark follows the largest output, a capture writes
a trace file and measures completion, ``snapshot()`` has the JAX
profiler's keys for the same calls, ``obs.configure(kernel_profile=)``
switches it, and the debug endpoints serve it.  Wrapped calls nested in
a wrapped call pass through (the JAX package composes those into one
jit).  On the CPU completion is the wall time; the card's event pairs
are held in tests/test_torch_cuda.py."""

import json
import os
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu import stats as jstats
from antidote_tpu.obs import prof as jprof
from antidote_tpu.obs.spans import tracer as jtracer
from antidote_tpu_torch import obs, stats
from antidote_tpu_torch.api import AntidoteGPU
from antidote_tpu_torch.config import Config
from antidote_tpu_torch.obs import prof
from antidote_tpu_torch.obs.prof import kernel_span, profiler
from antidote_tpu_torch.obs.spans import tracer


@pytest.fixture(autouse=True)
def _isolate(tmp_path):
    """Both packages' tracer and profiler are process-global: save the
    knobs, clear the aggregates, put everything back."""
    saved = (tracer.sample_rate, profiler.enabled, profiler.detail,
             jtracer.sample_rate, jprof.profiler.enabled,
             jprof.profiler.detail)
    for t, p in ((tracer, profiler), (jtracer, jprof.profiler)):
        t.clear()
        p.reset()
    yield
    (tracer.sample_rate, en, det, jtracer.sample_rate, jen, jdet) = saved
    profiler.configure(enabled=en, detail=det)
    jprof.profiler.configure(enabled=jen, detail=jdet)
    for t, p in ((tracer, profiler), (jtracer, jprof.profiler)):
        t.clear()
        p.reset()


def test_disabled_profiler_is_a_passthrough():
    calls = []

    def toy(x):
        calls.append(1)
        return x * 2 + 1

    wrapped = profiler.wrap(toy, name="toy_noop", subsystem="t")
    x = torch.arange(64)
    assert torch.equal(wrapped(x), toy(x))
    profiler.configure(enabled=False)
    before = profiler.snapshot()["kernels"]["toy_noop"]
    reg = stats.registry
    c0 = (reg.kernel_calls.value(kernel="toy_noop", subsystem="t"),
          reg.kernel_compile_misses.value(kernel="toy_noop"))
    for n in (64, 65, 66):
        assert torch.equal(wrapped(torch.arange(n)), toy(torch.arange(n)))
    assert profiler.snapshot()["kernels"]["toy_noop"] == before
    assert (reg.kernel_calls.value(kernel="toy_noop", subsystem="t"),
            reg.kernel_compile_misses.value(kernel="toy_noop")) == c0
    assert not tracer.spans(cat="kernel")
    assert len(calls) == 2 + 2 * 3


def test_wrapper_preserves_name_and_semantics():
    @kernel_span("t")
    def add_one(x):
        return x + 1

    assert add_one.__name__ == "add_one"
    assert add_one.__kernel_span__ == ("add_one", "t")
    assert int(add_one(torch.tensor(41))) == 42

    @kernel_span("t", name="raiser")
    def boom(x):
        raise ValueError("passes through")

    with pytest.raises(ValueError, match="passes through"):
        boom(torch.tensor(1))
    # an exception leaves the nesting flag clear: the next call counts
    add_one(torch.tensor(1))
    assert profiler.snapshot()["kernels"]["add_one"]["calls"] == 2


def test_signature_counters_count_once_per_shape():
    profiler.configure(detail=True)     # the census counts timed calls

    @kernel_span("t", name="miss_probe")
    def k(x):
        return x.sum()

    k(torch.arange(8))
    k(torch.arange(8))                      # same shape: no new count
    k(torch.arange(16))                     # new shape
    k(torch.arange(16, dtype=torch.int32))  # new dtype
    snap = profiler.snapshot()["kernels"]["miss_probe"]
    assert snap["calls"] == 4
    assert snap["compile_misses"] == 3
    assert stats.registry.kernel_compile_misses.value(
        kernel="miss_probe") >= 3
    assert stats.registry.kernel_calls.value(
        kernel="miss_probe", subsystem="t") >= 4


def test_same_name_distinct_functions_each_count():
    profiler.configure(detail=True)

    def make(mul):
        def body(x, _m=mul):
            return x * _m
        return profiler.wrap(body, name="shared_name_probe", subsystem="t")

    a, b = make(2), make(3)
    x = torch.arange(4)
    a(x)
    b(x)
    assert profiler.snapshot()["kernels"]["shared_name_probe"][
        "compile_misses"] == 2


def test_scalar_args_and_state_fields_key_the_signature():
    from antidote_tpu_torch.mat import store

    profiler.configure(detail=True)

    @kernel_span("t", name="static_probe")
    def k(x, n: int):
        return x * n

    k(torch.arange(4), 2)
    k(torch.arange(4), 3)                   # new scalar value
    k(torch.arange(4), 3)
    assert profiler.snapshot()["kernels"]["static_probe"][
        "compile_misses"] == 2
    # a store state (a dataclass) is flattened into its tensors
    st8 = store.counter_shard_init(8, 4, 2, device="cpu")
    st16 = store.counter_shard_init(16, 4, 2, device="cpu")
    for st in (st8, st8, st16):
        store.counter_read(st, torch.zeros(2, dtype=torch.int64))
    assert profiler.snapshot()["kernels"]["counter_read"][
        "compile_misses"] == 2


def test_nested_wrapped_calls_pass_through():
    @kernel_span("t", name="inner_composed")
    def inner(x):
        return x + 1

    @kernel_span("t", name="outer_probe")
    def outer(x):
        return inner(x) * 2

    assert torch.equal(outer(torch.arange(4)), (torch.arange(4) + 1) * 2)
    kernels = profiler.snapshot()["kernels"]
    assert "inner_composed" not in kernels
    assert kernels["outer_probe"]["calls"] == 1
    inner(torch.arange(4))                  # alone it counts
    assert profiler.snapshot()["kernels"]["inner_composed"]["calls"] == 1


def test_kernel_child_span_joins_sampled_txn_tree():
    tracer.sample_rate = 1.0

    @kernel_span("mat.store", name="span_probe")
    def k(x):
        return x + 1

    with tracer.span("device_read", "device", txid="ktx1"):
        k(torch.arange(4))
    roots = tracer.tree("ktx1")
    assert len(roots) == 1
    children = [c["span"].name for c in roots[0]["children"]]
    assert "kernel:span_probe" in children
    (kspan,) = tracer.spans(name="kernel:span_probe")
    assert kspan.cat == "kernel" and kspan.txid == "ktx1"
    assert kspan.args["subsystem"] == "mat.store"
    assert kspan.args["complete"] is True
    assert "kernel" in tracer.planes("ktx1")
    assert profiler.snapshot()["kernels"]["span_probe"]["completions"] == 1


def test_unsampled_calls_record_no_spans():
    tracer.sample_rate = 0.0

    @kernel_span("t", name="quiet_probe")
    def k(x):
        return x + 1

    with tracer.span("device_read", "device", txid="qx"):
        k(torch.arange(4))
    assert not tracer.spans(cat="kernel")
    snap = profiler.snapshot()["kernels"]["quiet_probe"]
    assert snap["calls"] == 1 and snap["completions"] == 0
    assert snap["complete_mean_s"] is None


def test_detail_mode_measures_every_call():
    profiler.configure(detail=True)

    @kernel_span("t", name="detail_probe")
    def k(x):
        return x + 1

    for _ in range(3):
        k(torch.arange(4))
    snap = profiler.snapshot()["kernels"]["detail_probe"]
    assert snap["completions"] == 3 and snap["complete_mean_s"] >= 0
    assert not tracer.spans(cat="kernel")   # no txn: no span


def test_buffer_hwm_gauge_tracks_output_bytes():
    profiler.configure(detail=True)     # the census counts timed calls

    @kernel_span("hwm_sub", name="hwm_probe")
    def k(x):
        return x * 2

    k(torch.zeros(16, dtype=torch.int64))
    k(torch.zeros(1024, dtype=torch.int64))
    k(torch.zeros(8, dtype=torch.int64))    # smaller: hwm unchanged
    snap = profiler.snapshot()
    assert snap["subsystem_bytes_hwm"]["hwm_sub"] == 1024 * 8
    assert snap["kernels"]["hwm_probe"]["bytes_out_hwm"] == 1024 * 8
    assert stats.registry.device_buffer_hwm.value(
        subsystem="hwm_sub") == 1024 * 8


def test_capture_writes_a_trace_and_measures_completion(tmp_path):
    @kernel_span("t", name="cap_probe")
    def k(x):
        return x.sum()

    out = str(tmp_path / "cap")
    with prof.profile(out):
        assert prof.active_dir() == out
        with pytest.raises(RuntimeError, match="already capturing"):
            prof.start(str(tmp_path / "other"))
        k(torch.arange(128.0))
    assert prof.active_dir() is None
    with pytest.raises(RuntimeError, match="no profiler capture"):
        prof.stop()
    (name,) = os.listdir(out)
    with open(os.path.join(out, name)) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "kernel:cap_probe" in names
    assert profiler.snapshot()["kernels"]["cap_probe"]["completions"] == 1


def test_snapshot_keys_equal_the_jax_profilers():
    """The same calls through both packages' profilers: the snapshot
    and every kernel entry carry the same keys, and the counters the
    same values, both in detail mode (the port's census counts timed
    calls alone)."""
    profiler.configure(detail=True)
    jprof.profiler.configure(detail=True)

    @kernel_span("t", name="parity_probe")
    def k(x, n: int):
        return x * n

    @jprof.kernel_span("t", name="parity_probe")
    def jk(x, n: int):
        return x * n

    for shape, n in ((4, 2), (4, 2), (8, 2), (8, 3)):
        k(torch.arange(shape), n)
        np.asarray(jk(jnp.arange(shape), n))
    snap, jsnap = profiler.snapshot(), jprof.profiler.snapshot()
    assert set(snap) == set(jsnap)
    got, want = snap["kernels"]["parity_probe"], jsnap["kernels"][
        "parity_probe"]
    assert set(got) == set(want)
    for key in ("subsystem", "calls", "compile_misses", "completions",
                "bytes_out_hwm"):
        assert got[key] == want[key], key
    assert snap["subsystem_bytes_hwm"] == jsnap["subsystem_bytes_hwm"]
    for name in ("kernel_calls", "kernel_compile_misses",
                 "kernel_dispatch_latency", "kernel_complete_latency",
                 "device_buffer_hwm"):
        assert type(getattr(stats.registry, name)).__name__ == type(
            getattr(jstats.registry, name)).__name__


def test_configure_kernel_profile_switches_the_profiler(tmp_path):
    obs.configure(kernel_profile=False)
    assert profiler.enabled is False
    obs.configure(kernel_profile=True)
    assert profiler.enabled is True
    obs.configure(kernel_profile=None)
    assert profiler.enabled is True
    # a node built with the knob off turns it off, as in the JAX package
    db = AntidoteGPU("dcoff", Config(kernel_profile=False),
                     data_dir=str(tmp_path / "data"), device="cpu")
    db.close()
    assert profiler.enabled is False


def test_device_workload_profiles_kernels_end_to_end(tmp_path):
    """After a device-plane workload the snapshot shows each kernel's
    timing and signature counts, and a sampled txn's span tree holds a
    kernel child span (test_obs_prof's end-to-end case, on the port's
    ``AntidoteGPU(device="cpu")``)."""
    tracer.sample_rate = 1.0
    cfg = Config(trace_sample_rate=1.0, device_async_flush=False)
    db = AntidoteGPU(dc_id="dcp", config=cfg,
                     data_dir=str(tmp_path / "data"), device="cpu")
    try:
        for _ in range(6):
            tx = db.start_transaction()
            db.update_objects(
                [(("prof_k", "counter_pn"), "increment", 1)], tx)
            db.commit_transaction(tx)
        tx_r = db.start_transaction()
        tx_w = db.start_transaction()
        db.update_objects(
            [(("prof_k", "counter_pn"), "increment", 1)], tx_w)
        db.commit_transaction(tx_w)
        (val,) = db.read_objects([("prof_k", "counter_pn")], tx_r)
        db.commit_transaction(tx_r)
        assert val == 6
        kspans = tracer.spans(cat="kernel")
        assert kspans, "device workload recorded no kernel spans"
        assert any(s.txid == tx_r.txid for s in kspans)
        snap = profiler.snapshot()
        fold = snap["kernels"].get("counter_read_keys")
        assert fold is not None, snap["kernels"].keys()
        assert fold["calls"] >= 1 and fold["compile_misses"] >= 1
        assert fold["dispatch_total_s"] > 0
        assert fold["completions"] >= 1
        assert fold["subsystem"] == "mat.store"
    finally:
        db.close()


def test_start_stop_profiling_through_the_api(tmp_path):
    db = AntidoteGPU(dc_id="dcq", config=Config(device_async_flush=False),
                     data_dir=str(tmp_path / "data"), device="cpu")
    try:
        db.start_profiling(str(tmp_path / "trace"))
        tx = db.start_transaction()
        db.update_objects([(("q", "counter_pn"), "increment", 2)], tx)
        db.commit_transaction(tx)
        assert db.stop_profiling() == str(tmp_path / "trace")
    finally:
        db.close()
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".json")


def test_debug_endpoints_serve_prof_pipeline_and_health():
    profiler.configure(detail=True)     # the census counts timed calls

    @kernel_span("t", name="http_probe")
    def k(x):
        return x + 1

    k(torch.arange(4))
    srv = stats.MetricsServer(port=0, reg=stats.Registry()).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        doc = json.load(urllib.request.urlopen(
            base + "/debug/prof", timeout=5))
        assert doc["enabled"] is True
        k0 = doc["kernels"]["http_probe"]
        assert k0["calls"] >= 1 and k0["compile_misses"] >= 1
        pipe = json.load(urllib.request.urlopen(
            base + "/debug/pipeline", timeout=5))
        assert isinstance(pipe, dict)
        health = json.load(urllib.request.urlopen(
            base + "/debug/health", timeout=5))
        assert isinstance(health, dict)
        body = urllib.request.urlopen(
            base + "/metrics", timeout=5).read().decode()
        for name in ("antidote_kernel_dispatch_latency_seconds",
                     "antidote_kernel_complete_latency_seconds",
                     "antidote_kernel_calls_total",
                     "antidote_kernel_compile_cache_misses_total"):
            assert name in body, name
    finally:
        srv.stop()


def test_disabled_call_costs_one_check():
    """Bounded overhead of the disabled path (3x + slack, as the JAX
    test bounds it): no flattening, no signature, no lock."""

    def raw(x):
        return x

    wrapped = profiler.wrap(raw, name="cheap_probe", subsystem="t")
    profiler.configure(enabled=False)
    x = torch.arange(4)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        wrapped(x)
    dt_wrapped = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        raw(x)
    dt_raw = time.perf_counter() - t0
    assert dt_wrapped < dt_raw * 3 + 0.05, (dt_wrapped, dt_raw)
