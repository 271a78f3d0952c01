"""The rest of the reference's multi-DC suite against the port, on the CPU:
every case of tests/multidc/test_causal_checker.py,
test_ckpt_bootstrap.py, test_elasticity.py, test_failure.py,
test_fleet_slo.py, test_obs_federation.py, test_stream_bootstrap.py,
test_txn_journey.py and test_ring_placement.py runs here on the port:
the reference file's own code, executed with its imports naming
``antidote_tpu_torch`` (tests/torch_refexec.py), its fixtures from the
file and from tests/multidc/conftest.py, every ``AntidoteGPU`` and
``DataCenter`` it builds without a device on the CPU. The reference
file's own test runs the JAX half of every case in the same suite, so
each case runs here on the port alone: it must pass, and wherever it
committed writes in this process, each DC of the port must read the same
final value of every key it wrote, read at the join of its commit VCs on
a live endpoint of each DC when the first endpoint closes
(tests/torch_refexec.py's ``Recorder``; the DCs' own causal probes are
not the case's writers). test_failure's
``test_chaos_all_types_converge`` runs at every seed, those the
reference is known to fail included (ROADMAP §3). No case is retried.

tests/multidc/test_ring_placement.py runs with the port's mesh devices
set to eight ``cpu`` entries (``runtime.set_mesh_devices``), as the
reference runs it on tests/conftest.py's forced 8-device CPU mesh: its
DCs ring-place their partitions and fold their stable time on that
mesh.  test_causal_flake_loop.py is opt-in.  The tracer samples nothing
unless a case sets its own rate, as the port's other parity files run
it."""

import os

import pytest

from antidote_tpu_torch import runtime
from antidote_tpu_torch.obs.spans import tracer as ttracer

import torch_refexec as rx

NAMES = ("test_causal_checker", "test_ckpt_bootstrap", "test_elasticity",
         "test_failure", "test_fleet_slo", "test_obs_federation",
         "test_stream_bootstrap", "test_txn_journey", "test_ring_placement")
#: the files whose cases run over a mesh of eight ``cpu`` entries
MESHED = ("tests/multidc/test_ring_placement.py",)
FILES = [f"tests/multidc/{n}.py" for n in NAMES]
CASES = [(rel, qual, params) for rel in FILES
         for qual, params in rx.cases(rel)]
LOADER = rx.Loader(port=True)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The reference code passes no device: everything it builds sits
    on the CPU; its tracer samples nothing."""
    rx.port_on_the_cpu(monkeypatch)
    monkeypatch.setattr(ttracer, "sample_rate", 0.0)


@pytest.mark.parametrize("rel,qual,params", CASES,
                         ids=[rx.case_id(*c) for c in CASES])
def test_reference_case_on_the_port(rel, qual, params, tmp_path,
                                    monkeypatch, request):
    prev = runtime.set_mesh_devices(
        ["cpu"] * 8 if rel in MESHED else None)
    try:
        _jax, port_rec = rx.run_on_both(
            (None, LOADER), rel, qual, params, tmp_path, monkeypatch,
            jax=False, request=request)
    finally:
        runtime.set_mesh_devices(prev)
    rx.assert_finals(None, port_rec, False)


def test_reference_cases_are_all_here():
    """The nine files hold 62 cases (55 test functions, parametrized
    and over a parametrized fixture); every one is above."""
    assert all(os.path.exists(os.path.join(rx.REPO, f)) for f in FILES)
    assert [sum(r == f for r, _, _ in CASES) for f in FILES] \
        == [3, 8, 15, 6, 7, 4, 3, 14, 2]
