"""The comparison that decides ``correct`` fails what it must: the
control (the reference in the program's place with one guarantee
broken) and each fault planted in the port's timed path, on tiny cells
on the CPU (the harness's look for the card skipped)."""

import pytest
import torch

from portbench.lib import harness, superstep

CURE = ("cure-16p-update-uniform", "cure-16p-read-zipf")
SUPERSTEP = "orset-1m-superstep"


def run(bench, cell):
    import tempfile

    cell.scratch = tempfile.mkdtemp()
    return harness.run_cell(bench, cell)


@pytest.fixture
def dense_samples(monkeypatch):
    # a tiny window runs too few steps for the cell's own stride
    monkeypatch.setattr(superstep, "SAMPLE_STRIDE", 7)


@pytest.mark.parametrize("name", CURE + (SUPERSTEP,))
def test_the_control_is_not_correct(bench, tiny, dense_samples, name):
    res = run(bench, tiny(name, control="stale_read"))
    assert res["correct"] is False, res["checks"]


def superstep_fault(monkeypatch, fault):
    from antidote_tpu_torch.mat import store

    append, read = store.orset_append, store.orset_read_full
    if fault == "state_unchanged":
        monkeypatch.setattr(store, "orset_append", lambda st, key, *a, **k: (
            st, torch.zeros(key.shape[0], dtype=torch.bool)))
    elif fault == "half_batch":
        def half(st, key, *a, **k):
            active = torch.arange(key.shape[0]) < key.shape[0] // 2
            return append(st, key, *a, active=active)
        monkeypatch.setattr(store, "orset_append", half)
    elif fault == "answer_altered":
        def flipped(*a, **k):
            out = read(*a, **k).clone()
            out[0, 0] = ~out[0, 0]
            return out
        monkeypatch.setattr(store, "orset_read_full", flipped)


def cure_fault(monkeypatch, fault):
    from antidote_tpu_torch.api import AntidoteGPU
    from antidote_tpu_torch.clocks import VC

    update, read = (AntidoteGPU.update_objects_static,
                    AntidoteGPU.read_objects_static)

    def mix(updates):
        # the mix's updates increment by 1; the fill's by 0
        return any(op == "increment" and p == 1 for _o, op, p in updates)

    if fault == "state_unchanged":
        def acked(self, clock, updates, props=None):
            if mix(updates):
                return VC({"dc1": 1})
            return update(self, clock, updates, props)
        monkeypatch.setattr(AntidoteGPU, "update_objects_static", acked)
    elif fault == "half_batch":
        def half(self, clock, updates, props=None):
            if mix(updates):
                updates = updates[:len(updates) // 2]
            return update(self, clock, updates, props)
        monkeypatch.setattr(AntidoteGPU, "update_objects_static", half)
    elif fault == "answer_altered":
        def altered(self, clock, objects, props=None):
            vals, vc = read(self, clock, objects, props)
            return [v + 1 if o[1] == "counter_pn" else v
                    for o, v in zip(objects, vals)], vc
        monkeypatch.setattr(AntidoteGPU, "read_objects_static", altered)


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", (CURE[0], SUPERSTEP))
def test_a_planted_fault_is_not_correct(bench, tiny, dense_samples,
                                        monkeypatch, name, fault):
    cell = tiny(name)
    plant = cure_fault if cell.config["system"] == "cure" \
        else superstep_fault
    plant(monkeypatch, fault)
    res = run(bench, cell)
    assert res["correct"] is False, res["checks"]
