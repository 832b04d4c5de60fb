"""A run with the timed path broken underneath comes out not correct.
The harness's look for a card is skipped (the CPU runs the port's plain
versions); everything else of a run is driven. One fault of each kind the
cells can have: a step that leaves its state unchanged; half of each
batch left out, the mean taken over the rest; an answer altered where it
is produced, in the step's sums and in the YAML the writer prints. The
cells run on one card, so there is no exchange between cards to leave
out."""

import numpy as np
import pytest
from conftest import tiny_cell

from benchmark import harness


def _unchanged(monkeypatch):
    from gorder_tpu_torch.core.order import OrderAccumulator

    monkeypatch.setattr(OrderAccumulator, "add_step",
                        lambda self, out, n_valid: None)


def _half_batch(monkeypatch):
    from gorder_tpu_torch.core.order import OrderAccumulator

    add = OrderAccumulator.add_step

    def half(self, out, n_valid):
        keep = max(1, n_valid // 2)
        add(self, np.asarray(out)[:keep], keep)

    monkeypatch.setattr(OrderAccumulator, "add_step", half)


def _altered_sum(monkeypatch):
    from gorder_tpu_torch.core.order import OrderAccumulator

    add = OrderAccumulator.add_step

    def altered(self, out, n_valid):
        out = np.array(out)
        out[..., 0, 3] += 10000 * out[..., 1, 3]   # a bond type's S + 0.01
        add(self, out, n_valid)

    monkeypatch.setattr(OrderAccumulator, "add_step", altered)


def _altered_yaml(monkeypatch):
    from gorder_tpu_torch.present import yaml_out

    fmt, render = yaml_out.fmt4, yaml_out.render_yaml
    calls = []

    def altered(value):
        calls.append(value)
        return fmt(value + (1e-3 if len(calls) == 5 else 0.0))

    def rendered(results):
        calls.clear()         # the fifth value of every file
        return render(results)

    monkeypatch.setattr(yaml_out, "fmt4", altered)
    monkeypatch.setattr(yaml_out, "render_yaml", rendered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered_sum": _altered_sum, "altered_yaml": _altered_yaml}


@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault, cache, monkeypatch):
    FAULTS[fault](monkeypatch)
    run = harness.execute(tiny_cell(name), 17, 0.0, False, device="cpu",
                          cache_dir=cache, log=lambda msg: None)
    assert harness.result(run, False)["correct"] is False


@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
def test_sound_run_is_correct(name, cache):
    run = harness.execute(tiny_cell(name), 17, 0.0, False, device="cpu",
                          cache_dir=cache, log=lambda msg: None)
    assert harness.result(run, False)["correct"] is True
