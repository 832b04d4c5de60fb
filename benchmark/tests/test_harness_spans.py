"""The readers of the port's spans and counters: `prepare_ms_per_analysis`,
`wire_pick_ms_per_analysis`, `decode_ms_per_kframe` and `transfer_gbps`,
on hand-made records, None where the program timed or counted nothing
(a program without these spans), and in a traced run at a tiny size."""

import pytest
from conftest import tiny_cell

from benchmark import cells, harness

NEW = ("prepare_ms_per_analysis", "wire_pick_ms_per_analysis",
       "decode_ms_per_kframe", "transfer_gbps")


def _run(*timers, frames=1000):
    run = harness.RunRecord(cell=cells.load_cell("aa-static"), seed=1)
    run.analyses = [harness.AnalysisRecord(frames=frames, t_start=0.0,
                                           timers=dict(t)) for t in timers]
    return run


def _read(name, run):
    return cells.metric_reader(name)(run)


def test_readers_by_hand():
    run = _run({"prepare": 0.6, "pick": 0.02, "decode": 0.15,
                "transfer": 0.5, "transfer_bytes": 3_000_000_000},
               {"prepare": 0.8, "pick": 0.04, "decode": 0.25,
                "transfer": 0.5, "transfer_bytes": 2_000_000_000})
    assert _read("prepare_ms_per_analysis", run) == pytest.approx(700.0)
    assert _read("wire_pick_ms_per_analysis", run) == pytest.approx(30.0)
    assert _read("decode_ms_per_kframe", run) == pytest.approx(200.0)
    assert _read("transfer_gbps", run) == pytest.approx(5.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name):
    """No analysis, or a program whose timers hold none of these (the
    parent's held `decode`, `transfer` and no counter)."""
    assert _read(name, _run()) is None
    older = _run({"wait": 0.1, "dispatch": 0.01, "convert": 0.002,
                  "transfer": 0.4})
    assert _read(name, older) is None


def test_traced_run_reads_the_spans(cache):
    """A traced run on the CPU: the four are read, the set-up and the pick
    lie inside the span from `run` to the first batch, and the existing
    metrics are still read."""
    cell = tiny_cell("aa-static")
    run = harness.execute(cell, 2_300_000_017, 0.0, True, device="cpu",
                          cache_dir=cache, log=lambda msg: None)
    metrics = harness.result(run, True)["metrics"]
    assert set(NEW) <= set(metrics)
    assert {"first_batch_ms", "decode_wait_ms_per_kframe",
            "dispatch_ms_per_batch", "write_ms_per_analysis"} <= set(metrics)
    value = {k: m["value"] for k, m in metrics.items()}
    assert (value["prepare_ms_per_analysis"]
            + value["wire_pick_ms_per_analysis"]) < value["first_batch_ms"]
    assert value["transfer_gbps"] > 0 and value["decode_ms_per_kframe"] > 0
