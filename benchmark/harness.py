"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics, and the result line (see `benchmark/__init__`).

Set-up (`setup_s`) is everything from the process's start to the
window's: CUDA, the seed's inputs (made, or found in the cache), loading
the port and its built kernels, and one whole warm analysis of the
cell's traffic. The window then runs whole analyses back to back, a
closed loop of one user, each from `Analysis.from_file` through
`gorder_tpu_torch.run(analysis, device=..., on_batch=...)` to
`results.write()`; it closes at the end of the analysis that is running
when `--seconds` have passed. With `--trace 1` the window runs under
`torch.profiler` and the line carries the per-layer metrics instead of
the end-to-end ones. After the window: the memory peak, then the
program's state freed, then the reference over the same integers, and
every analysis's results and YAML judged against it.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from . import cells, checks, peaks, synth
from .tracing import Tracer

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "gorder_tpu")
#: the port's knobs are the program's defaults in every run
_PORT_ENV = "GORDER_TPU_"


def _process_age():
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


_IMPORTED = time.perf_counter()
PROCESS_START = _IMPORTED - (_process_age() or 0.0)


@dataclass
class AnalysisRecord:
    """One analysis: host clock times (perf_counter s) of its start, its
    `run` call, its first `on_batch` call, the return of `run` and the
    end of `write()`; the port's phase timers after `run`; its batches and
    the wire of each."""

    frames: int
    t_start: float
    t_run: float = 0.0
    t_first_batch: float = None
    t_run_end: float = 0.0
    t_write_end: float = 0.0
    timers: dict = field(default_factory=dict)
    batches: int = 0
    wires: collections.Counter = field(default_factory=collections.Counter)
    yaml_path: str = ""
    error: str = None

    @property
    def wall_s(self) -> float:
        return self.t_write_end - self.t_start


@dataclass
class RunRecord:
    cell: cells.Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    analyses: list = field(default_factory=list)
    trace: object = None
    work: dict = field(default_factory=dict)
    peaks: dict = None
    device: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    expected: dict = None
    system: object = None

    def roofline_pct(self, kernel: str):
        """The kernel's share of its roofline in the traced window, or
        None where there is nothing to read."""
        state = self.work.get(kernel)
        if self.trace is None or self.peaks is None or state is None:
            return None
        rl = cells.roofline(kernel)
        seconds = self.trace.kernel_seconds(*rl.KERNELS)
        if seconds <= 0:
            return None
        least = len(self.analyses) * rl.bound_s(state, self.peaks)
        return 100.0 * least / seconds


def _yaml_value(v) -> str:
    if isinstance(v, dict):
        body = "{" + ", ".join(f"{k}: {_yaml_value(x)}"
                               for k, x in v.items() if k != "!") + "}"
        return f"!{v['!']} {body}" if "!" in v else body
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_value(x) for x in v) + "]"
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        return json.dumps(v)
    return repr(v)


def gorder_yaml(cell: cells.Cell, files: dict) -> str:
    """The cell's analysis as a gorder configuration file (what a user
    passes to `gorder config.yaml`): the traffic's `gorder` keys, the
    inputs, the decoder threads, the frames as an end time."""
    cfg, traffic = cell.config, cell.traffic
    frames = traffic["frames"]
    if frames > cfg["n_frames"]:
        raise ValueError(f"{cell.name}: {frames} frames asked, the "
                         f"trajectory holds {cfg['n_frames']}")
    keys = {"structure": str(files["structure"]),
            "bonds": str(files["bonds"]),
            "trajectory": str(files["trajectory"]),
            "n_threads": traffic["n_threads"], "silent": True,
            "overwrite": True, **traffic["gorder"]}
    if frames < cfg["n_frames"]:
        keys["end"] = (frames - 1) * cfg["dt_ps"]
    return "".join(f"{k}: {_yaml_value(v)}\n" for k, v in keys.items())


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def _host_lines(device, log) -> None:
    model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            model = next((line.split(":", 1)[1].strip() for line in fh
                          if line.startswith("model name")), "")
    except OSError:
        pass
    log(f"host: {os.cpu_count()} cores ({synth.encoder_threads()} usable), "
        f"{model}")
    if device.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out = "nvidia-smi not readable"
        log(f"card: {out}")


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device="cuda", cache_dir=None, log=print):
    """Run the cell once → RunRecord (numbers judged, metrics not yet
    read). `device` "cpu" runs the port's plain versions (the tests)."""
    for key in [k for k in os.environ if k.startswith(_PORT_ENV)]:
        del os.environ[key]
    os.environ["GORDER_TPU_MESH"] = "0"
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    run = RunRecord(cell=cell, seed=seed)
    last = [PROCESS_START]

    def stage(label):
        now = time.perf_counter()
        log(f"set-up: {label} {now - last[0]:.3f} s (at "
            f"{now - PROCESS_START:.3f} s)")
        last[0] = now

    stage("process start to the harness")
    _host_lines(device, log)
    stage("host and card lines")
    system, files, made = synth.prepare_inputs(
        cell.config, cell.config_bytes, seed, device, cache_dir, log=log)
    stage("inputs " + ("made" if made else "found in the cache"))
    import gorder_tpu_torch as gorder
    from gorder_tpu_torch.utils.timers import timers as port_timers

    frames = cell.traffic["frames"]
    tracer = Tracer(trace, cuda)
    with tempfile.TemporaryDirectory(prefix="gorder-benchmark-") as work:
        config_path = Path(work) / "analysis.yaml"
        config_path.write_text(gorder_yaml(cell, files))

        def analysis(index: int):
            """One whole analysis → (its record, its results)."""
            rec = AnalysisRecord(frames=frames, t_start=time.perf_counter())

            def on_batch(batch):
                rec.batches += 1
                rec.wires[batch.kind] += 1
                if rec.t_first_batch is None:
                    rec.t_first_batch = time.perf_counter()
                    with tracer.span("bench.first_batch"):
                        pass

            with tracer.span("bench.analysis"):
                request = gorder.Analysis.from_file(str(config_path))
                rec.yaml_path = str(Path(work) / f"order-{index}.yaml")
                request.output_yaml = rec.yaml_path
                rec.t_run = time.perf_counter()
                with tracer.span("bench.run"):
                    results = gorder.run(request, device=str(device),
                                         on_batch=on_batch)
                rec.t_run_end = time.perf_counter()
                rec.timers = port_timers.snapshot()
                with tracer.span("bench.write"):
                    results.write()
                rec.t_write_end = time.perf_counter()
            return rec, results

        stage("the port imported")
        warm, _ = analysis(0)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        stage(f"warm analysis (wire {dict(warm.wires)})")
        run.setup_s = time.perf_counter() - PROCESS_START
        tracer.start()
        outputs = []
        w0 = time.perf_counter()
        while True:
            try:
                rec, results = analysis(len(outputs) + 1)
            except Exception as exc:                     # noqa: BLE001
                traceback.print_exc()
                rec = AnalysisRecord(frames=frames, t_start=time.perf_counter(),
                                     error=f"{type(exc).__name__}: {exc}")
                rec.t_write_end = rec.t_start
                outputs.append((rec, None))
                log(f"analysis {len(outputs)} failed: {rec.error}")
                break
            outputs.append((rec, (checks.flatten_results(results),
                                  results.n_analyzed_frames)))
            del results
            if rec.t_write_end - w0 >= seconds:
                break
        run.window_s = outputs[-1][0].t_write_end - w0
        run.device = _card(device)
        run.device["memory_peak_bytes"] = (
            int(torch.cuda.max_memory_allocated(device)) if cuda else 0)
        run.trace = tracer.stop()
        run.analyses = [rec for rec, _ in outputs if rec.error is None]
        run.peaks = peaks.peaks_of(run.device["kind"])
        for i, (rec, _) in enumerate(outputs):
            if rec.error is None:
                log(f"analysis {i + 1}: {rec.frames} frames, wall "
                    f"{rec.wall_s:.4f} s (run {rec.t_run_end - rec.t_run:.4f}"
                    f", first batch {(rec.t_first_batch or rec.t_run) - rec.t_run:.4f}"
                    f", write {rec.t_write_end - rec.t_run_end:.4f}), "
                    f"{rec.batches} batches, wire {dict(rec.wires)}")
        judged = [(values[0], Path(rec.yaml_path).read_text(), values[1])
                  for rec, values in outputs if rec.error is None]
        if run.trace is not None:
            totals = collections.Counter()
            for label, seconds in run.trace.gaps:
                totals[label] += seconds
            for label, idle_s in totals.most_common():
                log(f"idle: {idle_s:.4f} s {label}")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        expected = reference_values(run, system, seed, frames, device,
                                    trace)
        log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    numbers, failed = checks.judge(expected, frames, judged,
                                   cell.traffic["limits"])
    run.expected = expected
    run.system = system
    run.numbers = numbers
    run.failed = failed + sum(rec.error is not None for rec, _ in outputs)
    run.attempted = len(outputs)
    return run


def reference_values(run, system, seed, frames, device, trace,
                     dtype=None):
    """The reference's expected values over the analysis's frames; with
    `trace`, also each roofline's work (run.work)."""
    import torch

    from .reference.order import OrderReference

    ref = OrderReference(system.names, system.resnames, system.molecule,
                         system.bonds, system.box,
                         system.config["precision"],
                         run.cell.traffic["gorder"], device,
                         dtype or torch.float64)
    observers = {}
    if trace:
        for path in sorted((cells.HERE / "rooflines").glob("*.py")):
            rl = cells.roofline(path.stem)
            state = rl.start(ref, system.config)
            if state is not None:
                observers[path.stem] = (rl, state)
    for _, ints in synth.trajectory_chunks(system, seed, n_frames=frames):
        ref.add(ints)
        for rl, state in observers.values():
            rl.add(state, ints)
    for name, (rl, state) in observers.items():
        rl.finish(state, ref)
        run.work[name] = state
    return ref.values()


def read_metrics(run: RunRecord, trace: bool) -> dict:
    entries = run.cell.per_layer if trace else run.cell.end_to_end
    out = {}
    for entry in entries:
        value = cells.metric_reader(entry["name"])(run)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def result(run: RunRecord, trace: bool) -> dict:
    limits = run.cell.traffic["limits"]
    correct = run.failed == 0 and run.attempted > 0 and all(
        run.numbers[k] <= limits[k] for k in checks.NAMES)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": read_metrics(run, trace),
            "device": dict(run.device)}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {k: {"value": _finite(run.numbers[k]),
                          "limit": limits[k]} for k in checks.NAMES}
    return line


def _finite(x):
    return x if math.isfinite(x) else "inf"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = cells.load_cell(args.workload)
    import torch

    import gorder_tpu_torch  # noqa: F401  the system under test, or no run

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    run = execute(cell, args.seed, args.seconds, bool(args.trace),
                  device="cuda", log=_log)
    bad = forbidden_modules()
    if bad:
        print(f"the run's process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result(run, bool(args.trace))
    _log(f"window: {run.attempted} analyses in {run.window_s:.4f} s, set-up "
        f"{run.setup_s:.4f} s, memory peak "
        f"{line['device']['memory_peak_bytes']} bytes")
    for name, item in line["checks"].items():
        print(f"check {name} = {item['value']} (limit {item['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
