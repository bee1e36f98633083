"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the reference, and the result line.

Everything that belongs to one configuration, cell, mode or per-layer
metric is a file of its own that this module finds by name:
``configs/<config>.json``, ``workloads/<cell>.json``, ``modes/<mode>.py``
and ``metrics/<metric>.py`` under the benchmark's folder, and the metric
and cell entries of ``BENCHMARK.json`` at the checkout's root.

A mode module provides ``setup(ctx) -> state`` (program, weights, inputs,
warm-up), ``iterate(state)`` (one dispatch or step of the window),
``drain(state)`` (waits for what the window issued), ``end_to_end(state,
window_s) -> {metric: value}``, ``units(state)`` (maps or samples completed
in the window), ``info(state)`` (launches, build seconds, set-up phases for
the ``info`` line), ``spans(state, spans, stack)`` (installs the traced run's
spans), ``count(state) -> operations per unit`` (the frozen count) and
``check(state) -> ({number: value}, failed)`` (the comparison with the
reference, after the window).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from mvsbench import spans as spans_lib
from mvsbench import trace as trace_lib

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that must not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dmvsnet_tpu")


@dataclass
class Context:
    """What a mode's set-up is given: the cell's files, the seed, the
    device, and ``options`` (empty in a benchmark run; the control and the
    fault checks of ``mvsbench/calibrate.py`` and the tests set them)."""

    name: str
    workload: dict
    config: dict
    seed: int
    device: str
    options: dict = field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mode_module(mode: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "modes" / f"{mode}.py", f"mvsbench_mode_{mode}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "metrics" / f"{name}.py", f"mvsbench_metric_{name}").read


def cell_files(name: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict]:
    """(workload, configuration) of cell ``name``."""
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    return workload, config


def cell_metrics(bench: dict, name: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    cell ``name`` reports: those that list it, or list no cells and (per
    layer) move an end-to-end metric that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def process_age_s() -> float:
    """Seconds since this process was started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Reading:
    """What a per-layer reader is given (``metrics/<name>.py: read``)."""

    mode: str
    workload: dict
    config: dict
    units: int              # maps (infer) or samples (train) in the window
    window_s: float         # the measured window of the traced run
    span_ms: dict           # summed span milliseconds over that window
    trace: dict | None      # trace.summarise of the sub-window
    sub_iterations: int     # dispatches or steps inside the sub-window
    ops_per_unit: float | None
    peaks: dict | None      # this card's row of counts/peaks.json


def peaks_for(device_name: str, bench_dir: Path = BENCH_DIR) -> dict | None:
    return load_json(bench_dir / "counts" / "peaks.json").get(device_name)


def run(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        bench_dir: Path = BENCH_DIR, root: Path = ROOT, options: dict | None = None,
        origin: tuple[float, float] | None = None, log=print) -> dict:
    """Runs cell ``name`` once and returns the result line's object.

    ``origin`` is (a ``time.perf_counter()`` reading, the process's age in
    seconds at that reading), so that ``setup_s`` counts from the process's
    start; without it, from this call."""
    origin = origin or (time.perf_counter(), 0.0)
    bench = load_json(root / "BENCHMARK.json")
    workload, config = cell_files(name, bench_dir)
    e2e_entries, layer_entries = cell_metrics(bench, name)
    mode = mode_module(workload["mode"], bench_dir)
    ctx = Context(name, workload, config, seed, device, dict(options or {}))
    cuda = ctx.cuda

    state = mode.setup(ctx)
    spans = spans_lib.Spans(cuda)
    with contextlib.ExitStack() as stack:
        if traced:
            mode.spans(state, spans, stack)
        t0 = time.perf_counter()
        setup_s = t0 - origin[0] + origin[1]
        while time.perf_counter() - t0 < seconds:
            mode.iterate(state)
        mode.drain(state)
        window_s = time.perf_counter() - t0
        span_ms = spans.totals_ms() if traced else {}
    units = mode.units(state)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    summary, sub = None, 0
    if traced:
        sub = int(workload["trace_iterations"])
        path = str(bench_dir / ".cache" / "trace" / f"{name}.json")
        with trace_lib.profiled(path, cuda):
            for _ in range(sub):
                mode.iterate(state)
            mode.drain(state)
        summary = trace_lib.summarise(path)

    dev_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    info = {"cell": name, "seed": seed, "card": card() if cuda else None,
            "window_s": window_s, "units": units, "memory_peak_bytes": peak, **mode.info(state)}
    log("info " + json.dumps(info), flush=True)

    metrics = {}
    if traced:
        reading = Reading(workload["mode"], workload, config, units, window_s, span_ms, summary,
                          sub, mode.count(state), peaks_for(dev_name, bench_dir))
        for m in layer_entries:
            value = metric_reader(m["name"], bench_dir)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = mode.end_to_end(state, window_s)
        values["setup_s"] = setup_s
        for m in e2e_entries:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    numbers, failed = mode.check(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = workload["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                   for c in checks.values())
    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": dev_name,
                         "count": int(workload["chips"]), "memory_peak_bytes": peak}}
    if traced:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
