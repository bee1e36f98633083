"""The traced run's Chrome trace reduced by the program's own spans.

The port marks its layers with ``torch.profiler`` ranges
(``dmvsnet_tpu_torch/utils/trace.py``: ``mvsnet.*`` in the model's forward,
``train.*`` in the train step), which are recorded only while a profiler
runs: in a ``--trace 1`` run, during the traced sub-window
(``trace.profiled``).  They land in the Chrome trace as ``user_annotation``
events, on the clock of the device's operations.  This module reduces the
trace that ``harness.run`` writes, ``.cache/trace/<cell>.json``, with every
time clipped to the ``mvsbench.subwindow`` annotation:

* program spans: ``user_annotation`` events whose name starts with
  ``mvsnet.`` or ``train.``;
* each kernel, memcpy and memset is linked by ``args.correlation`` to its
  launch (a ``cuda_runtime`` or ``cuda_driver`` event).  The launch's
  timestamp gives the operation's innermost span: the shortest program span,
  on any thread, whose host range holds that timestamp (on any thread, so
  that a CUDA backward, launched from autograd's own thread, falls inside
  ``train.backward``'s range on the main thread);
* ``self_ms[name]``: device time of the operations whose innermost span is
  named ``name``; operations that no launch links to count under
  ``(unlinked)``, operations launched outside every span under
  ``(outside)`` (the benchmark's own loop and copies);
* ``total_ms[name]``: device time of the operations launched inside any
  range of ``name``;
* ``idle_ms[name]``: the length of ``name``'s ranges (their union) in which
  no device operation ran.

The per-layer readers call ``reduction(r)``, which is None where the trace
holds no program span (a program that records none) or no device
operation (a run on the CPU).

    python3 -m mvsbench.program_spans <trace.json>

prints the reduction of a trace as one JSON object.
"""

from __future__ import annotations

import fnmatch
import json
import os
import sys
from pathlib import Path

import numpy as np

from mvsbench.trace import DEVICE_CATS, WINDOW, _union

BENCH_DIR = Path(__file__).resolve().parent
PREFIXES = ("mvsnet.", "train.")
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
UNLINKED, OUTSIDE = "(unlinked)", "(outside)"

_CACHE: dict[tuple[str, float], dict | None] = {}


def _covered(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, j = 0.0, 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < t:
            total += min(t, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def reduce(path: str | os.PathLike) -> dict | None:
    """The reduction of the Chrome trace at ``path`` (milliseconds), or
    None where it holds no program span or no device operation within the
    sub-window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    spans = []
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIXES):
            s = float(e["ts"])
            t = s + float(e["dur"])
            if t > w0 and s < w1:
                spans.append((s, t, e["name"]))
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops = []  # (start, end, launch timestamp or None), clipped to the window
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t > s:
            ops.append((s, t, launches.get(e.get("args", {}).get("correlation"))))
    if not spans or not ops:
        return None

    names = sorted({n for _, _, n in spans})
    starts = np.array([s for s, _, _ in spans])
    ends = np.array([t for _, t, _ in spans])
    col = np.array([names.index(n) for _, _, n in spans])
    linked = np.array([lt is not None for _, _, lt in ops])
    at = np.array([np.nan if lt is None else lt for _, _, lt in ops])
    dur = np.array([t - s for s, t, _ in ops])
    inside = (starts[None, :] <= at[:, None]) & (at[:, None] <= ends[None, :])
    innermost = np.where(inside, (ends - starts)[None, :], np.inf).argmin(axis=1)

    self_us = dict.fromkeys(names, 0.0)
    total_us = {}
    for i, n in enumerate(names):
        total_us[n] = float(dur[inside[:, col == i].any(axis=1)].sum())
    outside = linked & ~inside.any(axis=1)
    for k in np.nonzero(linked & ~outside)[0]:
        self_us[spans[innermost[k]][2]] += dur[k]
    self_us[UNLINKED] = float(dur[~linked].sum())
    self_us[OUTSIDE] = float(dur[outside].sum())

    busy = _union([(s, t) for s, t, _ in ops])
    idle_us = {}
    for n in names:
        ranges = _union([(max(s, w0), min(t, w1)) for s, t, m in spans if m == n])
        idle_us[n] = sum(t - s for s, t in ranges) - _covered(ranges, busy)
    out = {"window_ms": (w1 - w0) * 1e-3, "busy_ms": sum(t - s for s, t in busy) * 1e-3,
           "count": {n: int((col == i).sum()) for i, n in enumerate(names)}}
    for key, us in (("self_ms", self_us), ("total_ms", total_us), ("idle_ms", idle_us)):
        out[key] = {k: float(v) * 1e-3 for k, v in us.items()}
    return out


def trace_path(workload: dict) -> Path | None:
    """The traced run's trace of the cell whose workload file holds
    ``workload``."""
    for f in sorted((BENCH_DIR / "workloads").glob("*.json")):
        with open(f) as fh:
            if json.load(fh) == workload:
                return BENCH_DIR / ".cache" / "trace" / f"{f.stem}.json"
    return None


def reduction(r) -> dict | None:
    """``reduce`` of the trace of the run ``r`` (``harness.Reading``), cached
    by path and modification time; None where there is no such trace."""
    path = trace_path(r.workload)
    if path is None or not path.is_file():
        return None
    key = (str(path), path.stat().st_mtime)
    if key not in _CACHE:
        _CACHE[key] = reduce(path)
    return _CACHE[key]


def summed(by_name: dict, *patterns: str) -> float | None:
    """The sum of ``by_name``'s values whose name matches one of the
    ``fnmatch`` patterns; None where no name does."""
    hits = [v for k, v in by_name.items() if any(fnmatch.fnmatchcase(k, p) for p in patterns)]
    return sum(hits) if hits else None


if __name__ == "__main__":
    print(json.dumps(reduce(sys.argv[1])))
