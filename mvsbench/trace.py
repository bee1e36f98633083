"""The traced run's device trace: ``torch.profiler`` over a short steady
sub-window, written as a Chrome trace and reduced to what the per-layer
readers and the result line take from it.

* ``window_s``: the sub-window's length, from the host annotation that
  encloses it (the device is synchronised at both of its ends);
* ``busy_s``: the union of kernel, memcpy and memset intervals within it;
* ``device_ops``: device time by kernel or copy name;
* ``collective_s`` / ``collective_exposed_s``: the union of NCCL kernels,
  and the part of it that no other kernel overlaps;
* ``idle_gaps``: the intervals in which no device operation ran, summed by
  what the host was running at each gap's middle (the innermost operator,
  annotation or CUDA runtime call); gaps under ``SHORT_GAP_US`` are summed
  under one label, since they are launch latency.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import defaultdict

import numpy as np
import torch

WINDOW = "mvsbench.subwindow"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
SHORT_GAP_US = 20.0


@contextlib.contextmanager
def profiled(path: str, cuda: bool):
    """``torch.profiler`` over the block, inside the annotation ``WINDOW``;
    the Chrome trace is written to ``path`` at exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarise(path: str) -> dict:
    """Reduces the Chrome trace at ``path`` (times in microseconds)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace {path} has no {WINDOW} annotation")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, by_name, nccl, compute = [], defaultdict(float), [], []
    kernels = defaultdict(list)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        device.append((s, t))
        by_name[e["name"]] += (t - s) * 1e-6
        if e.get("cat") == "kernel":
            kernels[e["name"]].append((t - s) * 1e-6)
            (nccl if "nccl" in e["name"].lower() else compute).append((s, t))
    busy = _union(device)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))

    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    durs = ends - starts
    idle = defaultdict(float)
    for s, t in gaps:
        if t - s < SHORT_GAP_US:
            idle[f"(gaps under {SHORT_GAP_US:g} us)"] += (t - s) * 1e-6
            continue
        mid = 0.5 * (s + t)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0] if len(host) else []
        label = host[inside[np.argmin(durs[inside])]]["name"] if len(inside) else "(host idle)"
        idle[label] += (t - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    coll = _union(nccl)
    covered = _union(compute)
    hidden, j = 0.0, 0
    for s, t in coll:
        while j < len(covered) and covered[j][1] <= s:
            j += 1
        k = j
        while k < len(covered) and covered[k][0] < t:
            hidden += min(t, covered[k][1]) - max(s, covered[k][0])
            k += 1
    coll_s = sum(t - s for s, t in coll)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "collective_s": coll_s * 1e-6, "collective_exposed_s": (coll_s - hidden) * 1e-6,
            "device_ops": top(by_name), "idle_gaps": top(idle), "kernels": dict(kernels)}
