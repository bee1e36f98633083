"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the kernels are built once):

    python3 -m mvsbench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n ...> [--control-seeds <n ...>] \\
        [--fault <kind> --fault-seeds <n ...> ...] [--out <file.jsonl>]

* the program as the benchmark runs it, on ``--seeds``: the lower readings;
* the control, on ``--control-seeds``: the program with its own bf16
  compute policy (``compute_dtype=bfloat16``), the nearest precision below
  the configuration's fp32, in the same timed path and comparison;
* each planted fault (``mvsbench/faults.py``) on ``--fault-seeds``.

Each run is a short window at the cell's own sizes and load.  Prints one
JSON line per run and, last, per compared number: the largest program
reading, the smallest control reading and the smallest reading of each
fault.  Needs a CUDA card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from mvsbench import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser("mvsbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", action="append", default=[], choices=faults.KINDS)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2

    runs = [("program", s, {}, None) for s in args.seeds]
    runs += [("control", s, {"compute_dtype": "bfloat16"}, None) for s in args.control_seeds]
    runs += [(f, s, {}, f) for f in args.fault for s in args.fault_seeds]
    rows = []
    for kind, seed, options, fault in runs:
        if fault:
            with faults.planted(fault):
                r = harness.run(args.workload, seed, args.seconds, False, args.device,
                                options=options, log=lambda *a, **k: None)
        else:
            r = harness.run(args.workload, seed, args.seconds, False, args.device,
                            options=options, log=lambda *a, **k: None)
        row = {"kind": kind, "seed": seed, "correct": r["correct"],
               "checks": {k: c["value"] for k, c in r["checks"].items()},
               "metrics": {k: m["value"] for k, m in r["metrics"].items()},
               "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    summary = {}
    for name in rows[0]["checks"]:
        by = {}
        for row in rows:
            v = row["checks"][name]
            k = row["kind"]
            by[k] = max(by.get(k, v), v) if k == "program" else min(by.get(k, v), v)
        summary[name] = by
    print("summary " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps({"workload": args.workload, **row}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
