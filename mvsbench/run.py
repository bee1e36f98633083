"""The benchmark of dmvsnet_tpu_torch: one run of one cell.

    python3 -m mvsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Needs a CUDA card (as many as the cell
asks for); prints the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``) as the last line of standard output, one
JSON object, and each number that decided ``correct`` beside its limit as
the last lines of standard error.  Exits non-zero, printing no result, when
the card is missing, when the check cannot run, or when a module of JAX or
of the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")


def main(argv=None) -> int:
    from mvsbench import harness

    age = harness.process_age_s() - (time.perf_counter() - _T0)
    p = argparse.ArgumentParser("mvsbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    workload, _ = harness.cell_files(args.workload)
    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mvsbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", origin=(_T0, age))
    found = harness.forbidden_modules()
    if found:
        print(f"mvsbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
