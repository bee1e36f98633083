"""A rank other than rank 0 of a cell that runs on several cards.

    python3 -m mvsbench.rank --ctx '<json>'

Started by the cell's mode in rank 0's set-up (``modes/train_ddp.py``) with
torchrun's environment; sets itself up as the mode's ``setup_rank`` does
and then serves rank 0 until it says stop.  Prints nothing on standard
output."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")


def main(argv=None) -> int:
    from mvsbench import faults, harness

    p = argparse.ArgumentParser("mvsbench.rank")
    p.add_argument("--ctx", required=True)
    ctx = harness.Context(**json.loads(p.parse_args(argv).ctx))
    if ctx.device == "cpu":
        import torch

        # ranks that share the host's cores (the CPU rehearsal)
        torch.set_num_threads(2)
    mode = harness.mode_module(ctx.workload["mode"])
    fault = os.environ.get(faults.ENV)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        mode.serve(mode.setup_rank(ctx))
    return 0


if __name__ == "__main__":
    sys.exit(main())
