"""Mode ``train_ddp``: ``train``'s steps on every card the cell asks for,
one rank per card, as the ``Trainer`` trains under ``torchrun``.

The run's process is rank 0; its set-up starts ranks 1.. as processes of
their own (``python3 -m mvsbench.rank``) with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR = 127.0.0.1, MASTER_PORT a free port).
Every rank then sets itself up as the Trainer does: NCCL through
``parallel.multihost.init_multihost``, the dp mesh of every rank through
``parallel.mesh.make_mesh``, the model with its synced batch norm, DDP
through ``engine.train.data_parallel``, and its share of each global batch
(``workload["batch"]`` samples over the ranks); the loss is the global
batch's.  All ranks run the three checked steps, then rank 0 leads the
window: before each step it tells the other ranks, over a gloo group on the
host, to step, to wait for their card, or to stop.  No step waits for the
card.

The check is ``train``'s: rank 0's first gradient (after DDP's mean), its
running statistics and its weights against the reference run on the whole
global batches in one process, once the other ranks have stopped.  A traced
run profiles rank 0 alone, and the peak memory is rank 0's.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from mvsbench import program
from mvsbench.modes import train as single

STEP, WAIT, STOP = 1, 0, -1
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def setup(ctx):
    world = int(ctx.workload["chips"])
    port = _free_port()
    arg = json.dumps({"name": ctx.name, "workload": ctx.workload, "config": ctx.config,
                      "seed": ctx.seed, "device": ctx.device, "options": ctx.options})
    procs = [subprocess.Popen([sys.executable, "-m", "mvsbench.rank", "--ctx", arg],
                              env={**os.environ, **_env(r, world, port)},
                              stdout=subprocess.DEVNULL, cwd=str(program.ROOT))
             for r in range(1, world)]
    atexit.register(_end, procs)
    mine = _env(0, world, port)
    saved = {k: os.environ.get(k) for k in mine}
    os.environ.update(mine)
    state = setup_rank(ctx)
    state.procs, state.saved_env = procs, saved
    return state


def _end(procs) -> None:
    """Ends what is still running of ``procs`` and waits for it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def setup_rank(ctx):
    """One rank's training object (every rank, rank 0 too)."""
    program.package()
    from dmvsnet_tpu_torch.parallel import init_multihost
    from dmvsnet_tpu_torch.parallel import mesh as program_mesh

    init_multihost(ctx.device)
    device = program.device(ctx)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = program_mesh.make_mesh(device=device)
    state = single.build(ctx, device, mesh, dist.get_rank(), dist.get_world_size())
    state.flags = dist.new_group(backend="gloo")
    single.checked_steps(state)
    return state


def _flag(state, value: int | None = None) -> int:
    t = torch.tensor([0 if value is None else value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=state.flags)
    return int(t)


def serve(state) -> None:
    """Ranks 1..: step, wait for the card or stop, as rank 0 says."""
    while True:
        flag = _flag(state)
        if flag == STEP:
            single.iterate(state)
        elif flag == WAIT:
            single.drain(state)
        else:
            break
    dist.barrier(group=state.flags)
    dist.destroy_process_group()


def iterate(state) -> None:
    _flag(state, STEP)
    single.iterate(state)


def drain(state) -> None:
    _flag(state, WAIT)
    single.drain(state)


units, end_to_end, info, count, spans = (single.units, single.end_to_end, single.info,
                                          single.count, single.spans)


def check(state) -> tuple[dict, int]:
    _flag(state, STOP)
    dist.barrier(group=state.flags)
    dist.destroy_process_group()
    # this process is one process again
    for k, v in state.saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for p in state.procs:
        p.wait(timeout=RANK_TIMEOUT_S)
    bad = [p.returncode for p in state.procs if p.returncode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return single.check(state)
