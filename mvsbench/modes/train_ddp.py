"""Mode ``train_ddp``: ``train``'s steps on every card the cell asks for,
one rank per card, as the ``Trainer`` trains under ``torchrun``.

The run's process is rank 0; its set-up starts ranks 1.. as processes of
their own (``python3 -m mvsbench.rank``) with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR = 127.0.0.1, MASTER_PORT a free port,
OMP_NUM_THREADS = 1; on the card rank 0 takes one thread as well).
Every rank then sets itself up as the Trainer does: NCCL through
``parallel.multihost.init_multihost``, the dp mesh of every rank through
``parallel.mesh.make_mesh``, the model with its synced batch norm, DDP
through ``engine.train.data_parallel``, and its share of each global batch
(``workload["batch"]`` samples over the ranks); the loss is the global
batch's.  All ranks run the three checked steps, then rank 0 leads the
window: before each step it tells the other ranks, over a gloo group on the
host, to step, to wait for their card, or to stop.  It sends the flag to
step without waiting for the ranks to take it, so that no rank's host waits
for another's at a step; no step waits for the card.

The check is ``train``'s: rank 0's first gradient (after DDP's mean), its
running statistics and its weights against the reference run on the whole
global batches in one process, once the other ranks have stopped.

Read from every card: ``memory_peaks`` gathers each rank's peak over the
flag group (the result's ``memory_peak_bytes`` is the fullest card's), and
in a traced run every rank profiles the same sub-window (``profiled``: rank
0 tells the ranks to start their profilers, all meet before the window
opens, and rank 0 tells them to close it after its last step), writes its
Chrome trace to ``.cache/trace/<cell>.rank<r>.json`` and hands its summary to
rank 0.  ``idle_pct.train`` and ``device.busy_s`` are the ranks' mean,
``allreduce_exposed_ms.train`` the least over the ranks; the span metrics
and the ``breakdown`` are rank 0's (its CUDA-event spans and its trace).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from mvsbench import program
from mvsbench import trace as trace_lib
from mvsbench.modes import train as single

KIND = "train"
STEP, WAIT, STOP, TRACE, TRACE_END, PEAK = 1, 0, -1, 2, 3, 4
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}


def setup(ctx):
    world = int(ctx.workload["chips"])
    port = _free_port()
    arg = json.dumps({"name": ctx.name, "workload": ctx.workload, "config": ctx.config,
                      "seed": ctx.seed, "device": ctx.device, "options": ctx.options,
                      "bench_dir": ctx.bench_dir})
    procs = [subprocess.Popen([sys.executable, "-m", "mvsbench.rank", "--ctx", arg],
                              env={**os.environ, **_env(r, world, port)},
                              stdout=subprocess.DEVNULL, cwd=str(program.ROOT))
             for r in range(1, world)]
    atexit.register(_end, procs)
    mine = _env(0, world, port)
    saved = {k: os.environ.get(k) for k in mine}
    os.environ.update(mine)
    threads = torch.get_num_threads()
    if ctx.cuda:
        torch.set_num_threads(1)
    state = setup_rank(ctx)
    state.procs, state.saved_env, state.saved_threads = procs, saved, threads
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
    state.sent = []
    single.checked_steps(state)
    return state


def _flag(state, value: int | None = None) -> int:
    """Rank 0 sends ``value`` once the flags that it sent without waiting
    have been taken; the other ranks (``value`` None) take the next flag."""
    if value is not None:
        for work, _ in state.sent:
            work.wait()
        state.sent.clear()
    t = torch.tensor([0 if value is None else value], dtype=torch.int64)
    dist.broadcast(t, src=0, group=state.flags)
    return int(t)


def _gathered(state, mine) -> list | None:
    """``mine`` of every rank, rank 0's first, on rank 0 (None elsewhere)."""
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, out, dst=0, group=state.flags)
    return out


def _meet(state) -> None:
    dist.barrier(group=state.flags)


def _card_peak(state) -> int:
    return torch.cuda.max_memory_allocated() if state.device.type == "cuda" else 0


def _summary(path: str) -> dict:
    """A rank's trace summary without its kernels' times (rank 0 reads its
    own kernels)."""
    return {k: v for k, v in trace_lib.summarise(path).items() if k != "kernels"}


def _serve(state, until: int) -> None:
    """Ranks 1..: step, wait for the card, trace or report the peak, as
    rank 0 says, until it says ``until``."""
    while (flag := _flag(state)) != until:
        if flag == STEP:
            single.iterate(state)
        elif flag == WAIT:
            single.drain(state)
        elif flag == PEAK:
            _gathered(state, _card_peak(state))
        elif flag == TRACE:
            name = f"{state.ctx.name}.rank{dist.get_rank()}.json"
            path = str(Path(state.ctx.bench_dir) / ".cache" / "trace" / name)
            with trace_lib.profiled(path, state.device.type == "cuda", ready=lambda: _meet(state)):
                _serve(state, TRACE_END)
            _gathered(state, _summary(path))


def serve(state) -> None:
    """Ranks 1..: as rank 0 says, until it says stop."""
    _serve(state, STOP)
    dist.barrier(group=state.flags)
    dist.destroy_process_group()


def iterate(state) -> None:
    t = torch.tensor([STEP], dtype=torch.int64)
    state.sent.append((dist.broadcast(t, src=0, group=state.flags, async_op=True), t))
    single.iterate(state)


def drain(state) -> None:
    _flag(state, WAIT)
    single.drain(state)


def memory_peaks(state) -> list[int]:
    _flag(state, PEAK)
    return _gathered(state, _card_peak(state))


@contextlib.contextmanager
def profiled(state, path: str, cuda: bool):
    """Every rank's profiler over the same sub-window; yields the list that
    holds every rank's trace summary at the exit, rank 0's first."""
    summaries = []
    _flag(state, TRACE)
    with trace_lib.profiled(path, cuda, ready=lambda: _meet(state)):
        yield summaries
        _flag(state, TRACE_END)
    summaries.extend(_gathered(state, trace_lib.summarise(path)))


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
    torch.set_num_threads(state.saved_threads)
    for p in state.procs:
        p.wait(timeout=RANK_TIMEOUT_S)
    bad = [p.returncode for p in state.procs if p.returncode]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return single.check(state)
