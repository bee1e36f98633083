"""Multi-process initialisation (port of dmvsnet_tpu.parallel.multihost).

The reference bootstraps NCCL from the RANK / WORLD_SIZE / LOCAL_RANK
environment of ``torch.distributed.launch`` (tools.py:299-322).  The port
reads the same contract, as ``torchrun`` sets it (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or the JAX package's
COORDINATOR_ADDRESS ("host:port") / NUM_PROCESSES / PROCESS_ID, and
initialises one process group: nccl for a CUDA device, gloo for the CPU.
Every process drives one device, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# a collective that waits longer than this fails instead of hanging
TIMEOUT_S = 600.0


def _summary() -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": world, "local_devices": 1, "global_devices": world}


def init_multihost(device: str | torch.device = "cuda", backend: str | None = None,
                   timeout_s: float = TIMEOUT_S) -> dict:
    """Initialise the process group when the environment describes one; a
    no-op (one process) when it does not, and when a group exists already.

    Args:
      device: the device type the ranks compute on; picks the backend
        (nccl for cuda, gloo for cpu) and, for cuda, pins ``cuda:LOCAL_RANK``
        (LOCAL_RANK defaults to rank modulo the visible devices).
      backend: overrides the backend, e.g. gloo for ranks that share one card.
      timeout_s: how long a collective may wait before it fails.

    Returns {process_index, process_count, local_devices, global_devices},
    the keys of the JAX function; each process drives one device.

    Raises RuntimeError when the environment names more than one process
    but not all of rank, world size and address: the port never carries on
    as a single process then.
    """
    if dist.is_initialized():
        return _summary()
    env = os.environ
    world = env.get("WORLD_SIZE") or env.get("NUM_PROCESSES")
    rank = env.get("RANK") or env.get("PROCESS_ID")
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    elif env.get("COORDINATOR_ADDRESS"):
        init_method = f"tcp://{env['COORDINATOR_ADDRESS']}"
    else:
        init_method = None
    if (world is None and rank is None) or (
            int(world or 1) == 1 and (rank is None or init_method is None)):
        return _summary()
    if world is None or rank is None or init_method is None:
        raise RuntimeError(
            "incomplete multi-process environment: need WORLD_SIZE (or NUM_PROCESSES), "
            "RANK (or PROCESS_ID) and MASTER_ADDR + MASTER_PORT (or COORDINATOR_ADDRESS); "
            f"got WORLD_SIZE/NUM_PROCESSES={world}, RANK/PROCESS_ID={rank}")
    world, rank = int(world), int(rank)
    device = torch.device(device)
    if device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_dev == 0:
            raise RuntimeError("device 'cuda' requested but no CUDA device is visible")
        local = int(env.get("LOCAL_RANK", rank % n_dev))
        if local >= n_dev:
            raise RuntimeError(f"LOCAL_RANK={local} but {n_dev} CUDA device(s) are visible")
        torch.cuda.set_device(local)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"), init_method=init_method,
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return _summary()
