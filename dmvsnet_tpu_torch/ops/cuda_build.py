"""Build, load and launch the hand-written CUDA kernels of the port.

A kernel module declares its kernels once, at import (``declare``): per
kernel the source under ``csrc/``, the headers it includes and the
``ctypes`` argument list of its C entry point ``dmvs_<name>``.  Nothing is
compiled then.  ``build()`` compiles what is declared and not yet loaded,
one ``nvcc`` process per source, all started together, into shared
libraries with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``build/`` at the repository root by a hash of
source, headers and flags, and loads them with ``ctypes``.  ``launch()``
builds at first use, launches on PyTorch's current stream, counts the
launch and raises on a launch error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass(frozen=True)
class Kernel:
    source: Path                  # the .cu file under csrc/
    argtypes: tuple               # ctypes argument list of dmvs_<name>
    headers: tuple[Path, ...]     # included files, hashed with the source
    counts: dict[str, int]        # the declaring module's launch counts


KERNELS: dict[str, Kernel] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
# What build() has done so far: seconds (summed over calls), and per kernel
# the library path, whether it was compiled (or found cached) and the ptxas
# log.
BUILD_INFO: dict = {"seconds": 0.0, "kernels": {}}


def pointer_ints(n_ptr: int, n_int: int) -> tuple:
    """The usual argument list: ``n_ptr`` device pointers, ``n_int`` ints,
    then the stream."""
    return (ctypes.c_void_p,) * n_ptr + (ctypes.c_int,) * n_int + (ctypes.c_void_p,)


def declare(kernels: dict[str, tuple[str, tuple, tuple[str, ...]]]) -> dict[str, int]:
    """Declares kernels {name: (source, argtypes, headers)}, source and
    included headers as file names under csrc/.  Returns the launch counts
    of these kernels, {name: 0}: ``launch`` adds one per launch, and the
    declaring module exposes the dict as its ``LAUNCHES``."""
    counts = dict.fromkeys(kernels, 0)
    for name, (source, argtypes, headers) in kernels.items():
        KERNELS[name] = Kernel(CSRC / source, tuple(argtypes),
                               tuple(CSRC / h for h in headers), counts)
    return counts


def launches() -> dict[str, int]:
    """Launch counts of every declared kernel."""
    return {name: k.counts[name] for name, k in KERNELS.items()}


def reset_launches() -> None:
    """Sets the count of every declared kernel to 0, to count a run."""
    for name, k in KERNELS.items():
        k.counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use on the card")
    return found


def build() -> dict[str, ctypes._CFuncPtr]:
    """Compile (what is not cached) and load every declared kernel that is
    not loaded yet; returns {kernel name: C function}."""
    todo = [name for name in KERNELS if name not in _fns]
    if not todo:
        return _fns
    t0 = time.perf_counter()
    flags = " ".join(NVCC_FLAGS).encode()
    paths, procs = {}, {}
    for name in todo:
        k = KERNELS[name]
        digest = hashlib.sha256(k.source.read_bytes()
                                + b"".join(h.read_bytes() for h in k.headers) + flags)
        paths[name] = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        if not paths[name].exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(str(path)), "dmvs_" + name)
        fn.argtypes = list(KERNELS[name].argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
        BUILD_INFO["kernels"][name] = dict(path=str(path), built=name in procs,
                                           log=logs.get(name, ""))
    BUILD_INFO["seconds"] += time.perf_counter() - t0
    return _fns


def launch(name: str, tensors: Sequence[torch.Tensor], ints: Sequence[int]) -> None:
    """Launch kernel ``name`` on the current stream of the tensors' CUDA
    device: the tensors' pointers, then ``ints``, then the stream.  The
    caller has validated shapes, types and the alignment its kernel needs;
    this checks device and contiguity, counts the launch and raises on a
    launch error.  Does not synchronise."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel tensors must be contiguous")
    fn = build()[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        KERNELS[name].counts[name] += 1
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
