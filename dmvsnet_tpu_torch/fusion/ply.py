"""Binary little-endian PLY writer (xyz float32 + rgb uchar vertices).

Produces the same vertex layout as the reference's plyfile output
(reference filter/pcd.py:348-361) without the plyfile dependency, so the
MATLAB DTU evaluator and the T&T server consume our clouds unchanged.

A copy of dmvsnet_tpu.fusion.ply.
"""

from __future__ import annotations

import os

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz (N, 3) float; rgb (N, 3) uint8."""
    xyz = np.ascontiguousarray(xyz, dtype="<f4")
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    assert xyz.shape == rgb.shape and xyz.ndim == 2 and xyz.shape[1] == 3
    n = xyz.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read back a binary PLY written by write_ply (for tests)."""
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        rec = np.fromfile(
            f,
            dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")],
            count=n,
        )
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
    return xyz, rgb
