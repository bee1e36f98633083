"""File-format I/O: PFM depth maps, MVSNet cam.txt, pair.txt.

These formats are the compatibility contract with the reference
ecosystem (written depth maps must be readable by its fusion / MATLAB
eval, reference datasets/data_io.py:6-71, tools.py:40-57).

PFM: ``Pf\\n<w> <h>\\n<scale>\\n`` + float32 rows bottom-to-top; negative
scale marks little-endian.
cam.txt: ``extrinsic`` 4x4, blank, ``intrinsic`` 3x3, blank, then a
depth line ``depth_min depth_interval [num_depth depth_max]``.
pair.txt: total count, then per view: ``<ref>\\n<n> <src0> <score0> ...``.
"""

from __future__ import annotations

import os
import re

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().decode("ascii").rstrip()
        if header == "PF":
            channels = 3
        elif header == "Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        dims = f.readline().decode("ascii")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: bad PFM dimensions line {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f4")
    expected = width * height * channels
    if data.size != expected:
        raise ValueError(f"{path}: expected {expected} floats, got {data.size}")
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image)
    if image.dtype != np.float32:
        raise ValueError(f"PFM requires float32, got {image.dtype}")
    if image.ndim == 3 and image.shape[2] == 3:
        header = "PF"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = "Pf"
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"bad PFM shape {image.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"{header}\n".encode("ascii"))
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        f.write(f"{-scale:f}\n".encode("ascii"))  # little-endian
        np.flipud(image).astype("<f4").tofile(f)


def read_cam_file(path: str):
    """-> (intrinsics (3,3) f32, extrinsics (4,4) f32, depth_line floats)."""
    with open(path) as f:
        lines = [ln.rstrip() for ln in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ").reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ").reshape(3, 3)
    depth_line = [float(x) for x in lines[11].split()] if len(lines) > 11 and lines[11] else []
    return intrinsics, extrinsics, depth_line


def write_cam_file(path: str, proj2: np.ndarray) -> None:
    """Write the (2,4,4) [extrinsics; intrinsics+depth-row] stack in the
    reference's text format (reference tools.py:40-57): the 4th row of the
    intrinsics block carries (depth_min, interval, ndepth, depth_max)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(float(proj2[0][i][j])) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(float(proj2[1][i][j])) for j in range(3)) + " \n")
        f.write(
            "\n"
            + " ".join(str(float(proj2[1][3][j])) for j in range(4))
            + "\n"
        )


def read_pair_file(path: str) -> list[tuple[int, list[int]]]:
    """[(ref_view, [src views by descending score])], empty-src refs dropped."""
    pairs = []
    with open(path) as f:
        n = int(f.readline())
        for _ in range(n):
            ref = int(f.readline().rstrip())
            toks = f.readline().rstrip().split()
            srcs = [int(x) for x in toks[1::2]]
            if srcs:
                pairs.append((ref, srcs))
    return pairs


def write_pair_file(path: str, pairs: list[tuple[int, list[int]]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n")
            f.write(
                str(len(srcs)) + " "
                + " ".join(f"{s} {100.0 - i}" for i, s in enumerate(srcs)) + "\n"
            )


def load_image(path: str) -> np.ndarray:
    """RGB float32 in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32) / 255.0
