"""Canonical dataset splits as Python data.

The DTU splits are the standard MVSNet partition of the 128 DTU scans
(train 79 / val 18 / eval 22) used unchanged by the whole cascade-MVS
literature (the reference ships them as txt files,
datasets/lists/dtu/*.txt); ``single`` is its 3-scan smoke subset.
BlendedMVS scene hashes come from the official low-res release's
training/validation lists (reference datasets/lists/blendedmvs/*.txt);
the 106-scene training list is loaded from the dataset's own
``training_list.txt`` on disk when present, falling back to "all scenes
found minus validation".
"""

from __future__ import annotations

import os
import re

DTU_TRAIN_IDS = [
    2, 6, 7, 8, 14, 16, 18, 19, 20, 22, 30, 31, 36, 39, 41, 42, 44, 45, 46,
    47, 50, 51, 52, 53, 55, 57, 58, 60, 61, 63, 64, 65, 68, 69, 70, 71, 72,
    74, 76, 83, 84, 85, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99,
    100, 101, 102, 103, 104, 105, 107, 108, 109, 111, 112, 113, 115, 116,
    119, 120, 121, 122, 123, 124, 125, 126, 127, 128,
]
DTU_VAL_IDS = [3, 5, 17, 21, 28, 35, 37, 38, 40, 43, 56, 59, 66, 67, 82, 86, 106, 117]
# The 22 scans of the official DTU evaluation set (MATLAB protocol,
# reference scripts/evaluation_dtu/BaseEvalMain_web.m:27).
DTU_TEST_IDS = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49,
                62, 75, 77, 110, 114, 118]
DTU_SINGLE_IDS = [48, 49, 62]

BLENDEDMVS_VAL = [
    "5b7a3890fc8fcf6781e2593a", "5c189f2326173c3a09ed7ef3",
    "5b950c71608de421b1e7318f", "5a6400933d809f1d8200af15",
    "59d2657f82ca7774b1ec081d", "5ba19a8a360c7c30c1c169df",
    "59817e4a1bd4b175e7038d19",
]


def dtu_scans(split: str) -> list[str]:
    ids = {
        "train": DTU_TRAIN_IDS,
        "val": DTU_VAL_IDS,
        "test": DTU_TEST_IDS,
        "single": DTU_SINGLE_IDS,
        "trainval": sorted(DTU_TRAIN_IDS + DTU_VAL_IDS),
    }[split]
    return [f"scan{i}" for i in ids]


def resolve_scan_list(listfile: str | None, datapath: str | None = None) -> list[str]:
    """A scan list from (in priority order): an explicit txt file, a named
    DTU split, or 'all' = every scene directory under datapath
    (the reference's testlist semantics, model.py:308-318)."""
    if listfile and os.path.isfile(listfile):
        with open(listfile) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if listfile in ("train", "val", "test", "single", "trainval"):
        return dtu_scans(listfile)
    if listfile in (None, "all"):
        if not datapath:
            raise ValueError("testlist 'all' requires a datapath")
        return sorted(
            e for e in os.listdir(datapath)
            if os.path.isdir(os.path.join(datapath, e))
        )
    # explicit scan names, comma-separated ("scan1" or "scan1,scan4"), or
    # anything behind an explicit "scans:" marker: small-fixture runs and
    # tests name scans directly instead of monkeypatching the split tables.
    # Restricted to the scanNNN pattern (or the marker) so a mistyped list
    # FILENAME still raises FileNotFoundError instead of becoming a bogus
    # one-element scan list.
    if listfile and listfile.startswith("scans:"):
        return [p.strip() for p in listfile[len("scans:"):].split(",") if p.strip()]
    parts = [p.strip() for p in listfile.split(",")] if listfile else []
    if parts and all(re.fullmatch(r"scan\d+", p) for p in parts):
        return parts
    raise FileNotFoundError(f"scan list {listfile!r} not found")
