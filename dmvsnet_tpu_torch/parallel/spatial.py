"""Row bands of the spatial mesh axis (the port's counterpart of
dmvsnet_tpu.parallel.mesh's ``spatial_spec`` / ``constrain``).

The JAX package constrains each (B, D, H, W, 2) cost volume to be sharded
on H over ``sp`` and lets GSPMD partition the cost U-Nets, halo exchanges
included.  Here the split is explicit:

* ``row_bands`` cuts a stage's height into one band per sp rank, on
  multiples of ``ROW_ALIGN`` = 8 rows: the U-Nets halve H three times, so
  every level's band is whole rows of that level, and the depth heads'
  mod-4 / mod-2 row parities are the global ones.  Bands may be uneven
  (216 rows over 2 ranks: 112 + 104).
* ``bands_for`` follows ``constrain``: where H does not divide over sp the
  pass is left unsplit (one note at debug level; ``stats`` counts such
  passes).  Unlike GSPMD, which pads, an empty band raises.
* ``halo_exchange`` gives a band its neighbours' edge rows, one above and
  one below, zeros at the image's top and bottom (the convolution's
  padding).  Each rank writes its first and last rows into its slot of a
  zeroed (sp, 2, ...) table and one ``psum`` over sp fills every slot; the
  backward of ``psum`` adds each halo row's cotangent to its owner's row.
* ``gather_rows`` zero-pads a band to the whole height and sums over sp.
* ``split_rows`` / ``rows_split``: within ``split_rows(True)`` the
  convolutions that ``models.blocks.spatial_split`` marked run on bands.

Only ``all_reduce`` is used (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import logging
import threading

import torch

from dmvsnet_tpu_torch.parallel.mesh import AXIS_SPATIAL, Mesh

ROW_ALIGN = 8
# passes left unsplit because their height does not divide over sp
stats = {"unsplit_passes": 0}
_split = threading.local()


def row_bands(h: int, sp: int) -> list[tuple[int, int]]:
    """(start, stop) rows of each of ``sp`` bands of a height-``h`` map, on
    multiples of ``ROW_ALIGN``, the first ones a block longer where the
    blocks do not divide evenly.  Raises ValueError when ``h`` is not a
    multiple of ``ROW_ALIGN`` or a band would be empty."""
    if h % ROW_ALIGN:
        raise ValueError(f"stage height {h} is not a multiple of {ROW_ALIGN} rows")
    blocks = h // ROW_ALIGN
    if blocks < sp:
        raise ValueError(f"stage height {h} leaves a band empty over sp={sp}: each band "
                         f"needs at least {ROW_ALIGN} rows")
    base, extra = divmod(blocks, sp)
    bands, start = [], 0
    for s in range(sp):
        stop = start + ROW_ALIGN * (base + (s < extra))
        bands.append((start, stop))
        start = stop
    return bands


def bands_for(h: int, mesh: Mesh | None, passes: int = 1) -> list[tuple[int, int]] | None:
    """The bands of a height-``h`` stage on ``mesh``, or None where its
    ``passes`` cost passes run unsplit: no mesh, sp = 1, or ``h`` not
    divisible by sp (the JAX package's ``constrain`` drops the constraint
    there; counted in ``stats``)."""
    sp = 1 if mesh is None else mesh.size(AXIS_SPATIAL)
    if sp == 1:
        return None
    if h % sp:
        logging.debug("sp=%d does not divide stage height %d: %d cost pass(es) unsplit",
                      sp, h, passes)
        stats["unsplit_passes"] += passes
        return None
    return row_bands(h, sp)


def take_rows(x: torch.Tensor, h_axis: int, band: tuple[int, int]) -> torch.Tensor:
    """Rows ``band`` of ``x`` along ``h_axis``; the backward pads the
    cotangent with zeros outside the band."""
    return x.narrow(h_axis, band[0], band[1] - band[0])


@contextlib.contextmanager
def split_rows(active: bool = True):
    """Within the block (in this thread) the convolutions marked by
    ``models.blocks.spatial_split`` take their inputs as row bands."""
    saved = getattr(_split, "active", False)
    _split.active = active
    try:
        yield
    finally:
        _split.active = saved


def rows_split() -> bool:
    return getattr(_split, "active", False)


def halo_exchange(x: torch.Tensor, mesh: Mesh, h_axis: int) -> torch.Tensor:
    """``x``, this rank's band, with one row of each neighbouring band
    above and below along ``h_axis`` (zeros beyond the first and the last
    band): one all_reduce over sp."""
    sp, s = mesh.size(AXIS_SPATIAL), mesh.coords[AXIS_SPATIAL]
    edges = torch.stack([x.narrow(h_axis, 0, 1), x.narrow(h_axis, x.shape[h_axis] - 1, 1)])
    table = mesh.psum(torch.cat([edges.new_zeros((s, *edges.shape)), edges[None],
                                 edges.new_zeros((sp - s - 1, *edges.shape))]),
                      AXIS_SPATIAL, "halo")
    zero = edges.new_zeros(edges.shape[1:])
    above = table[s - 1, 1] if s > 0 else zero
    below = table[s + 1, 0] if s < sp - 1 else zero
    return torch.cat([above, x, below], dim=h_axis)


def gather_rows(x: torch.Tensor, mesh: Mesh, h_axis: int,
                bands: list[tuple[int, int]]) -> torch.Tensor:
    """The whole map from every rank's band ``x`` along ``h_axis``: the band
    zero-padded to the whole height, summed over sp.  Its backward sums the
    cotangents over sp, so a band receives sp times the cotangent of a
    map every rank reads whole (models/mvsnet.py)."""
    start, stop = bands[mesh.coords[AXIS_SPATIAL]]
    shape = list(x.shape)
    shape[h_axis] = start
    above = x.new_zeros(shape)
    shape[h_axis] = bands[-1][1] - stop
    below = x.new_zeros(shape)
    return mesh.psum(torch.cat([above, x, below], dim=h_axis), AXIS_SPATIAL, "gather")
