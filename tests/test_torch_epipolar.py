"""The port's epipolar rectification (dmvsnet_tpu_torch.core.epipolar) vs
dmvsnet_tpu.core.epipolar: every field of the Rectification, the grid
coordinates, and the plain rectified sweep against rectified_sweep_corr_jnp.

The port is batched over pairs, so the three pairs (rotated, pure
translation, forward motion) go through one call and are held against
three calls of the JAX function.

Tolerances: 1e-5 of each field's largest magnitude (fp32 3x3 products and
inverses in another summation order); the sweep volumes 2e-4 absolute on
smoothed unit-variance features, the tolerance tests/test_epipolar_kernel.py
uses for the same algorithm.  The forward-motion pair has its epipole inside
the image: its homographies are near-singular (scale factors in the
thousands) and the validity gate rejects it.  Its grid coordinates pass
through a pole and amplify the 4e-6 difference of the homographies, so the
grid functions of both packages get the same homography and are held at
the pixels away from the pole.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.core import epipolar as jepi
from dmvsnet_tpu.core import geometry as jgeo
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch.core import epipolar as tepi

H, W = 32, 64
REL_TOL = 1e-5
SWEEP_TOL = 2e-4
PAIRS = ("rotated", "translation", "forward")


def _pair_cams(kind):
    cams = np.stack([
        jsyn.camera_stack(1.2 * W, 1.2 * W, W / 2, H / 2),
        jsyn.camera_stack(1.2 * W, 1.2 * W, W / 2, H / 2, tx=-80.0,
                          angle=0.05 if kind == "rotated" else 0.0),
    ])
    if kind == "forward":
        cams[1] = cams[0]
        cams[1, 0, :3, 3] = [0.5, 0.3, -40.0]  # mostly-forward motion
    return cams


def _rel(kind):
    fused = jgeo.fuse_projection(jnp.asarray(_pair_cams(kind)))
    return np.asarray(jgeo.relative_projection(fused[1][None], fused[0][None])[0])


@pytest.fixture(scope="module")
def rects():
    rels = np.stack([_rel(k) for k in PAIRS])
    port = tepi.compute_rectification(torch.from_numpy(rels), H, W)
    jax_side = [jepi.compute_rectification(jnp.asarray(r), H, W) for r in rels]
    return rels, port, jax_side


@pytest.mark.parametrize("i", range(len(PAIRS)), ids=PAIRS)
def test_rectification_fields_match_jax(rects, i):
    _, port, jax_side = rects
    for name in jepi.Rectification._fields:
        want = np.asarray(getattr(jax_side[i], name))
        got = getattr(port, name)[i].numpy()
        assert got.shape == want.shape, name
        err = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert err <= REL_TOL, (PAIRS[i], name, err)


@pytest.mark.parametrize("i", range(len(PAIRS)), ids=PAIRS)
def test_grid_coordinates_match_jax(rects, i):
    """Both packages map the same homography (the JAX side's) to grid
    coordinates; the homographies themselves are held by the test above."""
    _, _, jax_side = rects
    for fn, h_name in (("rect_grid_coords", "h_src"), ("rect_grid_coords", "h_ref"),
                       ("unrect_grid_coords", "h_ref")):
        h = getattr(jax_side[i], h_name)
        want = getattr(jepi, fn)(h, H, W)
        got = getattr(tepi, fn)(torch.tensor(np.asarray(h))[None], H, W)
        for g, wnt in zip(got, want):
            wnt = np.asarray(wnt)
            assert g.shape == (1, H, W)
            # away from the pole of a near-singular homography (forward
            # motion only): coordinates within 100 image widths
            near = np.abs(wnt) < 100 * W
            assert near.mean() > 0.9
            err = np.max(np.abs(g[0].numpy() - wnt)[near] / np.maximum(np.abs(wnt[near]), W))
            assert err <= REL_TOL, (PAIRS[i], fn, h_name, err)


def test_rectification_carries_its_inverses(rects):
    """h_ref_inv / h_src_inv (fields the JAX package does not have) invert
    the homographies of the two well-conditioned pairs, so the coordinate
    maps made from them equal rect_grid_coords; select() keeps a subset."""
    _, port, _ = rects
    two = port.select(torch.tensor([0, 1]))
    assert all(t.shape[0] == 2 for t in two)
    for h, h_inv in ((two.h_ref, two.h_ref_inv), (two.h_src, two.h_src_inv)):
        eye = tepi._matmul(h, h_inv)
        assert (eye - torch.eye(3)).abs().max() <= 1e-4
        want = tepi.rect_grid_coords(h, H, W)
        got = tepi.apply_h(h_inv, *tepi.pixel_grid(H, W))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_apply_h_guards_a_zero_denominator():
    m = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]])
    x, y = tepi.apply_h(m, torch.tensor([[0.0, 2.0]]), torch.tensor([[1.0, 4.0]]))
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    np.testing.assert_allclose(x[0, 1].item(), 1.0)
    np.testing.assert_allclose(y[0, 1].item(), 2.0)


def _smooth(a, k=3):
    for _ in range(k):
        a = 0.25 * (np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 1))
    return a


@pytest.mark.parametrize("c,ndepth", [(8, 8), (16, 6)])
def test_plain_rectified_sweep_matches_jax_oracle(rng, c, ndepth):
    """The whole plain sweep (rectify, 1-D lerp, correlate, un-rectify) for a
    rotated and a pure-translation pair in one batched call, with per-pixel
    inverse-depth fans."""
    kinds = ("rotated", "translation")
    rels = np.stack([_rel(k) for k in kinds])
    feats = np.stack([[_smooth(f) for f in pair] for pair in
                      rng.normal(size=(2, 2, H, W, c))]).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dmin = 450.0 + 20.0 * np.sin(gx / 11.0) * np.cos(gy / 7.0)
    inv_lo = np.broadcast_to(1.0 / dmin, (2, H, W)).astype(np.float32)
    inv_step = ((1.0 / 800.0 - inv_lo) / (ndepth - 1)).astype(np.float32)

    got = tepi.rectified_sweep_corr(
        torch.from_numpy(feats[:, 1]), torch.from_numpy(feats[:, 0]), torch.from_numpy(rels),
        torch.from_numpy(inv_lo), torch.from_numpy(inv_step), ndepth).numpy()
    assert got.shape == (2, ndepth, H, W, 2)
    for i in range(2):
        want = np.asarray(jepi.rectified_sweep_corr_jnp(
            jnp.asarray(feats[i, 1]), jnp.asarray(feats[i, 0]), jnp.asarray(rels[i]),
            jnp.asarray(inv_lo[i]), jnp.asarray(inv_step[i]), ndepth))
        assert np.abs(want).max() > 0.01
        np.testing.assert_allclose(got[i], want, atol=SWEEP_TOL, rtol=0)
