"""The port's geometry and hypothesis samplers vs dmvsnet_tpu.core.

Inputs are made with numpy from a seed and go through both packages.
Tolerances: warp coordinates within 1e-4 px (NUMERICS.json
geometry_precision_px measured 6.1e-5 px between fp32 paths); matrices
and depths within fp32 rounding of their magnitude.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.core import geometry as jgeo
from dmvsnet_tpu.core import sampling as jsamp
from dmvsnet_tpu_torch.core import geometry as tgeo
from dmvsnet_tpu_torch.core import sampling as tsamp
from tests.conftest import make_camera

COORD_TOL_PX = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _cams(rng, n=3):
    return np.stack([make_camera(rng, angle=0.05 * i, t=[0.2 * i, -0.05 * i, 0.1])
                     for i in range(n)])


def test_inv3_fuse_relative_match_jax(rng):
    proj2 = _cams(rng)[None]                     # (1, 3, 2, 4, 4)
    a = rng.normal(size=(5, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tgeo.inv3(_t(a)).numpy(), np.asarray(jgeo.inv3(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-6)
    tf = tgeo.fuse_projection(_t(proj2))
    jf = jgeo.fuse_projection(jnp.asarray(proj2))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-3)
    trel = tgeo.relative_projection(tf[:, 1], tf[:, 0]).numpy()
    jrel = np.asarray(jgeo.relative_projection(jf[:, 1], jf[:, 0]))
    np.testing.assert_allclose(trel, jrel, rtol=1e-5, atol=1e-5)
    # the stacked (B, V-1, 3, 4) form used by the cost pass
    rels = tgeo.relative_projections(_t(proj2)).numpy()
    assert rels.shape == (1, 2, 3, 4)
    np.testing.assert_allclose(rels[0, 0], jrel[0, :3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_plane_sweep_coords_match_jax(rng, per_pixel):
    proj2 = _cams(rng)[None]
    fused = jgeo.fuse_projection(jnp.asarray(proj2))
    rel = np.asarray(jgeo.relative_projection(fused[:, 2], fused[:, 0]))
    h, w, d = 12, 20, 5
    if per_pixel:
        dv = np.sort(rng.uniform(300, 900, (1, d, h, w)).astype(np.float32), axis=1)
        dv[0, 0, 0, :3] = [0.0, -50.0, 1e6]  # refine fans reach zero/negative/far
    else:
        dv = np.linspace(425, 935, d, dtype=np.float32)[None]
    jx, jy = jgeo.plane_sweep_coords(jnp.asarray(rel), jnp.asarray(dv), h, w)
    tx, ty = tgeo.plane_sweep_coords(_t(rel), _t(dv), h, w)
    assert tx.shape == (1, d, h, w)
    for t_, j_ in ((tx, jx), (ty, jy)):
        j_ = np.asarray(j_)
        ok = np.abs(j_) < 1e4  # far-off projections: compare relative
        np.testing.assert_allclose(t_.numpy()[ok], j_[ok], atol=COORD_TOL_PX, rtol=0)
        np.testing.assert_allclose(t_.numpy()[~ok], j_[~ok], rtol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_stage1_and_cascade_samples_match_jax(rng, inverse):
    dv = np.linspace(425.0, 935.0, 192, dtype=np.float32)[None].repeat(2, 0)
    ts, tsi = tsamp.stage1_samples(_t(dv), 8, 6, 10, inverse=inverse)
    js, jsi = jsamp.stage1_samples(jnp.asarray(dv), 8, 6, 10, inverse=inverse)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(float(tsi), float(jsi), rtol=1e-6)

    last = rng.uniform(500, 700, (2, 6, 10)).astype(np.float32)
    ivl = np.float32(2.0 * (935.0 - 425.0) / 192)
    tc, tci = tsamp.cascade_samples(_t(last), 8, torch.tensor(ivl), inverse=inverse)
    jc, jci = jsamp.cascade_samples(jnp.asarray(last), 8, jnp.asarray(ivl), inverse=inverse)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(float(tci), float(jci), rtol=1e-6)

    tu = tsamp.upsample_depth_samples(tc, 12, 20).numpy()
    ju = np.asarray(jsamp.upsample_depth_samples(jc, 12, 20))
    np.testing.assert_allclose(tu, ju, rtol=1e-6)
