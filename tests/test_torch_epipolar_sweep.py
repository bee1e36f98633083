"""The port's epipolar sweep (dmvsnet_tpu_torch.ops.epipolar_sweep) vs
dmvsnet_tpu.ops.pallas.epipolar_sweep with its Pallas kernels in interpret
mode, as tests/test_epipolar_kernel.py runs them.  On the CPU the port's
wrappers run their plain versions; the CUDA kernels are held against the
plain versions on the card by the tests marked ``cuda`` and by
chip_smoke.py.

Tolerances (absolute, on smoothed unit-variance features): resample 1e-5
(fp32 4-tap sums); the 1-D sweep and whole per-view volumes 2e-4 (the Pallas
band matmuls reassociate); against the port's exact pass 5e-4 where the
rectification is the identity and 1e-4 where the pass falls back.  In every
case the port's flags equal the JAX package's ``sweep_engaged``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.core import epipolar as jepi
from dmvsnet_tpu.core import geometry as jgeo
from dmvsnet_tpu.core import sampling as jsampling
from dmvsnet_tpu.ops import warp as jwarp
from dmvsnet_tpu.ops.pallas import epipolar_sweep as jes
from dmvsnet_tpu.ops.pallas import warp_correlate as jwc
from dmvsnet_tpu_torch.core import epipolar as tepi
from dmvsnet_tpu_torch.core import geometry as tgeo
from dmvsnet_tpu_torch.ops import cuda_build
from dmvsnet_tpu_torch.ops import epipolar_sweep as tes
from dmvsnet_tpu_torch.ops import warp_correlate as twc
from dmvsnet_tpu_torch.utils import synthetic as tsyn

H, W = 32, 64
RESAMPLE_TOL = 1e-5
SWEEP_TOL = 2e-4


def _smooth(a, k=3):
    for _ in range(k):
        a = 0.25 * (np.roll(a, 1, 0) + np.roll(a, -1, 0) + np.roll(a, 1, 1) + np.roll(a, -1, 1))
    return a


def _feats(rng, c, views):
    """(1, V, H, W, C) smoothed features."""
    return np.stack([_smooth(rng.normal(size=(H, W, c))) for _ in range(views)]
                    )[None].astype(np.float32)


def _cams(views=2, angle=0.0, baseline=80.0):
    return tsyn.camera_set("translate", views, H, W, tx=-baseline, angle=angle)


def _rels(cams):
    """(V-1, 4, 4) relative projections of the source views (JAX side)."""
    fused = jgeo.fuse_projection(jnp.asarray(cams))
    return np.stack([np.asarray(jgeo.relative_projection(fused[v], fused[0]))
                     for v in range(1, len(cams))])


def _inv_fan(dpl, dmin=450.0, dmax=800.0):
    """(1, D, H, W) inverse-depth-uniform hypotheses."""
    inv = 1.0 / dmin + np.arange(dpl, dtype=np.float32) * ((1.0 / dmax - 1.0 / dmin) / (dpl - 1))
    return np.broadcast_to((1.0 / inv)[None, :, None, None], (1, dpl, H, W)).astype(np.float32)


def _refine_fan(centre=600.0, spread=40.0, step=6.0):
    """(1, 4, H, W) per-pixel arithmetic-in-depth fan with an oscillating
    interval: the refine checkerboard's structure."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    mid = centre + spread * np.sin(gx / 17.0) * np.cos(gy / 13.0)
    st = step + 2.0 * ((gx + gy) % 2)
    ds = np.arange(4, dtype=np.float32) - 1.5
    return (mid[None] + ds[:, None, None] * st[None]).astype(np.float32)[None]


def _both(feats, cams, dv):
    """The pass through both packages: (port cost, port flags, JAX cost,
    JAX sweep_engaged per view)."""
    proj2 = cams[None].astype(np.float32)
    before = cuda_build.launches()
    with torch.no_grad():
        cost, flags = tes.aggregate_cost_volume_epipolar(
            torch.from_numpy(feats), torch.from_numpy(proj2), torch.from_numpy(dv))
    assert cuda_build.launches() == before  # CPU tensors: plain versions, no launch
    want = jes.aggregate_cost_volume_epipolar(
        [jnp.asarray(feats[:, v]) for v in range(feats.shape[1])], jnp.asarray(proj2),
        jnp.asarray(dv), interpret=True)
    engaged = [bool(jes.sweep_engaged(jnp.asarray(r), jnp.asarray(dv[0]), H, W, feats.shape[-1]))
               for r in _rels(cams)]
    assert flags.dtype == torch.bool and flags.shape == (1, len(cams) - 1)
    assert flags[0].tolist() == engaged
    return cost.numpy(), flags, np.asarray(want), engaged


def _exact(feats, cams, dv):
    return twc.aggregate_cost_volume(torch.from_numpy(feats),
                                     torch.from_numpy(cams[None].astype(np.float32)),
                                     torch.from_numpy(dv), impl="torch").numpy()


# ---------------------------------------------------------------------------
# the two kernels' contracts
# ---------------------------------------------------------------------------

def test_resample_matches_pallas_kernel_and_bilinear_sample(rng):
    """Two images in one call, homography coordinates that leave the image
    (zero padding), against resample_tiled and both bilinear_samples."""
    imgs = _feats(rng, 16, 2)[0]
    rect = jepi.compute_rectification(jnp.asarray(_rels(_cams(angle=0.07))[0]), H, W)
    coords = [jepi.rect_grid_coords(rect.h_src, H, W), jepi.unrect_grid_coords(rect.h_ref, H, W)]
    px = np.stack([np.asarray(c[0]) for c in coords]) + np.float32(3.25)
    py = np.stack([np.asarray(c[1]) for c in coords])
    assert (px > W).any() and (px < W - 1).any()
    got = tes.resample(torch.from_numpy(imgs), torch.from_numpy(px), torch.from_numpy(py))
    assert got.shape == (2, H, W, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), tes.resample_plain(torch.from_numpy(imgs), torch.from_numpy(px),
                                        torch.from_numpy(py)).numpy())
    for n in range(2):
        args = (jnp.asarray(imgs[n]), jnp.asarray(px[n]), jnp.asarray(py[n]))
        np.testing.assert_allclose(got[n].numpy(), np.asarray(jwarp.bilinear_sample(*args)),
                                   atol=RESAMPLE_TOL, rtol=0)
        np.testing.assert_allclose(got[n].numpy(),
                                   np.asarray(jes.resample_tiled(*args, interpret=True)),
                                   atol=RESAMPLE_TOL, rtol=0)


@pytest.mark.parametrize("c", [8, 16, 32])
def test_sweep1d_matches_pallas_kernel(rng, c):
    """sweep1d on natural channel order vs _sweep1d on the JAX package's
    group-major source and tiled reference, with columns left and right of
    the row (they contribute 0)."""
    d = 4
    src_r, ref_r = _feats(rng, c, 2)[0]
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    px = np.stack([gx * 0.9 + 0.37 * i + 2.5 * np.sin(gy / 5.0) - 3.0 + 4.0 * i
                   for i in range(d)]).astype(np.float32)
    assert (px < 0).any() and (px > W - 1).any()
    got = tes.sweep1d(torch.from_numpy(src_r)[None], torch.from_numpy(ref_r)[None],
                      torch.from_numpy(px)[None])[0].numpy()
    assert got.shape == (d, H, W, 2)
    perm = list(range(0, c, 2)) + list(range(1, c, 2))
    tiled = jes._sweep1d(jnp.asarray(src_r[:, :, perm]), jwc._tile_ref(jnp.asarray(ref_r)),
                         jnp.asarray(px), interpret=True)
    want = np.asarray(jwc._untile_out(tiled, H, W))
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=SWEEP_TOL, rtol=0)
    # and the same function as a bilinear sample on the pixel's own row
    py = np.broadcast_to(gy[None].astype(np.float32), px.shape)
    warped = jwarp.bilinear_sample(jnp.asarray(src_r), jnp.asarray(px), jnp.asarray(py))
    ref = np.asarray(jwarp.group_correlation(warped[None], jnp.asarray(ref_r)[None])[0])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    img = torch.zeros(1, 8, 8, 8)
    xy = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="C % 4"):
        tes.resample(torch.zeros(1, 8, 8, 6), xy, xy)
    with pytest.raises(ValueError, match="px, py must be"):
        tes.resample(img, xy, xy[:, :4])
    with pytest.raises(TypeError, match="float32"):
        tes.resample(img, xy.double(), xy.double())
    with pytest.raises(ValueError, match="src_r, ref_r must be"):
        tes.sweep1d(img, img[:, :4], torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="px must be"):
        tes.sweep1d(img, img, torch.zeros(1, 2, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        tes.sweep1d(img, img.double(), torch.zeros(1, 2, 8, 8))


# ---------------------------------------------------------------------------
# the fan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fan", ["inverse", "refine", "zero_crossing"])
def test_fan_coeffs_and_px_match_jax(fan):
    """_fan_coeffs and _fan_px on a cascade fan (inverse mode), a refine fan
    (depth-affine mode) and a refine fan that reaches zero and negative
    depths: flags equal, coefficients and coordinates 1e-5 relative."""
    dv = {"inverse": _inv_fan(8), "refine": _refine_fan(),
          "zero_crossing": _refine_fan(centre=8.0, spread=6.0, step=6.0)}[fan]
    if fan == "zero_crossing":
        dv[0, 1, 3, 5] = 0.0
        assert (dv < 0).any()
    coeffs, inv_ok, dep_ok = tes._fan_coeffs(torch.from_numpy(dv))
    j_coeffs, j_inv_ok, j_dep_ok = jes._fan_coeffs(jnp.asarray(dv[0]))
    assert (bool(inv_ok[0]), bool(dep_ok[0])) == (bool(j_inv_ok), bool(j_dep_ok))
    assert bool(dep_ok[0]) == (fan != "inverse")
    assert torch.isfinite(coeffs).all()
    np.testing.assert_allclose(coeffs[0].numpy(), np.asarray(j_coeffs), rtol=1e-5, atol=1e-9)

    rel = _rels(_cams(angle=0.05))[0]
    rect = tepi.compute_rectification(torch.from_numpy(rel)[None], H, W)
    j_rect = jepi.compute_rectification(jnp.asarray(rel), H, W)
    d = dv.shape[1]
    for mode in (True, False):
        got = tes._fan_px(rect, coeffs, [mode], d, H, W)[0].numpy()
        want = np.asarray(jes._fan_px(j_rect, j_coeffs, mode, d, H, W))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # a pair in each mode: each keeps its own form
    both = tes._fan_px(tepi.Rectification(*(t.repeat(2, *[1] * (t.dim() - 1)) for t in rect)),
                       coeffs.repeat(2, 1, 1, 1), [True, False], d, H, W)
    np.testing.assert_array_equal(both[0].numpy(),
                                  tes._fan_px(rect, coeffs, [True], d, H, W)[0].numpy())
    np.testing.assert_array_equal(both[1].numpy(),
                                  tes._fan_px(rect, coeffs, [False], d, H, W)[0].numpy())


# ---------------------------------------------------------------------------
# whole cost passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [8, 16, 32])
def test_rotated_pair_matches_jax_pass(rng, c):
    """A rotated pair engages the sweep in both packages; the volumes agree
    and differ from the exact pass (the sweep is an approximation)."""
    feats, cams, dv = _feats(rng, c, 2), _cams(angle=0.05), _inv_fan(8)
    got, flags, want, engaged = _both(feats, cams, dv)
    assert engaged == [True]
    assert got.shape == (1, 8, H, W, 2)
    np.testing.assert_allclose(got, want, atol=SWEEP_TOL, rtol=0)
    assert np.abs(got - _exact(feats, cams, dv)).max() > 1e-3


def test_orbit_cameras_match_jax_sweep(rng):
    """Four views rotated by degrees about several axes (as a DTU rig's
    are): the port's geometry gates decide as the JAX package's geometry
    gates (scales and epipole distance of its own rectification), and the
    volume equals the sum over the views of the JAX package's plain
    rectified sweep.  The JAX pass itself falls back on these views for its
    TPU window spans alone, a gate the port does not have (ROADMAP §3,
    stated differences), so its volume is not the reference here."""
    feats, cams, dpl = _feats(rng, 16, 4), tsyn.camera_set("orbit", 4, H, W), 8
    dv = _inv_fan(dpl)
    with torch.no_grad():
        cost, flags = tes.aggregate_cost_volume_epipolar(
            torch.from_numpy(feats), torch.from_numpy(cams[None].astype(np.float32)),
            torch.from_numpy(dv))
    diag = float((H * H + W * W) ** 0.5)
    want_flags, want = [], 0.0
    inv_lo = np.full((H, W), 1.0 / dv[0, 0, 0, 0], np.float32)
    inv_step = np.full((H, W), (1.0 / dv[0, -1, 0, 0] - inv_lo[0, 0]) / (dpl - 1), np.float32)
    for v, rel in enumerate(_rels(cams), start=1):
        rect = jepi.compute_rectification(jnp.asarray(rel), H, W)
        scales = np.abs(np.asarray(rect.scales))
        want_flags.append(bool((scales > tes.SCALE_MIN).all() and (scales < tes.SCALE_MAX).all()
                               and float(rect.epipole_dist) > tes.EPIPOLE_MARGIN * diag))
        want = want + np.asarray(jepi.rectified_sweep_corr_jnp(
            jnp.asarray(feats[0, v]), jnp.asarray(feats[0, 0]), jnp.asarray(rel),
            jnp.asarray(inv_lo), jnp.asarray(inv_step), dpl))
    assert flags[0].tolist() == want_flags == [True, True, True]
    np.testing.assert_allclose(cost[0].numpy(), want, atol=SWEEP_TOL, rtol=0)
    assert np.abs(cost.numpy() - _exact(feats, cams, dv)).max() > 1e-3


def test_pure_translation_is_exact(rng):
    """Two source views, zero relative rotation: the rectification is the
    identity, so the sweep equals the exact pass as well."""
    feats, cams, dv = _feats(rng, 16, 3), _cams(views=3), _inv_fan(8)
    got, flags, want, engaged = _both(feats, cams, dv)
    assert engaged == [True, True]
    np.testing.assert_allclose(got, want, atol=SWEEP_TOL, rtol=0)
    np.testing.assert_allclose(got, _exact(feats, cams, dv), atol=5e-4, rtol=0)


def test_refine_fan_takes_the_depth_affine_mode(rng):
    feats, cams, dv = _feats(rng, 16, 2), _cams(), _refine_fan()
    got, flags, want, engaged = _both(feats, cams, dv)
    assert engaged == [True]
    np.testing.assert_allclose(got, want, atol=SWEEP_TOL, rtol=0)
    np.testing.assert_allclose(got, _exact(feats, cams, dv), atol=5e-4, rtol=0)


def test_per_pixel_cascade_fans(rng):
    """Checkerboarded per-pixel inverse fans, the real stage-2 input."""
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    last = 600.0 + 40.0 * np.sin(gx / 17.0) * np.cos(gy / 13.0)
    dv, _ = jsampling.cascade_samples(jnp.asarray(last, jnp.float32)[None], 8,
                                      jnp.float32(5.0), inverse=True)
    feats, cams, dv = _feats(rng, 16, 2), _cams(), np.array(dv)
    got, flags, want, engaged = _both(feats, cams, dv)
    assert engaged == [True]
    np.testing.assert_allclose(got, want, atol=SWEEP_TOL, rtol=0)
    np.testing.assert_allclose(got, _exact(feats, cams, dv), atol=5e-4, rtol=0)


@pytest.mark.parametrize("case", ["five_planes", "forward_motion"])
def test_fallback_equals_the_exact_pass(rng, case):
    """D = 5 (folded channels not a multiple of 8) and an epipole inside
    the image both go to the exact 2-D pass in both packages."""
    feats = _feats(rng, 16, 2)
    if case == "five_planes":
        cams, dv = _cams(angle=0.05), _inv_fan(5)
    else:
        cams, dv = _cams(baseline=0.0), _inv_fan(8)
        cams[1, 0, :3, 3] = [0.5, 0.3, -40.0]
    got, flags, want, engaged = _both(feats, cams, dv)
    assert engaged == [False]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, _exact(feats, cams, dv), atol=1e-6, rtol=0)


def test_mixed_pass_falls_back_per_view_and_batch_element(rng):
    """Batch 2, three source views: element 0 takes the sweep for views 1
    and 3 and the exact pass for view 2 (forward motion); element 1's fan
    fits neither form, so all of it goes to the exact pass.  Each element
    equals the sum of its parts, and sweep_engaged reports the same flags."""
    c, d = 8, 4
    cams = _cams(views=4, angle=0.02)
    cams[2, 0, :3, 3] = [0.5, 0.3, -40.0]
    proj2 = torch.from_numpy(np.stack([cams, cams]).astype(np.float32))
    feats = torch.from_numpy(np.concatenate([_feats(rng, c, 4), _feats(rng, c, 4)]))
    bad = np.sort(rng.uniform(400, 900, (1, d, H, W)).astype(np.float32), axis=1)
    dv = torch.from_numpy(np.concatenate([_inv_fan(d), bad]))
    with torch.no_grad():
        cost, flags = tes.aggregate_cost_volume_epipolar(feats, proj2, dv)
    assert flags.tolist() == [[True, False, True], [False, False, False]]
    rel = tgeo.relative_projections(proj2)
    assert torch.equal(tes.sweep_engaged(rel, dv, H, W, c), flags)

    def sub(b, views, fn):
        out = fn(feats[b:b + 1, [0, *views]], proj2[b:b + 1, [0, *views]], dv[b:b + 1])
        return (out[0] if isinstance(out, tuple) else out)[0]

    exact = lambda f, p, x: twc.aggregate_cost_volume(f, p, x, impl="torch")  # noqa: E731
    with torch.no_grad():
        want0 = sub(0, [1, 3], tes.aggregate_cost_volume_epipolar) + sub(0, [2], exact)
    np.testing.assert_allclose(cost[0].numpy(), want0.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(cost[1].numpy(), sub(1, [1, 2, 3], exact).numpy(),
                               atol=1e-6, rtol=0)


def test_an_input_that_requires_a_gradient_raises(rng):
    feats = torch.from_numpy(_feats(rng, 8, 2)).requires_grad_()
    proj2 = torch.from_numpy(_cams()[None].astype(np.float32))
    with pytest.raises(RuntimeError, match="no gradient"):
        tes.aggregate_cost_volume_epipolar(feats, proj2, torch.from_numpy(_inv_fan(8)))
    with torch.no_grad():
        cost, flags = tes.aggregate_cost_volume_epipolar(feats, proj2,
                                                         torch.from_numpy(_inv_fan(8)))
    assert not cost.requires_grad and flags.all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_resample_and_sweep1d_match_plain_on_card(rng):
    """Both CUDA kernels vs their plain versions on the card: every channel
    width of the features, 4 coefficient channels and 12 folded ones for the
    resample, coordinates that leave the image.  The sweep also at its
    design's edges: W that no warp's span of pixels divides, D = 1 and 7
    (runs of planes with a ragged tail), N = 1, and fans that move slowly
    across the whole row and off both ends of it (the loads a plane reuses
    from the previous one).  Tolerance 1e-4 * max(1, max|plain|): same taps
    and weights, sums with FMAs in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain versions")
    dev = torch.device("cuda")
    n, h, w, d = 3, 40, 56, 6
    px = torch.from_numpy(rng.uniform(-4, w + 3, (n, d, h, w)).astype(np.float32)).to(dev)
    py = torch.from_numpy(rng.uniform(-4, h + 3, (n, h, w)).astype(np.float32)).to(dev)
    for c in (4, 8, 12, 16, 32):
        img = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)).to(dev)
        before = dict(tes.LAUNCHES)
        got = tes.resample(img, px[:, 0].contiguous(), py)
        want = tes.resample_plain(img, px[:, 0], py)
        torch.cuda.synchronize()
        assert tes.LAUNCHES["resample"] == before["resample"] + 1
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item()), c

    with pytest.raises(ValueError, match="kernel built for C"):
        tes.sweep1d(img[..., :4].contiguous(), img[..., :4].contiguous(), px)

    def fans(n, d, h, w):
        """White noise over [-4, W+3], and per pixel a fan that moves
        monotonically from left of the row to right of it (under a column
        a plane at D = 48)."""
        noise = rng.uniform(-4, w + 3, (n, d, h, w))
        start = rng.uniform(-3.0, 0.5 * w if d > 1 else w + 2.0, (n, 1, h, w))
        step = (w + 2.5 - start) / max(d - 1, 1) * rng.uniform(0.3, 1.0, (n, 1, h, w))
        slow = start + step * np.arange(d)[None, :, None, None]
        return [torch.from_numpy(f.astype(np.float32)).to(dev) for f in (noise, slow)]

    for n, h, w, d in ((n, h, w, d), (1, 7, 57, 1), (1, 9, 61, 7), (2, 5, 37, 48),
                       (1, 6, 41, 64), (2, 5, 35, 32)):
        for c in twc.CHANNELS:
            src_r, ref_r = (torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
                            .to(dev) for _ in range(2))
            for px in fans(n, d, h, w):
                before = dict(tes.LAUNCHES)
                got = tes.sweep1d(src_r, ref_r, px)
                want = tes.sweep1d_plain(src_r, ref_r, px)
                torch.cuda.synchronize()
                assert tes.LAUNCHES["sweep1d"] == before["sweep1d"] + 1
                assert ((px < 0).any() and (px > w - 1).any()), "the fan stays inside the row"
                err = (got - want).abs().max().item()
                assert err <= 1e-4 * max(1.0, want.abs().max().item()), (c, n, h, w, d)


@pytest.mark.cuda
@pytest.mark.parametrize("cams", ["translate", "orbit"])
@pytest.mark.parametrize("d", [8, 32, 64])
def test_cuda_epipolar_pass_matches_plain_on_card(rng, cams, d):
    """The whole epipolar pass on the card (gates, four resamples, the sweep,
    the exact kernel for the views that fall back) against the same pass
    with the plain versions of its kernels, on 11 views (the tank_test
    view count) under both camera sets, with D = 8 and the tank_test
    sweeps' 64 and 32 planes: the same flags, costs within 1e-4 *
    max(1, max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain versions")
    dev = torch.device("cuda")
    views, c = 11, 16
    cam = tsyn.camera_set(cams, views, H, W, tx=-18.0)
    feats = torch.from_numpy(_feats(rng, c, views)).to(dev)
    proj2 = torch.from_numpy(cam[None].astype(np.float32)).to(dev)
    dv = torch.from_numpy(_inv_fan(d)).to(dev)
    with torch.no_grad():
        before = dict(tes.LAUNCHES)
        got, flags = tes.aggregate_cost_volume_epipolar(feats, proj2, dv)
        launched = {k: tes.LAUNCHES[k] - before[k] for k in before}
        saved = tes.resample, tes.sweep1d, twc.warp_correlate
        tes.resample, tes.sweep1d = tes.resample_plain, tes.sweep1d_plain
        twc.warp_correlate = twc.warp_correlate_plain
        try:
            want, want_flags = tes.aggregate_cost_volume_epipolar(feats, proj2, dv)
        finally:
            tes.resample, tes.sweep1d, twc.warp_correlate = saved
    torch.cuda.synchronize()
    assert torch.equal(flags, want_flags) and flags.shape == (1, views - 1)
    if flags.any():
        assert launched["resample"] == 4 and launched["sweep1d"] == 1, launched
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol, (flags.tolist(), cams, d)
