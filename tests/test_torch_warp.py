"""The port's cost pass vs the JAX package: the plain PyTorch warp +
group correlation against both dmvsnet_tpu.ops.warp.aggregate_cost_volume
(XLA path) and aggregate_cost_volume_pallas in interpret mode, and the
kernel wrapper's CPU path against the plain version.

Tolerance: 1e-5 absolute on cost volumes of unit-variance features (fp32
rounding of the 4-tap sums and the means; the Pallas kernel's band
matmuls reassociate, so it gets the 2e-4 of tests/test_pallas_warp.py).
The CUDA kernel itself is held against the plain version on the card by
the test marked ``cuda`` and by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.ops import warp as jwarp
from dmvsnet_tpu.ops.pallas.warp_correlate import aggregate_cost_volume_pallas
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch.core import geometry as tgeo
from dmvsnet_tpu_torch.ops import warp as twarp
from dmvsnet_tpu_torch.ops import warp_correlate as twc
from dmvsnet_tpu_torch.utils import synthetic as tsyn

TOL = 1e-5
PALLAS_TOL = 2e-4


def _case(rng, c, h=24, w=160, d=4, views=3, cams=None, lo=400, hi=700):
    feats = [rng.normal(size=(1, h, w, c)).astype(np.float32) for _ in range(views)]
    if cams is None:
        cams = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2,
                                           tx=-6.0 * i, angle=0.012 * i)
                         for i in range(views)])
    proj2 = cams[None].astype(np.float32)
    dv = np.sort(rng.uniform(lo, hi, (1, d, h, w)).astype(np.float32), axis=1)
    return feats, proj2, dv


def _port(feats, proj2, dv):
    out = twarp.aggregate_cost_volume([torch.from_numpy(f) for f in feats],
                                      torch.from_numpy(proj2), torch.from_numpy(dv))
    return out.numpy()


def _jax(feats, proj2, dv, pallas=False):
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(proj2), jnp.asarray(dv))
    if pallas:
        return np.asarray(aggregate_cost_volume_pallas(*args, interpret=True))
    return np.asarray(jwarp.aggregate_cost_volume(*args))


@pytest.mark.parametrize("channels", [8, 16, 32])
def test_cost_volume_matches_xla_and_pallas(rng, channels):
    feats, proj2, dv = _case(rng, channels)
    ours = _port(feats, proj2, dv)
    assert ours.shape == (1, 4, 24, 160, 2) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv), atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv, pallas=True),
                               atol=PALLAS_TOL, rtol=0)


def test_cost_volume_zero_padding_and_padded_sizes(rng):
    """Non-tile-aligned H/W and a translation that throws much of the warp
    outside the source image (zero padding)."""
    h, w = 20, 72
    cams = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2),
                     jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2, tx=-60.0)])
    feats, proj2, dv = _case(rng, 8, h=h, w=w, d=3, views=2, cams=cams, lo=300, hi=500)
    ours = _port(feats, proj2, dv)
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv), atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv, pallas=True),
                               atol=PALLAS_TOL, rtol=0)


def test_cost_volume_wide_baseline(rng):
    """The adversarial geometry of tests/test_pallas_warp.py (3x focal
    ratio, wide depth range) that exceeds the TPU kernel's windows: the
    port has no windows, so it must simply agree."""
    h, w = 32, 768
    cams = np.stack([jsyn.camera_stack(300.0, 300.0, w / 2, h / 2),
                     jsyn.camera_stack(900.0, 900.0, w / 2, h / 2, tx=-2.0)])
    feats, proj2, dv = _case(rng, 8, h=h, w=w, d=4, views=2, cams=cams, lo=120, hi=900)
    ours = _port(feats, proj2, dv)
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv), atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, _jax(feats, proj2, dv, pallas=True),
                               atol=PALLAS_TOL, rtol=0)


def test_bilinear_sample_matches_jax(rng):
    img = rng.normal(size=(2, 7, 9, 4)).astype(np.float32)
    x = rng.uniform(-3, 12, (2, 5, 6)).astype(np.float32)
    y = rng.uniform(-3, 10, (2, 5, 6)).astype(np.float32)
    ours = twarp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                                 torch.from_numpy(y)).numpy()
    for b in range(2):
        ref = np.asarray(jwarp.bilinear_sample(jnp.asarray(img[b]), jnp.asarray(x[b]),
                                               jnp.asarray(y[b])))
        np.testing.assert_allclose(ours[b], ref, atol=1e-6, rtol=0)


def test_kernel_wrapper_cpu_path_is_the_plain_version(rng):
    """On CPU tensors the wrapper runs the plain version (no launch); the
    stacked (B, V, H, W, C) form equals the per-view list form, with
    per-image (B, D) and per-pixel hypotheses, for B = 2."""
    b, v, h, w, c, d = 2, 4, 16, 24, 16, 3
    feats = rng.normal(size=(b, v, h, w, c)).astype(np.float32)
    cams = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2, tx=-4.0 * i,
                                       angle=0.01 * i) for i in range(v)])
    proj2 = np.stack([cams, cams * np.float32(1.0)]).astype(np.float32)
    proj2[1, :, 0, 0, 3] += 1.5
    for dv in (np.linspace(450, 650, d, dtype=np.float32)[None].repeat(b, 0),
               rng.uniform(450, 650, (b, d, h, w)).astype(np.float32)):
        before = dict(twc.LAUNCHES)
        ours = twc.aggregate_cost_volume(torch.from_numpy(feats), torch.from_numpy(proj2),
                                         torch.from_numpy(dv)).numpy()
        assert twc.LAUNCHES == before
        ref = twarp.aggregate_cost_volume([torch.from_numpy(feats[:, i]) for i in range(v)],
                                          torch.from_numpy(proj2),
                                          torch.from_numpy(dv)).numpy()
        np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)


def test_kernel_wrapper_rejects_grad_and_bad_shapes(rng):
    feats = torch.from_numpy(rng.normal(size=(1, 2, 8, 8, 8)).astype(np.float32))
    rel = torch.zeros(1, 1, 3, 4)
    depth = torch.ones(1, 2, 8, 8)
    # inputs that require grad are accepted now (the adjoint kernels exist):
    # the result carries a gradient to the features and none to the grid
    f, dep = feats.clone().requires_grad_(), depth.clone().requires_grad_()
    twc.warp_correlate(f, rel, dep).sum().backward()
    assert f.grad is not None and dep.grad is None
    with pytest.raises(ValueError, match=r"feats must be \(B, V, H, W, C\)"):
        twc.warp_correlate(feats[0], rel, depth)
    with pytest.raises(ValueError, match="at least one source view"):
        twc.warp_correlate(feats[:, :1], rel[:, :0], depth)
    with pytest.raises(ValueError, match="depth must be"):
        twc.warp_correlate(feats, rel, depth[..., :4])
    with pytest.raises(ValueError, match="rel must be"):
        twc.warp_correlate(feats, torch.zeros(1, 2, 3, 4), depth)
    with pytest.raises(TypeError, match="float32"):
        twc.warp_correlate(feats, rel, depth.double())


CAMERA_SETS = ["translate", "orbit"]


@pytest.mark.parametrize("kind", CAMERA_SETS)
def test_camera_set_is_the_cameras_it_names(kind):
    """utils/synthetic.camera_set, the camera sets of the card tests and of
    chip_smoke.py: "translate" is the JAX package's camera_stack per view,
    "orbit" the port's orbit_camera_stack; another name raises."""
    v, h, w = 5, 40, 56
    got = tsyn.camera_set(kind, v, h, w, tx=-12.0)
    if kind == "orbit":
        want = tsyn.orbit_camera_stack(v, 1.2 * w, 1.2 * w, w / 2, h / 2)
    else:
        want = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2, tx=-12.0 * i,
                                           angle=0.01 * i) for i in range(v)])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="camera set"):
        tsyn.camera_set("spiral", v, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("cams", CAMERA_SETS)
def test_cuda_kernel_matches_plain_on_card(rng, cams):
    """The CUDA kernel vs its plain version on the card, every channel
    width, per-pixel hypotheses including negative depths, under both
    camera sets.  Tolerance 1e-4 * max(1, max|plain|): the coordinates
    round as the plain version's do, but the channel sums use FMAs in
    another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, v, h, w, d = 2, 5, 40, 56, 6
    proj2 = torch.from_numpy(
        np.stack([tsyn.camera_set(cams, v, h, w)] * b).astype(np.float32)).to(dev)
    for c in twc.CHANNELS:
        feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32)).to(dev)
        dv = rng.uniform(-100, 900, (b, d, h, w)).astype(np.float32)
        dv[:, 0, 0, :4] = 0.0  # the z == 0 guard
        dv = torch.from_numpy(dv).to(dev)
        got = twc.aggregate_cost_volume(feats, proj2, dv, impl="cuda")
        want = twc.aggregate_cost_volume(feats, proj2, dv, impl="torch")
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, c


def _branch_fans(rng, kind, b, d, h, w):
    """(B, D, H, W) hypotheses for the branches of the kernels: "smooth"
    inverse-depth fans (a tile's taps move a fraction of a pixel per plane,
    so the scatter's window holds them), "noise" white-noise depths that
    cross zero (its boxes overflow), "outside" a plane inside the image
    between planes at z = 0 and near 0, which project wholly outside."""
    if kind == "smooth":
        base = 1.0 / np.linspace(1 / 450.0, 1 / 750.0, d, dtype=np.float32)
        ramp = np.linspace(0.0, 20.0, w, dtype=np.float32)[None, None, None, :]
        return np.broadcast_to(base[None, :, None, None] + ramp, (b, d, h, w)).copy()
    if kind == "noise":
        dv = (600.0 + 400.0 * rng.normal(size=(b, d, h, w))).astype(np.float32)
        dv[:, 0, 0, :4] = 0.0  # the z == 0 guard
        return dv
    planes = [np.zeros((b, h, w), np.float32), np.full((b, h, w), 1e-30, np.float32)]
    dv = np.stack([planes[i % 2] if i % 3 else np.full((b, h, w), 550.0, np.float32)
                   for i in range(d)], axis=1)
    return dv.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("cams", CAMERA_SETS)
@pytest.mark.parametrize("channels", [8, 16, 32])
@pytest.mark.parametrize("fan", ["smooth", "noise", "outside"])
def test_cuda_kernel_branches_on_card(rng, channels, fan, cams):
    """The kernel's branches against its plain version on the card: every
    C, H and W that are not multiples of a tile, D from 1 to 7 (D = 4 and
    plane counts the per-C plane group does not divide), and the 11-view
    tank_test sweeps of stages 1 and 2 (D = 64 and 32); fans whose taps fit
    a window, overflow it, or leave the image; both camera sets; tolerance
    as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    dev = torch.device("cuda")
    kind = cams
    for b, v, h, w, d in ((1, 2, 37, 53, 1), (2, 5, 40, 56, 4), (2, 3, 29, 70, 5),
                          (1, 4, 16, 40, 7), (1, 11, 22, 44, 64), (1, 11, 26, 50, 32)):
        feats = torch.from_numpy(rng.normal(size=(b, v, h, w, channels)).astype(np.float32))
        cams = tsyn.camera_set(kind, v, h, w)
        proj2 = torch.from_numpy(np.broadcast_to(cams, (b, *cams.shape)).astype(np.float32))
        dv = torch.from_numpy(_branch_fans(rng, fan, b, d, h, w))
        got = twc.aggregate_cost_volume(feats.to(dev), proj2.to(dev), dv.to(dev))
        want = twc.aggregate_cost_volume(feats.to(dev), proj2.to(dev), dv.to(dev), impl="torch")
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, (b, v, h, w, d)
        if fan == "outside":
            outside = [i for i in range(d) if i % 3]
            np.testing.assert_array_equal(want[:, outside].cpu().numpy(), 0.0)
            np.testing.assert_array_equal(got[:, outside].cpu().numpy(), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cams", CAMERA_SETS)
def test_cuda_kernel_on_a_view_subset(rng, cams):
    """The epipolar path's per-view fallback calls the kernel on one source
    view of one batch element: a (1, 2, H, W, C) copy of a view subset
    equals the plain version of the same subset, under both camera sets."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    dev = torch.device("cuda")
    b, v, h, w, c, d = 2, 5, 33, 45, 16, 6
    feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32)).to(dev)
    cams = tsyn.camera_set(cams, v, h, w)
    proj2 = torch.from_numpy(np.stack([cams, cams]).astype(np.float32)).to(dev)
    dv = torch.from_numpy(_branch_fans(rng, "smooth", b, d, h, w)).to(dev)
    for bi, view in ((0, 1), (1, 3)):
        sub = feats[bi:bi + 1, [0, view]].contiguous()
        rel = tgeo.relative_projections(proj2[bi:bi + 1, [0, view]])
        got = twc.warp_correlate(sub, rel, dv[bi:bi + 1])
        want = twc.warp_correlate_plain(sub, rel, dv[bi:bi + 1])
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, (bi, view)
