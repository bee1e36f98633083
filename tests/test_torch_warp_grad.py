"""The port's cost-pass gradients vs the JAX package: autograd of the plain
PyTorch cost pass (the CPU path of the kernel wrapper, and the plain
version of both adjoint CUDA kernels) against ``jax.grad`` of
dmvsnet_tpu.ops.warp.aggregate_cost_volume (XLA path) and of
aggregate_cost_volume_pallas in interpret mode (the custom VJP with the two
adjoint Pallas kernels), at the shapes of tests/test_pallas_warp.py.

Tolerance: 5e-4 absolute on gradients of unit-variance features and
cotangents, as tests/test_pallas_warp.py uses for the Pallas VJP (band
matmuls reassociate); the XLA path agrees to 1e-5.  The sampling grid
carries no gradient: depth hypotheses and projections get None.  The CUDA
kernels are held against the plain version on the card by the tests marked
``cuda`` and by chip_smoke.py, among them on bf16 features upcast to fp32
(the bf16 policies' cost passes) and per source view (the adaptive cost
pass: kernel 1 and both adjoints on each (reference, source) pair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmvsnet_tpu.ops import warp as jwarp
from dmvsnet_tpu.ops.pallas.warp_correlate import aggregate_cost_volume_pallas
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch.core import geometry as tgeo
from dmvsnet_tpu_torch.ops import warp_correlate as twc
from dmvsnet_tpu_torch.utils import synthetic as tsyn

XLA_TOL = 1e-5
PALLAS_TOL = 5e-4
CAMERA_SETS = ["translate", "orbit"]


def _case(rng, c, views, b=1, h=24, w=160, d=4):
    feats = rng.normal(size=(b, views, h, w, c)).astype(np.float32)
    cams = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2,
                                       tx=-6.0 * i, angle=0.012 * i) for i in range(views)])
    proj2 = np.broadcast_to(cams, (b, *cams.shape)).astype(np.float32).copy()
    dv = np.sort(rng.uniform(400, 700, (b, d, h, w)).astype(np.float32), axis=1)
    cot = rng.normal(size=(b, d, h, w, 2)).astype(np.float32)
    return feats, proj2, dv, cot


def _port_grads(feats, proj2, dv, cot, impl="cuda"):
    f = torch.from_numpy(feats).requires_grad_()
    # depth_values_c-style hypotheses: they require grad in the model
    depth = torch.from_numpy(dv).requires_grad_()
    proj = torch.from_numpy(proj2).requires_grad_()
    out = twc.aggregate_cost_volume(f, proj, depth, impl=impl)
    (out * torch.from_numpy(cot)).sum().backward()
    return f.grad.numpy(), depth.grad, proj.grad


def _jax_grads(feats, proj2, dv, cot, pallas):
    views = feats.shape[1]

    def loss(fs, dvj):
        if pallas:
            out = aggregate_cost_volume_pallas(list(fs), jnp.asarray(proj2), dvj, interpret=True)
        else:
            out = jwarp.aggregate_cost_volume(list(fs), jnp.asarray(proj2), dvj)
        return jnp.sum(out * jnp.asarray(cot))

    fs = tuple(jnp.asarray(feats[:, i]) for i in range(views))
    g_f, g_dv = jax.grad(loss, argnums=(0, 1))(fs, jnp.asarray(dv))
    return np.stack([np.asarray(g) for g in g_f], axis=1), np.asarray(g_dv)


@pytest.mark.parametrize("channels,views", [(8, 3), (32, 2)])
def test_cost_pass_gradients_match_xla_and_pallas(rng, channels, views):
    feats, proj2, dv, cot = _case(rng, channels, views)
    ours, g_depth, g_proj = _port_grads(feats, proj2, dv, cot)
    assert ours.shape == feats.shape and ours.dtype == np.float32
    assert g_depth is None and g_proj is None
    xla, xla_dv = _jax_grads(feats, proj2, dv, cot, pallas=False)
    pal, pal_dv = _jax_grads(feats, proj2, dv, cot, pallas=True)
    np.testing.assert_allclose(ours, xla, atol=XLA_TOL, rtol=0)
    np.testing.assert_allclose(ours, pal, atol=PALLAS_TOL, rtol=0)
    # the JAX package gives the grid zero cotangents; the port gives None
    np.testing.assert_array_equal(xla_dv, 0.0)
    np.testing.assert_array_equal(pal_dv, 0.0)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_grid_carries_no_gradient_on_either_path(rng, impl):
    """Hypotheses computed from tensors that require grad (as the refine
    pass's depth_values_c are) must not pass a gradient through the
    sampling coordinates: on the wrapper's CPU path and on the plain path."""
    feats, proj2, dv, cot = _case(rng, 8, 3, b=2, h=12, w=20)
    base = torch.from_numpy(dv).requires_grad_()
    f = torch.from_numpy(feats).requires_grad_()
    out = twc.aggregate_cost_volume(f, torch.from_numpy(proj2), base * 1.0 + 0.5, impl=impl)
    (out * torch.from_numpy(cot)).sum().backward()
    assert base.grad is None
    assert f.grad is not None and np.isfinite(f.grad.numpy()).all()
    assert float(f.grad.abs().max()) > 0


def test_grad_plain_equals_autograd_and_splits_by_slot(rng):
    """warp_correlate_grad_plain is autograd of the plain forward; the two
    per-kernel wrappers fill disjoint slots of one buffer, and the combined
    wrapper returns the whole gradient (CPU tensors: no launch)."""
    feats, proj2, dv, cot = _case(rng, 16, 4, b=2, h=12, w=20, d=3)
    f, depth, ct = (torch.from_numpy(x) for x in (feats, dv, cot))
    rel = tgeo.relative_projections(torch.from_numpy(proj2))
    want, _, _ = _port_grads(feats, proj2, dv, cot, impl="torch")
    before = dict(twc.LAUNCHES)
    whole = twc.warp_correlate_grad_plain(f, rel, depth, ct)
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(twc.warp_correlate_grad(f, rel, depth, ct).numpy(),
                                  whole.numpy())
    buf = torch.full_like(f, float("nan"))
    twc.warp_correlate_grad_ref(f, rel, depth, ct, buf)
    assert torch.isnan(buf[:, 1:]).all() and not torch.isnan(buf[:, 0]).any()
    twc.warp_correlate_grad_src(f, rel, depth, ct, buf)
    np.testing.assert_allclose(buf.numpy(), want, atol=1e-6, rtol=0)
    assert twc.LAUNCHES == before
    with pytest.raises(ValueError, match="cot must be"):
        twc.warp_correlate_grad(f, rel, depth, ct[..., :1])
    with pytest.raises(ValueError, match="out must match feats"):
        twc.warp_correlate_grad_src(f, rel, depth, ct, buf[:, :2])


def test_out_of_image_fans_give_finite_zero_contributions(rng):
    """Zero, negative and huge hypotheses (refine fans reach them): the
    gradient stays finite, and planes whose taps all fall outside the
    source images add exactly nothing."""
    b, v, h, w, c = 1, 3, 12, 20, 8
    feats, proj2, _, _ = _case(rng, c, v, b=b, h=h, w=w)
    dv = np.stack([np.full((b, h, w), x, np.float32)
                   for x in (550.0, 0.0, -300.0, 1e30, 1e-30)], axis=1)
    cot = rng.normal(size=(b, 5, h, w, 2)).astype(np.float32)
    g_all, _, _ = _port_grads(feats, proj2, dv, cot)
    assert np.isfinite(g_all).all()
    # planes at (or next to) depth 0 project far outside every source image
    # (z == 0 takes the 1e-5 guard); negative and huge depths still land
    # inside.  Dropping the outside planes changes nothing.
    f = torch.from_numpy(feats)
    rel = tgeo.relative_projections(torch.from_numpy(proj2))
    outside = twc.warp_correlate_plain(f, rel, torch.from_numpy(dv[:, [1, 4]]))
    np.testing.assert_array_equal(outside.numpy(), 0.0)
    g_two, _, _ = _port_grads(feats, proj2, dv[:, [0, 2, 3]], cot[:, [0, 2, 3]])
    np.testing.assert_allclose(g_all, g_two, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("cams", CAMERA_SETS)
def test_cuda_adjoint_kernels_match_plain_on_card(rng, cams):
    """Both adjoint CUDA kernels vs autograd of the plain forward on the
    card, every channel width, per-pixel hypotheses including zero and
    negative depths, through the autograd.Function, under both camera sets.
    Tolerance 1e-4 * max(1, max|plain|): same taps and weights bit for bit,
    sums in another order (and, for the scatter, in an order that varies
    run to run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    dev = torch.device("cuda")
    b, v, h, w, d = 2, 5, 40, 56, 6
    rel = tgeo.relative_projections(torch.from_numpy(
        np.stack([tsyn.camera_set(cams, v, h, w)] * b).astype(np.float32)).to(dev))
    for c in twc.CHANNELS:
        feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32)).to(dev)
        dv = rng.uniform(-100, 900, (b, d, h, w)).astype(np.float32)
        dv[:, 0, 0, :4] = 0.0  # the z == 0 guard
        depth = torch.from_numpy(dv).to(dev)
        cot = torch.from_numpy(rng.normal(size=(b, d, h, w, 2)).astype(np.float32)).to(dev)
        f, r, dep = (t.clone().requires_grad_() for t in (feats, rel, depth))
        before = dict(twc.LAUNCHES)
        twc.warp_correlate(f, r, dep).backward(cot)
        torch.cuda.synchronize()
        # one launch of each of kernels 1-3; the gated pass (forward only,
        # eval) none
        assert {k: twc.LAUNCHES[k] - before[k] for k in before} == {
            **dict.fromkeys(before, 1), "gated_warp_correlate": 0}
        assert r.grad is None and dep.grad is None
        want = twc.warp_correlate_grad_plain(feats, rel, depth, cot)
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (f.grad - want).abs().max().item() <= tol, c


def _branch_fans(rng, kind, b, d, h, w):
    """(B, D, H, W) hypotheses for the scatter's branches: "smooth"
    inverse-depth fans (a tile's taps move a fraction of a pixel per plane,
    so they combine in the window and in the register cells), "noise"
    white-noise depths that cross zero, "outside" a plane inside the image
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


def _card_case(rng, c, b, v, h, w, d, fan, tx=-5.0, cams="translate"):
    dev = torch.device("cuda")
    feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32)).to(dev)
    cams = tsyn.camera_set(cams, v, h, w, tx=tx)
    rel = tgeo.relative_projections(torch.from_numpy(
        np.broadcast_to(cams, (b, *cams.shape)).astype(np.float32)).to(dev))
    depth = torch.from_numpy(_branch_fans(rng, fan, b, d, h, w)).to(dev)
    cot = torch.from_numpy(rng.normal(size=(b, d, h, w, 2)).astype(np.float32)).to(dev)
    return feats, rel, depth, cot


@pytest.mark.cuda
@pytest.mark.parametrize("cams", CAMERA_SETS)
@pytest.mark.parametrize("channels", [8, 16, 32])
@pytest.mark.parametrize("fan", ["smooth", "noise", "outside"])
def test_cuda_adjoint_branches_on_card(rng, channels, fan, cams):
    """Both adjoint kernels against autograd of the plain forward on the
    card, through the autograd.Function, at the scatter's branches: every
    C, H and W that are not multiples of its tile, D from 1 to 7, fans whose
    taps fit the window, overflow it, or leave the image; and deep sweeps,
    whose planes the reference gradient takes in runs with a ragged last
    one: D = 17, D = 48 (the dtu s1 main sweep) and the 11-view tank_test
    sweeps D = 64 and 32 (stages 1 and 2); both camera sets.  Tolerance as
    above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    for b, v, h, w, d in ((1, 2, 37, 53, 1), (2, 5, 40, 56, 4), (2, 3, 29, 70, 5),
                          (1, 4, 16, 40, 7), (2, 3, 13, 29, 17), (1, 5, 19, 37, 48),
                          (1, 11, 14, 30, 64), (1, 11, 18, 34, 32)):
        feats, rel, depth, cot = _card_case(rng, channels, b, v, h, w, d, fan, cams=cams)
        f = feats.clone().requires_grad_()
        twc.warp_correlate(f, rel, depth).backward(cot)
        want = twc.warp_correlate_grad_plain(feats, rel, depth, cot)
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (f.grad - want).abs().max().item() <= tol, (b, v, h, w, d)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [8, 16, 32])
def test_cuda_scatter_counters_on_card(rng, channels):
    """The scatter's counters: on smooth fans a lane's consecutive planes
    share a bilinear cell, so fewer float4 atomics reach device memory than
    half the 2 per valid tap of a scatter that combines nothing, and cells
    change less often than planes; on white-noise depths over a wide
    baseline nearly every plane moves the cell; with or without counters
    the result is the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    for fan, tx, (b, v, h, w, d) in (("smooth", -5.0, (2, 5, 40, 72, 8)),
                                     ("noise", -40.0, (1, 3, 24, 256, 4))):
        feats, rel, depth, cot = _card_case(rng, channels, b, v, h, w, d, fan, tx=tx)
        stats = torch.zeros(2, dtype=torch.int64, device=feats.device)
        got = twc.warp_correlate_grad_src(feats, rel, depth, cot, stats=stats)
        want = twc.warp_correlate_grad_plain(feats, rel, depth, cot)
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got[:, 1:] - want[:, 1:]).abs().max().item() <= tol, fan
        atomics, moves = stats.tolist()
        lane_planes = b * (v - 1) * h * w * (channels // 8) * (d - 1)
        if fan == "smooth":
            reached = int((want[:, 1:] != 0).any(-1).sum())  # source pixels reached
            uncombined = b * d * h * w * (v - 1) * 4 * channels // 4  # at most
            assert reached * channels // 4 <= atomics < uncombined // 2, stats
            assert 0 < moves < lane_planes // 2, stats
        else:
            assert moves > lane_planes // 2, stats


def test_scatter_counters_are_checked(rng):
    feats, proj2, dv, cot = _case(rng, 8, 3, b=1, h=12, w=20, d=2)
    f, depth, ct = (torch.from_numpy(x) for x in (feats, dv, cot))
    rel = tgeo.relative_projections(torch.from_numpy(proj2))
    with pytest.raises(ValueError, match="stats must be"):
        twc.warp_correlate_grad_src(f, rel, depth, ct, stats=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="stats must be"):
        twc.warp_correlate_grad_src(f, rel, depth, ct, stats=torch.zeros(2))


@pytest.mark.cuda
def test_cuda_kernels_on_bf16_upcast_features_on_card(rng):
    """Kernels 1-3 on bf16 features upcast to fp32 (what the cost pass's
    entry hands them) against their plain versions on the card, tolerance
    1e-4 * max(1, max|plain|); through the entry itself the cost volume is
    fp32 and the feature gradient bf16 and finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    dev = torch.device("cuda")
    b, v, h, w, d = 2, 5, 40, 56, 6
    proj2 = torch.from_numpy(np.stack([tsyn.camera_set("orbit", v, h, w)] * b)
                             .astype(np.float32)).to(dev)
    rel = tgeo.relative_projections(proj2)
    for c in twc.CHANNELS:
        feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32))
        feats = feats.to(dev).to(torch.bfloat16)
        depth = torch.from_numpy(rng.uniform(400, 900, (b, d, h, w)).astype(np.float32)).to(dev)
        cot = torch.from_numpy(rng.normal(size=(b, d, h, w, 2)).astype(np.float32)).to(dev)
        up = feats.float()
        got = twc.warp_correlate(up, rel, depth)
        want = twc.warp_correlate_plain(up, rel, depth)
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item()), c
        grad = twc.warp_correlate_grad(up, rel, depth, cot)
        want_grad = twc.warp_correlate_grad_plain(up, rel, depth, cot)
        tol = 1e-4 * max(1.0, want_grad.abs().max().item())
        assert (grad - want_grad).abs().max().item() <= tol, c
        f = feats.clone().requires_grad_()
        cost = twc.aggregate_cost_volume(f, proj2, depth)
        assert cost.dtype == torch.float32
        (cost * cot).sum().backward()
        torch.cuda.synchronize()
        assert f.grad.dtype == torch.bfloat16 and bool(torch.isfinite(f.grad.float()).all()), c


@pytest.mark.cuda
def test_cuda_per_view_kernel_on_card(rng):
    """The adaptive cost pass on the card: kernel 1 once per source view on
    the (reference, source) pair and, in the backward, kernels 2 and 3 once
    per view, against the plain version per pair; value and feature
    gradient within 1e-4 * max(1, max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU suite checks the plain version")
    from dmvsnet_tpu_torch.models.blocks import init_weights
    from dmvsnet_tpu_torch.models.cost_reg import AggWeightNetVolume

    dev = torch.device("cuda")
    b, v, h, w, d = 2, 5, 40, 56, 6
    proj2 = torch.from_numpy(np.stack([tsyn.camera_set("orbit", v, h, w)] * b)
                             .astype(np.float32)).to(dev)
    net = AggWeightNetVolume()
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()

    def gate(sim):
        return sim * torch.sigmoid(
            net(sim.permute(0, 4, 1, 2, 3).contiguous()).permute(0, 2, 3, 4, 1))

    for c in (8, 16, 32):
        feats = torch.from_numpy(rng.normal(size=(b, v, h, w, c)).astype(np.float32)).to(dev)
        depth = torch.from_numpy(rng.uniform(400, 900, (b, d, h, w)).astype(np.float32)).to(dev)
        cot = torch.from_numpy(rng.normal(size=(b, d, h, w, 2)).astype(np.float32)).to(dev)
        out = {}
        for impl in ("cuda", "torch"):
            f = feats.clone().requires_grad_()
            before = dict(twc.LAUNCHES)
            cost = twc.aggregate_cost_volume_adaptive(f, proj2, depth, gate, impl)
            (cost * cot).sum().backward()
            torch.cuda.synchronize()
            launched = {k: twc.LAUNCHES[k] - before[k] for k in before}
            assert launched == {**dict.fromkeys(before, v - 1 if impl == "cuda" else 0),
                                "gated_warp_correlate": 0}, launched
            out[impl] = (cost.detach(), f.grad)
        for got, want in zip(out["cuda"], out["torch"]):
            assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item()), c
