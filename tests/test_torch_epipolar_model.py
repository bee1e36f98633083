"""The epipolar eval path as a whole: the port's MVSNet with
warp_impl="epipolar" vs the JAX MVSNet with use_epipolar_warp, identical
weights, at 64x96, 3 views, ndepths 8/8/8, the sweep routed at every main
pass and at the stage-1 refine pass in both packages.

The JAX side runs its Pallas kernels in interpret mode (the module switch
tests/test_epipolar_kernel.py uses); this file runs that one JAX forward and
no other.  The weights start on the port's side (seeded init, random
batch-norm statistics) and reach JAX through
tools/convert_torch_ckpt.convert_state_dict.

Tolerances over the interior tests/test_epipolar_kernel.py uses (the
rectified resamples read zero padding at the border, the same in both
packages but ill-conditioned there): final depth <= 0.05 mm and
confidence <= 1e-3 as the outer bound, and ten times the measured
difference (depth 1.6e-4 mm, confidence 0) as the bound held.  The flags
the port reports equal the JAX package's ``sweep_engaged`` on the same
stage inputs: every view engaged at stage 1 (both passes) and at the stage-3
main pass, none at the stage-2 main pass, whose hypotheses (the noisy
stage-1 depth of random weights, upsampled bilinearly) fit neither fan form,
so that pass exercises the fallback inside the model in both packages.
"""

import copy
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dmvsnet_tpu.ops.pallas.epipolar_sweep as jes
from dmvsnet_tpu.core import geometry as jgeo
from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.utils import synthetic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402

H, W, V = 64, 96, 3
NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
MAIN, REFINE = (0, 1, 2), (0,)
DEPTH_TOL_MM = 2e-3      # 10x the measured 1.6e-4 mm; outer bound 0.05 mm
CONF_TOL = 1e-4          # measured 0; outer bound 1e-3
INNER = (slice(None), slice(8, H - 8), slice(12, W - 12))


@pytest.fixture(scope="module")
def outputs():
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="epipolar", epipolar_main_stages=MAIN,
                   epipolar_refine_stages=REFINE)
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    model.eval()

    imgs, cams, _ = synthetic.render_plane_views(H, W, V, depth=600.0, baseline=100.0)
    proj = {k: np.broadcast_to(p, (1, *p.shape)).copy()
            for k, p in synthetic.stage_projections(cams).items()}
    imgs = imgs[None].astype(np.float32)
    dv = np.linspace(425.0, 935.0, 48, dtype=np.float32)[None]
    args = (torch.from_numpy(imgs), {k: torch.from_numpy(p) for k, p in proj.items()},
            torch.from_numpy(dv))
    with torch.inference_mode():
        t_out = model(*args)
        model.warp_impl = "torch"
        t_exact = model(*args)
        model.warp_impl = "epipolar"

    params, stats = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 use_epipolar_warp=True, epipolar_main_stages=MAIN,
                 epipolar_refine_stages=REFINE)
    old, jes.INTERPRET = jes.INTERPRET, True
    try:
        j_out = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(imgs),
                         {k: jnp.asarray(p) for k, p in proj.items()}, jnp.asarray(dv),
                         train=False)
    finally:
        jes.INTERPRET = old
    return model, args, t_out, t_exact, j_out, proj


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_final_depth_and_confidence_match_jax(outputs):
    _, _, t_out, _, j_out, _ = outputs
    depth = t_out["depth"].numpy()
    assert depth.shape == (1, H, W) and np.isfinite(depth).all()
    dd = _maxdiff(depth[INNER], np.asarray(j_out["depth"])[INNER])
    dc = _maxdiff(t_out["photometric_confidence"].numpy()[INNER],
                  np.asarray(j_out["photometric_confidence"])[INNER])
    print(f"epipolar model parity: depth max |diff| {dd:.3e} mm, confidence {dc:.3e}")
    assert dd <= DEPTH_TOL_MM
    assert dc <= CONF_TOL


def test_flags_equal_jax_sweep_engaged(outputs):
    """The port's flags equal the JAX package's sweep_engaged at every routed
    pass (all views at stage 1 and the stage-3 main pass, the fallback at the
    stage-2 main pass); the passes that are not routed report no view."""
    _, _, t_out, _, j_out, proj = outputs
    for s, c in enumerate((32, 16, 8)):
        stage = f"stage{s + 1}"
        h, w = H >> (2 - s), W >> (2 - s)
        fused = jgeo.fuse_projection(jnp.asarray(proj[stage][0]))
        for key, dv_key, routed in (("sweep_engaged", "depth_values", s in MAIN),
                                    ("sweep_engaged_refine", "depth_values_c", s in REFINE)):
            flags = t_out[stage][key]
            assert flags.shape == (1, V - 1) and flags.dtype == torch.bool
            if not routed:
                assert not flags.any(), (stage, key)
                continue
            dv = j_out[stage][dv_key][0]
            want = [bool(jes.sweep_engaged(jgeo.relative_projection(fused[v], fused[0]),
                                           dv, h, w, c)) for v in range(1, V)]
            assert flags[0].tolist() == want, (stage, key)
            assert want == [(stage, key) != ("stage2", "sweep_engaged")] * (V - 1), (stage, key)


def test_the_sweep_changes_the_result_within_the_numerics_gate(outputs):
    """The epipolar model differs from the exact model (the sweep ran), and
    stays within NUMERICS.json tol.epi_* of it over the interior."""
    _, _, t_out, t_exact, _, _ = outputs
    diff = np.abs(t_out["depth"].numpy() - t_exact["depth"].numpy())[INNER]
    assert diff.max() > 0.0
    assert "sweep_engaged" not in t_exact["stage1"]
    assert diff.mean() <= 0.5 and np.percentile(diff, 99) <= 5.0 and diff.max() <= 60.0


def test_training_mode_sends_every_pass_to_the_exact_path(outputs):
    """A module in training mode takes no sweep: no flag is set, and the
    gradient reaches the features (the sweep itself would raise)."""
    model, args, _, _, _, _ = outputs
    out = copy.deepcopy(model).train()(*args)  # a copy: the forward updates batch statistics
    for s in range(3):
        st = out[f"stage{s + 1}"]
        assert not st["sweep_engaged"].any() and not st["sweep_engaged_refine"].any()
    assert out["depth"].requires_grad
    with pytest.raises(RuntimeError, match="no gradient"):
        model(*args)  # eval mode with autograd on: the sweep refuses
