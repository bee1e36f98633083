"""The bf16 compute policies of the port against the JAX package at bf16.

* blocks (ConvBlock 2-D / 3-D, DeconvBlock 2-D / 3-D, PlainConv) in eval
  and train mode, the feature net and both cost U-Nets in eval mode, each
  against the JAX module at ``dtype=bfloat16`` on the same bf16 inputs, the
  JAX U-Nets with ``fold_level0=False``: the ``models/blocks.py`` form,
  which the port runs (eval batch norm in fp32 arithmetic, the result in
  bf16), not the fold-then-apply form of ``models/folded.py``;
* the cost pass on bf16 features against
  ``aggregate_cost_volume_pallas(interpret=True)``: fp32 output, gradients
  in bf16;
* eval through the port's CLI at ``--feature_dtype bfloat16
  --costreg_dtype bfloat16`` (64x96, 3 views, ndepths 8/8/8, the test's
  weights via ``--resume``) against one jitted JAX forward of
  ``MVSNet(feature_dtype=bf16, costreg_dtype=bf16, fold_level0=False)`` on
  the batch the CLI's dataset loads; ``--compute_dtype bfloat16`` writes the
  same maps bit for bit (the cost passes upcast bf16 features, so the
  compute dtype changes only what the two nets follow; the JAX package's
  Pallas path has the same contract);
* one train step at ``compute_dtype=bfloat16`` (32x64): feature gradients
  in bf16 and finite, loss within 1e-2 of the fp32 step.

Weights: the port's seeded init with random batch-norm parameters and
statistics, crossing to JAX through ``convert.jax_tree_from_state_dict``.

Tolerances.  bf16 keeps 8 significant bits, so two implementations that
round an fp32 result to bf16 differ by one bf16 step wherever their fp32
results straddle a rounding boundary, and a U-Net carries such flips
through 12-15 layers.  Each bound is 10x the difference measured with
torch 2.13 and jax 0.9 on the CPU (``MEASURED``), as a multiple of
max|JAX output|: blocks (output and, in train mode, the new running
statistics), feature net, U-Nets and the cost pass's gradient (one bf16
step is 2^-8 to 2^-7 of a value, so 10x is a few steps).  The cost pass:
atol 2e-4 (the JAX package's own bound for its bf16 Pallas entry).  Depth
maps: ``NUMERICS.json`` ``tol`` (mean 0.2 / p99 2 / max 10 mm) and 10x the
measured max; confidence 10x the measured max.
"""

import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu.models import blocks as jblocks
from dmvsnet_tpu.models import cost_reg as jcr
from dmvsnet_tpu.models.feature_net import FeatureNet as JFeatureNet
from dmvsnet_tpu.ops.pallas import aggregate_cost_volume_pallas
from dmvsnet_tpu.utils import synthetic as jsyn
from dmvsnet_tpu_torch import cli
from dmvsnet_tpu_torch.convert import jax_tree_from_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.data import io
from dmvsnet_tpu_torch.data.general_eval import GeneralEvalDataset
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models import blocks as tblocks
from dmvsnet_tpu_torch.models import cost_reg as tcr
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.models.feature_net import FeatureNet
from dmvsnet_tpu_torch.ops import warp_correlate as wc
from dmvsnet_tpu_torch.utils import synthetic

H, W, V = 64, 96, 3
NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
TOL = json.load(open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "NUMERICS.json")))["tol"]
# max |port - JAX| / max |JAX| measured with torch 2.13 (CPU) and jax 0.9
# (CPU), rounded up; the bounds are 10x these.  The 2-D convs differ by one
# bf16 step where the fp32 sums straddle a rounding boundary (XLA's 2-D
# conv and the bias add round separately), the JAX 3-D convs (its D-dense
# form) agree bit for bit; depths in mm at ~600 mm, absolute
MEASURED = dict(blocks=7.0e-3, stats=7.2e-5, feature_net=1.1e-2, cost_reg=5.3e-3,
                cost_pass_grad=8.7e-4, depth_mm=0.122, conf=2.4e-7)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs beside other workers, where a
    process that spins a thread per core slows every one of them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _bound(name: str, floor: float) -> float:
    """10x the measured difference, and no less than ``floor`` (one bf16
    step of the output's scale where the measurement was 0)."""
    return max(10.0 * MEASURED[name], floor)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_bn(rng, params, stats):
    def walk(node, fn, path=()):
        return {k: walk(v, fn, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
                for k, v in node.items()}

    def p_fn(path, v):
        if path[-2:] == ("bn", "scale"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if path[-2:] == ("bn", "bias"):
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v)

    def s_fn(path, v):
        if path[-1] == "mean":
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    return walk(params, p_fn), walk(stats, s_fn)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _apply(jm, variables, x, **kw):
    """``jm.apply`` jitted (a module's ops one by one would each compile)."""
    return jax.jit(functools.partial(jm.apply, **kw))(variables, x)


# ------------------------------------------------------------------ blocks

def _block_cases(dims):
    return [
        ("conv s1", jblocks.ConvBlock(6, kernel=3, stride=1, dims=dims, dtype=jnp.bfloat16),
         tblocks.ConvBlock(4, 6, 3, 1, dims=dims, dtype=BF16)),
        ("conv s2", jblocks.ConvBlock(6, kernel=3, stride=2, dims=dims, dtype=jnp.bfloat16),
         tblocks.ConvBlock(4, 6, 3, 2, dims=dims, dtype=BF16)),
        ("deconv", jblocks.DeconvBlock(5, kernel=3, dims=dims, dtype=jnp.bfloat16),
         tblocks.DeconvBlock(4, 5, 3, dims=dims, dtype=BF16)),
    ]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_blocks_bf16_match_jax(rng, dims, train):
    """Output dtype (bf16 in eval, fp32 in train), values and, in train
    mode, the new fp32 running statistics."""
    shape = (2, 6, 10, 4) if dims == 2 else (1, 4, 6, 8, 4)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    to_cf = (0, dims + 1, *range(1, dims + 1))
    to_cl = (0, *range(2, dims + 2), 1)
    for name, jm, tm in _block_cases(dims):
        variables = jax.jit(jm.init)(jax.random.PRNGKey(1), x)
        params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                      _np_tree(variables["batch_stats"]))
        if train:
            want, mutated = _apply(jm, {"params": params, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
        else:
            want = _apply(jm, {"params": params, "batch_stats": stats}, x)
        sd = state_dict_from_jax({"feature": {"conv0_0": params}},
                                 {"feature": {"conv0_0": stats}})
        tm.load_state_dict({k[len("feature.conv0.0."):]: v for k, v in sd.items()},
                           strict=False)
        tm.train(train)
        xt = torch.from_numpy(_f32(x)).to(BF16).permute(to_cf)
        got = tm(xt)
        assert got.dtype == (torch.float32 if train else BF16), name
        assert str(want.dtype) == ("float32" if train else "bfloat16"), name
        d = _rel(got.detach().float().permute(to_cl).numpy(), _f32(want))
        print(f"{name} {dims}-D train={train}: rel max diff {d:.2e}")
        assert d <= _bound("blocks", 2 ** -8), name
        if train:
            new = mutated["batch_stats"]["bn"]
            assert tm.bn.running_mean.dtype == torch.float32
            ds = max(_rel(tm.bn.running_mean.numpy(), new["mean"]),
                     _rel(tm.bn.running_var.numpy(), new["var"]))
            print(f"{name} {dims}-D running statistics: rel max diff {ds:.2e}")
            assert ds <= _bound("stats", 1e-6), name


@pytest.mark.parametrize("dims,kernel,bias", [(2, 1, True), (2, 3, False), (3, 3, False)])
def test_plain_conv_bf16_matches_jax(rng, dims, kernel, bias):
    shape = (2, 6, 10, 4) if dims == 2 else (1, 4, 6, 8, 4)
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jnp.bfloat16)
    jm = jblocks.PlainConv(5, kernel=kernel, dims=dims, use_bias=bias, dtype=jnp.bfloat16)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), x)["params"])
    want = _apply(jm, {"params": params}, x)
    tm = tblocks.PlainConv(4, 5, kernel=kernel, dims=dims, use_bias=bias, dtype=BF16)
    sd = state_dict_from_jax({"feature": {"out1": params}}, {})
    tm.load_state_dict({k[len("feature.out1."):]: v for k, v in sd.items()})
    to_cf = (0, dims + 1, *range(1, dims + 1))
    got = tm(torch.from_numpy(_f32(x)).to(BF16).permute(to_cf))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    d = _rel(got.detach().float().permute(0, *range(2, dims + 2), 1).numpy(), _f32(want))
    print(f"plain conv {dims}-D k{kernel} bias={bias}: rel max diff {d:.2e}")
    assert d <= _bound("blocks", 2 ** -8)


def test_feature_net_bf16_matches_jax(rng):
    """Eval mode: the six feature maps in bf16."""
    x = jnp.asarray(rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32))
    jm = JFeatureNet(8, dtype=jnp.bfloat16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    want = _apply(jm, {"params": params, "batch_stats": stats}, x)
    tm = FeatureNet(8, dtype=BF16)
    sd = state_dict_from_jax({"feature": params}, {"feature": stats})
    tm.load_state_dict({k[len("feature."):]: v for k, v in sd.items()}, strict=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    worst = 0.0
    for k, w in want.items():
        assert got[k].dtype == BF16 and str(w.dtype) == "bfloat16", k
        worst = max(worst, _rel(got[k].float().permute(0, 2, 3, 1).numpy(), _f32(w)))
    print(f"feature net bf16: rel max diff {worst:.2e}")
    assert worst <= _bound("feature_net", 2 ** -8)


@pytest.mark.parametrize("refine", [False, True])
def test_cost_reg_bf16_matches_jax(rng, refine):
    d = 4 if refine else 8
    x = jnp.asarray(rng.normal(size=(1, d, 16, 24, 2)).astype(np.float32)).astype(jnp.bfloat16)
    jcls, tcls = ((jcr.CostRegNetRefine, tcr.CostRegNetRefine) if refine
                  else (jcr.CostRegNet, tcr.CostRegNet))
    jm = jcls(8, dtype=jnp.bfloat16, fold_level0=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3), x)
    params, stats = _randomize_bn(rng, _np_tree(variables["params"]),
                                  _np_tree(variables["batch_stats"]))
    want = _apply(jm, {"params": params, "batch_stats": stats}, x)
    top = "cost_reg_refine_0" if refine else "cost_reg_0"
    prefix = "cost_regularization_refine.0." if refine else "cost_regularization.0."
    tm = tcls(8, dtype=BF16)
    sd = state_dict_from_jax({top: params}, {top: stats})
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=False)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(_f32(x)).to(BF16).permute(0, 4, 1, 2, 3))
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    dd = _rel(got.float().permute(0, 2, 3, 4, 1).numpy(), _f32(want))
    print(f"cost reg bf16 refine={refine}: rel max diff {dd:.2e}")
    assert dd <= _bound("cost_reg", 2 ** -8)


# --------------------------------------------------------------- cost pass

def test_cost_pass_on_bf16_features_matches_pallas(rng):
    """The port's cost pass on bf16 features (the kernel's wrapper; on CPU
    tensors its plain version) against the JAX Pallas entry in interpret
    mode: the entry upcasts, the cost volume is fp32 and the feature
    gradient comes back in bf16."""
    b, h, w, c, d = 1, 24, 160, 8, 4
    feats32 = rng.normal(size=(b, 3, h, w, c)).astype(np.float32)
    cams = np.stack([jsyn.camera_stack(1.2 * w, 1.2 * w, w / 2, h / 2, tx=-6.0 * i,
                                       angle=0.012 * i) for i in range(3)])
    proj2 = cams[None].astype(np.float32)
    dv = np.sort(rng.uniform(400, 700, (b, d, h, w)).astype(np.float32), axis=1)
    cot = rng.normal(size=(b, d, h, w, 2)).astype(np.float32)

    jfeats = [jnp.asarray(feats32[:, i]).astype(jnp.bfloat16) for i in range(3)]

    def loss(*fs):
        out = aggregate_cost_volume_pallas(list(fs), jnp.asarray(proj2), jnp.asarray(dv),
                                           interpret=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                   has_aux=True))(*jfeats)
    assert want.dtype == jnp.float32

    tfeats = torch.from_numpy(feats32).to(BF16).requires_grad_()
    got = wc.aggregate_cost_volume(tfeats, torch.from_numpy(proj2), torch.from_numpy(dv))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4, rtol=0)
    (got * torch.from_numpy(cot)).sum().backward()
    assert tfeats.grad.dtype == BF16
    tgrad = tfeats.grad.float().numpy()
    assert np.isfinite(tgrad).all()
    want_grad = np.stack([_f32(g) for g in jgrads], axis=1)
    dg = _rel(tgrad, want_grad)
    print(f"cost pass bf16 gradient: rel max diff {dg:.2e}")
    assert dg <= _bound("cost_pass_grad", 2 ** -8)


# -------------------------------------------------------- model, CLI, step

def _port_weights() -> dict:
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="torch")
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.state_dict()


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_eval")
    data = root / "data"
    synthetic.write_eval_scene(str(data), "scan1", height=H, width=W, n_views=V)
    sd = _port_weights()
    torch.save(sd, root / "weights.pt")
    base = ["--test", "--preset", "dtu_test", "--device", "cpu", "--datapath", str(data),
            "--testlist", "scan1", "--ndepths", *map(str, NDEPTHS), "--max_h", str(H),
            "--max_w", str(W), "--num_view", str(V), "--filter_method", "none",
            "--resume", str(root / "weights.pt")]
    maps = {}
    for name, flags in (("nets", ["--feature_dtype", "bfloat16", "--costreg_dtype", "bfloat16"]),
                        ("compute", ["--compute_dtype", "bfloat16"]),
                        ("fp32", [])):
        out = root / name
        summary = cli.main(base + ["--outdir", str(out)] + flags)
        assert summary["maps"] == V
        maps[name] = [tuple(io.read_pfm(str(out / "scan1" / kind / f"{i:08d}.pfm"))[0]
                            for kind in ("depth_est", "confidence")) for i in range(V)]

    ds = GeneralEvalDataset(str(data), ["scan1"], nviews=V, ndepths=192, interval_scale=1.06,
                            max_h=H, max_w=W, inverse_depth=True)
    samples = [ds[i] for i in range(V)]
    imgs = jnp.asarray(np.stack([s["imgs"] for s in samples]))
    proj = {k: jnp.asarray(np.stack([s["proj_matrices"][k] for s in samples]))
            for k in samples[0]["proj_matrices"]}
    dv = jnp.asarray(np.stack([s["depth_values"] for s in samples]))
    params, stats = jax_tree_from_state_dict(sd)
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 feature_dtype=jnp.bfloat16, costreg_dtype=jnp.bfloat16, fold_level0=False)
    j_out = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, imgs, proj, dv)
    return maps, np.asarray(j_out["depth"]), np.asarray(j_out["photometric_confidence"])


def test_cli_eval_bf16_nets_match_jax(eval_runs):
    maps, j_depth, j_conf = eval_runs
    depth = np.stack([m[0] for m in maps["nets"]]).astype(np.float64)
    conf = np.stack([m[1] for m in maps["nets"]]).astype(np.float64)
    diff = np.abs(depth - j_depth)
    dc = float(np.abs(conf - j_conf).max())
    print(f"bf16 nets vs JAX: depth mean {diff.mean():.3e} p99 {np.percentile(diff, 99):.3e} "
          f"max {diff.max():.3e} mm, confidence max {dc:.3e}")
    assert np.isfinite(depth).all()
    assert diff.mean() <= TOL["mean_mm"] and np.percentile(diff, 99) <= TOL["p99_mm"]
    assert diff.max() <= min(TOL["max_mm"], _bound("depth_mm", 1e-3))
    assert dc <= _bound("conf", 1e-5)
    # the policies did change the maps: bf16 nets are not the fp32 model
    fp32 = np.stack([m[0] for m in maps["fp32"]])
    assert np.abs(fp32 - depth).max() > 0


def test_cli_compute_dtype_writes_the_same_maps(eval_runs):
    maps = eval_runs[0]
    for (d0, c0), (d1, c1) in zip(maps["nets"], maps["compute"]):
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(c0, c1)


def test_bf16_train_step_feature_gradients(rng):
    """One train step at compute_dtype=bfloat16 against the fp32 step on
    the same weights: loss within 1e-2 relative; the features reach the
    cost pass in bf16 and their gradient comes back in bf16, finite."""
    sd = _port_weights()
    for k, v in sd.items():
        if ".prob." in k:
            v.mul_(0.2)
    batch = synthetic.make_batch(batch=1, n_views=V, height=32, width=64, n_depths=32)
    tb = {k: ({s: torch.from_numpy(x) for s, x in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in batch.items()}
    losses, seen = {}, []
    real = wc.aggregate_cost_volume

    def recording(feats, *args):
        feats.register_hook(lambda g: seen.append((feats.dtype, g.dtype,
                                                   bool(torch.isfinite(g.float()).all()))))
        return real(feats, *args)

    mp = pytest.MonkeyPatch()
    mp.setattr(wc, "aggregate_cost_volume", recording)
    try:
        for dtype in (torch.float32, BF16):
            model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                           warp_impl="torch", dtype=dtype)
            model.load_state_dict(sd)
            seen.clear()
            opt, sched = make_optimizer(model.parameters(), lambda n: 0.0)
            scalars, _ = make_train_step()(model, opt, sched, tb)
            losses[dtype] = float(scalars["loss"])
    finally:
        mp.undo()
    assert len(seen) == 6 and all(s == (BF16, BF16, True) for s in seen), seen
    rel = abs(losses[BF16] - losses[torch.float32]) / abs(losses[torch.float32])
    print(f"bf16 train step: loss {losses[BF16]:.6f} vs fp32 {losses[torch.float32]:.6f} "
          f"(rel {rel:.2e})")
    assert np.isfinite(losses[BF16]) and rel <= 1e-2
