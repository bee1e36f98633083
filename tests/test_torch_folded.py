"""The folded level-0 execution plan of the port (``models/folded.py``,
``fold_level0``) against the JAX package's ``models/folded.py`` and against
the port's own unfolded plan, at 64x96, 3 views, ndepths 8/8/8 (every
stage's main pass folds there: D = 8 and 2 channels give 64).

* layouts: ``fold2d`` / ``fold3d`` / ``fold_depth`` equal the JAX ones
  after an NHWC -> NCHW transpose; fold then unfold is the identity;
* folded kernels: equal to JAX's ``folded_kernel_s1`` / ``_s2`` /
  ``_deconv`` bit for bit on converted parameters (3-D with 4 and 8 planes;
  2-D with k 1, 3, 5 and stride 1, 2), with the same padding;
* blocks: folded and unfolded execution of the same ``ConvBlock`` /
  ``DeconvBlock`` / ``PlainConv`` module: outputs and new running
  statistics within 1e-5 * max(1, max|unfolded|), in eval and train mode;
  weight gradients within 1e-5 relative (max |diff| / max |unfolded|);
* ``CostRegNet``, ``CostRegNetRefine`` and ``FeatureNet`` with
  ``fold_level0=True`` against the JAX modules with ``fold_level0=True`` on
  the same parameters (the port's seeded init with random batch-norm
  statistics, through ``convert.jax_tree_from_state_dict``, loaded back
  from ``convert.state_dict_from_jax``), eval and train (outputs and new
  running statistics): FEAT_TOL as tests/test_torch_models.py, TRAIN_TOL
  where train-mode batch norm divides by the small batch's spread;
* the whole ``MVSNet(fold_level0=True)`` against the JAX package's (one
  jitted JAX forward): depth within 0.01 mm, confidence within 1e-4
  (tests/test_torch_slice.py's tolerances);
* bf16: a folded cost U-Net at ``dtype=bfloat16`` against the JAX folded
  U-Net at bf16, within 10x the difference measured (MEASURED_BF16, as
  tests/test_torch_dtype.py bounds its bf16 modules);
* the cost model counts the same FLOPs and bytes for ``fold_level0`` True
  and False (an eval forward and a train step): under a count both run
  the unfolded plan;
* the state dict's keys are the same under every plan; the number of
  folded convolutions per forward (6 folded passes x 2 branches x 4 + 5 in
  the feature net), none under None, and a pass the shape rule declines is
  counted.

The JAX references are computed once per module: one jitted function for
the three nets (eval, train, bf16) and one jitted ``MVSNet`` forward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu.models import cost_reg as jcr
from dmvsnet_tpu.models import folded as jfolded
from dmvsnet_tpu.models.feature_net import FeatureNet as JFeatureNet
from dmvsnet_tpu_torch.convert import jax_tree_from_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.engine import profiler
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_train_step
from dmvsnet_tpu_torch.models import MVSNet, folded
from dmvsnet_tpu_torch.models.blocks import ConvBlock, DeconvBlock, PlainConv, init_weights
from dmvsnet_tpu_torch.models.cost_reg import CostRegNet, CostRegNetRefine
from dmvsnet_tpu_torch.models.feature_net import FeatureNet
from dmvsnet_tpu_torch.utils import synthetic

H, W, V = 64, 96, 3
NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
BLOCK_TOL = 1e-5
FEAT_TOL = 1e-4
# train-mode batch norm over a batch of 1 x 16 x 24 voxels: the convolutions'
# reassociation noise is divided by the batch's spread at every block
TRAIN_TOL = 1e-3
DEPTH_TOL_MM, CONF_TOL = 0.01, 1e-4
# max |port - JAX| / max |JAX| of the folded U-Nets at bf16, measured with
# torch 2.13 (CPU) and jax 0.9 (CPU); the bound is 10x this
MEASURED_BF16 = dict(costreg=4.8e-3, costreg_refine=3.9e-3)
BF16 = torch.bfloat16
# one folded (stage, pass) runs 2 branches x 4 folded convolutions
FOLDED_PER_PASS, FOLDED_FEATURE = 8, 5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _randomized(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded weights and random batch-norm parameters and statistics."""
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module


def _rand(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> None:
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), (what, err)


# ----------------------------------------------------------------- layouts

def test_layouts_match_jax_and_round_trip():
    x3, x2 = _rand((2, 6, 8, 12, 3)), _rand((2, 8, 12, 5), 1)   # NDHWC, NHWC
    t3 = torch.from_numpy(x3).permute(0, 4, 1, 2, 3)
    t2 = torch.from_numpy(x2).permute(0, 3, 1, 2)
    f3, f2 = folded.fold3d(t3), folded.fold2d(t2)
    np.testing.assert_array_equal(f3.permute(0, 2, 3, 1).numpy(), np.asarray(jfolded.fold3d(x3)))
    np.testing.assert_array_equal(f2.permute(0, 2, 3, 1).numpy(), np.asarray(jfolded.fold2d(x2)))
    np.testing.assert_array_equal(folded.fold_depth(t3).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jfolded.fold_depth(x3)))
    assert torch.equal(folded.unfold3d(f3, 6, 3), t3)
    assert torch.equal(folded.unfold2d(f2, 5), t2)


# ----------------------------------------------------------------- kernels

def _to_torch(kernel: np.ndarray) -> torch.Tensor:
    """A flax kernel through the converter (as a U-Net head's weight)."""
    sd = state_dict_from_jax({"cost_reg_0": {"cosR_small": {"prob": {"conv": {"kernel": kernel}}}}},
                             {})
    return sd["cost_regularization.0.cosR_small.prob.weight"]


KERNEL_CASES = ([("3d", d, kind, 3) for d in (4, 8) for kind in ("s1", "s2", "deconv")]
                + [("2d", 1, kind, k) for k in (1, 3, 5) for kind in ("s1", "s2")])


@pytest.mark.parametrize("dims,d,kind,k", KERNEL_CASES,
                         ids=[f"{c[0]}-d{c[1]}-{c[2]}-k{c[3]}" for c in KERNEL_CASES])
def test_folded_kernels_equal_jax(dims, d, kind, k):
    n = 3 if dims == "3d" else 2
    ci, co = 3, 5
    # flax layouts: conv (k.., ci, co), transposed conv (k.., co, ci)
    shape = (k,) * n + ((co, ci) if kind == "deconv" else (ci, co))
    kern = _rand(shape, 7)
    w = _to_torch(kern)
    if kind == "s1":
        want, want_pad = jfolded.folded_kernel_s1(jnp.asarray(kern), d, n)
        got, pad = folded.folded_kernel_s1(w, d, n)
    elif kind == "s2":
        want, want_pad, want_do = jfolded.folded_kernel_s2(jnp.asarray(kern), d, n)
        got, pad, do = folded.folded_kernel_s2(w, d, n)
        assert do == want_do
    else:
        want, want_pad, want_do = jfolded.folded_kernel_deconv(jnp.asarray(kern), d, n)
        got, pad, do = folded.folded_kernel_deconv(w, d, n)
        assert do == want_do
    assert [tuple(pad)] * 2 == [tuple(p) for p in want_pad]
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), np.asarray(want))


# ------------------------------------------------- blocks, folded vs not

# case: factory, input shape (3-D: its planes at axis 2 are folded in), the
# output's layout ("fold3d" / "fold2d": folded, with (planes, channels) to
# unfold it; "plain"); transposed convolutions take their input plain
BLOCKS = {
    "conv3d_s1": (lambda: ConvBlock(2, 8, dims=3), (2, 2, 8, 16, 24), "fold3d", (8, 8)),
    "conv3d_s2": (lambda: ConvBlock(8, 16, stride=2, dims=3), (2, 8, 8, 16, 24), "plain", None),
    "conv2d_k3_s1": (lambda: ConvBlock(3, 8, 3, 1), (2, 3, 16, 24), "fold2d", (1, 8)),
    "conv2d_k3_s2": (lambda: ConvBlock(8, 16, 3, 2), (2, 8, 16, 24), "plain", None),
    "conv2d_k5_s2": (lambda: ConvBlock(8, 16, 5, 2), (2, 8, 16, 24), "plain", None),
    "deconv3d": (lambda: DeconvBlock(16, 8, dims=3), (2, 16, 4, 8, 12), "fold3d", (8, 8)),
    "deconv2d": (lambda: DeconvBlock(16, 8, dims=2), (2, 16, 8, 12), "fold2d", (1, 8)),
    "plainconv3d": (lambda: PlainConv(8, 2, kernel=3, dims=3), (2, 8, 8, 16, 24), "fold3d",
                    (8, 2)),
    "plainconv2d_bias": (lambda: PlainConv(8, 32, kernel=1, use_bias=True), (2, 8, 16, 24),
                         "fold2d", (1, 32)),
}


def _folded_call(name: str, module, x: torch.Tensor) -> torch.Tensor:
    """``module`` run folded on ``x``, brought back to the unfolded layout."""
    _, shape, out, od = BLOCKS[name]
    d = shape[2] if len(shape) == 5 else 1
    if isinstance(module, DeconvBlock):
        y = folded.deconv_block(module, x, d)
    else:
        run = folded.conv_block if isinstance(module, ConvBlock) else folded.plain_conv
        y = run(module, folded.fold3d(x) if len(shape) == 5 else folded.fold2d(x), d)
    if out == "fold3d":
        return folded.unfold3d(y, *od)
    return folded.unfold2d(y, od[1]) if out == "fold2d" else y


@pytest.fixture(scope="module")
def block_runs():
    """Per case and mode: the unfolded and the folded run of one module from
    the same state (output, weight gradients, state after)."""
    out = {}
    for i, (name, (factory, shape, *_)) in enumerate(BLOCKS.items()):
        state = _randomized(factory(), i).state_dict()
        x = torch.from_numpy(_rand(shape, i) + 0.5)
        cot = None
        for train in (False, True):
            runs = {}
            for plan in ("unfolded", "folded"):
                module = factory()
                module.load_state_dict(state)
                module.train(train)
                y = module(x) if plan == "unfolded" else _folded_call(name, module, x)
                if cot is None:
                    cot = torch.from_numpy(_rand(tuple(y.shape), 100 + i))
                (y * cot).sum().backward()
                runs[plan] = dict(y=y.detach(), state=module.state_dict(),
                                  grads={n: p.grad for n, p in module.named_parameters()})
            out[name, train] = runs
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_folded_block_matches_unfolded(block_runs, name, train):
    runs = block_runs[name, train]
    want, got = runs["unfolded"], runs["folded"]
    _close(got["y"], want["y"], BLOCK_TOL, "output")
    for k, v in want["state"].items():
        if "running" in k:
            _close(got["state"][k], v, BLOCK_TOL, k)
        else:
            assert torch.equal(got["state"][k], v), k


@pytest.mark.parametrize("name", list(BLOCKS))
def test_folded_block_weight_gradients(block_runs, name):
    runs = block_runs[name, True]
    want, got = runs["unfolded"]["grads"], runs["folded"]["grads"]
    assert want.keys() == got.keys()
    for n, g in want.items():
        err = float((got[n] - g).abs().max()) / float(g.abs().max())
        assert err <= BLOCK_TOL, (n, err)


# ------------------------------------------------- nets against the JAX package

NETS = {
    "costreg": (CostRegNet, jcr.CostRegNet, (1, 8, 16, 24, 2), "cost_regularization.0."),
    "costreg_refine": (CostRegNetRefine, jcr.CostRegNetRefine, (1, 4, 16, 24, 2),
                       "cost_regularization_refine.0."),
    "feature": (FeatureNet, JFeatureNet, (2, 32, 48, 3), "feature."),
}


# the JAX package's name of each net's top module
_TOP = {"costreg": "cost_reg_0", "costreg_refine": "cost_reg_refine_0", "feature": "feature"}


def _jax_variables(prefix: str, state: dict) -> dict:
    params, stats = jax_tree_from_state_dict({prefix + k: v for k, v in state.items()})
    top = next(iter(params))
    return {"params": params[top], "batch_stats": stats[top]}


@pytest.fixture(scope="module")
def nets():
    """Per net: the JAX variables, the input (NDHWC / NHWC), and the JAX
    outputs at fold_level0=True in eval and train mode (with the new
    statistics) and, for the U-Nets, at bf16: one jitted function."""
    cases, jmods = {}, {}
    for i, (name, (tcls, jcls, shape, prefix)) in enumerate(NETS.items()):
        state = _randomized(tcls(8), i).state_dict()
        cases[name] = dict(variables=_jax_variables(prefix, state), x=_rand(shape, 10 + i),
                           prefix=prefix)
        jmods[name] = (jcls(8, fold_level0=True),
                       None if name == "feature" else jcls(8, dtype=jnp.bfloat16, fold_level0=True))

    @jax.jit
    def references(variables, xs):
        out = {}
        for name, (jm, jm16) in jmods.items():
            v, x = variables[name], xs[name]
            out[name, "eval"] = jm.apply(v, x)
            out[name, "train"] = jm.apply(v, x, True, mutable=["batch_stats"])
            if jm16 is not None:
                out[name, "bf16"] = jm16.apply(v, x.astype(jnp.bfloat16))
        return out

    refs = references({k: c["variables"] for k, c in cases.items()},
                      {k: jnp.asarray(c["x"]) for k, c in cases.items()})
    return cases, jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), refs)


def _load(name: str, cases: dict, dtype=torch.float32):
    """The port's net with fold_level0=True on the JAX variables, converted
    by ``convert.state_dict_from_jax``."""
    tcls, _, _, prefix = NETS[name]
    case = cases[name]
    top = _TOP[name]
    sd = state_dict_from_jax({top: case["variables"]["params"]},
                             {top: case["variables"]["batch_stats"]})
    net = tcls(8, dtype=dtype, fold_level0=True)
    net.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=False)
    return net


def _channels_first(x: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.permute(0, 4, 1, 2, 3) if t.dim() == 5 else t.permute(0, 3, 1, 2)


def _channels_last(t: torch.Tensor) -> np.ndarray:
    return (t.permute(0, 2, 3, 4, 1) if t.dim() == 5 else t.permute(0, 2, 3, 1)).numpy()


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(NETS))
def test_folded_nets_match_jax(nets, name, mode):
    cases, refs = nets
    net = _load(name, cases).train(mode == "train")
    before = folded.stats["convolutions"]
    with torch.no_grad():
        got = net(_channels_first(cases[name]["x"]))
    assert folded.stats["convolutions"] - before == (FOLDED_FEATURE if name == "feature"
                                                     else 2 * 4)
    want = refs[name, mode]
    tol = FEAT_TOL if mode == "eval" else TRAIN_TOL
    if mode == "train":
        want, updates = want
        new_state = net.state_dict()
        prefix = cases[name]["prefix"]
        want_stats = state_dict_from_jax({}, {_TOP[name]: updates["batch_stats"]})
        assert want_stats
        for k, v in want_stats.items():
            _close(new_state[k[len(prefix):]], v, tol, k)
    if name == "feature":
        for k, v in got.items():
            np.testing.assert_allclose(_channels_last(v), want[k], atol=tol, rtol=0, err_msg=k)
    else:
        np.testing.assert_allclose(_channels_last(got), want, atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["costreg", "costreg_refine"])
def test_folded_cost_reg_bf16_matches_jax(nets, name):
    cases, refs = nets
    net = _load(name, cases, dtype=BF16).eval()
    x = _channels_first(cases[name]["x"]).to(BF16)
    with torch.no_grad():
        got = net(x)
    assert got.dtype == BF16
    want = refs[name, "bf16"]
    rel = float(np.abs(_channels_last(got.float()) - want).max() / np.abs(want).max())
    print(f"folded {name} bf16: rel max diff {rel:.2e}")
    assert rel <= 10 * MEASURED_BF16[name]


# ------------------------------------------------------------ the whole model

def _model(fold_level0, seed: int = 0) -> MVSNet:
    return _randomized(MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                              warp_impl="torch", fold_level0=fold_level0), seed)


def _args(batch_size: int = 1):
    batch = synthetic.make_batch(batch=batch_size, n_views=V, height=H, width=W, n_depths=32)
    return (torch.from_numpy(batch["imgs"]),
            {k: torch.from_numpy(v) for k, v in batch["proj_matrices"].items()},
            torch.from_numpy(batch["depth_values"]))


@pytest.fixture(scope="module")
def whole_model():
    model = _model(True).eval()
    args = _args()
    before = dict(folded.stats)
    with torch.inference_mode():
        got = model(*args)
    ran = {k: folded.stats[k] - before[k] for k in before}
    params, stats = jax_tree_from_state_dict(model.state_dict())
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                 fold_level0=True)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats},
                             *(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor)
                               else {k: jnp.asarray(v.numpy()) for k, v in a.items()}
                               for a in args))
    return got, jax.tree_util.tree_map(np.asarray, want), ran


def test_folded_model_matches_jax(whole_model):
    got, want, _ = whole_model
    dd = float(np.abs(got["depth"].numpy() - want["depth"]).max())
    dc = float(np.abs(got["photometric_confidence"].numpy()
                      - want["photometric_confidence"]).max())
    print(f"folded model: depth max |diff| {dd:.3e} mm, confidence {dc:.3e}")
    assert np.isfinite(got["depth"].numpy()).all()
    assert dd <= DEPTH_TOL_MM and dc <= CONF_TOL


@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
def test_folded_model_stages_match_jax(whole_model, stage):
    got, want, _ = whole_model
    for k in ("depth", "depth_sub_plus", "depth_sub_plus_refine"):
        assert float(np.abs(got[stage][k].numpy() - want[stage][k]).max()) <= DEPTH_TOL_MM, k
    for k in ("photometric_confidence", "photometric_confidence_refine"):
        assert float(np.abs(got[stage][k].numpy() - want[stage][k]).max()) <= CONF_TOL, k


def test_folded_convolutions_per_forward(whole_model):
    """Every pass folds at 64x96 with 8 planes: 6 x 8 + 5; None folds
    nothing; a 48-plane pass is declined and counted."""
    _, _, ran = whole_model
    assert ran == {"convolutions": 6 * FOLDED_PER_PASS + FOLDED_FEATURE, "declined": 0}
    model = _model(None).eval()
    args = _args()
    before = dict(folded.stats)
    with torch.inference_mode():
        model(*args)
    assert folded.stats == before
    net = CostRegNet(8, fold_level0=True).eval()
    with torch.no_grad():
        net(torch.zeros(1, 2, 48, 16, 24))
    assert folded.stats == {"convolutions": before["convolutions"],
                            "declined": before["declined"] + 2}


def test_folded_kernels_made_in_inference_mode_serve_training():
    """The index arrays kept per device are made on the first call; one in
    inference mode must not leave tensors a later backward cannot save."""
    net = _randomized(CostRegNet(2, fold_level0=True), 5)   # weight shapes no other test folds
    x = torch.from_numpy(_rand((1, 2, 8, 8, 16), 5))
    with torch.inference_mode():
        want = net.eval()(x)
    got = net(x.clone().requires_grad_())
    got.sum().backward()
    _close(got.detach(), want, BLOCK_TOL, "output")
    assert all(p.grad is not None for p in net.parameters())


def test_state_dict_keys_are_the_same_under_every_plan():
    keys = [list(MVSNet(ndepths=NDEPTHS, fold_level0=f).state_dict()) for f in (None, True, False)]
    assert keys[0] == keys[1] == keys[2]
    model = MVSNet(ndepths=NDEPTHS)
    sd = model.state_dict()
    model.fold_level0 = True
    assert model.feature.fold_level0 and model.cost_regularization_refine[2].cosR_huge.fold_level0
    assert list(model.state_dict()) == list(sd)
    with pytest.raises(ValueError, match="fold_level0"):
        model.fold_level0 = "yes"


def test_cost_model_counts_the_unfolded_program():
    """cost_analysis of an eval forward and cost_breakdown of a train step:
    equal FLOPs and bytes for fold_level0 True and False, since under a
    count every call runs the unfolded plan (``blocks.takes_fold``).  So
    the counted step of the fold_level0=True model leaves the state of an
    unfolded step without the counter (BLOCK_TOL), and that of a folded
    step within TRAIN_TOL (train-mode batch norm divides the plans'
    reassociation by the small batch's spread, as in
    test_folded_nets_match_jax)."""
    sd = _model(False, 3).state_dict()
    args = _args()
    batch = synthetic.make_batch(batch=1, n_views=V, height=H, width=W, n_depths=32)
    batch = {k: ({n: torch.from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v)) for k, v in batch.items()}
    step = make_train_step((0.5, 1.0, 2.0))
    counts = {}
    for plan in (False, True):
        model = _model(plan)
        model.load_state_dict(sd)
        counts[plan, "eval"] = profiler.model_summary(model, *args)
        optimizer, scheduler = make_optimizer(model.parameters(), lambda i: 0.0)
        counts[plan, "train"] = profiler.cost_breakdown(step, model, optimizer, scheduler, batch)
        counts[plan, "state"] = {k: v.clone() for k, v in model.state_dict().items()}
    assert counts[False, "eval"] == counts[True, "eval"]
    assert counts[False, "train"] == counts[True, "train"]
    assert counts[True, "train"]["flops"]["convolution"] > 0
    # one step of each plan without the counter from the same weights
    for plan, tol in ((False, BLOCK_TOL), (True, TRAIN_TOL)):
        model = _model(plan)
        model.load_state_dict(sd)
        optimizer, scheduler = make_optimizer(model.parameters(), lambda i: 0.0)
        step(model, optimizer, scheduler, batch)
        for k, v in model.state_dict().items():
            _close(counts[True, "state"][k], v, tol, k)
