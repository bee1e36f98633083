"""The training slice as a whole: one fp32 train step of the port vs the JAX
package's ``make_train_step`` with identical weights and batch, at 64x96,
3 views, batch 2, ndepths 8/8/8, interval ratios 4/2/1, inverse depth.
The same step also runs on gloo ranks (the worker of
tests/test_torch_parallel.py): dp on 2 ranks, one batch element per rank;
vp on 2, the whole batch on both ranks and one source view each; sp on 2,
the whole batch on both and the rows of every cost U-Net split (at 64x96
stage 1 has 16 rows: bands of 8 + 8); dpsp on 4, 2 dp x 2 sp.  All are
held against the same JAX step (global batch), with the same tolerances.
The two batch elements' masks differ (element 0 has a second hole), so the
dp ranks' mask counts differ and a mean of per-rank means would show.  The
dp and sp steps are repeated with remat and must equal themselves bit for
bit.

The weights start on the port's side (seeded init, random batch-norm
parameters and statistics, probability heads damped by 0.2 to keep the
random network well-conditioned in train mode) and reach JAX through
``convert.jax_tree_from_state_dict``.  The JAX step runs once, jitted, with
an optimizer that records the gradients instead of applying them, so the
file compiles one ``value_and_grad`` of the whole model.  Gradients are
compared, not post-Adam parameters: where g ~ 0 Adam's m/(sqrt(v)+eps)
amplifies rounding.

Tolerances: loss 1e-5 relative.  Gradients, as relative L2 differences
||g_port - g_jax|| / ||g_jax||: 5e-3 for all parameters taken together,
1e-3 for the median parameter, 0.1 for the worst one.  The gradient is far
worse conditioned than the loss: the loss routes it through min/max
composites and checkerboards, and a convolution in front of a train-mode
batch norm gets a gradient that is a small difference of large terms.
Measured on the port alone, a 1e-6 relative change of the images moves the
median parameter's gradient by 2e-5 and the worst by 1e-2; the two fp32
implementations differ by more than that input change.  A wrong formula
(running statistics, a gradient leaking through the sampling grid) shows
as a difference of order 1 in many parameters.  New
running mean / variance 1e-4 * max(1, max|stat|); abs_depth_error 1e-3 mm;
threshold metrics 2 pixels of 6144.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_parallel import collect, run_ranks

from dmvsnet_tpu.engine.state import TrainState
from dmvsnet_tpu.engine.steps import make_train_step as j_make_train_step
from dmvsnet_tpu.models import MVSNet as JMVSNet
from dmvsnet_tpu_torch.convert import jax_tree_from_state_dict, state_dict_from_jax
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_eval_step, make_train_step
from dmvsnet_tpu_torch.models import MVSNet
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.utils import synthetic

NDEPTHS, RATIOS, DLOSSW = (8, 8, 8), (4, 2, 1), (0.5, 1.0, 2.0)
LOSS_RTOL = 1e-5
GRAD_RTOL_ALL, GRAD_RTOL_MEDIAN, GRAD_RTOL_WORST = 5e-3, 1e-3, 0.1
STAT_RTOL = 1e-4
# the ranked steps: mode -> ranks (tests/test_torch_parallel.STEP_MESHES)
RANKS = {"dp": 2, "vp": 2, "sp": 2, "dpsp": 4}


def _record_grads() -> optax.GradientTransformation:
    """Leaves the parameters alone and keeps the gradients as its state."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    gen = torch.Generator().manual_seed(0)
    model = MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                   warp_impl="cuda")  # CPU tensors: the wrapper runs the plain version
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        # Train-mode batch norm gives every layer unit-variance activations, so
        # with random heads the probability logits are large, the soft argmax
        # is nearly a hard one, and the cascade amplifies a 1e-6 relative
        # change of the images to hundreds of mm at stage 3 (measured on the
        # port alone): no two fp32 implementations can agree there.  Damped
        # heads keep the comparison at a well-conditioned point.
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    batch = synthetic.make_batch(batch=2, n_views=3, height=64, width=96, n_depths=32)
    rng = np.random.default_rng(0)
    batch["imgs"] = (batch["imgs"] + rng.normal(0, 0.02, batch["imgs"].shape)).astype(np.float32)
    batch["imgs"][1] = batch["imgs"][1, :, ::-1].copy()  # two different batch elements
    for s, m in batch["mask"].items():
        m[:, : m.shape[1] // 4, : m.shape[2] // 3] = 0.0  # a hole in the mask
        m[0, m.shape[1] // 2:, m.shape[2] // 2:] = 0.0    # and a second one in element 0

    def move(v):
        return {k: move(x) for k, x in v.items()} if isinstance(v, dict) else torch.from_numpy(v)

    # the ranked steps run while JAX compiles
    runs = {}
    for mode, world in RANKS.items():
        d = tmp_path_factory.mktemp(mode)
        torch.save(dict(mode=mode, sd0=sd0, batch=move(batch), ndepths=NDEPTHS, ratios=RATIOS,
                        dlossw=DLOSSW, remat=mode in ("dp", "sp")), d / "inputs.pt")
        runs[mode] = run_ranks("step", world, d)

    params, stats = jax_tree_from_state_dict(sd0)
    jm = JMVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True)
    tx = _record_grads()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    new_state, j_scalars, (j_depth, _) = j_make_train_step(DLOSSW, "regression")(state, jbatch)
    j_grads = jax.tree_util.tree_map(np.asarray, new_state.opt_state)
    j_stats = jax.tree_util.tree_map(np.asarray, new_state.batch_stats)
    j_scalars = {k: float(v) for k, v in j_scalars.items()}

    tbatch = move(batch)
    # lr 0: the step leaves the parameters where they were and p.grad holds
    # this step's gradients afterwards
    opt, sched = make_optimizer(model.parameters(), lambda n: 0.0)
    t_scalars, (t_depth, t_conf) = make_train_step(DLOSSW, "regression")(model, opt, sched, tbatch)
    return dict(model=model, sd0=sd0, tbatch=tbatch, t_scalars=t_scalars, t_depth=t_depth,
                j_scalars=j_scalars, j_grads=j_grads, j_stats=j_stats,
                j_depth=np.asarray(j_depth), sched=sched,
                ranks={mode: collect(h) for mode, h in runs.items()})


def _check_scalars(t: dict, j: dict) -> None:
    print(f"train step: loss {t['loss']:.6f} (port) vs {j['loss']:.6f} (JAX)")
    assert np.isfinite(t["loss"]) and abs(t["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"])
    assert abs(t["abs_depth_error"] - j["abs_depth_error"]) <= 1e-3
    for k in ("thres2mm_error", "thres4mm_error", "thres8mm_error"):
        assert abs(t[k] - j[k]) <= 2.0 / (64 * 96), k
    assert t["lr"] == 0.0


def _check_grads(grads: dict, j_grads) -> None:
    """Every parameter's gradient (numpy, by reference name) against the
    JAX step's, as relative L2 differences."""
    want = state_dict_from_jax(j_grads, {})
    assert set(want) == set(grads)
    rels, sq_diff, sq_norm = {}, 0.0, 0.0
    for name, g in grads.items():
        g, w = g.astype(np.float64), want[name].numpy().astype(np.float64)
        assert np.abs(w).max() > 0, f"{name}: JAX gradient is identically zero"
        rels[name] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        sq_diff += float(((g - w) ** 2).sum())
        sq_norm += float((w ** 2).sum())
    worst = max(rels, key=rels.get)
    overall = (sq_diff / sq_norm) ** 0.5
    print(f"train step: gradient relative L2 diff: all parameters together {overall:.2e}, "
          f"median per parameter {np.median(list(rels.values())):.2e}, "
          f"worst {rels[worst]:.2e} at {worst} ({len(rels)} parameters)")
    assert overall <= GRAD_RTOL_ALL
    assert np.median(list(rels.values())) <= GRAD_RTOL_MEDIAN
    assert rels[worst] <= GRAD_RTOL_WORST, worst


def _check_stats(got: dict, j_stats, sd0: dict) -> None:
    want = state_dict_from_jax({}, j_stats)
    assert len(want) == 2 * sum(1 for k in got if k.endswith("running_mean"))
    for name, w in want.items():
        tol = STAT_RTOL * max(1.0, float(w.abs().max()))
        assert float((got[name] - w).abs().max()) <= tol, name
        # and they did move away from where they started
        assert not torch.equal(got[name], sd0[name]), name


def test_loss_and_metrics_match_jax(step_results):
    r = step_results
    _check_scalars({k: float(v) for k, v in r["t_scalars"].items()}, r["j_scalars"])
    assert r["sched"].last_epoch == 1
    assert float(np.abs(r["t_depth"].numpy() - r["j_depth"]).max()) <= 0.01
    assert not r["t_depth"].requires_grad


def test_every_parameter_gradient_matches_jax(step_results):
    r = step_results
    params = dict(r["model"].named_parameters())
    _check_grads({n: p.grad.numpy() for n, p in params.items()}, r["j_grads"])
    # lr 0 left the parameters alone
    assert all(torch.equal(p.detach(), r["sd0"][n]) for n, p in params.items())


def test_new_batch_stats_match_jax(step_results):
    r = step_results
    _check_stats(r["model"].state_dict(), r["j_stats"], r["sd0"])


@pytest.mark.parametrize("mode", list(RANKS))
def test_two_rank_loss_and_metrics_match_jax(step_results, mode):
    ranks = step_results["ranks"][mode]
    r0 = ranks[0]
    # the global scalars, the same on every rank
    assert all(r["scalars"] == r0["scalars"] for r in ranks)
    _check_scalars(r0["scalars"], step_results["j_scalars"])
    if mode in ("dp", "dpsp"):  # one element per dp coordinate, different mask counts
        assert r0["mask_count"] != ranks[-1]["mask_count"]
    assert r0["backend"] == "gloo" and r0["init"]["process_count"] == RANKS[mode]


@pytest.mark.parametrize("mode", list(RANKS))
def test_two_rank_gradients_match_jax(step_results, mode):
    ranks = step_results["ranks"][mode]
    r0 = ranks[0]
    # DDP leaves the same averaged gradient on every rank
    assert all(torch.equal(g, r["grads"][n]) for r in ranks for n, g in r0["grads"].items())
    _check_grads({n: g.numpy() for n, g in r0["grads"].items()}, step_results["j_grads"])


@pytest.mark.parametrize("mode", list(RANKS))
def test_two_rank_batch_stats_match_jax(step_results, mode):
    for r in step_results["ranks"][mode]:
        _check_stats(r["state"], step_results["j_stats"], step_results["sd0"])


def test_eval_step_after_train_step_uses_running_stats(step_results):
    r = step_results
    scalars, depth, conf = make_eval_step(DLOSSW)(r["model"], r["tbatch"])
    assert not r["model"].training
    assert depth.shape == conf.shape == (2, 64, 96)
    assert set(scalars) == {"loss", "abs_depth_error", "thres2mm_error", "thres4mm_error",
                            "thres8mm_error"}
    assert all(np.isfinite(float(v)) for v in scalars.values())
    before = {k: v.clone() for k, v in r["model"].state_dict().items()}
    make_eval_step(DLOSSW)(r["model"], r["tbatch"])
    assert all(torch.equal(v, before[k]) for k, v in r["model"].state_dict().items())


def test_two_rank_remat_step_equals_step(step_results):
    """The dp step with remat on both ranks equals the dp step without it
    bit for bit (both under deterministic algorithms; tests/test_torch_remat.py
    holds the one-process steps): the recomputed synced batch norms
    all_reduce again in the backward, in the same order on both ranks, and
    update no running statistic."""
    for r in step_results["ranks"]["dp"]:
        on = r["remat"]
        assert on["scalars"] == r["scalars"] and torch.equal(on["depth"], r["depth"])
        for n, g in r["grads"].items():
            assert torch.equal(g, on["grads"][n]), n
        for k, v in r["state"].items():
            assert torch.equal(v, on["state"][k]), k


def test_sp_remat_step_equals_step(step_results):
    """The sp step with remat on both ranks equals the sp step without it
    bit for bit (both under deterministic algorithms): the recomputed banded
    U-Nets issue their halo exchanges and synced batch norms again in the
    backward, in the same order on both ranks, and update no running
    statistic."""
    for r in step_results["ranks"]["sp"]:
        on = r["remat"]
        assert on["scalars"] == r["scalars"] and torch.equal(on["depth"], r["depth"])
        for n, g in r["grads"].items():
            assert torch.equal(g, on["grads"][n]), n
        for k, v in r["state"].items():
            assert torch.equal(v, on["state"][k]), k
