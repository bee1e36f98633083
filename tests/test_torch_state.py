"""The port's lr schedule, optimizers and train-mode batch norm vs the JAX
package (optax, flax).

Tolerances: schedule 1e-6 relative (JAX evaluates it in fp32); Adam / AdamW
parameters after 5 steps of fixed gradients 1e-6 absolute on values of
order 1 (fp32 moment updates in another association); batch norm outputs
and running statistics 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmvsnet_tpu.engine import state as jstate
from dmvsnet_tpu.models import blocks as jblocks
from dmvsnet_tpu_torch.engine import state as tstate
from dmvsnet_tpu_torch.models import blocks as tblocks


@pytest.mark.parametrize("scheduler", ["steplr", "cosinelr"])
def test_lr_schedule_matches_jax_on_a_grid_of_steps(scheduler):
    kw = dict(base_lr=1e-3, steps_per_epoch=7, scheduler=scheduler, warmup_epochs=0.5,
              milestones=(2, 3, 5), lr_decay=0.5, total_epochs=6)
    jsched = jstate.make_lr_schedule(**kw)
    tsched = tstate.make_lr_schedule(**kw)
    steps = list(range(0, 50))
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps, jnp.int32)))
    got = np.array([tsched(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(1e-3 / 3) and 0.99e-3 < got.max() <= 1e-3
    assert got[-1] < got[10]
    with pytest.raises(ValueError, match="unknown scheduler"):
        tstate.make_lr_schedule(1e-3, 7, scheduler="poly")


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_steps_match_optax(rng, wd):
    """5 steps of fixed gradients: Adam (wd = 0) and AdamW (wd > 0) with the
    warmup schedule; the lr of step n is schedule(n)."""
    sched_kw = dict(base_lr=1e-2, steps_per_epoch=4, warmup_epochs=1.0, milestones=(1,))
    shapes = {"w": (3, 4), "b": (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]

    tx = jstate.make_optimizer(jstate.make_lr_schedule(**sched_kw), wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    tsched = tstate.make_lr_schedule(**sched_kw)
    opt, scheduler = tstate.make_optimizer(tp.values(), tsched, wd)
    assert type(opt) is (torch.optim.AdamW if wd else torch.optim.Adam)
    for n, g in enumerate(grads):
        assert scheduler.last_epoch == n
        assert scheduler.get_last_lr()[0] == pytest.approx(tsched(n))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        scheduler.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        assert np.abs(tp[k].detach().numpy() - p0[k]).max() > 1e-3


@pytest.mark.parametrize("dims,shape", [(2, (2, 5, 6, 4)), (3, (1, 1, 2, 3, 4))])
def test_batch_norm_train_step_matches_flax(rng, dims, shape):
    """Train-mode ConvBlock vs flax: output, running mean and running
    VARIANCE.  The 3-D case has n = 6 elements per channel, where torch's
    unbiased running-variance update would be 6/5 of the batch variance."""
    cin, cout = shape[-1], 5
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    jm = jblocks.ConvBlock(cout, kernel=1, dims=dims)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["bn"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    params["bn"]["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    stats = {"bn": {"mean": rng.normal(0, 0.2, cout).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}}
    want, mutated = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
    new = mutated["batch_stats"]["bn"]

    tm = tblocks.ConvBlock(cin, cout, kernel=1, dims=dims)
    perm = (3, 2, 0, 1) if dims == 2 else (4, 3, 0, 1, 2)
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(params["conv"]["kernel"].transpose(perm).copy()))
        tm.bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
        tm.bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
        tm.bn.running_mean.copy_(torch.from_numpy(stats["bn"]["mean"]))
        tm.bn.running_var.copy_(torch.from_numpy(stats["bn"]["var"]))
    tm.train()
    to_cf = (0, dims + 1, *range(1, dims + 1))
    to_cl = (0, *range(2, dims + 2), 1)
    xt = torch.from_numpy(x).permute(to_cf).requires_grad_()
    got = tm(xt)
    got.sum().backward()  # the corrected buffer update must not break autograd
    np.testing.assert_allclose(got.detach().permute(to_cl).numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(), np.asarray(new["mean"]), atol=1e-5)
    np.testing.assert_allclose(tm.bn.running_var.numpy(), np.asarray(new["var"]), atol=1e-5)
    assert int(tm.bn.num_batches_tracked) == 1
    # what the stock module would have written differs visibly at n = 6
    if dims == 3:
        n = x.size // cin
        batch_var = (np.asarray(new["var"]) - 0.9 * stats["bn"]["var"]) / 0.1
        unbiased = 0.9 * stats["bn"]["var"] + 0.1 * batch_var * n / (n - 1)
        assert np.abs(unbiased - tm.bn.running_var.numpy()).max() > 1e-3
    # eval mode leaves the buffers alone and uses them
    before = tm.bn.running_var.clone()
    tm.eval()
    tm(xt.detach())
    assert torch.equal(tm.bn.running_var, before)
