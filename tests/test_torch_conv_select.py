"""cuDNN's algorithm choice inside the port's steps
(``dmvsnet_tpu_torch.measured_conv_algorithms``, ``engine/steps``), on the
CPU at the size of tests/test_torch_trace.py (32x64, 3 views, batch 1,
ndepths 8/8/8), for each of the infer, eval and train steps:

* inside the model call, and for the train step inside its backward,
  ``torch.backends.cudnn.benchmark`` is True and ``benchmark_limit`` is
  ``CONV_CANDIDATES`` (``BACKWARD_CONV_CANDIDATES`` in the backward) while
  ``allow_tf32`` (cuDNN's and cuBLAS's), ``enabled`` and ``deterministic``
  keep the caller's values, whether the caller pinned fp32 or set them
  otherwise;
* after the step every flag is the caller's again, also when the step
  raises (in the forward, or for the train step in its backward), and a
  model called directly, outside a step, sees the caller's flags;
* ``blocks.conv_selections()`` counts each distinct convolution problem
  once: nothing for a direct call with the caller's flags, the same count
  after a second identical step, twice it after a step at a new image size;
  under the unfolded and the folded level-0 plans.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dmvsnet_tpu_torch import BACKWARD_CONV_CANDIDATES, CONV_CANDIDATES, pin_fp32
from dmvsnet_tpu_torch.engine.state import make_optimizer
from dmvsnet_tpu_torch.engine.steps import make_eval_step, make_infer_step, make_train_step
from dmvsnet_tpu_torch.models import MVSNet, blocks, folded
from dmvsnet_tpu_torch.models.blocks import init_weights
from dmvsnet_tpu_torch.parallel import make_mesh, shard_batch
from dmvsnet_tpu_torch.utils import synthetic

NDEPTHS, RATIOS = (8, 8, 8), (4, 2, 1)
V = 3
STEPS = ("infer", "eval", "train")
FLAGS = {
    "benchmark": (torch.backends.cudnn, "benchmark"),
    "benchmark_limit": (torch.backends.cudnn, "benchmark_limit"),
    "cudnn_allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul_allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "enabled": (torch.backends.cudnn, "enabled"),
    "deterministic": (torch.backends.cudnn, "deterministic"),
}
# what a caller may have set before a step: fp32 pinned as the entry points
# pin it, or every flag other than benchmark turned the other way
CALLERS = {
    "pinned": dict(benchmark=False, benchmark_limit=10, cudnn_allow_tf32=False,
                   matmul_allow_tf32=False, enabled=True, deterministic=False),
    "other": dict(benchmark=False, benchmark_limit=0, cudnn_allow_tf32=True,
                  matmul_allow_tf32=True, enabled=False, deterministic=True),
}


class Raised(RuntimeError):
    pass


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def caller_flags_restored():
    """Whatever a test sets, the next one starts from the flags it found."""
    saved = read_flags()
    yield
    set_flags(saved)


def read_flags() -> dict:
    return {k: getattr(obj, attr) for k, (obj, attr) in FLAGS.items()}


def set_flags(values: dict) -> None:
    for k, v in values.items():
        obj, attr = FLAGS[k]
        setattr(obj, attr, v)


@pytest.fixture(scope="module")
def weights() -> dict:
    """Seeded weights with damped probability heads (as
    tests/test_torch_trace.py), so that a step stays finite."""
    model = _model()
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".prob." in name:
                p.mul_(0.2)
    return {k: v.clone() for k, v in model.state_dict().items()}


def _model() -> MVSNet:
    # CPU tensors: the kernel path runs its plain version
    return MVSNet(ndepths=NDEPTHS, depth_interval_ratio=RATIOS, inverse_depth=True,
                  warp_impl="cuda")


def _batch(height: int, width: int) -> dict:
    host = synthetic.make_batch(batch=1, n_views=V, height=height, width=width, n_depths=32)
    rng = np.random.default_rng(0)
    host["imgs"] = (host["imgs"] + rng.normal(0, 0.02, host["imgs"].shape)).astype(np.float32)
    return shard_batch(host, make_mesh(1))


def _runner(kind: str, weights: dict, fold: bool = False):
    """(model, run(batch)): the model with ``weights`` and one call of the
    ``kind`` step on it."""
    model = _model()
    model.load_state_dict(weights)
    model.fold_level0 = True if fold else None
    if kind == "infer":
        step = make_infer_step()
        return model, lambda b: step(model, b["imgs"], b["proj_matrices"], b["depth_values"])
    if kind == "eval":
        step = make_eval_step()
        return model, lambda b: step(model, b)
    step = make_train_step()
    opt, sched = make_optimizer(model.parameters(), lambda n: 1e-3)
    return model, lambda b: step(model, opt, sched, b)


def _watch(model, seen: dict, raise_in: str | None = None):
    """Records the flags in the first 3-D convolution of the stage-1 cost
    U-Net: its forward (a forward hook) and its weight's gradient (a tensor
    hook, which runs inside the backward); raises there if asked."""
    conv = model.cost_regularization[0].cosR_small.conv0.conv

    def forward(_module, _args, _out):
        seen["forward"] = read_flags()
        if raise_in == "forward":
            raise Raised("in the forward")

    def backward(grad):
        seen["backward"] = read_flags()
        if raise_in == "backward":
            raise Raised("in the backward")
        return grad

    conv.register_forward_hook(forward)
    conv.weight.register_hook(backward)


@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("kind", STEPS)
def test_a_step_measures_conv_algorithms_and_restores_the_flags(weights, kind, caller):
    want = CALLERS[caller]
    inside = {**want, "benchmark": True, "benchmark_limit": CONV_CANDIDATES}
    batch = _batch(32, 64)

    set_flags(want)
    model, run = _runner(kind, weights)
    seen = {}
    _watch(model, seen)
    run(batch)
    assert seen["forward"] == inside
    if kind == "train":
        assert seen["backward"] == {**inside, "benchmark_limit": BACKWARD_CONV_CANDIDATES}
    assert read_flags() == want

    # the flags of a direct call are the caller's
    seen.clear()
    with torch.no_grad():
        model.eval()(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    assert seen["forward"] == want

    # a step that raises leaves the caller's flags too
    model, run = _runner(kind, weights)
    seen = {}
    _watch(model, seen, raise_in="backward" if kind == "train" else "forward")
    with pytest.raises(Raised):
        run(batch)
    assert seen["forward"] == inside
    assert read_flags() == want


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("kind", STEPS)
def test_conv_selections_count_each_problem_once(weights, kind, fold):
    pin_fp32()
    torch.backends.cudnn.benchmark = False
    blocks.reset_conv_selections()
    folded.stats.update(convolutions=0, declined=0)
    model, run = _runner(kind, weights, fold)
    small, wider = _batch(32, 64), _batch(64, 64)

    with torch.no_grad():
        model.eval()(small["imgs"], small["proj_matrices"], small["depth_values"])
    assert blocks.conv_selections() == 0

    run(small)
    first = blocks.conv_selections()
    assert first > 0
    assert (folded.stats["convolutions"] > 0) == fold
    run(small)
    assert blocks.conv_selections() == first
    # every convolution of the network meets a new problem at another size
    run(wider)
    assert blocks.conv_selections() == 2 * first
    blocks.reset_conv_selections()
    assert blocks.conv_selections() == 0
