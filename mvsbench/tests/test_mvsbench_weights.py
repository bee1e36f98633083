"""The seeded weight rule (``mvsbench/weights.py``): every standing
configuration's state dict gets, from one seed, the values it got before
the rules for linear and norm parameters, to the bit; a module of linear
layers, layer and group norms and a Conv1d + BatchNorm1d gets values inside
the stated ranges; a float entry without a rule raises, naming itself."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from dmvsnet_tpu_torch.engine.train import build_model
from mvsbench import harness, program, weights

SEED = 2_147_483_929


def _range_before(name: str, shapes: dict) -> tuple[float, float]:
    """``weights._range`` as it was before the rules for linear and norm
    parameters, frozen here."""
    ranges = {"bn.weight": (0.5, 1.5), "bn.bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
              "running_var": (0.5, 1.5)}
    for suffix, rng in ranges.items():
        if name.endswith(suffix):
            return rng
    weight = shapes.get(name.rsplit(".", 1)[0] + ".weight")
    if weight is None or len(weight) < 3:
        raise ValueError(f"no rule for the weight {name!r} of shape {tuple(shapes[name])}")
    bound = 1.0 / math.sqrt(weight[1] * math.prod(weight[2:]))
    if ".prob." in f".{name}":
        bound *= 0.01
    return -bound, bound


@pytest.mark.parametrize("cell", ["dtu_eval", "tank_eval", "tank_adaptive"])
def test_a_standing_configuration_gets_the_same_weights_as_before(cell, monkeypatch):
    workload, config = harness.cell_files(cell)
    ctx = SimpleNamespace(config=config, workload=workload, seed=SEED, options={},
                          device="cpu")
    sd = build_model(program.config(ctx), torch.device("cpu")).state_dict()
    now = weights.generate(sd, SEED, "cpu")
    monkeypatch.setattr(weights, "_range", _range_before)
    before = weights.generate(sd, SEED, "cpu")
    assert list(now) == list(before)
    for name in sd:
        assert torch.equal(now[name], before[name]), name


class _Layers(nn.Module):
    """The parameters of a transformer's layers and a keypoint encoder."""

    def __init__(self):
        super().__init__()
        self.q = nn.Linear(32, 16)
        self.merge = nn.Linear(16, 32, bias=False)
        self.norm1 = nn.LayerNorm(32)
        self.gn = nn.GroupNorm(4, 32)
        self.kenc = nn.Sequential(nn.Conv1d(2, 32, 1), nn.BatchNorm1d(32))
        self.register_buffer("grid", torch.arange(5.0), persistent=False)


def _within(t: torch.Tensor, lo: float, hi: float) -> bool:
    """Inside [lo, hi], and spread over most of it (not a narrower rule)."""
    return lo <= float(t.min()) and float(t.max()) <= hi and \
        float(t.max() - t.min()) > 0.5 * (hi - lo)


def test_linear_and_norm_parameters_get_the_stated_ranges():
    module = _Layers()
    sd = weights.generate(module.state_dict(), SEED, "cpu")
    assert "grid" not in sd
    linear = {"q.weight": 32, "q.bias": 32, "merge.weight": 16, "kenc.0.weight": 2,
              "kenc.0.bias": 2}
    for name, fan_in in linear.items():
        bound = 1.0 / math.sqrt(fan_in)
        assert _within(sd[name], -bound, bound), name
    for name in ("norm1.weight", "gn.weight", "kenc.1.weight", "kenc.1.running_var"):
        assert _within(sd[name], 0.5, 1.5), name
    for name in ("norm1.bias", "gn.bias", "kenc.1.bias", "kenc.1.running_mean"):
        assert _within(sd[name], -0.1, 0.1), name
    assert int(sd["kenc.1.num_batches_tracked"]) == 0
    module.load_state_dict(sd)
    # a layer on its own, whose names carry no module prefix
    alone = weights.generate(nn.Linear(32, 8).state_dict(), SEED, "cpu")
    assert _within(alone["weight"], -32 ** -0.5, 32 ** -0.5)


@pytest.mark.parametrize("name,shape", [("table", (4, 8)), ("enc.pe", (16,)),
                                        ("norm1.scale", (32,))])
def test_a_float_entry_without_a_rule_raises_naming_itself(name, shape):
    sd = {"norm1.weight": torch.zeros(32), name: torch.zeros(shape)}
    with pytest.raises(ValueError, match=name):
        weights.generate(sd, SEED, "cpu")
