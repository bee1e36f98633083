"""A configuration's ``"program"`` object (``mvsbench/program.py``): its
keys reach the port's ``Config`` verbatim; a key that the ``Config`` lacks,
or that repeats a field the benchmark maps, stops the run at set-up, by
name, before any model is built; the standing configurations give the
``Config`` that the mapping gave before the object."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from dmvsnet_tpu_torch.config import Config
from dmvsnet_tpu_torch.engine import evaluate, train
from mvsbench import harness, program

SEED = 2_147_483_951
CELLS = sorted(p.stem for p in (harness.BENCH_DIR / "workloads").glob("*.json"))


def _config_before(ctx) -> Config:
    """``program.config`` as it was before the ``"program"`` object, frozen
    here."""
    c, w = ctx.config, ctx.workload
    fields = dict(
        fea_mode=c["fea_mode"], agg_mode=c["agg_mode"], depth_mode=c["depth_mode"],
        ndepths=tuple(c["ndepths"]), interval_ratio=tuple(c["interval_ratio"]),
        inverse_depth=c["inverse_depth"], numdepth=c["numdepth"],
        interval_scale=c["interval_scale"], dlossw=tuple(c["dlossw"]),
        compute_dtype=ctx.options.get("compute_dtype", c["precision"]),
        batch_size=w["batch"], seed=ctx.seed % (1 << 63))
    if w["mode"] == "infer":
        fields.update(num_view=w["views"], max_h=w["height"], max_w=w["width"],
                      eval_batch=w["batch"], filter_method="none")
    else:
        t = w["training"]
        fields.update(nviews=w["views"], img_size=(w["height"], w["width"]), lr=t["lr"],
                      wd=t["wd"], scheduler=t["scheduler"], warmup=t["warmup"],
                      milestones=tuple(t["milestones"]), lr_decay=t["lr_decay"],
                      epochs=t["epochs"])
    return Config(**fields)


def _ctx(cell: str, **config) -> SimpleNamespace:
    workload, base = harness.cell_files(cell)
    return SimpleNamespace(config={**base, **config}, workload=workload, seed=SEED,
                           options={}, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_standing_configuration_gives_the_config_it_gave_before(cell):
    ctx = _ctx(cell)
    assert "program" not in ctx.config
    assert program.config(ctx) == _config_before(ctx)


@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train"])
def test_the_program_object_reaches_the_config(cell):
    ctx = _ctx(cell, program={"warp_impl": "torch", "remat": True})
    cfg = program.config(ctx)
    assert (cfg.warp_impl, cfg.remat) == ("torch", True)
    assert cfg.replace(warp_impl="auto", remat=False) == _config_before(ctx)


@pytest.mark.parametrize("extra,refused", [
    ({"warp_impl": "torch", "no_such_field": 1}, "no_such_field"),
    ({"ndepths": [8, 8, 8]}, "ndepths"),
    ({"compute_dtype": "bfloat16"}, "compute_dtype"),
    ({"lr": 0.1}, "lr"),
])
@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train"])
def test_a_field_the_port_lacks_or_a_mapped_one_is_refused(cell, extra, refused):
    with pytest.raises(ValueError, match=refused):
        program.config(_ctx(cell, program=extra))


def test_every_mapped_field_is_a_field_of_the_config():
    fields = set(Config.__dataclass_fields__)
    assert set(program.MAPPED) <= fields
    for cell in ("dtu_eval", "dtu_train"):
        ctx = _ctx(cell)
        default = Config()
        set_here = {f for f in fields if getattr(program.config(ctx), f) != getattr(default, f)}
        assert set_here <= set(program.MAPPED), set_here - set(program.MAPPED)


@pytest.mark.parametrize("cell", ["dtu_eval", "dtu_train"])
def test_a_run_stops_at_set_up_naming_the_field(tiny_bench, monkeypatch, cell):
    root, bench = tiny_bench
    path = bench / "configs" / "tiny_dmvsnet_dtu.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "program": {"arch": "transmvsnet"}}))

    def never(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(evaluate, "build_model", never)
    monkeypatch.setattr(train, "build_model", never)
    with pytest.raises(ValueError, match="arch"):
        harness.run(f"tiny_{cell}", SEED, 0.1, False, device="cpu", bench_dir=bench, root=root,
                    log=lambda *a, **k: None)
