"""Mode ``infer_cascade``: mode ``infer`` for a cascade whose stages take
the winner (argmax over D) of their probability volume, compared stage by
stage on the hypotheses that the program itself took.

Set-up, the window, the traced spans and the frozen count are ``infer``'s,
taken from it; only the comparison with the reference differs.

Why a mode of its own: with the benchmark's seeded weights the volumes are
nearly flat, so at a few pixels in 10^4 the reference's two best planes lie
within float32 rounding of each other.  Rounding alone then moves such a
pixel's winner by whole planes, and through the next stage's hypotheses,
which are placed around the previous stage's depth, the volumes and depths
of the region around it.  ``infer``'s numbers read those flips in the fp32
program as under the bf16 control, and cannot tell the two apart
(``PERF.md``, ``tank_transmvsnet``).

The configuration's reference takes the keyword ``seeds``
(``{"stage{k}": depth}``): stage k + 1's hypotheses are placed around the
given stage-k depth in place of its own.  A forward hook keeps
references to each dispatch's stage depths (it does no device work).  Once
the window has closed the reference runs once for each batch and each
distinct set of those depths among the batch's dispatches, seeded with
them, so that each stage of the program is compared with the reference's
on the same hypotheses.  Dispatches of one batch give the same depths in
an untraced run; in a traced run those under the profiler may not (flips
at near-ties), hence a reference run for each set:

* ``prob``: the largest |probability - reference| over every stage's
  volume.  No stage's volume depends on a winner of its own stage, and each
  is compared on the program's own hypotheses, so rounding reaches it only
  through the arithmetic.
* ``depth_mean_mm``: the largest mean |depth - reference| of a compared
  map (the final depth of every dispatch of the window, and each stage's
  depth of the last dispatch), taken over the pixels where the
  reference's two best planes of that stage lie more than twice the
  ``prob`` limit apart.  Where the volumes agree to the limit, the program
  must pick the reference's plane there, so a gap there is a depth read
  from the wrong plane or from wrong hypotheses, or an answer altered
  after the head; the pixels left out are the near-ties whose winner
  rounding decides, which no limit can hold.

So ``prob`` is the number that tells a precision below the configuration's
from it, and ``depth_mean_mm`` the one that sees the depth maps
themselves.  The share of pixels left out, each stage's two gaps and
the number of reference runs are printed on the run's ``checked`` line.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvsbench.modes import infer

KIND = infer.KIND
iterate, drain, units = infer.iterate, infer.drain, infer.units
end_to_end, info, spans, count = infer.end_to_end, infer.info, infer.spans, infer.count


def setup(ctx):
    """``infer``'s set-up, which (with ``program.config``) reads the
    workload as a workload of mode ``infer``, and a hook that keeps each
    dispatch's depths of the stages before the last (``state.seeded``, in
    the order of ``state.answers``)."""
    state = infer.setup(dataclasses.replace(ctx, workload={**ctx.workload, "mode": "infer"}))
    stages = [f"stage{i + 1}" for i in range(state.num_stage - 1)]
    state.seeded = []

    def keep(_module, _args, out):
        state.seeded.append({s: out[s]["depth"] for s in stages})

    state.model.register_forward_hook(keep)
    return state


def _map_mean(gap: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Each map's mean of ``gap`` (B, H, W) over ``mask`` (0 where the mask
    holds no pixel)."""
    gap = gap.reshape(len(gap), -1).astype(np.float64)
    mask = mask.reshape(len(mask), -1)
    return (gap * mask).sum(1) / np.maximum(mask.sum(1), 1)


def _top_two_gap(prob: np.ndarray) -> np.ndarray:
    """p(best plane) - p(second best), (B, H, W) of a (B, D, H, W) volume."""
    top = np.partition(prob, -2, axis=1)
    return top[:, -1] - top[:, -2]


def _groups(state, b: int, last: dict, stages: list[str]) -> list[dict]:
    """Batch ``b``'s distinct sets of seeding depths: each with the indices
    of its dispatches in ``state.answers`` and whether the batch's last
    dispatch (``last``, whose stage outputs are compared) is one of them."""
    groups: list[dict] = []

    def add(seeds, index=None, is_last=False):
        for g in groups:
            if all(np.array_equal(g["seeds"][s], seeds[s]) for s in stages):
                break
        else:
            g = {"seeds": seeds, "answers": [], "last": False}
            groups.append(g)
        if index is not None:
            g["answers"].append(index)
        g["last"] |= is_last

    for i, (bi, _) in enumerate(state.answers):
        if bi == b:
            add({s: t.cpu().numpy() for s, t in state.seeded[i].items()}, index=i)
    if b in last:
        add({s: last[b][s][0] for s in stages}, is_last=True)
    return groups


def check(state) -> tuple[dict, int]:
    limits = state.ctx.workload["limits"]
    stages = [f"stage{i + 1}" for i in range(state.num_stage)]
    final = stages[-1]
    last = {b: {s: tuple(t.cpu().numpy() for t in ts) for s, ts in v.items()}
            for b, v in state.last.items()}
    groups = {b: _groups(state, b, last, stages[:-1]) for b in range(len(state.batches))}
    state.last.clear()
    state.seeded.clear()
    state.model = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = infer._reference(state)
    gaps = {"depth_mean_mm": 0.0, "prob": 0.0}
    notes = {s: {"prob": 0.0, "depth_mean_mm": 0.0, "left_out": 0.0} for s in stages}
    failed = runs = 0
    for b, host in enumerate(state.batches):
        for group in groups[b]:
            seeds = {s: torch.from_numpy(d).to(state.device) for s, d in group["seeds"].items()}
            with torch.no_grad():
                out = ref(*infer._inputs(state, host), seeds=seeds)
            runs += 1
            want = {s: (out[s]["depth"].cpu().numpy(), out[s]["prob_volume"].cpu().numpy())
                    for s in stages}
            del out, seeds
            # the pixels whose winner the volumes' agreement to the limit decides
            decided = {s: _top_two_gap(want[s][1]) > 2 * limits["prob"] for s in stages}
            for s in stages:
                notes[s]["left_out"] = max(notes[s]["left_out"], float(1 - decided[s].mean()))
            for i in group["answers"]:
                per_map = _map_mean(np.abs(state.answers[i][1] - want[final][0]), decided[final])
                gaps["depth_mean_mm"] = max(gaps["depth_mean_mm"], float(per_map.max()))
                failed += int((per_map > limits["depth_mean_mm"]).sum())
            if not group["last"]:
                continue
            bad = False
            for s, (depth, prob) in last[b].items():
                g_prob = float(np.abs(prob - want[s][1]).max())
                g_depth = float(_map_mean(np.abs(depth - want[s][0]), decided[s]).max())
                notes[s]["prob"] = max(notes[s]["prob"], g_prob)
                notes[s]["depth_mean_mm"] = max(notes[s]["depth_mean_mm"], g_depth)
                g = {"depth_mean_mm": g_depth, "prob": g_prob}
                gaps = {k: max(gaps[k], g[k]) for k in gaps}
                bad |= any(g[k] > limits[k] for k in g)
            failed += state.ctx.workload["batch"] if bad else 0
    state.check_notes = {"by_stage": notes, "reference_runs": runs}
    return gaps, min(failed, units(state))
