"""pair_cost_ms.eval: device milliseconds per map in TransMVSNet's pixel-wise
cost passes less its view-weight net: each source view's pair pass of
kernel 1 at V = 2 (``ops/warp_correlate.aggregate_cost_volume_pixelwise``),
the channel means, the weighted sum and its normalisation, and at stages 2
and 3 the view weights' upsampling.  It is the
total device time of the program spans ``mvsnet.s*.main.cost`` less that of
``mvsnet.s*.main.view_weight``, which they hold, in the traced sub-window's
Chrome trace (``mvsbench/program_spans.py``).  None where the trace holds no
view-weight span: another architecture, or a program that records none."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    if not red:
        return None
    cost = program_spans.summed(red["total_ms"], "mvsnet.s*.main.cost")
    view = program_spans.summed(red["total_ms"], "mvsnet.s*.main.view_weight")
    if cost is None or view is None:
        return None
    return (cost - view) / (r.sub_iterations * r.workload["batch"])
