"""view_weight_ms.eval: device milliseconds per map in TransMVSNet's
pixel-wise view-weight net (``models/transmvsnet.PixelwiseNet``, once per
source view at stage 1): the total device time of the program spans
``mvsnet.s*.main.view_weight`` in the traced sub-window's Chrome trace
(``mvsbench/program_spans.py``).  None where the trace holds no such span:
another architecture, or a program that records none."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "mvsnet.s*.main.view_weight")
    if ms is None:
        return None
    return ms / (r.sub_iterations * r.workload["batch"])
