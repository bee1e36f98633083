"""fmt_ms.eval: device milliseconds per map in TransMVSNet's Feature Matching
Transformer (``models/transmvsnet.FMTWithPathway``: the position encoding,
the eight linear-attention layers and the pathway down to stages 2 and 3):
the total device time of the program span ``mvsnet.fmt`` in the traced
sub-window's Chrome trace (``mvsbench/program_spans.py``).  None where the
trace holds no such span: another architecture, or a program that records
none."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "mvsnet.fmt")
    if ms is None:
        return None
    return ms / (r.sub_iterations * r.workload["batch"])
