"""heads_ms.eval: device milliseconds per map in hypothesis sampling and the
depth heads (``core/sampling``, ``models/depth_net``): the self device time
of the program spans ``mvsnet.s*.sample`` and ``mvsnet.s*.*.head`` in the
traced sub-window's Chrome trace (``mvsbench/program_spans.py``)."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["self_ms"], "mvsnet.s*.sample", "mvsnet.s*.*.head")
    if ms is None:
        return None
    return ms / (r.sub_iterations * r.workload["batch"])
