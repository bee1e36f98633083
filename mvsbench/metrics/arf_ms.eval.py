"""arf_ms.eval: device milliseconds per map in TransMVSNet's Adaptive
Receptive Field heads (``models/transmvsnet.ARFFeatureNet``'s ``out1`` to
``out3``: a conv block and three modulated deformable convolutions each,
``ops/deform_conv``): the total device time of the program spans
``mvsnet.arf.s*`` in the traced sub-window's Chrome trace
(``mvsbench/program_spans.py``).  None where the trace holds no such span:
another architecture, or a program that records none."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "mvsnet.arf.s*")
    if ms is None:
        return None
    return ms / (r.sub_iterations * r.workload["batch"])
