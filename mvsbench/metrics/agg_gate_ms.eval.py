"""agg_gate_ms.eval: device milliseconds per map in the adaptive
aggregation's gates (``models/cost_reg.AggWeightNetVolume``, the sigmoid and
the product, in ``models/mvsnet.MVSNet._gate``): the
total device time of the program spans ``mvsnet.s*.*.gate`` in the traced
sub-window's Chrome trace (``mvsbench/program_spans.py``).  None where the
trace holds no such span: a configuration that aggregates by variance, or
a program that records none."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "mvsnet.s*.*.gate")
    if ms is None:
        return None
    return ms / (r.sub_iterations * r.workload["batch"])
