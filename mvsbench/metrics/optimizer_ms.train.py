"""optimizer_ms.train: device milliseconds per step launched by the
optimizer and the learning-rate scheduler (``engine/state``: Adam): the
total device time of the program span ``train.optimizer`` in the traced
sub-window's Chrome trace (``mvsbench/program_spans.py``)."""

from mvsbench import program_spans


def read(r):
    if r.kind != "train" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "train.optimizer")
    if ms is None:
        return None
    return ms / r.sub_iterations
