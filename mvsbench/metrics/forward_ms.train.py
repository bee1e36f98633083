"""forward_ms.train: device milliseconds per step launched in the training
forward and the loss (``models/``, ``losses/mvs_loss``): the total device
time of the program spans ``train.forward`` and ``train.loss`` in the traced
sub-window's Chrome trace (``mvsbench/program_spans.py``)."""

from mvsbench import program_spans


def read(r):
    if r.kind != "train" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    ms = red and program_spans.summed(red["total_ms"], "train.forward", "train.loss")
    if ms is None:
        return None
    return ms / r.sub_iterations
