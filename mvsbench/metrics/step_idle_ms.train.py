"""step_idle_ms.train: milliseconds per step in which the host was inside
the train step (the program span ``train.step``, ``engine/steps``) and no
kernel, memcpy or memset ran on the card, in the traced sub-window's
Chrome trace (``mvsbench/program_spans.py``)."""

from mvsbench import program_spans


def read(r):
    if r.kind != "train" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    if not red or "train.step" not in red["idle_ms"]:
        return None
    return red["idle_ms"]["train.step"] / r.sub_iterations
