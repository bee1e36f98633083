"""forward_idle_ms.eval: milliseconds per map in which the host was inside
the model's forward (the program span ``mvsnet.forward``) and no kernel,
memcpy or memset ran on the card, in the traced sub-window's Chrome trace
(``mvsbench/program_spans.py``)."""

from mvsbench import program_spans


def read(r):
    if r.kind != "infer" or not r.sub_iterations:
        return None
    red = program_spans.reduction(r)
    if not red or "mvsnet.forward" not in red["idle_ms"]:
        return None
    return red["idle_ms"]["mvsnet.forward"] / (r.sub_iterations * r.workload["batch"])
