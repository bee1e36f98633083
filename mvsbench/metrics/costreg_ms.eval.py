"""costreg_ms.eval: device milliseconds per map in the cost U-Nets (every
``cost_regularization*`` module's forward), from the CUDA-event spans that
the benchmark records around those calls over the traced run's window."""

SPAN = "costreg"


def read(r):
    if r.kind != "infer" or not r.units or SPAN not in r.span_ms:
        return None
    return r.span_ms[SPAN] / r.units
