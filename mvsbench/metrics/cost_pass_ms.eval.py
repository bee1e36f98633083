"""cost_pass_ms.eval: device milliseconds per map in the cost passes
(``ops/warp_correlate.aggregate_cost_volume``: geometry and kernel 1), from
the CUDA-event spans that the benchmark records around those calls over the
traced run's window."""

SPAN = "cost_pass"


def read(r):
    if r.kind != "infer" or not r.units or SPAN not in r.span_ms:
        return None
    return r.span_ms[SPAN] / r.units
