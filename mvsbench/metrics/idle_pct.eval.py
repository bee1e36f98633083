"""idle_pct.eval: the share of the traced sub-window in which no kernel,
memcpy or memset ran on the card, from the torch.profiler trace."""

MODE = "infer"


def read(r):
    if r.mode != MODE or not r.trace or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
