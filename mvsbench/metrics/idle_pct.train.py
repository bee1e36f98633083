"""idle_pct.train: the share of the traced sub-window in which no kernel,
memcpy or memset ran on the card, from the torch.profiler trace; on a cell
of several cards, the mean of every card's share."""

from mvsbench.harness import idle_pct

KIND = "train"


def read(r):
    if r.kind != KIND or not r.traces or any(t["busy_s"] <= 0 for t in r.traces):
        return None
    return sum(idle_pct(t) for t in r.traces) / len(r.traces)
