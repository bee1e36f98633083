"""allreduce_exposed_ms.train: milliseconds per step in which an NCCL
kernel ran and no other kernel did (the gradient all-reduce that the
backward does not hide, the synced batch norm's all-reduces on the
forward's path), from the torch.profiler traces of the traced sub-window,
on the card where it is least.  An NCCL kernel runs from its own rank's
arrival until the last rank's, so a card's exposed time holds its wait for
the slower ranks; the card that waited least comes closest to the
exchange's own cost.  Nothing to read where no NCCL kernel ran (a cell on
one card)."""


def read(r):
    if r.kind != "train" or not r.traces or not r.sub_iterations:
        return None
    if any(t["collective_s"] <= 0 for t in r.traces):
        return None
    return 1e3 * min(t["collective_exposed_s"] for t in r.traces) / r.sub_iterations
