"""allreduce_exposed_ms.train: milliseconds per step on rank 0 in which an
NCCL kernel ran and no other kernel did (the gradient all-reduce that the
backward does not hide, the synced batch norm's all-reduces on the
forward's path), from the torch.profiler trace of the traced sub-window."""


def read(r):
    if r.mode != "train_ddp" or not r.trace or not r.sub_iterations:
        return None
    if r.trace["collective_s"] <= 0:
        return None
    return 1e3 * r.trace["collective_exposed_s"] / r.sub_iterations
