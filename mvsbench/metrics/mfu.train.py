"""mfu.train: the training step's share of the card's fp32 peak.  The
frozen count of a step's forward, loss and backward per sample
(``mvsbench/counts``; no recomputation is counted), times the samples of the
traced run's window, over that window, over the peak of the cell's cards."""


def read(r):
    if r.mode != "train" or not r.ops_per_unit or not r.peaks or not r.units:
        return None
    peak = r.peaks["fp32_flops_per_s"] * r.workload["chips"]
    return 100.0 * r.ops_per_unit * r.units / r.window_s / peak
