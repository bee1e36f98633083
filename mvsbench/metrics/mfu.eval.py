"""mfu.eval: the eval step's share of the card's fp32 peak.  The frozen
count of operations per map at the cell's shapes (``mvsbench/counts``,
TF32 off, so the fp32 peak outside the tensor cores is the ceiling), times
the maps of the traced run's window, over that window, over the peak."""


def read(r):
    if r.mode != "infer" or not r.ops_per_unit or not r.peaks or not r.units:
        return None
    return 100.0 * r.ops_per_unit * r.units / r.window_s / r.peaks["fp32_flops_per_s"]
