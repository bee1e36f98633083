"""mfu.eval: the eval step's share of the cell's cards' fp32 peak.  The
frozen count of operations per map at the cell's shapes (``mvsbench/counts``,
TF32 off, so the fp32 peak outside the tensor cores is the ceiling), times
the maps of the traced run's window, over that window, over the peak of the
cell's cards."""


def read(r):
    if r.kind != "infer" or not r.ops_per_unit or not r.peaks or not r.units:
        return None
    peak = r.peaks["fp32_flops_per_s"] * r.workload["chips"]
    return 100.0 * r.ops_per_unit * r.units / r.window_s / peak
