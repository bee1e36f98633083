"""warp_correlate_roofline: kernel 1's share of its roofline in the traced
sub-window.  The least time of a batch's six cost passes at the cell's
shapes (per pass the larger of its least bytes over the card's bandwidth
and its fp32 operations over the fp32 peak: ``mvsbench/counts``), times the
batches of the sub-window, over the summed device time of
``warp_correlate_kernel`` in the trace."""

from mvsbench.counts import cost


def read(r):
    if r.mode != "infer" or not r.trace or not r.peaks:
        return None
    times = [t for name, ts in r.trace["kernels"].items()
             if "warp_correlate_kernel" in name and "grad" not in name for t in ts]
    if not times:
        return None
    least = cost.warp_correlate_least_seconds(
        r.config, r.workload, r.peaks["fp32_flops_per_s"], r.peaks["bytes_per_s"])
    return 100.0 * least * r.sub_iterations / sum(times)
