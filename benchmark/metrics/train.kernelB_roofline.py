"""train.kernelB_roofline: the least time one H100 needs for the
compositing backward (`work.compositing_backward` at the reference's
counts of the checked steps) over the median device time of one launch
of kernel B (`csrc/raster_bwd.cu::raster_bwd_kernel`) in the traced
window, in percent. Silent when the window launched no such kernel."""

import statistics

from benchmark import peaks, trace, work

KERNEL = "raster_bwd_kernel("


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.counts:
        return None
    times = [t for name, ts in s.kernel_s.items()
             if trace.short(name).startswith(KERNEL) for t in ts]
    if not times:
        return None
    w = work.compositing_backward(work.shape(ctx.config, ctx.counts))
    return 100.0 * peaks.least_seconds(*w) / statistics.median(times)
