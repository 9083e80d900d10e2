"""view.kernelA_roofline: the least time one H100 needs for the compositing
stage (`work.compositing` at the reference's counts of the checked
views) over the median device time of one launch of kernel A
(`csrc/raster_fwd.cu::raster_fwd_kernel`) in the traced window, in
percent. Silent when the window launched no such kernel."""

import statistics

from benchmark import peaks, trace, work

KERNEL = "raster_fwd_kernel("


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.counts:
        return None
    times = [t for name, ts in s.kernel_s.items()
             if trace.short(name).startswith(KERNEL) for t in ts]
    if not times:
        return None
    w = work.compositing(work.shape(ctx.config, ctx.counts))
    return 100.0 * peaks.least_seconds(*w) / statistics.median(times)
