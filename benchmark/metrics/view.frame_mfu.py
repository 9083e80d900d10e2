"""view.frame_mfu: the least time one H100 needs for a frame's work at
its published peaks (`work.frame`: projection and SH, binning, compositing
and the background, at the reference's counts of the checked views), over
the measured time per frame of the traced window, in percent."""

from benchmark import peaks, work


def read(ctx):
    if not ctx.counts or not ctx.requests:
        return None
    w = work.frame(work.shape(ctx.config, ctx.counts))
    return 100.0 * peaks.least_seconds(*w) / (ctx.window_s / ctx.requests)
