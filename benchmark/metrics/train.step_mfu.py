"""train.step_mfu: the least time one H100 needs for a training step's
work at its published peaks (`work.train_step`: the frame, the loss, the
compositing and projection backward, Adam and the densification
statistics, at the reference's counts of the checked steps), over the
measured time per step of the traced window, in percent."""

from benchmark import peaks, work


def read(ctx):
    if not ctx.counts or not ctx.requests:
        return None
    w = work.train_step(work.shape(ctx.config, ctx.counts))
    return 100.0 * peaks.least_seconds(*w) / (ctx.window_s / ctx.requests)
