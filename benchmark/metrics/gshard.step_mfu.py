"""gshard.step_mfu: the least time the mesh's cards need for a training
step's work at their published peaks (`work.train_step` at the
reference's counts of the checked steps over the whole scene, divided
over the configuration's mesh_data x mesh_tile cards), over the measured
time per step of the traced window, in percent."""

from benchmark import peaks, work


def read(ctx):
    if not ctx.counts or not ctx.requests:
        return None
    cards = ctx.config["mesh_data"] * ctx.config["mesh_tile"]
    w = work.train_step(work.shape(ctx.config, ctx.counts))
    return 100.0 * peaks.least_seconds(*w) / cards / (ctx.window_s
                                                      / ctx.requests)
