"""view.host_syncs: synchronising CUDA calls per frame inside `render`
(the binning's and the kernel wrappers' reads of device values), counted
with `torch.cuda.set_sync_debug_mode` in the traced window."""


def read(ctx):
    return ctx.syncs_per_request
