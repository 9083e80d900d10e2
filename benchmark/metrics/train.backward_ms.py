"""train.backward_ms: device time per step of the work launched from the
loss's return to the optimizer's call: `loss.backward()`, the projection
and SH backward, `CompositeFn`'s backward with kernel B and
`fold_pair_grads`, in milliseconds."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.requests or "backward" not in s.span_device_s:
        return None
    return 1e3 * s.span_device_s["backward"] / ctx.requests
