"""view.projection_ms: device time per frame of the work launched in the
span around `project_gaussians` (ops/projection.py and ops/sh.py), in
milliseconds."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.requests or "projection" not in s.span_device_s:
        return None
    return 1e3 * s.span_device_s["projection"] / ctx.requests
