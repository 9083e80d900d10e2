"""view.binning_ms: device time per frame of the work launched in the span
around `ops/sort.py::bin_splats`, in milliseconds."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.requests or "binning" not in s.span_device_s:
        return None
    return 1e3 * s.span_device_s["binning"] / ctx.requests
