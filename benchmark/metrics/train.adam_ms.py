"""train.adam_ms: device time per step of the work launched in the span
around `train/trainer.py::apply_gradients`, in milliseconds."""


def read(ctx):
    s = ctx.summary
    if s is None or not ctx.requests or "adam" not in s.span_device_s:
        return None
    return 1e3 * s.span_device_s["adam"] / ctx.requests
