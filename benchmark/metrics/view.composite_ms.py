"""view.composite_ms: device time per frame of the work in the program's span
"composite" (`ops/rasterize.py::rasterize_tiles`: the field packing, the
compositor's checks and kernel A; and the background), in milliseconds.
Silent on a program without the tracing module; raises on a traced run
that finds no profiler or no gs/ request span, or device work but none in
the span (`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_request_ms(ctx, "composite")
