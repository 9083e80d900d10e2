"""train.projection_bwd_ms: device time per step of the backward of the
projection and SH colour: the work of the autograd nodes whose forward ops
ran in the program's span "projection" ("projection.bwd": the 3x3
products, the SH and covariance elementwise kernels), in milliseconds.
Silent on a program without the tracing module; raises on a traced run
that finds no profiler or no gs/ request span, or device work but none in
the span (`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_request_ms(ctx, "projection.bwd")
