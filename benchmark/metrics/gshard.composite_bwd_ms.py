"""gshard.composite_bwd_ms: device time per step of the compositor's
backward over a rank's tiles: the program's span "composite_bwd"
(`ops/cuda/raster.py::CompositeTilesFn.backward`: kernel E-B and
`fold_pair_grads`) and the autograd nodes of the rest of the span
"composite" ("composite.bwd"), rank 0's, in milliseconds. Silent on a
program without the tracing module; raises on a traced run that finds no
profiler or no gs/ request span, or device work but none in the span
(`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_request_ms(ctx, "composite_bwd",
                                        "composite.bwd")
