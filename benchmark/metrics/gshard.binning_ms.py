"""gshard.binning_ms: device time per step of the work in the program's span
"binning" (`ops/sort.py::bin_splats` over the candidate rows a rank
received), rank 0's, in milliseconds. Silent on a program without the
tracing module; raises on a traced run that finds no profiler or no gs/
request span, or device work but none in the span (`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_request_ms(ctx, "binning")
