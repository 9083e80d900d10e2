"""gshard.exchange_ms: device time per step of the work in the program's span
"exchange" (`parallel/gaussian_sharded.py`: the band classes, the stable
sort, the packing and the forward all-to-all), rank 0's, in milliseconds.
Silent on a program without the tracing module; raises on a traced run
that finds no profiler or no gs/ request span, or device work but none in
the span (`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    return program_trace.per_request_ms(ctx, "exchange")
