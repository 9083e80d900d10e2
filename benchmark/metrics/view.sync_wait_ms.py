"""view.sync_wait_ms: host time per frame blocked at syncs inside the
program's spans (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, and memcpy calls that copy device to host: the
binning's `nonzero`, the compositor's checks), in milliseconds; the loop's
own copy of the frame, outside the spans, is left out. Silent on a program
without the tracing module; raises on a traced run that finds no profiler
or no gs/ request span (`program_trace`)."""

from benchmark import program_trace


def read(ctx):
    p = program_trace.of_run(ctx)
    return None if p is None else 1e3 * p.waits() / p.requests
