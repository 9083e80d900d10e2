"""view.pair_yield_pct: the share of the binning's slots that hold a live
(tile, splat) pair, over the traced window: 100 times the program's
counter `binning.live_pairs` over `binning.slots` (`ops/sort.py::
bin_splats`, which counts while a profiler records), in percent. Silent on
a program without the tracing module; a traced run in which the binning
counted nothing raises."""

from benchmark import program_trace


def read(ctx):
    c = program_trace.counters(ctx)
    if c is None:
        return None
    if not c.get("binning.slots"):
        raise RuntimeError("the traced run counted no binning slots")
    return 100.0 * c["binning.live_pairs"] / c["binning.slots"]
