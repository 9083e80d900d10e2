"""gshard.slot_yield_pct: the share of the exchange's slots that carry a
live row: 100 times the program's counter `exchange.live_rows` over
`exchange.slots` (S cap_hop rows sent a step; `parallel/
gaussian_sharded.py::banded_candidates_a2a`, rank 0's), in percent. Silent
on an untraced run or a program without the tracing module; a traced run
that counted no slots raises."""

from benchmark import program_trace


def read(ctx):
    c = program_trace.counters(ctx)
    if c is None:
        return None
    if not c.get("exchange.slots"):
        raise RuntimeError("the traced run counted no exchange slots")
    return 100.0 * c["exchange.live_rows"] / c["exchange.slots"]
