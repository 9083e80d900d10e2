"""gshard.band_skew: how unevenly rank 0's shard falls over the bands of
tile rows: S times the sum over the steps of the largest per-band row
count (`exchange.band_max`) over the sum of the live rows
(`exchange.live_rows`), S the mesh's 'tile' size (the configuration's
`mesh_tile`). 1.0 when every band takes as many rows; the fullest band's
rows against the even share. Rank 0's shard is a seeded random share of
the scene, so its split samples the whole's. Silent on an untraced run or
a program without the tracing module; a traced run that counted no rows
raises."""

from benchmark import program_trace


def read(ctx):
    c = program_trace.counters(ctx)
    if c is None:
        return None
    if not c.get("exchange.live_rows"):
        raise RuntimeError("the traced run counted no exchanged rows")
    return ctx.config["mesh_tile"] * c["exchange.band_max"] / \
        c["exchange.live_rows"]
