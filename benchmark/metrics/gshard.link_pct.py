"""gshard.link_pct: the all-to-alls' share of the NVLink roofline: the bytes
that leave rank 0's card in the exchange's two all-to-alls (the program's
counter `exchange.bytes_off`) over the device time of the NCCL send/receive
kernels that carry them (every kernel with "SendRecv" in its name in the
traced window), as a share of one H100 SXM's 450 GB/s a direction
(`benchmark/nvlink.py`), in percent. The kernels' time includes their wait
for the slowest peer. Silent on an untraced run, a run without device
work (the CPU) or a program without the tracing module; a traced run on
the card that counted no exchange, or bytes but no such kernel, raises;
on a mesh of one rank no byte leaves the card and it is silent."""

from benchmark import nvlink, program_trace

KERNEL = "SendRecv"


def read(ctx):
    c = program_trace.counters(ctx)
    s = ctx.summary
    if c is None or s is None or not s.events:
        return None
    if not c.get("exchange.slots"):
        raise RuntimeError("the traced run counted no exchange")
    if not c.get("exchange.bytes_off"):
        return None        # a mesh of one rank: nothing left the card
    seconds = sum(t for name, ts in s.kernel_s.items() if KERNEL in name
                  for t in ts)
    if seconds <= 0:
        raise RuntimeError("the traced run ran no NCCL send/receive kernel")
    return 100.0 * c["exchange.bytes_off"] / seconds / nvlink.NVLINK_BYTES_S
