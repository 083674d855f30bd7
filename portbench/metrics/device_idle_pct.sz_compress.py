"""device_idle_pct.sz_compress (%): in the cells of the SZ route, the share of
the compress phases' wall time (their host spans, from the first call to the
synchronise's return) in which no operation ran on the card."""

from portbench.tracing import idle_pct


def read(ctx):
    return idle_pct(ctx.trace, "compress")
