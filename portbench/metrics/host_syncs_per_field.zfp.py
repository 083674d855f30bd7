"""host_syncs_per_field.zfp (syncs/field): the synchronising runtime calls
(a stream, device or event synchronise, a blocking copy) the entry point
makes while a compress phase's calls run, per field or box, counted exactly
from the trace's runtime calls, in the cells of the ZFP route.  Today SZ pays
one a call (``int(packed.total_bits)``) and ZFP none."""

from portbench.tracing import syncs_per_call


def read(ctx):
    return syncs_per_call(ctx.trace, "compress")
