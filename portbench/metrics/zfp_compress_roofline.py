"""zfp_compress_roofline (%): the ZFP coder's share of its memory roofline
in the compress phases (the carve and K6).

The least time is the bytes the compress calls need, each read or written once,
at the published 3.35 TB/s (``peaks.json``): the f32 field, and the stream: exactly rate / 32 of the
field's bytes (``CompressionResult.nbytes``; the headers live inside the
rate's budget).
It is divided by the device time of every operation the compress calls put on
the card, so a kernel that a later change fuses, splits or adds counts
against the same work.  Reads nothing in a cell of another compressor."""

from portbench.tracing import roofline_pct

COMPRESSOR, PHASE = "tpu-zfp", "compress"


def least_bytes(raw_nbytes: int, nbytes: int) -> int:
    """Bytes one call must move: the field once and the stored stream once."""
    return raw_nbytes + nbytes


def read(ctx):
    return roofline_pct(ctx, COMPRESSOR, PHASE, least_bytes)
