"""sz_core_compress_roofline (%): SZ's core coder's share of its memory
roofline in the compress phases of the 1-D route (the cube's pad, PW_REL's
log transform, the guarded bound, the prequantize, the int64 Lorenzo
residual and the packer, all plain PyTorch operations).

The least time is the bytes the compress calls need, each read or written
once, at the published 3.35 TB/s (``peaks.json``): the f32 field, and the
stream's stored bytes: its words as ``total_bits`` counts them (never the
n + 2-word capacity buffer), one width byte a block and, under PW_REL, the
2-bit sign channel, all of which ``CompressionResult.nbytes`` holds.
It is divided by the device time of every operation the compress calls put on
the card, so an operation that a later change fuses, splits or adds counts
against the same work.  Reads nothing in a cell of another compressor."""

from portbench.tracing import roofline_pct

COMPRESSOR, PHASE = "tpu-sz", "compress"


def least_bytes(raw_nbytes: int, nbytes: int) -> int:
    """Bytes one call must move: the field once and the stored stream once."""
    return raw_nbytes + nbytes


def read(ctx):
    return roofline_pct(ctx, COMPRESSOR, PHASE, least_bytes)
