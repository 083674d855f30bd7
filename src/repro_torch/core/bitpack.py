"""Block-adaptive fixed-width bit packing (the port of ``repro.core.bitpack``).

Codes are zigzag-mapped to unsigned, each block of ``BLOCK`` codes is packed
at its maximum bit length, and a code of width ``w <= 32`` at bit offset
``p`` spans at most the words ``p >> 5`` and ``(p >> 5) + 1``, so packing is
two scatter-adds and unpacking two gathers.  The stream (``words``,
``widths``, ``total_bits``) is bit for bit the reference's.

Representation.  Stored words are ``torch.uint32`` tensors, the storage
boundary; they are only ever viewed, sliced or crossed to and from another
dtype through an ``int32`` view, since PyTorch implements few operations for
``uint32`` (on the CPU it has no shifts or adds for it), and ``>>`` on
``int32`` is arithmetic where the reference's ``uint32`` shift is logical,
so all bit arithmetic carries 32-bit values in ``int64`` masked to
``[0, 2**32)``; ``u32_to_i64``/``i64_to_u32`` cross the boundary.  Offsets
and prefix sums are ``int64`` (the reference's are ``int32``; the values are
equal wherever the reference's do not wrap, which the ``n * 32 < 2**31``
limit guarantees).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

BLOCK = 64  # codes per packing block
_WIDTH_BITS = 8  # per-block header width charged to the bitstream
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class PackedCodes:
    """Bitstream produced by :func:`pack_codes`."""

    words: torch.Tensor  # uint32[capacity_words] worst-case sized buffer
    widths: torch.Tensor  # uint8[n_blocks] per-block code width (0..32)
    total_bits: torch.Tensor  # int64[] true payload size incl. headers
    n: int  # number of codes packed


def check_fits(where: str, n: int) -> None:
    """The reference's int32 bit-offset limit, with its error text."""
    if n * 32 >= 2**31:
        raise ValueError(f"{where}: n={n} too large for int32 bit offsets; chunk the field")


def u32_to_i64(u: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit pattern) tensor -> int64 in [0, 2**32)."""
    if u.dtype in (torch.uint32, torch.int32):
        u = u.view(torch.int32)
    return u.to(torch.int64) & MASK32


def i64_to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit values -> uint32 storage (wraps mod 2**32)."""
    return (v & MASK32).to(torch.int32).view(torch.uint32)


def round_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as the reference's ``jnp.round(x).astype(jnp.int32)``
    converts on XLA and the card's ``__float2int_rn`` does: round half to
    even, saturate to [-2**31, 2**31 - 1], NaN to 0.  (``.to(torch.int32)``
    of an out-of-range float is undefined; on x86 it gives -2**31.)"""
    r = torch.round(x)
    # 2**31 - 1 is no float32: clamp below 2**31 (2**31 - 128 is the float32
    # below it), then select the top value
    safe = torch.where(torch.isnan(r), 0.0, r).clamp(-2.0**31, 2.0**31 - 128)
    return torch.where(r >= 2.0**31, 2**31 - 1, safe.to(torch.int32))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device -> a host numpy array; uint32 stays uint32."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).cpu().numpy().view(np.uint32)
    return t.cpu().numpy()


def zigzag(v: torch.Tensor) -> torch.Tensor:
    """Signed int32 -> unsigned (as int64) so small magnitudes get small codes."""
    v = v.to(torch.int32).to(torch.int64)
    return ((v << 1) ^ (v >> 63)) & MASK32


def unzigzag(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`zigzag`; returns int32."""
    u = u32_to_i64(u)
    return ((u >> 1) ^ -(u & 1)).to(torch.int32)


def bitlength(u: torch.Tensor) -> torch.Tensor:
    """Exact integer bit length of 32-bit unsigned values (0 -> 0); int32."""
    v = u32_to_i64(u)
    w = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        w = w + m.to(torch.int64) * s
        v = torch.where(m, v >> s, v)
    return (w + (v > 0).to(torch.int64)).to(torch.int32)


def code_mask(w: torch.Tensor) -> torch.Tensor:
    """Mask of the low ``w`` bits (as int64), exact for w in [0, 32]."""
    w = w.to(torch.int64)
    shift = 32 - torch.clamp(w, min=1)  # in [0, 31]
    return torch.where(w == 0, 0, torch.full_like(w, MASK32) >> shift)


def _block_layout(n: int, block: int) -> tuple[int, int]:
    n_blocks = -(-n // block)
    return n_blocks, n_blocks * block


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``dim`` (int64 for integer input)."""
    return torch.cumsum(x, dim=dim) - x


def compact_streams(rows: torch.Tensor, counts: torch.Tensor, capacity: int):
    """Concatenate variable-length streams into one dense word arena.

    ``rows`` is ``[R, W]`` (uint32 or int32 bit patterns), stream ``r`` dense
    from word 0 and ``counts[r] <= W`` words long.  Returns ``(words,
    offsets, used)`` with stream ``r`` at ``words[offsets[r] : offsets[r] +
    counts[r]]`` and zeros past ``used`` — one exclusive scan and one
    gather.  Rows of zero count repeat an offset, so the row of word ``i``
    is found with ``searchsorted(..., right=True)`` as in the reference.
    """
    counts = counts.to(torch.int64)
    offsets = exclusive_cumsum(counts)
    used = counts.sum()
    i = torch.arange(capacity, dtype=torch.int64, device=rows.device)
    r = torch.searchsorted(offsets, i, right=True) - 1
    off = i - offsets[r]
    valid = (off < counts[r]) & (i < used)
    bits = rows.view(torch.int32) if rows.dtype == torch.uint32 else rows
    vals = bits[r, off.clamp(0, rows.shape[1] - 1)]
    words = torch.where(valid, vals, torch.zeros((), dtype=bits.dtype, device=rows.device))
    if rows.dtype == torch.uint32:
        words = words.view(torch.uint32)
    return words, offsets, used


def _code_positions(width: torch.Tensor, padded: int, block: int):
    """Absolute bit position of bit 0 of every code, and each code's width."""
    width = width.to(torch.int64)
    base = exclusive_cumsum(width * block)
    pos = torch.arange(padded, dtype=torch.int64, device=width.device)
    blk = pos // block
    w_per = width[blk]
    return base[blk] + (pos % block) * w_per, w_per


def pack_codes(codes: torch.Tensor, block: int = BLOCK) -> PackedCodes:
    """Pack signed int32 ``codes`` (flat) into a block-adaptive bitstream."""
    n = codes.numel()
    check_fits("pack_codes", n)
    n_blocks, padded = _block_layout(n, block)
    u = F.pad(zigzag(codes.reshape(-1)), (0, padded - n))
    width = bitlength(u.view(n_blocks, block)).amax(dim=1)  # int32[n_blocks]
    pos0, _ = _code_positions(width, padded, block)

    capacity = n + 2  # worst case: 32 bits/code => n words; +2 slack
    # Codes never share a bit, so add == OR and sums stay below 2**32.
    # Indices past the capacity only carry zero bits (the reference drops
    # them); the buffer holds every index and is cut to the capacity.
    off = pos0 & 31
    word0 = pos0 >> 5
    lo = (u << off) & MASK32
    hi = (u >> 1) >> (31 - off)  # u >> (32 - off), 0 at off == 0
    buf = torch.zeros(padded + 66, dtype=torch.int64, device=codes.device)
    buf.index_add_(0, word0, lo)
    buf.index_add_(0, word0 + 1, hi)

    total_bits = (width.to(torch.int64) * block).sum() + n_blocks * _WIDTH_BITS
    return PackedCodes(i64_to_u32(buf[:capacity]), width.to(torch.uint8), total_bits, n)


def unpack_codes(packed: PackedCodes, block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns int32[n]."""
    n = packed.n
    _, padded = _block_layout(n, block)
    pos0, w_per = _code_positions(packed.widths, padded, block)
    words = u32_to_i64(packed.words)
    cap = words.shape[0]
    off = pos0 & 31
    lo = words[(pos0 >> 5).clamp(0, cap - 1)] >> off
    # words[word1] << (32 - off); two-step shift so off == 0 yields 0
    hi = ((words[((pos0 >> 5) + 1).clamp(0, cap - 1)] << 1) << (31 - off)) & MASK32
    u = (lo | hi) & code_mask(w_per)
    return unzigzag(u[:n])


def _row_positions(width: torch.Tensor, block: int):
    """Per-row bit position of bit 0 of every code, and each code's width
    (int64 [B, P]), for block widths ``width`` [B, P // block]."""
    width = width.to(torch.int64)
    base = exclusive_cumsum(width * block, dim=1)
    idx_in_block = torch.arange(width.shape[1] * block, dtype=torch.int64,
                                device=width.device) % block
    w_per = torch.repeat_interleave(width, block, dim=1)
    return torch.repeat_interleave(base, block, dim=1) + idx_in_block[None, :] * w_per, w_per


def pack_codes_rows(codes: torch.Tensor, n, block: int = BLOCK):
    """Batched :func:`pack_codes` over ``codes: int32[B, P]`` rows (P a
    ``block`` multiple): row ``b`` holds ``n[b]`` real codes left-justified,
    zeros past them, so its stream equals ``pack_codes(codes[b, :n[b]])``.

    Returns ``(rows, counts, widths, total_bits)``: uint32 [B, P + 2]
    buffers dense from word 0, int32 [B] stored words ``min(2 * sum(width),
    n + 2)``, uint8 [B, P // block] widths and int32 [B] bits with headers
    charged for ``ceil(n[b] / block)`` blocks only — the reference's
    accounting exactly.  The reference scatters with ``mode="drop"``; no
    index can drop here, since the last code's high word is at most ``P``.
    """
    bsz, padded = codes.shape
    if padded % block:
        raise ValueError(f"pack_codes_rows: row length {padded} not a {block} multiple")
    if padded * 32 >= 2**31:
        raise ValueError(f"pack_codes_rows: P={padded} too large for int32 bit offsets")
    n = torch.as_tensor(n, dtype=torch.int64, device=codes.device)
    u = zigzag(codes)
    width = bitlength(u.view(bsz, padded // block, block)).amax(dim=2)  # int32 [B, nb]
    pos0, _ = _row_positions(width, block)
    off = pos0 & 31
    word0 = pos0 >> 5
    lo = (u << off) & MASK32
    hi = (u >> 1) >> (31 - off)  # u >> (32 - off), 0 at off == 0
    buf = torch.zeros(bsz, padded + 2, dtype=torch.int64, device=codes.device)
    buf.scatter_add_(1, word0, lo)  # codes never share a bit: add == OR
    buf.scatter_add_(1, word0 + 1, hi)

    wsum = width.to(torch.int64).sum(dim=1)
    counts = torch.minimum(2 * wsum, n + 2)
    total_bits = wsum * block + (n + block - 1) // block * _WIDTH_BITS
    return (i64_to_u32(buf), counts.to(torch.int32), width.to(torch.uint8),
            total_bits.to(torch.int32))


def unpack_codes_rows(rows: torch.Tensor, widths: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_codes_rows`: uint32 [B, cap] payload buffers +
    uint8 [B, nb] widths -> int32 [B, nb * block] codes (zeros past each
    row's real length)."""
    words = u32_to_i64(rows)
    cap = words.shape[1]
    pos0, w_per = _row_positions(widths, block)
    off = pos0 & 31
    lo = torch.gather(words, 1, (pos0 >> 5).clamp(0, cap - 1)) >> off
    # words[word1] << (32 - off); two-step shift so off == 0 yields 0
    hi = ((torch.gather(words, 1, ((pos0 >> 5) + 1).clamp(0, cap - 1)) << 1) << (31 - off)) & MASK32
    return unzigzag((lo | hi) & code_mask(w_per))


def packed_nbytes(packed: PackedCodes) -> torch.Tensor:
    """True storage bytes of the stream (payload + block headers)."""
    return (packed.total_bits + 7) // 8


def to_storage(packed: PackedCodes) -> dict[str, np.ndarray]:
    """Host-side: slice the worst-case buffer down to the real payload."""
    bits = int(packed.total_bits)
    n_words = (bits - int(packed.widths.shape[0]) * _WIDTH_BITS + 31) // 32
    return {
        "words": to_numpy(packed.words[:n_words]),
        "widths": to_numpy(packed.widths),
        "n": np.asarray(packed.n),
    }


def from_storage(words, widths, n: int, total_bits=None,
                 device: str | torch.device | None = None) -> PackedCodes:
    """Rebuild a :class:`PackedCodes` on ``device`` (CUDA unless ``"cpu"``,
    :func:`repro_torch.device.resolve_device`) from its true-payload storage
    slice (inverse of :func:`to_storage`): zero-extend the words back to the
    worst-case ``n + 2`` capacity the unpackers expect."""
    device = resolve_device(device)
    words = np.asarray(words, np.uint32)
    widths = np.array(widths, np.uint8)  # a writable copy for torch.from_numpy
    # a descriptor that disagrees with its payload is refused here, before
    # any device work, as a ValueError
    if widths.shape != (-(-n // BLOCK),) or len(words) > n + 2 or (widths > 32).any():
        raise ValueError(f"stream of {n} codes: {widths.shape} widths (max "
                         f"{int(widths.max(initial=0))}), {len(words)} words")
    if total_bits is None:
        total_bits = int(np.sum(widths.astype(np.int64)) * BLOCK
                         + widths.shape[0] * _WIDTH_BITS)
    wfull = np.zeros(n + 2, np.uint32)
    wfull[: len(words)] = words
    words_t = torch.from_numpy(wfull.view(np.int32)).to(device).view(torch.uint32)
    return PackedCodes(words_t, torch.from_numpy(widths).to(device),
                       torch.tensor(int(total_bits), dtype=torch.int64, device=device), n)
