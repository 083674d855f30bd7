"""K3, K4, K8 and K9: single-pass fused TPU-SZ encode/decode, for one field
and for a batch of same-shape fields (the port of ``repro.kernels.sz_fused``).

The kernels' entry points are the stream-level functions.
:func:`fused_compress` fuses dual quantization + 3-D Lorenzo residual +
zigzag + per-block width + word-level packing + stream assembly: a TILE-padded
f32 field in, the dense stream out (uint32 words of capacity ``n + 2``, zero
past the payload, uint8 widths, device int64 ``total_bits``), and the int32
residuals never reach device memory.  :func:`fused_decompress` inverts it in
one pass: it finds each block's payload in the stream, unpacks, unzigzags,
runs the per-tile 3-fold prefix sum and dequantizes.

Bitstream layout: identical to ``bitpack.pack_codes`` applied to the
tile-major flattening of the residual field (tiles in raster order, each
(8, 64, 128) tile flattened C-order), so the ``fused`` and ``xla`` paths of
:mod:`repro_torch.kernels.ops` emit the same stream and decode each other's.

K8 and K9 (:func:`fused_compress_batched`, :func:`fused_decompress_batched`)
are the arena-batched forms (the snapshot path's kernel buckets): (B, Z, Y,
X) TILE-aligned rows with a per-row bound ``eb_i[B]`` go through one launch,
row ``b``'s stream right after row ``b - 1``'s in one word arena, so K8 is K3
over the (B*Z, Y, X) field with the bound of each block's row (no tile spans
two rows, since prediction resets at tile edges and Z % 8 == 0), and K9 is
K4 over the arena.

On a CUDA tensor the four stream-level functions launch the kernels in
``csrc/sz_fused.cu`` (or raise): one launch each, no host sync, nothing but
``torch.zeros``/``torch.empty`` around it, so each captures in a CUDA graph.
On a CPU tensor they run their plain versions, which compute what the JAX
package computes around its Pallas calls: a 64-word payload row per block
(:func:`fused_encode_plain`, the reference's ``_fused_encode``), the dense
stream compacted from the rows (:func:`_assemble_stream`,
``bitpack.compact_streams``), and back (:func:`_disassemble`,
:func:`fused_decode_plain`).  The rows exist only because a TPU kernel
cannot scatter; the CUDA kernels never form them.  ``launches`` counts kernel
launches, nothing else; a single field's launch, with its allocations and
zeroed scratch, is a span ``kernel.fused_compress`` or
``kernel.fused_decompress`` (:mod:`repro_torch.obs.trace`).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build
from repro_torch.kernels import lorenzo3d as _lor
from repro_torch.obs import trace as obs_trace

TILE = _lor.TILE  # (8, 64, 128)
CODES_PER_TILE = TILE[0] * TILE[1] * TILE[2]  # 65536
BLOCKS_PER_TILE = CODES_PER_TILE // bitpack.BLOCK  # 1024
WORDS_PER_BLOCK = 64  # a block's payload is at most 2 * 32 words
CHUNK_POINTS = TILE[1] * TILE[2]  # a kernel's work unit: one z-plane of a tile

launches = {"fused_compress": 0, "fused_decompress": 0, "fused_compress_batched": 0,
            "fused_decompress_batched": 0}


def tile_major_flatten(a: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) -> flat codes in tile-major order (the kernel bitstream
    order): tiles in raster order, each tile flattened C-order."""
    return _lor.to_tiles(a).reshape(-1)


def tile_major_unflatten(flat: torch.Tensor, padded_shape) -> torch.Tensor:
    """Inverse of :func:`tile_major_flatten`."""
    gz, gy, gx = _lor.tile_grid(padded_shape)
    return _lor.from_tiles(flat.reshape(gz, gy, gx, *TILE))


# ------------------------------------------------- block rows (plain) -----


def _in_block_layout(width: torch.Tensor):
    """Per-code (lo-word index, bit offset) inside a block payload, int64
    [nb, BLOCK], with ``i * w = 32 * wlo + off``."""
    i = torch.arange(bitpack.BLOCK, dtype=torch.int64, device=width.device)
    bitpos = i[None, :] * width.to(torch.int64)[:, None]
    return bitpos >> 5, bitpos & 31


def _pack_blocks(u: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Pack codes ``u`` (32-bit values in int64, [nb, BLOCK]) into uint32
    [nb, WORDS_PER_BLOCK] payload rows, dense from word 0 and zero past
    ``2*width``: each code adds its low part to word ``wlo`` and its high part
    to ``wlo + 1`` (bit positions never collide, so add == OR)."""
    wlo, off = _in_block_layout(width)
    lo = (u << off) & bitpack.MASK32
    hi = (u >> 1) >> (31 - off)  # u >> (32 - off), 0 at off == 0
    rows = torch.zeros(u.shape[0], WORDS_PER_BLOCK + 1, dtype=torch.int64, device=u.device)
    rows.scatter_add_(1, wlo, lo)
    rows.scatter_add_(1, wlo + 1, hi)  # column 64 only ever receives zeros
    return bitpack.i64_to_u32(rows[:, :WORDS_PER_BLOCK])


def _unpack_blocks(words: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_blocks`: uint32 [nb, WORDS_PER_BLOCK] rows ->
    codes as int64 [nb, BLOCK]."""
    wlo, off = _in_block_layout(width)
    w = bitpack.u32_to_i64(words)
    lo = torch.gather(w, 1, wlo) >> off
    hi = ((torch.gather(w, 1, (wlo + 1).clamp(max=WORDS_PER_BLOCK - 1)) << 1) << (31 - off))
    return ((lo | hi) & bitpack.MASK32) & bitpack.code_mask(width.to(torch.int64)[:, None])


def fused_encode_plain(x: torch.Tensor, eb_i):
    """The reference's ``_fused_encode`` (the K3 Pallas kernel): f32 (Z, Y,
    X), TILE-padded -> per-block payload rows (uint32 [n/64, 64]) and widths
    (int32 [n/64]) in tile-major block order."""
    delta = _lor.lorenzo3d_quantize_plain(x, eb_i)
    u = bitpack.zigzag(tile_major_flatten(delta)).view(-1, bitpack.BLOCK)
    width = bitpack.bitlength(u).amax(dim=1)
    return _pack_blocks(u, width), width


def _assemble_stream(block_words: torch.Tensor, width: torch.Tensor, n: int) -> bitpack.PackedCodes:
    """Concatenate per-block payloads into the dense global stream, equal to
    ``bitpack.pack_codes`` on the tile-major residuals (block payloads are
    word-aligned, so this is one compaction and no bit arithmetic)."""
    # capacity n + 2 matches pack_codes' worst-case buffer exactly
    words, _, _ = bitpack.compact_streams(block_words, 2 * width, n + 2)
    total_bits = (width.to(torch.int64) * bitpack.BLOCK).sum() + width.shape[0] * bitpack._WIDTH_BITS
    return bitpack.PackedCodes(words, width.to(torch.uint8), total_bits, n)


def _disassemble(words: torch.Tensor, widths: torch.Tensor):
    """The inverse of :func:`_assemble_stream`.  Dense stream(s) -> per-block
    payload rows (uint32 [nb, 64], zero past ``2*w``) and int32 widths:
    block payloads lie back to back, so the exclusive scan of ``2*w`` is
    the offset table (one gather)."""
    width = widths.reshape(-1).to(torch.int32)
    wcount = 2 * width.to(torch.int64)
    base = bitpack.exclusive_cumsum(wcount)
    j = torch.arange(WORDS_PER_BLOCK, dtype=torch.int64, device=width.device)
    idx = base[:, None] + j[None, :]
    words = words.view(torch.int32)
    vals = words[idx.clamp(0, words.shape[0] - 1)]
    rows = torch.where(j[None, :] < wcount[:, None], vals, torch.zeros((), dtype=torch.int32,
                                                                         device=vals.device))
    return rows.view(torch.uint32), width


def fused_decode_plain(block_words: torch.Tensor, width: torch.Tensor, padded_shape, eb_i):
    """The reference's ``_decode_tile`` over every tile (the K4 Pallas
    kernel): per-block payload rows + widths -> unpack + unzigzag + per-tile
    3-fold prefix sum + dequantize -> f32 ``padded_shape``."""
    u = _unpack_blocks(block_words, width)
    delta = tile_major_unflatten(bitpack.unzigzag(u).reshape(-1), padded_shape)
    return _lor.lorenzo3d_reconstruct_plain(delta, eb_i)


def _eb_rows(eb_i, like: torch.Tensor, bsz: int) -> torch.Tensor:
    eb = torch.as_tensor(eb_i, dtype=torch.float32, device=like.device).reshape(-1)
    if eb.numel() != bsz:
        raise ValueError(f"eb_i must hold one bound per row: want {bsz}, got {eb.numel()}")
    return eb.contiguous()


def fused_encode_batched_plain(x: torch.Tensor, eb_i):
    """The reference's ``_fused_encode_batched``: :func:`fused_encode_plain`
    on each row, blocks of row 0 first (uint32 [B * nb, 64] rows, int32
    [B * nb] widths)."""
    eb = _eb_rows(eb_i, x, x.shape[0])
    parts = [fused_encode_plain(x[b], eb[b]) for b in range(x.shape[0])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def fused_decode_batched_plain(block_words: torch.Tensor, width: torch.Tensor, padded_shape,
                               eb_i) -> torch.Tensor:
    """:func:`fused_decode_plain` on each row's blocks -> f32 (B, *padded_shape)."""
    nb = math.prod(padded_shape) // bitpack.BLOCK
    bsz = width.numel() // nb
    eb = _eb_rows(eb_i, block_words, bsz)
    return torch.stack([fused_decode_plain(block_words[b * nb:(b + 1) * nb],
                                           width[b * nb:(b + 1) * nb], padded_shape, eb[b])
                        for b in range(bsz)])


# ------------------------------------------------------- K3 and K8 -------


def _check_rows(x: torch.Tensor, where: str) -> None:
    _build.check_cuda(x, torch.float32, f"{where} x")
    if x.data_ptr() % 16:
        raise ValueError(f"{where}: x must be 16-byte aligned (the kernel reads 16-byte vectors)")


def _scratch(units: int, device) -> torch.Tensor:
    """The look-back's flags (one per unit: a tile plane for the encoder, a
    tile for the decoder) and the ticket, zeroed."""
    return torch.zeros(units + 1, dtype=torch.int64, device=device)


def _encode(x: torch.Tensor, eb: torch.Tensor, bsz: int, row_meta, row_bits):
    """Launch the stream encoder over ``bsz`` TILE-padded rows of ``x``;
    returns (words uint32 [bsz * (n + 2)], widths uint8 [bsz * n / 64])."""
    z, y, w = x.shape[-3:]
    n = z * y * w
    words = torch.empty(bsz * (n + 2), dtype=torch.int32, device=x.device)  # the kernel writes all
    widths = torch.empty(bsz * n // bitpack.BLOCK, dtype=torch.uint8, device=x.device)
    scratch = _scratch(bsz * n // CHUNK_POINTS, x.device)
    P, I = _build.P, _build.I
    _build.launch("sz_fused", "sz_stream_encode", [P, P, P, P, P, P, P, I, I, I, I],
                  x.data_ptr(), eb.data_ptr(), words.data_ptr(), widths.data_ptr(),
                  scratch.data_ptr(), row_meta, row_bits, bsz, z, y, w, device=x.device)
    return words.view(torch.uint32), widths


def fused_compress_plain(x: torch.Tensor, eb_i) -> bitpack.PackedCodes:
    """Plain version of K3: the reference's ``fused_compress``, block rows
    then one compaction."""
    n = x.numel()
    bitpack.check_fits("fused_compress", n)
    return _assemble_stream(*fused_encode_plain(x, eb_i), n)


def fused_compress(x: torch.Tensor, eb_i) -> bitpack.PackedCodes:
    """K3: fused SZ encode of a TILE-padded f32 (Z, Y, X) field straight to
    the dense stream, equal to the ``xla`` path's
    ``pack_codes(tile_major_flatten(lorenzo3d_quantize(x)))``."""
    n = x.numel()
    bitpack.check_fits("fused_compress", n)
    if x.device.type == "cpu":
        return fused_compress_plain(x, eb_i)
    _lor.tile_grid(x.shape)
    eb = _lor._eb_on(eb_i, x)
    _check_rows(x, "fused_compress")
    with obs_trace.span("kernel.fused_compress"):
        total_bits = torch.empty((), dtype=torch.int64, device=x.device)
        words, widths = _encode(x, eb, 1, None, total_bits.data_ptr())
        launches["fused_compress"] += 1
    return bitpack.PackedCodes(words, widths, total_bits, n)


def _batched_rows(x: torch.Tensor, where: str) -> int:
    n = math.prod(x.shape[1:])
    if n * 32 >= 2**31:
        raise ValueError(f"{where}: row n={n} too large; chunk the field")
    if x.shape[0] * (n + 2) >= 2**31:
        raise ValueError(f"{where}: {x.shape[0]} rows of n={n} overflow int32 arena offsets")
    if x.ndim != 4:
        raise ValueError(f"{where}: want (B, Z, Y, X) rows, got {tuple(x.shape)}")
    _lor.tile_grid(x.shape[1:])
    return n


def fused_compress_batched_plain(x: torch.Tensor, eb_i):
    """Plain version of K8: the reference's ``fused_compress_batched``, every
    row's block rows compacted into one arena."""
    n = _batched_rows(x, "fused_compress_batched")
    bsz = x.shape[0]
    block_words, width = fused_encode_batched_plain(x, eb_i)
    nb = n // bitpack.BLOCK
    arena, block_offsets, used = bitpack.compact_streams(block_words, 2 * width, bsz * (n + 2))
    width_rows = width.view(bsz, nb)
    wsum = width_rows.to(torch.int64).sum(dim=1)
    offsets = block_offsets.view(bsz, nb)[:, 0]
    total_bits = wsum * bitpack.BLOCK + nb * bitpack._WIDTH_BITS
    return (arena, width_rows.to(torch.uint8), offsets.to(torch.int32),
            (2 * wsum).to(torch.int32), total_bits.to(torch.int32), used.to(torch.int32))


def fused_compress_batched(x: torch.Tensor, eb_i):
    """K8, arena-batched fused SZ encode: (B, Z, Y, X) rows -> one contiguous
    uint32 word arena holding every row's stream back to back, in one launch.

    Returns ``(arena, widths, offsets, counts, total_bits, used)`` (uint32
    [B * (n + 2)], uint8 [B, nb], int32 [B] three times, int32 []) with
    ``arena[offsets[b] : offsets[b] + counts[b]]`` equal to
    ``fused_compress(x[b], eb_i[b])``'s stored words and zeros past ``used``.
    Rows hold only full blocks, so ``2 * sum(width) <= n`` and nothing is cut
    at ``n + 2``."""
    if x.device.type == "cpu":
        return fused_compress_batched_plain(x, eb_i)
    n = _batched_rows(x, "fused_compress_batched")
    bsz = x.shape[0]
    eb = _eb_rows(eb_i, x, bsz)
    _check_rows(x, "fused_compress_batched")
    meta = torch.empty(3 * bsz + 1, dtype=torch.int32, device=x.device)
    arena, widths = _encode(x, eb, bsz, meta.data_ptr(), None)
    launches["fused_compress_batched"] += 1
    return (arena, widths.view(bsz, n // bitpack.BLOCK), meta[:bsz], meta[bsz:2 * bsz],
            meta[2 * bsz:3 * bsz], meta[3 * bsz])


# ------------------------------------------------------- K4 and K9 -------


def _decode(words: torch.Tensor, widths: torch.Tensor, eb: torch.Tensor, out: torch.Tensor,
            where: str) -> torch.Tensor:
    """Launch the stream decoder: ``out`` (f32, TILE-padded rows of shape
    ``out.shape[-3:]``) from the dense stream(s) ``words`` and their uint8
    ``widths``."""
    z, y, w = out.shape[-3:]
    if widths.numel() * bitpack.BLOCK != out.numel():
        raise ValueError(f"{where}: want {out.numel() // bitpack.BLOCK} widths for "
                         f"{tuple(out.shape)}, got {tuple(widths.shape)}")
    words = words.view(torch.int32)
    _build.check_cuda(words, torch.int32, f"{where} words")
    _build.check_cuda(widths, torch.uint8, f"{where} widths")
    bsz = out.numel() // (z * y * w)
    scratch = _scratch(out.numel() // CODES_PER_TILE, words.device)  # the decoder's unit is a tile
    P, I, L = _build.P, _build.I, _build.L
    _build.launch("sz_fused", "sz_stream_decode", [P, L, P, P, P, P, I, I, I, I],
                  words.data_ptr(), words.numel(), widths.data_ptr(), eb.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), bsz, z, y, w, device=words.device)
    return out


def fused_decompress_plain(packed: bitpack.PackedCodes, padded_shape, eb_i) -> torch.Tensor:
    """Plain version of K4: the reference's ``fused_decompress``, the stream
    disassembled into block rows, then decoded."""
    block_words, width = _disassemble(packed.words, packed.widths)
    return fused_decode_plain(block_words, width, tuple(padded_shape), eb_i)


def fused_decompress(packed: bitpack.PackedCodes, padded_shape, eb_i) -> torch.Tensor:
    """K4: the dense stream -> f32 ``padded_shape`` field in one pass (each
    block's payload found, unpacked, unzigzagged, 3-fold prefix-summed and
    dequantized; the int32 codes never reach device memory)."""
    if packed.words.device.type == "cpu":
        return fused_decompress_plain(packed, padded_shape, eb_i)
    _lor.tile_grid(padded_shape)
    eb = _lor._eb_on(eb_i, packed.words)
    with obs_trace.span("kernel.fused_decompress"):
        out = torch.empty(tuple(padded_shape), dtype=torch.float32, device=packed.words.device)
        _decode(packed.words, packed.widths, eb, out, "fused_decompress")
        launches["fused_decompress"] += 1
    return out


def fused_decompress_batched_plain(arena: torch.Tensor, widths: torch.Tensor, padded_shape,
                                   eb_i) -> torch.Tensor:
    """Plain version of K9: the reference's ``fused_decompress_batched``, the
    whole arena disassembled at once, then every row decoded."""
    block_words, width = _disassemble(arena, widths)
    return fused_decode_batched_plain(block_words, width, tuple(padded_shape), eb_i)


def fused_decompress_batched(arena: torch.Tensor, widths: torch.Tensor, padded_shape,
                             eb_i) -> torch.Tensor:
    """K9, inverse of :func:`fused_compress_batched`: the word arena + per-row
    widths uint8 [B, nb] -> f32 (B, *padded_shape) in one launch.  Rows lie
    back to back, so the arena is one stream to the decoder."""
    if arena.device.type == "cpu":
        return fused_decompress_batched_plain(arena, widths, padded_shape, eb_i)
    _lor.tile_grid(padded_shape)
    if widths.ndim != 2:
        raise ValueError(f"fused_decompress_batched: want widths [B, nb], got {tuple(widths.shape)}")
    bsz = widths.shape[0]
    eb = _eb_rows(eb_i, arena, bsz)
    out = torch.empty((bsz, *padded_shape), dtype=torch.float32, device=arena.device)
    _decode(arena, widths, eb, out, "fused_decompress_batched")
    launches["fused_decompress_batched"] += 1
    return out
