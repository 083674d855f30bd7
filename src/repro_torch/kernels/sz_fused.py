"""K3, K4, K8 and K9: single-pass fused TPU-SZ encode/decode, for one field
and for a batch of same-shape fields (the port of ``repro.kernels.sz_fused``).

K3 fuses dual quantization + 3-D Lorenzo residual + zigzag + per-block
width + word-level packing: per 64-code block it emits a 64-word payload row
(dense from word 0, zeros past ``2*w``) and its int32 width, in tile-major
block order, and the int32 residuals never reach device memory.  The dense
stream is then one :func:`bitpack.compact_streams` (exclusive scan of
``2*w`` + one gather) — plain PyTorch on either device, as the JAX package
runs it in jnp outside Pallas.  K4 inverts it: the stream is disassembled
into rows, then one pass unpacks, unzigzags, runs the per-tile 3-fold prefix
sum and dequantizes.

Bitstream layout: identical to ``bitpack.pack_codes`` applied to the
tile-major flattening of the residual field (tiles in raster order, each
(8, 64, 128) tile flattened C-order), so the ``fused`` and ``xla`` paths of
:mod:`repro_torch.kernels.ops` emit the same stream and decode each other's.

K8 and K9 are the arena-batched forms (the snapshot path's kernel buckets):
(B, Z, Y, X) TILE-aligned rows with a per-row bound ``eb_i[B]`` go through
one launch, row ``b``'s blocks following row ``b - 1``'s, so K8 is K3 over
the (B*Z, Y, X) field with the bound of each block's row (no tile spans two
rows, since prediction resets at tile edges and Z % 8 == 0).  All rows'
streams then compact into one word arena with a single
:func:`bitpack.compact_streams`, which stays plain PyTorch as the reference
keeps it outside Pallas; K9 disassembles the whole arena at once, then
decodes every row in one launch.

On a CUDA tensor ``fused_encode``/``fused_decode`` and their ``_batched``
forms launch the kernels in ``csrc/sz_fused.cu`` (or raise); on a CPU tensor
they run the plain versions beside them.  ``launches`` counts kernel
launches, nothing else.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import bitpack
from repro_torch.kernels import _build
from repro_torch.kernels import lorenzo3d as _lor

TILE = _lor.TILE  # (8, 64, 128)
CODES_PER_TILE = TILE[0] * TILE[1] * TILE[2]  # 65536
BLOCKS_PER_TILE = CODES_PER_TILE // bitpack.BLOCK  # 1024
WORDS_PER_BLOCK = 64  # a block's payload is at most 2 * 32 words

launches = {"fused_encode": 0, "fused_decode": 0, "fused_encode_batched": 0,
            "fused_decode_batched": 0}


def tile_major_flatten(a: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) -> flat codes in tile-major order (the kernel bitstream
    order): tiles in raster order, each tile flattened C-order."""
    return _lor.to_tiles(a).reshape(-1)


def tile_major_unflatten(flat: torch.Tensor, padded_shape) -> torch.Tensor:
    """Inverse of :func:`tile_major_flatten`."""
    gz, gy, gx = _lor.tile_grid(padded_shape)
    return _lor.from_tiles(flat.reshape(gz, gy, gx, *TILE))


# ------------------------------------------------------------- encode -----


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
    """Plain version of K3: (block rows uint32 [nb, 64], widths int32 [nb])."""
    delta = _lor.lorenzo3d_quantize_plain(x, eb_i)
    u = bitpack.zigzag(tile_major_flatten(delta)).view(-1, bitpack.BLOCK)
    width = bitpack.bitlength(u).amax(dim=1)
    return _pack_blocks(u, width), width


def fused_encode(x: torch.Tensor, eb_i):
    """One fused pass: f32 (Z, Y, X), TILE-padded -> per-block payload rows
    (uint32 [n/64, 64]) and widths (int32 [n/64]) in tile-major block order."""
    if x.device.type == "cpu":
        return fused_encode_plain(x, eb_i)
    _lor.tile_grid(x.shape)
    z, y, w = x.shape
    eb = _lor._eb_on(eb_i, x)
    _build.check_cuda(x, torch.float32, "fused_encode x")
    nb = x.numel() // bitpack.BLOCK
    words = torch.empty(nb, WORDS_PER_BLOCK, dtype=torch.int32, device=x.device)
    widths = torch.empty(nb, dtype=torch.int32, device=x.device)
    P, I = _build.P, _build.I
    _build.launch("sz_fused", "sz_fused_encode", [P, P, P, P, I, I, I],
                  x.data_ptr(), eb.data_ptr(), words.data_ptr(), widths.data_ptr(), z, y, w,
                  device=x.device)
    launches["fused_encode"] += 1
    return words.view(torch.uint32), widths


def _assemble_stream(block_words: torch.Tensor, width: torch.Tensor, n: int) -> bitpack.PackedCodes:
    """Concatenate per-block payloads into the dense global stream, equal to
    ``bitpack.pack_codes`` on the tile-major residuals (block payloads are
    word-aligned, so this is one compaction and no bit arithmetic)."""
    # capacity n + 2 matches pack_codes' worst-case buffer exactly
    words, _, _ = bitpack.compact_streams(block_words, 2 * width, n + 2)
    total_bits = (width.to(torch.int64) * bitpack.BLOCK).sum() + width.shape[0] * bitpack._WIDTH_BITS
    return bitpack.PackedCodes(words, width.to(torch.uint8), total_bits, n)


def fused_compress(x: torch.Tensor, eb_i) -> bitpack.PackedCodes:
    """Fused SZ encode of a TILE-padded f32 field; the stream equals the
    ``xla`` path's ``pack_codes(tile_major_flatten(lorenzo3d_quantize(x)))``."""
    n = x.numel()
    bitpack.check_fits("fused_compress", n)
    block_words, width = fused_encode(x, eb_i)
    return _assemble_stream(block_words, width, n)


# ------------------------------------------------------------- decode -----


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
    """Plain version of K4: unpack + unzigzag + per-tile 3-fold prefix sum +
    dequantize -> f32 ``padded_shape``."""
    u = _unpack_blocks(block_words, width)
    delta = tile_major_unflatten(bitpack.unzigzag(u).reshape(-1), padded_shape)
    return _lor.lorenzo3d_reconstruct_plain(delta, eb_i)


def fused_decode(block_words: torch.Tensor, width: torch.Tensor, padded_shape, eb_i) -> torch.Tensor:
    """Per-block payload rows + widths -> f32 ``padded_shape`` field."""
    if block_words.device.type == "cpu":
        return fused_decode_plain(block_words, width, padded_shape, eb_i)
    z, y, w = padded_shape
    _lor.tile_grid(padded_shape)
    nb = math.prod(padded_shape) // bitpack.BLOCK
    if tuple(block_words.shape) != (nb, WORDS_PER_BLOCK) or tuple(width.shape) != (nb,):
        raise ValueError(f"fused_decode: want ({nb}, {WORDS_PER_BLOCK}) rows and ({nb},) widths "
                         f"for {tuple(padded_shape)}, got {tuple(block_words.shape)} and "
                         f"{tuple(width.shape)}")
    block_words = block_words.view(torch.int32)
    _build.check_cuda(block_words, torch.int32, "fused_decode block_words")
    _build.check_cuda(width, torch.int32, "fused_decode width")
    eb = _lor._eb_on(eb_i, block_words)
    out = torch.empty(tuple(padded_shape), dtype=torch.float32, device=block_words.device)
    P, I = _build.P, _build.I
    _build.launch("sz_fused", "sz_fused_decode", [P, P, P, P, I, I, I],
                  block_words.data_ptr(), width.data_ptr(), eb.data_ptr(), out.data_ptr(),
                  z, y, w, device=block_words.device)
    launches["fused_decode"] += 1
    return out


def fused_decompress(packed: bitpack.PackedCodes, padded_shape, eb_i) -> torch.Tensor:
    """Fused SZ decode: disassemble the stream, then K4 (unpack + unzigzag +
    3-fold prefix sum + dequantize in one pass)."""
    block_words, width = _disassemble(packed.words, packed.widths)
    return fused_decode(block_words, width, tuple(padded_shape), eb_i)


# ----------------------------------------------------- batched / arena -----


def _eb_rows(eb_i, like: torch.Tensor, bsz: int) -> torch.Tensor:
    eb = torch.as_tensor(eb_i, dtype=torch.float32, device=like.device).reshape(-1)
    if eb.numel() != bsz:
        raise ValueError(f"eb_i must hold one bound per row: want {bsz}, got {eb.numel()}")
    return eb.contiguous()


def fused_encode_batched_plain(x: torch.Tensor, eb_i):
    """Plain version of K8: K3's plain version on each row, blocks of row 0
    first (uint32 [B * nb, 64] rows, int32 [B * nb] widths)."""
    eb = _eb_rows(eb_i, x, x.shape[0])
    parts = [fused_encode_plain(x[b], eb[b]) for b in range(x.shape[0])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def fused_encode_batched(x: torch.Tensor, eb_i):
    """K8: f32 (B, Z, Y, X) TILE-padded rows + per-row bounds ``eb_i[B]`` ->
    every row's per-block payload rows and widths in one launch."""
    if x.device.type == "cpu":
        return fused_encode_batched_plain(x, eb_i)
    if x.ndim != 4:
        raise ValueError(f"fused_encode_batched: want (B, Z, Y, X) rows, got {tuple(x.shape)}")
    _lor.tile_grid(x.shape[1:])
    bsz, z, y, w = x.shape
    eb = _eb_rows(eb_i, x, bsz)
    _build.check_cuda(x, torch.float32, "fused_encode_batched x")
    nb = x.numel() // bitpack.BLOCK
    words = torch.empty(nb, WORDS_PER_BLOCK, dtype=torch.int32, device=x.device)
    widths = torch.empty(nb, dtype=torch.int32, device=x.device)
    P, I = _build.P, _build.I
    _build.launch("sz_fused", "sz_fused_encode_batched", [P, P, P, P, I, I, I, I],
                  x.data_ptr(), eb.data_ptr(), words.data_ptr(), widths.data_ptr(),
                  bsz, z, y, w, device=x.device)
    launches["fused_encode_batched"] += 1
    return words.view(torch.uint32), widths


def fused_compress_batched(x: torch.Tensor, eb_i):
    """Arena-batched fused SZ encode: (B, Z, Y, X) rows -> one contiguous
    uint32 word arena holding every row's stream back to back.

    Returns ``(arena, widths, offsets, counts, total_bits, used)`` (uint32
    [B * (n + 2)], uint8 [B, nb], int32 [B] three times, int32 []) with
    ``arena[offsets[b] : offsets[b] + counts[b]]`` equal to
    ``fused_compress(x[b], eb_i[b])``'s stored words.  Rows hold only full
    blocks, so ``2 * sum(width) <= n`` and nothing is cut at ``n + 2``."""
    bsz = x.shape[0]
    n = math.prod(x.shape[1:])
    if n * 32 >= 2**31:
        raise ValueError(f"fused_compress_batched: row n={n} too large; chunk the field")
    block_words, width = fused_encode_batched(x, eb_i)
    nb = n // bitpack.BLOCK
    arena, block_offsets, used = bitpack.compact_streams(block_words, 2 * width, bsz * (n + 2))
    width_rows = width.view(bsz, nb)
    wsum = width_rows.to(torch.int64).sum(dim=1)
    offsets = block_offsets.view(bsz, nb)[:, 0]
    total_bits = wsum * bitpack.BLOCK + nb * bitpack._WIDTH_BITS
    return (arena, width_rows.to(torch.uint8), offsets.to(torch.int32),
            (2 * wsum).to(torch.int32), total_bits.to(torch.int32), used.to(torch.int32))


def fused_decode_batched_plain(block_words: torch.Tensor, width: torch.Tensor, padded_shape,
                               eb_i) -> torch.Tensor:
    """Plain version of K9: K4's plain version on each row's blocks."""
    nb = math.prod(padded_shape) // bitpack.BLOCK
    bsz = width.numel() // nb
    eb = _eb_rows(eb_i, block_words, bsz)
    return torch.stack([fused_decode_plain(block_words[b * nb:(b + 1) * nb],
                                           width[b * nb:(b + 1) * nb], padded_shape, eb[b])
                        for b in range(bsz)])


def fused_decode_batched(block_words: torch.Tensor, width: torch.Tensor, padded_shape,
                         eb_i) -> torch.Tensor:
    """K9: every row's per-block payload rows + widths (row 0's blocks
    first) -> f32 (B, *padded_shape) in one launch."""
    if block_words.device.type == "cpu":
        return fused_decode_batched_plain(block_words, width, padded_shape, eb_i)
    z, y, w = padded_shape
    _lor.tile_grid(padded_shape)
    nb = math.prod(padded_shape) // bitpack.BLOCK
    bsz = width.numel() // nb
    if (bsz * nb != width.numel() or tuple(block_words.shape) != (bsz * nb, WORDS_PER_BLOCK)
            or tuple(width.shape) != (bsz * nb,)):
        raise ValueError(f"fused_decode_batched: want (B * {nb}, {WORDS_PER_BLOCK}) rows and "
                         f"(B * {nb},) widths for rows of {tuple(padded_shape)}, got "
                         f"{tuple(block_words.shape)} and {tuple(width.shape)}")
    block_words = block_words.view(torch.int32)
    _build.check_cuda(block_words, torch.int32, "fused_decode_batched block_words")
    _build.check_cuda(width, torch.int32, "fused_decode_batched width")
    eb = _eb_rows(eb_i, block_words, bsz)
    out = torch.empty((bsz, *padded_shape), dtype=torch.float32, device=block_words.device)
    P, I = _build.P, _build.I
    _build.launch("sz_fused", "sz_fused_decode_batched", [P, P, P, P, I, I, I, I],
                  block_words.data_ptr(), width.data_ptr(), eb.data_ptr(), out.data_ptr(),
                  bsz, z, y, w, device=block_words.device)
    launches["fused_decode_batched"] += 1
    return out


def fused_decompress_batched(arena: torch.Tensor, widths: torch.Tensor, padded_shape,
                             eb_i) -> torch.Tensor:
    """Inverse of :func:`fused_compress_batched`: the word arena + per-row
    widths uint8 [B, nb] -> f32 (B, *padded_shape).  Rows lie back to back,
    so one global disassembly of the arena feeds one K9 launch."""
    block_words, width = _disassemble(arena, widths)
    return fused_decode_batched(block_words, width, tuple(padded_shape), eb_i)
