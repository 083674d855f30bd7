"""K6 and K7: single-pass fused TPU-ZFP encode and decode (the port of
``repro.kernels.zfp_fused``).

K5 (:mod:`repro_torch.kernels.zfp3d`) writes the uint32 coefficient planes,
a full 4 B/pt copy of the input, for the coder outside to read again.  K6
runs stages 1-3, the sequency permutation and the plane-parallel embedded
coder of :mod:`repro_torch.core.zfp` in one pass, so only the ``rate``-bit
stream and 11 header bytes per 64 values leave the kernel; K7 is its
inverse.  The plain versions beside them are the reference's kernel bodies
written in PyTorch: the shared stages 1-3 (``zfp3d.block_float_negabinary``)
and the coder of ``core.zfp`` itself, so the ``core``, ``xla`` and
``fused`` paths emit the same stream by construction.  The one formulation
difference is K7's word fetch: the reference's XLA decoder gathers each
plane's 3 words from the flat buffer, clipped to its end, while the fused
decoder reads 0 past its block's ``wpb`` words; those bits lie past ``keep``
and are masked off, so all forms give the same floats.

The kernels read and write a 3-D field in place, in the blocks' order of
``core.zfp._carve_blocks``: the compressors' ``fused_*_field`` entries pass
the field itself, and the arena's ``fused_*_blocks`` pass carved ``(NB, 4,
4, 4)`` blocks as the field ``(4 NB, 4, 4)``, whose blocks they are.  On a
CUDA tensor the wrappers launch the kernels in ``csrc/zfp_fused.cu`` (or
raise); on a CPU tensor they run the plain versions, the field entries
around ``_carve_blocks`` and ``_uncarve_blocks``.  ``launches`` counts
kernel launches, nothing else; each launch, with its allocations, is a span
``kernel.<launches key>`` (:mod:`repro_torch.obs.trace`) whose argument
``layout`` says which entry made it, ``"field"`` or ``"blocks"``.
"""

from __future__ import annotations

import torch

from repro_torch.core import zfp as zfp_core
from repro_torch.core.bitpack import u32_to_i64
from repro_torch.kernels import _build
from repro_torch.kernels import zfp3d as _zfp3d
from repro_torch.obs import trace as obs_trace

N_GROUPS = zfp_core.N_GROUPS

launches = {"fused_compress_blocks": 0, "fused_decompress_blocks": 0}


def _transform_tile(blocks: torch.Tensor):
    """Stages 1-3 + the sequency permutation: (u sequency order int64[T,
    64], emax int32[T], gtops int64[T, 10])."""
    u_idx, e, nonzero = _zfp3d.block_float_negabinary(blocks)
    u = u_idx[:, zfp_core._index(zfp_core.PERM, u_idx.device)]
    gtops = zfp_core._group_tops(zfp_core._bitlength32(u)) * nonzero[:, None]
    emax = torch.where(nonzero, e + zfp_core._EMAX_BIAS, 0)
    return u, emax, gtops


def fused_compress_blocks_plain(blocks: torch.Tensor, rate: int):
    """Plain version of K6: (NB, 4, 4, 4) f32 -> (words uint32[NB, wpb],
    emax uint8[NB], gtops uint8[NB, 10])."""
    zfp_core.payload_words(rate)  # validates the rate
    u, emax, gtops = _transform_tile(blocks)
    return (zfp_core._encode_words_impl(u, gtops, rate), emax.to(torch.uint8),
            gtops.to(torch.uint8))


def _encode(x: torch.Tensor, shape: tuple, rate: int, layout: str):
    """Launch K6 on the contiguous field ``x`` of ``shape`` -> (words
    uint32[nb, wpb], emax uint8[nb], gtops uint8[nb, 10])."""
    wpb = zfp_core.payload_words(rate)
    nb = zfp_core.n_blocks_for(shape)
    with obs_trace.span("kernel.fused_compress_blocks", layout=layout):
        words = torch.empty(nb, wpb, dtype=torch.int32, device=x.device)
        emax = torch.empty(nb, dtype=torch.uint8, device=x.device)
        gtops = torch.empty(nb, N_GROUPS, dtype=torch.uint8, device=x.device)
        P, I, L = _build.P, _build.I, _build.L
        _build.launch("zfp_fused", "zfp_fused_encode", [P, P, P, P, L, L, L, I, I],
                      x.data_ptr(), words.data_ptr(), emax.data_ptr(), gtops.data_ptr(),
                      *shape, wpb, rate * 64 - zfp_core._HEADER_BITS, device=x.device)
        launches["fused_compress_blocks"] += 1
    return words.view(torch.uint32), emax, gtops


def fused_compress_blocks(blocks: torch.Tensor, rate: int):
    """One fused pass: (NB, 4, 4, 4) f32 blocks -> (words uint32[NB, wpb],
    emax uint8[NB], gtops uint8[NB, 10]); any NB, any rate >= 1."""
    if blocks.device.type == "cpu":
        return fused_compress_blocks_plain(blocks, rate)
    nb = _zfp3d._check_blocks(blocks, "fused_compress_blocks blocks")
    return _encode(blocks, (4 * nb, 4, 4), rate, "blocks")


def _check_shape(shape, what: str) -> tuple:
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"{what}: want a 3-D field, got shape {shape}")
    return shape


def fused_compress_field(x: torch.Tensor, rate: int):
    """K6 on a contiguous 3-D f32 field, read in place: the ``words``,
    ``emax`` and ``gtops`` of ``fused_compress_blocks(_carve_blocks(x),
    rate)`` with no carved copy."""
    shape = _check_shape(x.shape, "fused_compress_field x")
    if x.device.type == "cpu":
        return fused_compress_blocks_plain(zfp_core._carve_blocks(x), rate)
    _build.check_cuda(x, torch.float32, "fused_compress_field x")
    return _encode(x, shape, rate, "field")


def fused_compress_arena(blocks: torch.Tensor, rate: int):
    """Arena-batched fused encode: the concatenated blocks of any number of
    leaves -> one flat word arena plus the header sidecars, one launch.  A
    leaf owning block rows ``[b0, b1)`` owns arena words ``[b0 * wpb, b1 *
    wpb)`` (fixed rate: no scan)."""
    words, emax, gtops = fused_compress_blocks(blocks, rate)
    return words.reshape(-1), emax, gtops


def fused_decompress_arena(arena: torch.Tensor, emax: torch.Tensor, gtops: torch.Tensor,
                           rate: int) -> torch.Tensor:
    """Inverse of :func:`fused_compress_arena` -> (NB, 4, 4, 4) f32 blocks."""
    wpb = zfp_core.payload_words(rate)
    return fused_decompress_blocks(arena.reshape(-1, wpb), emax, gtops, rate)


def fused_decompress_blocks_plain(words: torch.Tensor, emax: torch.Tensor, gtops: torch.Tensor,
                                  rate: int) -> torch.Tensor:
    """Plain version of K7: each plane's <= 3 words from its block's row (0
    past the row's end), the shared decode tail, the inverse permutation and
    stages 1-3 inverted."""
    budget = rate * 64 - zfp_core._HEADER_BITS
    wpb = words.shape[1]
    OFF, keep = zfp_core._plane_offsets(gtops, budget)
    w = u32_to_i64(words)

    def fetch(k: int) -> torch.Tensor:
        idx = (OFF >> 5) + k
        return torch.where(idx < wpb, torch.gather(w, 1, torch.clamp(idx, max=wpb - 1)), 0)

    u = zfp_core._extract_coeffs(fetch(0), fetch(1), fetch(2), OFF, keep, gtops)
    return zfp_core._blocks_from_coeffs(u, emax)


def _check_stream(words: torch.Tensor, rate: int, nb: int | None = None) -> int:
    """The stream's block count; raises unless ``words`` is (nb, wpb)."""
    wpb = zfp_core.payload_words(rate)
    if words.ndim != 2 or words.shape[1] != wpb:
        raise ValueError(f"stream has shape {tuple(words.shape)}; rate {rate} needs "
                         f"{wpb} words per block")
    if nb is not None and words.shape[0] != nb:
        raise ValueError(f"stream has {words.shape[0]} blocks; the field needs {nb}")
    return words.shape[0]


def _decode(words: torch.Tensor, emax: torch.Tensor, gtops: torch.Tensor, rate: int,
            shape: tuple, layout: str) -> torch.Tensor:
    """Launch K7 into a fresh contiguous f32 field of ``shape``."""
    nb = words.shape[0]
    if tuple(emax.shape) != (nb,) or tuple(gtops.shape) != (nb, N_GROUPS):
        raise ValueError(f"fused_decompress_blocks: want ({nb},) emax and ({nb}, {N_GROUPS}) "
                         f"gtops, got {tuple(emax.shape)} and {tuple(gtops.shape)}")
    words = words.view(torch.int32)
    _build.check_cuda(words, torch.int32, "fused_decompress_blocks words")
    _build.check_cuda(emax, torch.uint8, "fused_decompress_blocks emax")
    _build.check_cuda(gtops, torch.uint8, "fused_decompress_blocks gtops")
    with obs_trace.span("kernel.fused_decompress_blocks", layout=layout):
        out = torch.empty(shape, dtype=torch.float32, device=words.device)
        P, I, L = _build.P, _build.I, _build.L
        _build.launch("zfp_fused", "zfp_fused_decode", [P, P, P, P, L, L, L, I, I],
                      words.data_ptr(), emax.data_ptr(), gtops.data_ptr(), out.data_ptr(), *shape,
                      words.shape[1], rate * 64 - zfp_core._HEADER_BITS, device=words.device)
        launches["fused_decompress_blocks"] += 1
    return out


def fused_decompress_blocks(words: torch.Tensor, emax: torch.Tensor, gtops: torch.Tensor,
                            rate: int) -> torch.Tensor:
    """Inverse fused pass: stream + headers -> (NB, 4, 4, 4) f32 blocks."""
    nb = _check_stream(words, rate)
    if words.device.type == "cpu":
        return fused_decompress_blocks_plain(words, emax, gtops, rate)
    return _decode(words, emax, gtops, rate, (4 * nb, 4, 4), "blocks").view(nb, 4, 4, 4)


def fused_decompress_field(words: torch.Tensor, emax: torch.Tensor, gtops: torch.Tensor,
                           rate: int, shape) -> torch.Tensor:
    """K7 into the field: stream + headers of a field of ``shape`` -> the
    floats of ``_uncarve_blocks(fused_decompress_blocks(...), shape)``, on
    CUDA a fresh contiguous field written in place (only its own points)."""
    shape = _check_shape(shape, "fused_decompress_field shape")
    _check_stream(words, rate, zfp_core.n_blocks_for(shape))
    if words.device.type == "cpu":
        return zfp_core._uncarve_blocks(fused_decompress_blocks_plain(words, emax, gtops, rate),
                                        shape)
    return _decode(words, emax, gtops, rate, shape, "field")
