"""Public wrappers around the kernels (the port of ``repro.kernels.ops``):
padding and block carving, path dispatch, the bitstream layer, and the
compressed-KV decode attention (K10).

``path`` picks the engine, for either compressor: ``fused`` is the
single-pass kernel pipeline (K3/K4 for SZ, K6/K7 for ZFP), ``xla`` is the
unfused kernel around the word-level coder in PyTorch (K1/K2 with
``bitpack`` for SZ; K5 with ``core.zfp.encode_words`` for ZFP, whose decode
is ``core.zfp.decompress``, as in the reference); the name is kept from the
reference, where that path is XLA.  ``auto`` is ``fused`` on a CUDA tensor
and ``xla`` on a CPU one, as the reference picks ``fused`` on the TPU.  All
paths of a compressor emit the same stream.

Traced (:mod:`repro_torch.obs.trace`): the device work around the kernels
is in spans, so the operations it launches are put down to them:
``sz.guarded_eb``, and ``zfp.carve`` on the ZFP ``xla`` path (the fused ZFP
path reads and writes the field in place: nothing is left around K6 and
K7); each fused launch is its kernel module's ``kernel.<name>`` span.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.core import zfp as zfp_core
from repro_torch.kernels import kvc_attention as _kvc
from repro_torch.kernels import lorenzo3d as _lor
from repro_torch.kernels import sz_fused as _szf
from repro_torch.kernels import zfp3d as _zfp
from repro_torch.kernels import zfp_fused as _zfpf
from repro_torch.obs import trace as obs_trace


def _resolve_path(what: str, path: str, device: torch.device) -> str:
    if path == "auto":
        return "fused" if device.type == "cuda" else "xla"
    if path not in ("fused", "xla"):
        raise ValueError(f"unknown {what} kernel path {path!r}; want fused|xla|auto")
    return path


# ------------------------------------------------------------- TPU-SZ -----


def sz_compress_kernel(x: torch.Tensor, eb: float, path: str = "auto", eb_i=None):
    """Kernel-path SZ compress of a 3-D f32 field: returns (PackedCodes,
    padded_shape, eb_i).  Tile-blocked prediction; the bitstream is the
    tile-major layout shared by both paths.

    ``eb_i`` overrides the guarded bound derived from ``max|x|`` (a sharded
    caller passes the bound of the global maximum)."""
    path = _resolve_path("SZ", path, x.device)
    padded = tuple(s + (-s) % t for s, t in zip(x.shape, _lor.TILE))
    # refuse an oversized field before anything is allocated
    bitpack.check_fits("fused_compress" if path == "fused" else "pack_codes", math.prod(padded))
    if padded != tuple(x.shape):
        x = F.pad(x, (0, padded[2] - x.shape[2], 0, padded[1] - x.shape[1],
                      0, padded[0] - x.shape[0]))
    x = x.contiguous()
    if eb_i is None:
        with obs_trace.span("sz.guarded_eb"):
            eb_i = _lor.guarded_eb(x, eb)
    eb_i = torch.as_tensor(eb_i, dtype=torch.float32, device=x.device)
    if path == "fused":
        packed = _szf.fused_compress(x, eb_i)
    else:
        delta = _lor.lorenzo3d_quantize(x, eb_i)
        packed = bitpack.pack_codes(_szf.tile_major_flatten(delta))
    return packed, padded, eb_i


def sz_decompress_kernel(packed: bitpack.PackedCodes, padded_shape, orig_shape, eb_i,
                         path: str = "auto") -> torch.Tensor:
    device = packed.words.device
    eb_i = torch.as_tensor(eb_i, dtype=torch.float32, device=device)
    if _resolve_path("SZ", path, device) == "fused":
        xr = _szf.fused_decompress(packed, tuple(padded_shape), eb_i)
    else:
        delta = _szf.tile_major_unflatten(bitpack.unpack_codes(packed), tuple(padded_shape))
        xr = _lor.lorenzo3d_reconstruct(delta, eb_i)
    return xr[tuple(slice(0, s) for s in orig_shape)]


# ------------------------------------------------------------ TPU-ZFP -----


def _carve(x: torch.Tensor) -> torch.Tensor:
    """The field's (NB, 4, 4, 4) blocks, a copy, in the ``zfp.carve`` span."""
    with obs_trace.span("zfp.carve"):
        return zfp_core._carve_blocks(x.to(torch.float32))


def zfp_transform_kernel(x: torch.Tensor):
    """Kernel-path ZFP stages 1-4 on a 3-D field: (u uint32[NB, 64] in
    sequency order, emax uint8[NB], gtops uint8[NB, 10]), the values of
    :func:`repro_torch.core.zfp.block_transform`."""
    u, emax, gtops = _zfp.zfp3d_transform(_carve(x))
    u = u.view(torch.int32)[:, zfp_core._index(zfp_core.PERM, u.device)].view(torch.uint32)
    return u, emax, gtops


def zfp_compress_kernel(x: torch.Tensor, rate: int, path: str = "auto") -> zfp_core.ZFPCompressed:
    """Kernel-path fixed-rate ZFP compress of a 3-D field: the same
    ``words``/``emax``/``gtops`` as :func:`repro_torch.core.zfp.compress`
    on every path."""
    path = _resolve_path("ZFP", path, x.device)
    zfp_core.payload_words(rate)  # validates the rate before any work
    if path == "fused":
        # a view is made contiguous first: the copy _carve_blocks' reshape made
        words, emax, gtops = _zfpf.fused_compress_field(x.to(torch.float32).contiguous(), rate)
    else:
        u, emax, gtops = zfp_transform_kernel(x)
        words = zfp_core.encode_words(u.view(torch.int32), gtops, rate)
    return zfp_core.ZFPCompressed(words, emax, gtops, tuple(x.shape), rate)


def zfp_decompress_kernel(c: zfp_core.ZFPCompressed, path: str = "auto") -> torch.Tensor:
    """Kernel-path decode of :func:`zfp_compress_kernel` output (it also
    reads :func:`repro_torch.core.zfp.compress` streams: same layout)."""
    if _resolve_path("ZFP", path, c.words.device) == "fused":
        return _zfpf.fused_decompress_field(c.words, c.emax, c.gtops, c.rate, c.shape)
    return zfp_core.decompress(c)


# ---------------------------------------------- compressed-KV attention ----


def kvc_attention(q: torch.Tensor, k_codes, k_scale, v_codes, v_scale, index, offset: int = 0,
                  lse: bool = False):
    """Fused dequant+attention decode step (K10), dispatched by the device of
    its tensors: the kernel on CUDA, the plain version on the CPU.  q:
    (B, H, D); codes (B, S, Hkv, D) with Hkv dividing H (un-repeated GQA);
    ``index`` is a scalar shared position or a (B,) per-slot position
    vector.  Any S: the reference's padding to its chunk has no
    counterpart.  A block of a cache whose sequence is split passes its
    first global position (``offset``) and takes ``(out, lse)`` back with
    ``lse=True`` (:mod:`repro_torch.kernels.kvc_attention`)."""
    return _kvc.kvc_decode_attention(q, k_codes, k_scale, v_codes, v_scale, index, offset, lse)


def kvc_attention_paged(q: torch.Tensor, k_pool, k_scale_pool, v_pool, v_scale_pool, page_table,
                        index) -> torch.Tensor:
    """K10 read through the page table of the paged pool, dispatched like
    :func:`kvc_attention`: ``kvc_attention(q, *cache_codes(pool,
    PagedKV(index, page_table)), index)`` without the gathered copy on the
    card.  Pools (n_pages, page, Hkv, D) int8 and (n_pages, page, Hkv) f32;
    ``page_table`` (B, max_pages) int32."""
    return _kvc.kvc_decode_attention_paged(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                                           page_table, index)
