"""Public wrappers around the SZ kernels (the SZ half of
``repro.kernels.ops``): padding to tile multiples, path dispatch, and the
bitstream layer.

``path`` picks the engine: ``fused`` is the single-pass K3/K4 pipeline,
``xla`` is K1/K2 around the word-level ``bitpack`` coder (the name is kept
from the reference, where that path is XLA), and ``auto`` is ``fused`` on a
CUDA tensor and ``xla`` on a CPU one, as the reference picks ``fused`` on
the TPU.  Both emit the same tile-major stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.kernels import lorenzo3d as _lor
from repro_torch.kernels import sz_fused as _szf


def _resolve_sz_path(path: str, device: torch.device) -> str:
    if path == "auto":
        return "fused" if device.type == "cuda" else "xla"
    if path not in ("fused", "xla"):
        raise ValueError(f"unknown SZ kernel path {path!r}; want fused|xla|auto")
    return path


def sz_compress_kernel(x: torch.Tensor, eb: float, path: str = "auto", eb_i=None):
    """Kernel-path SZ compress of a 3-D f32 field: returns (PackedCodes,
    padded_shape, eb_i).  Tile-blocked prediction; the bitstream is the
    tile-major layout shared by both paths.

    ``eb_i`` overrides the guarded bound derived from ``max|x|`` (a sharded
    caller passes the bound of the global maximum)."""
    path = _resolve_sz_path(path, x.device)
    padded = tuple(s + (-s) % t for s, t in zip(x.shape, _lor.TILE))
    # refuse an oversized field before anything is allocated
    bitpack.check_fits("fused_compress" if path == "fused" else "pack_codes", math.prod(padded))
    if padded != tuple(x.shape):
        x = F.pad(x, (0, padded[2] - x.shape[2], 0, padded[1] - x.shape[1],
                      0, padded[0] - x.shape[0]))
    x = x.contiguous()
    if eb_i is None:
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
    if _resolve_sz_path(path, device) == "fused":
        xr = _szf.fused_decompress(packed, tuple(padded_shape), eb_i)
    else:
        delta = _szf.tile_major_unflatten(bitpack.unpack_codes(packed), tuple(padded_shape))
        xr = _lor.lorenzo3d_reconstruct(delta, eb_i)
    return xr[tuple(slice(0, s) for s in orig_shape)]
