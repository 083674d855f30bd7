"""K1 and K2: tile-blocked dual quantization + 3-D Lorenzo residual, and its
inverse (the port of ``repro.kernels.lorenzo3d``).

The field is carved into (8, 64, 128) tiles and prediction resets at every
tile edge — GPU-SZ's independent-block design, and part of the stream
format.  The guarded bound ``eb_i`` is data-dependent (it comes from
``max|x|``), so it stays a device f32 scalar passed to the kernel by
pointer: reading it on the host would add a sync to every call.

Each function runs where its tensor lives: on a CUDA tensor it launches the
hand-written kernel in ``csrc/lorenzo3d.cu`` (and raises if the library
cannot be built or loaded), on a CPU tensor it runs the plain PyTorch
version beside it.  ``launches`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.core import sz
from repro_torch.core.bitpack import round_i32
from repro_torch.kernels import _build

TILE = (8, 64, 128)

launches = {"lorenzo3d_quantize": 0, "lorenzo3d_reconstruct": 0}


def guarded_eb(x: torch.Tensor, eb) -> torch.Tensor:
    """Internal bound: user eb shrunk for f32 quantize/dequantize roundoff
    (the shared policy in :func:`repro_torch.core.sz.internal_bound`)."""
    return sz.internal_bound(x.abs().amax(), eb)


def tile_grid(shape) -> tuple[int, int, int]:
    """Tiles per axis of a TILE-padded (Z, Y, X) shape."""
    if len(shape) != 3 or any(s % t for s, t in zip(shape, TILE)):
        raise ValueError(f"shape {tuple(shape)} is not TILE-padded to {TILE}")
    return tuple(s // t for s, t in zip(shape, TILE))


def to_tiles(a: torch.Tensor) -> torch.Tensor:
    """(Z, Y, X) -> (gz, gy, gx, 8, 64, 128) view of the tiles."""
    gz, gy, gx = tile_grid(a.shape)
    tz, ty, tx = TILE
    return a.reshape(gz, tz, gy, ty, gx, tx).permute(0, 2, 4, 1, 3, 5)


def from_tiles(t: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_tiles`."""
    gz, gy, gx, tz, ty, tx = t.shape
    return t.permute(0, 3, 1, 4, 2, 5).reshape(gz * tz, gy * ty, gx * tx)


def _eb_on(eb_i, like: torch.Tensor) -> torch.Tensor:
    eb = torch.as_tensor(eb_i, dtype=torch.float32, device=like.device)
    if eb.numel() != 1:
        raise ValueError(f"eb_i must be a scalar, got shape {tuple(eb.shape)}")
    return eb.reshape(())


# ------------------------------------------------------------- K1 ---------


def lorenzo3d_quantize_plain(x: torch.Tensor, eb_i) -> torch.Tensor:
    """Plain version of K1: reciprocal-multiply quantization (as the kernel
    and ``repro.kernels.ref`` do; ``x / (2 eb)`` differs in ulps), then the
    per-tile residual."""
    tile_grid(x.shape)
    eb = _eb_on(eb_i, x)
    q = round_i32(x.to(torch.float32) * (1.0 / (2.0 * eb)))
    return from_tiles(sz.lorenzo_residual(to_tiles(q), ndim=3))


def lorenzo3d_quantize(x: torch.Tensor, eb_i) -> torch.Tensor:
    """f32 (Z, Y, X), TILE-padded -> int32 tile-blocked Lorenzo residuals.
    ``eb_i`` is the guarded bound (see :func:`guarded_eb`)."""
    if x.device.type == "cpu":
        return lorenzo3d_quantize_plain(x, eb_i)
    tile_grid(x.shape)
    z, y, w = x.shape
    eb = _eb_on(eb_i, x)
    _build.check_cuda(x, torch.float32, "lorenzo3d_quantize x")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    P, I = _build.P, _build.I
    _build.launch("lorenzo3d", "lorenzo3d_quantize", [P, P, P, I, I, I],
                  x.data_ptr(), eb.data_ptr(), out.data_ptr(), z, y, w, device=x.device)
    launches["lorenzo3d_quantize"] += 1
    return out


# ------------------------------------------------------------- K2 ---------


def lorenzo3d_reconstruct_plain(delta: torch.Tensor, eb_i) -> torch.Tensor:
    """Plain version of K2: per-tile 3-fold inclusive prefix sum (wrapping
    as int32), then f32 * (2 eb)."""
    tile_grid(delta.shape)
    eb = _eb_on(eb_i, delta)
    q = from_tiles(sz.lorenzo_reconstruct(to_tiles(delta), ndim=3))
    return q.to(torch.float32) * (2.0 * eb)


def lorenzo3d_reconstruct(delta: torch.Tensor, eb_i) -> torch.Tensor:
    """Inverse of :func:`lorenzo3d_quantize` + dequantization (decompression)."""
    if delta.device.type == "cpu":
        return lorenzo3d_reconstruct_plain(delta, eb_i)
    tile_grid(delta.shape)
    z, y, w = delta.shape
    eb = _eb_on(eb_i, delta)
    _build.check_cuda(delta, torch.int32, "lorenzo3d_reconstruct delta")
    out = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    P, I = _build.P, _build.I
    _build.launch("lorenzo3d", "lorenzo3d_reconstruct", [P, P, P, I, I, I],
                  delta.data_ptr(), eb.data_ptr(), out.data_ptr(), z, y, w, device=delta.device)
    launches["lorenzo3d_reconstruct"] += 1
    return out
