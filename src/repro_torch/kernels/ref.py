"""Plain PyTorch oracles for the SZ kernels (the port of the SZ half of
``repro.kernels.ref``).

Each mirrors its kernel's semantics, tile-blocked prediction included, with
padding and concatenation instead of the shared tile helpers, so the tests
cross-check two independent formulations.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lorenzo3d import TILE, guarded_eb

_2P31 = 1 << 31


def _tiles(a: torch.Tensor) -> torch.Tensor:
    tz, ty, tw = TILE
    z, y, w = a.shape
    return a.reshape(z // tz, tz, y // ty, ty, w // tw, tw).permute(0, 2, 4, 1, 3, 5)


def _untile(t: torch.Tensor, shape) -> torch.Tensor:
    return t.permute(0, 3, 1, 4, 2, 5).reshape(shape)


def lorenzo3d_quantize_ref(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Tile-blocked dual-quant Lorenzo residual (int32)."""
    eb_i = guarded_eb(x, eb)
    # reciprocal-multiply, matching the kernel exactly (x/a differs in ulps)
    q = torch.round(x.to(torch.float32) * (1.0 / (2.0 * eb_i))).to(torch.int64)
    d = _tiles(q)
    for axis in (3, 4, 5):
        zero = torch.zeros_like(d.narrow(axis, 0, 1))
        d = d - torch.cat([zero, d.narrow(axis, 0, d.shape[axis] - 1)], dim=axis)
    d = ((d + _2P31) % (1 << 32)) - _2P31  # int32 wrap
    return _untile(d, x.shape).to(torch.int32)


def lorenzo3d_reconstruct_ref(delta: torch.Tensor, eb_i) -> torch.Tensor:
    dt = _tiles(delta.to(torch.int64))
    for axis in (3, 4, 5):
        dt = ((torch.cumsum(dt, dim=axis) + _2P31) % (1 << 32)) - _2P31
    q = _untile(dt, delta.shape).to(torch.int32)
    eb = torch.as_tensor(eb_i, dtype=torch.float32, device=delta.device)
    return q.to(torch.float32) * (2.0 * eb)
