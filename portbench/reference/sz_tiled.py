"""Plain reference of SZ's tiled route (``get_compressor("tpu-sz")`` on a 3-D
field on the card: ``guarded_eb``, K3, K4), a frozen copy of the port's
plain versions.

Compress: pad the field with zeros to (8, 64, 128) tiles; the guarded bound
``eb_i = eb * (0.995 - clamp(|x|max / eb * 2^-22, 0, 0.25))``, all float32;
``q = round(x * (1 / (2 eb_i)))``; the 3-D Lorenzo residual inside each tile
(prediction resets at tile edges), wrapping as int32; zigzag; tiles in
raster order, each flattened C-order; blocks of 64 codes packed at their
widest code's bit length into one dense word stream of capacity n + 2;
``total_bits`` = 64 * sum(widths) + 8 * blocks.  Decompress inverts it and
dequantizes with ``q * (2 eb_i)``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.bits import (MASK32, bitlength, code_mask, i64_to_u32, round_i32,
                                      u32_to_i64, wrap_i32)

TILE = (8, 64, 128)
BLOCK = 64
WIDTH_BITS = 8
LIMITS = {"max_err_over_eb": 1.0}  # the ABS guarantee: |x' - x| <= eb


def padded_shape(shape) -> tuple[int, int, int]:
    return tuple(s + (-s) % t for s, t in zip(shape, TILE))


def guarded_bound(x: torch.Tensor, eb: float) -> torch.Tensor:
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=x.device)  # noqa: E731
    e = f32(float(eb))
    kappa = torch.clamp(x.abs().amax() / e * f32(2.0**-22), 0.0, 0.25)
    return e * (f32(0.995) - kappa)


def _tiles(a: torch.Tensor) -> torch.Tensor:
    gz, gy, gx = (s // t for s, t in zip(a.shape, TILE))
    return a.reshape(gz, TILE[0], gy, TILE[1], gx, TILE[2]).permute(0, 2, 4, 1, 3, 5)


def _untiles(t: torch.Tensor) -> torch.Tensor:
    gz, gy, gx, tz, ty, tx = t.shape
    return t.permute(0, 3, 1, 4, 2, 5).reshape(gz * tz, gy * ty, gx * tx)


def _positions(width: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit position of every code and its width, int64 [n]."""
    width = width.to(torch.int64)
    base = torch.cumsum(width * BLOCK, 0) - width * BLOCK
    pos = torch.arange(n, dtype=torch.int64, device=width.device)
    blk = pos // BLOCK
    w = width[blk]
    return base[blk] + (pos % BLOCK) * w, w


def compress(x: torch.Tensor, kwargs: dict) -> dict[str, torch.Tensor]:
    x = x.to(torch.float32)
    pz, py, px = padded_shape(x.shape)
    x = F.pad(x, (0, px - x.shape[2], 0, py - x.shape[1], 0, pz - x.shape[0]))
    n = x.numel()
    if n * 32 >= 2**31:
        raise ValueError(f"n={n} too large for the stream's int32 bit offsets")
    eb_i = guarded_bound(x, kwargs["eb"])
    q = round_i32(x * (1.0 / (2.0 * eb_i))).to(torch.int64)
    d = _tiles(q)
    for axis in (3, 4, 5):
        prev = torch.zeros_like(d)
        ext = d.shape[axis]
        prev.narrow(axis, 1, ext - 1).copy_(d.narrow(axis, 0, ext - 1))
        d = d - prev
    v = wrap_i32(d).reshape(-1)  # tile-major order
    del q, d
    u = ((v << 1) ^ (v >> 63)) & MASK32  # zigzag
    width = bitlength(u.view(-1, BLOCK)).amax(dim=1)
    pos, _ = _positions(width, n)
    off = pos & 31
    word = pos >> 5
    buf = torch.zeros(n + 66, dtype=torch.int64, device=x.device)
    buf.index_add_(0, word, (u << off) & MASK32)
    buf.index_add_(0, word + 1, (u >> 1) >> (31 - off))  # codes never share a bit
    total = (width * BLOCK).sum() + width.numel() * WIDTH_BITS
    return {"words": i64_to_u32(buf[: n + 2]), "widths": width.to(torch.uint8),
            "total_bits": total.reshape(()), "eb_i": eb_i.reshape(())}


def decompress(stream: dict, x_shape, kwargs: dict) -> torch.Tensor:
    shape = padded_shape(x_shape)
    n = math.prod(shape)
    pos, w = _positions(stream["widths"], n)
    words = u32_to_i64(stream["words"])
    cap = words.shape[0]
    off = pos & 31
    lo = words[(pos >> 5).clamp(0, cap - 1)] >> off
    hi = ((words[((pos >> 5) + 1).clamp(0, cap - 1)] << 1) << (31 - off)) & MASK32
    u = (lo | hi) & code_mask(w)
    v = (u >> 1) ^ -(u & 1)  # unzigzag
    gz, gy, gx = (s // t for s, t in zip(shape, TILE))
    q = v.reshape(gz, gy, gx, *TILE)
    for axis in (3, 4, 5):
        q = wrap_i32(torch.cumsum(q, dim=axis))
    xr = _untiles(q).to(torch.int32).to(torch.float32) * (2.0 * stream["eb_i"].to(torch.float32))
    return xr[tuple(slice(0, s) for s in x_shape)]


def program_stream(result) -> dict[str, torch.Tensor]:
    p = result.payload
    packed = p["kpacked"]
    return {"words": packed.words, "widths": packed.widths,
            "total_bits": packed.total_bits.reshape(()).to(torch.int64),
            "eb_i": torch.as_tensor(p["eb_i"]).reshape(()).to(torch.float32)}


def guarantees(x: torch.Tensor, recon: torch.Tensor, kwargs: dict) -> dict[str, torch.Tensor]:
    """The ABS guarantee's number as a 0-d tensor on the device (no wait)."""
    if tuple(recon.shape) != tuple(x.shape):
        return {"max_err_over_eb": torch.tensor(math.inf)}
    err = (recon.to(torch.float64) - x.to(torch.float64)).abs().amax()
    return {"max_err_over_eb": err / float(kwargs["eb"])}
