"""Plain reference of SZ's core route on 1-D fields (``get_compressor("tpu-sz")``
on a 1-D field, on the card as on the CPU: the HACC partition, the cube, the
global Lorenzo coder and the block packer, and under PW_REL the log
transform), a frozen copy of the port's core route.

Compress: under PW_REL, ``signs = sign(x)`` as int8 and ``x = ln|x|`` (0 where
x is 0), with the ABS bound ``eb = log1p(pw_rel)`` on the logs.  The field is
cut into partitions of 2^27 points, each zero-padded to a cube of side
``max(4, ceil(n^(1/3)))``; per cube, the guarded bound ``eb_i = eb * (0.995 -
clamp(|x|max / eb * 2^-22, 0, 0.25))``, all float32; ``q = round(x / (2
eb_i))``; the global 3-D Lorenzo residual, wrapping as int32; zigzag; blocks
of 64 codes in C order packed at their widest code's bit length into one
dense word stream of capacity n + 2; ``total_bits`` = 64 * sum(widths) + 8 *
blocks.  The stream holds the cubes' words and widths one after another,
``total_bits`` and ``eb_i`` one a cube, and ``signs`` under PW_REL.
Decompress inverts it: prefix sums wrapping as int32, ``q * (2 eb_i)``, the
cubes' first points joined, and under PW_REL ``sign * exp(x)``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.bits import (MASK32, bitlength, code_mask, i64_to_u32, round_i32,
                                      u32_to_i64, wrap_i32)

PARTITION = 1 << 27  # HACC partition of a 1-D field, as in the paper
BLOCK = 64
WIDTH_BITS = 8
# the ABS guarantee |x' - x| <= eb, and the PW_REL one |x' - x| <= pw_rel |x|
LIMITS = {"max_err_over_eb": 1.0, "max_relerr_over_pwrel": 1.0}


def cube_sides(n: int) -> list[tuple[int, int]]:
    """(points, cube side) of each partition of a field of ``n`` points."""
    out = []
    for a in range(0, n, PARTITION):
        m = min(PARTITION, n - a)
        out.append((m, max(4, math.ceil(m ** (1 / 3)))))
    return out


def guarded_bound(x: torch.Tensor, eb: float) -> torch.Tensor:
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=x.device)  # noqa: E731
    e = f32(float(eb))
    kappa = torch.clamp(x.abs().amax() / e * f32(2.0**-22), 0.0, 0.25)
    return e * (f32(0.995) - kappa)


def _positions(width: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit position of every code and its width, int64 [n]."""
    width = width.to(torch.int64)
    base = torch.cumsum(width * BLOCK, 0) - width * BLOCK
    pos = torch.arange(n, dtype=torch.int64, device=width.device)
    blk = pos // BLOCK
    w = width[blk]
    return base[blk] + (pos % BLOCK) * w, w


def _pack(v: torch.Tensor):
    """int64 codes holding int32 values -> (words, widths, total_bits)."""
    n = v.numel()
    blocks = -(-n // BLOCK)
    u = F.pad(((v << 1) ^ (v >> 63)) & MASK32, (0, blocks * BLOCK - n))  # zigzag
    width = bitlength(u.view(blocks, BLOCK)).amax(dim=1)
    pos, _ = _positions(width, blocks * BLOCK)
    off = pos & 31
    word = pos >> 5
    buf = torch.zeros(blocks * BLOCK + 66, dtype=torch.int64, device=v.device)
    buf.index_add_(0, word, (u << off) & MASK32)
    buf.index_add_(0, word + 1, (u >> 1) >> (31 - off))  # codes never share a bit
    total = (width * BLOCK).sum() + blocks * WIDTH_BITS
    return i64_to_u32(buf[: n + 2]), width.to(torch.uint8), total.reshape(())


def _unpack(words: torch.Tensor, widths: torch.Tensor, n: int) -> torch.Tensor:
    """The int64 codes of one cube's stream."""
    pos, w = _positions(widths, n)
    words = u32_to_i64(words)
    cap = words.shape[0]
    off = pos & 31
    lo = words[(pos >> 5).clamp(0, cap - 1)] >> off
    hi = ((words[((pos >> 5) + 1).clamp(0, cap - 1)] << 1) << (31 - off)) & MASK32
    u = (lo | hi) & code_mask(w)
    return (u >> 1) ^ -(u & 1)  # unzigzag


def compress(x: torch.Tensor, kwargs: dict) -> dict[str, torch.Tensor]:
    if x.ndim != 1:
        raise ValueError(f"the core route's reference takes 1-D fields, not {tuple(x.shape)}")
    x = x.to(torch.float32)
    stream: dict[str, torch.Tensor] = {}
    if "pw_rel" in kwargs:
        stream["signs"] = torch.sign(x).to(torch.int8)
        mag = x.abs()
        nz = mag > 0
        x = torch.where(nz, torch.log(torch.where(nz, mag, 1.0)), 0.0).to(torch.float32)
        eb = math.log1p(float(kwargs["pw_rel"]))
    else:
        eb = float(kwargs["eb"])
    words, widths, totals, ebs = [], [], [], []
    for a, (m, side) in zip(range(0, x.shape[0], PARTITION), cube_sides(x.shape[0])):
        n = side ** 3
        if n * 32 >= 2**31:
            raise ValueError(f"n={n} too large for the stream's int32 bit offsets")
        cube = F.pad(x[a:a + m], (0, n - m)).reshape(side, side, side)
        eb_i = guarded_bound(cube, eb)
        d = round_i32(cube / (2.0 * eb_i)).to(torch.int64)
        for axis in range(3):  # the residual, exact in int64
            d = torch.diff(d, dim=axis, prepend=torch.zeros_like(d.narrow(axis, 0, 1)))
        w, wd, t = _pack(wrap_i32(d).reshape(-1))
        del d
        words.append(w)
        widths.append(wd)
        totals.append(t)
        ebs.append(eb_i.reshape(()))
    stream.update(words=torch.cat(words), widths=torch.cat(widths),
                  total_bits=torch.stack(totals), eb_i=torch.stack(ebs))
    return stream


def decompress(stream: dict, x_shape, kwargs: dict) -> torch.Tensor:
    flats, w0, b0 = [], 0, 0
    for i, (m, side) in enumerate(cube_sides(x_shape[0])):
        n = side ** 3
        blocks = -(-n // BLOCK)
        v = _unpack(stream["words"][w0:w0 + n + 2], stream["widths"][b0:b0 + blocks], n)
        w0, b0 = w0 + n + 2, b0 + blocks
        q = v.reshape(side, side, side)
        for axis in range(3):
            q = wrap_i32(torch.cumsum(q, dim=axis))
        xr = q.to(torch.int32).to(torch.float32) * (2.0 * stream["eb_i"][i].to(torch.float32))
        flats.append(xr.reshape(-1)[:m])
    x = torch.cat(flats)[: x_shape[0]]
    if "pw_rel" in kwargs:
        s = stream["signs"]
        x = torch.where(s == 0, 0.0, s.to(torch.float32) * torch.exp(x))
    return x


def program_stream(result) -> dict[str, torch.Tensor]:
    p = result.payload
    parts = p["parts"]
    out = {"words": torch.cat([c.packed.words for c in parts]),
           "widths": torch.cat([c.packed.widths for c in parts]),
           "total_bits": torch.stack([c.packed.total_bits.reshape(()).to(torch.int64)
                                      for c in parts]),
           "eb_i": torch.stack([torch.as_tensor(c.eb).reshape(()).to(torch.float32)
                                for c in parts])}
    if p["signs"] is not None:
        out["signs"] = p["signs"]
    return out


def guarantees(x: torch.Tensor, recon: torch.Tensor, kwargs: dict) -> dict[str, torch.Tensor]:
    """Both numbers as 0-d tensors on the device (no wait), 0 for the mode the
    call does not state: ABS ``max |x' - x| / eb``; PW_REL ``max |x' - x| /
    (pw_rel |x|)`` over nonzero x, inf where a zero comes back nonzero."""
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    if tuple(recon.shape) != tuple(x.shape):
        inf = torch.full((), math.inf, dtype=torch.float64, device=x.device)
        return {"max_err_over_eb": inf, "max_relerr_over_pwrel": inf}
    x64, r64 = x.to(torch.float64), recon.to(torch.float64)
    err = (r64 - x64).abs()
    if "pw_rel" not in kwargs:
        return {"max_err_over_eb": err.amax() / float(kwargs["eb"]), "max_relerr_over_pwrel": zero}
    nz = x64 != 0
    rel = torch.where(nz, err / (float(kwargs["pw_rel"]) * x64.abs()), 0.0).amax()
    zeros_moved = (~nz & (r64 != 0)).any()
    return {"max_err_over_eb": zero,
            "max_relerr_over_pwrel": torch.where(zeros_moved, math.inf, rel)}
