"""Bit helpers shared by the references (frozen copies of the port's
``core.bitpack`` arithmetic).  32-bit values are carried in int64 masked to
[0, 2**32), since PyTorch has few operations for uint32."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_2P31 = 1 << 31


def u32_to_i64(u: torch.Tensor) -> torch.Tensor:
    if u.dtype in (torch.uint32, torch.int32):
        u = u.view(torch.int32)
    return u.to(torch.int64) & MASK32


def i64_to_u32(v: torch.Tensor) -> torch.Tensor:
    return (v & MASK32).to(torch.int32).view(torch.uint32)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it equals mod 2**32 (kept in int64)."""
    return ((v + _2P31) & MASK32) - _2P31


def round_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32: round half to even, saturate, NaN to 0."""
    r = torch.round(x)
    safe = torch.where(torch.isnan(r), 0.0, r).clamp(-2.0**31, 2.0**31 - 128)
    return torch.where(r >= 2.0**31, 2**31 - 1, safe.to(torch.int32))


def bitlength(v: torch.Tensor) -> torch.Tensor:
    """Bit length of 32-bit values held in int64 (0 -> 0), int64."""
    w = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        w = w + m.to(torch.int64) * s
        v = torch.where(m, v >> s, v)
    return w + (v > 0).to(torch.int64)


def code_mask(w: torch.Tensor) -> torch.Tensor:
    """Mask of the low ``w`` bits (int64), exact for w in [0, 32]."""
    w = w.to(torch.int64)
    return torch.where(w == 0, 0, torch.full_like(w, MASK32) >> (32 - torch.clamp(w, min=1)))


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (every element when the shapes differ)."""
    if tuple(a.shape) != tuple(b.shape) or a.element_size() != b.element_size():
        return max(a.numel(), b.numel())
    if a.device != b.device:
        b = b.to(a.device)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return int((a.contiguous().view(bits) != b.contiguous().view(bits)).sum())


DIGEST_CHUNK = 1 << 16  # values a chunk of a digest
_DIGEST_GROUP = 1 << 8  # chunks summed at once: bounds the int64 temporaries
_weights: dict = {}


def _digest_weights(device) -> torch.Tensor:
    """Two fixed rows of odd weights below 2**24, one for each 16-bit half."""
    key = str(device)
    if key not in _weights:
        g = torch.Generator().manual_seed(0x5EED)
        w = torch.randint(0, 1 << 23, (2, DIGEST_CHUNK), generator=g, dtype=torch.int64) * 2 + 1
        _weights[key] = w.to(device)
    return _weights[key]


def digest(x: torch.Tensor) -> torch.Tensor:
    """A digest of ``x``'s bits, int64 ``(chunks, 2)``: for each run of
    ``DIGEST_CHUNK`` values (4-byte elements, flattened), the weighted sums of
    their low and high 16-bit halves, exact (below 2**56 each), so two
    tensors' digests differ in a chunk wherever a value's bits or place
    differ, but for a collision of weighted sums.  Runs on ``x``'s device and
    does not wait for it."""
    v = x.contiguous().reshape(-1).view(torch.int32)
    w = _digest_weights(v.device)
    n = v.numel()
    out = torch.empty((-(-n // DIGEST_CHUNK), 2), dtype=torch.int64, device=v.device)
    step = DIGEST_CHUNK * _DIGEST_GROUP
    for a in range(0, n, step):
        part = v[a:a + step]
        if part.numel() % DIGEST_CHUNK:
            part = torch.nn.functional.pad(part, (0, DIGEST_CHUNK - part.numel() % DIGEST_CHUNK))
        rows = part.reshape(-1, DIGEST_CHUNK)
        c = a // DIGEST_CHUNK
        out[c:c + rows.shape[0], 0] = ((rows & 0xFFFF).to(torch.int64) * w[0]).sum(dim=1)
        out[c:c + rows.shape[0], 1] = (((rows >> 16) & 0xFFFF).to(torch.int64) * w[1]).sum(dim=1)
    return out
