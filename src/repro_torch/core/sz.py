"""TPU-SZ: error-bounded lossy compression via dual-quantized Lorenzo
prediction (the port of ``repro.core.sz``).

Prequantize ``q = round(x / (2*eb))`` (round half to even), take the exact
integer Lorenzo residual of ``q`` and pack it with :mod:`bitpack`; the
inverse Lorenzo transform is a d-fold inclusive prefix sum.  The arithmetic
is the reference's: ``compress`` divides by ``2*eb_i`` (the kernels multiply
by its reciprocal, which differs in ulps), and residuals and prefix sums wrap
mod 2**32 exactly as the reference's int32 arithmetic does — they are carried
in int64 and wrapped back, because ``torch.cumsum`` on int32 returns int64.

``block_size`` mirrors GPU-SZ's independent data blocking (prediction resets
at block borders); ``None`` is global prediction.  The ``exchange`` border
hooks of :func:`lorenzo_residual` and :func:`lorenzo_reconstruct` let a
sharded caller (:mod:`repro_torch.dist.insitu`) give each shard's predictor
its true left neighbours.

Traced (:mod:`repro_torch.obs.trace`): :func:`compress` is the span
``sz.core_compress`` (its own time the guarded bound and the prequantize),
with the children ``sz.lorenzo`` (the residual) and ``sz.pack``;
:func:`decompress` is ``sz.core_decompress``, with the children
``sz.unpack`` and ``sz.reconstruct`` (the prefix sums and the dequantize).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

_2P31 = 1 << 31


@dataclasses.dataclass
class SZCompressed:
    """Compressed field."""

    packed: bitpack.PackedCodes
    eb: torch.Tensor  # float32[] absolute error bound used
    shape: tuple[int, ...]
    block_size: int | None  # None => global Lorenzo


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it equals mod 2**32 (kept in int64)."""
    return ((v + _2P31) & bitpack.MASK32) - _2P31


def lorenzo_residual(q: torch.Tensor, exchange=None, ndim: int | None = None) -> torch.Tensor:
    """Exact integer Lorenzo residual: d-fold first difference (int32).

    ``exchange`` is the border-override hook for sharded fields: a callable
    ``(field_axis, last_plane) -> prev_plane | None``.  Before differencing
    field axis ``a``, the running intermediate's *last* plane along that axis
    (int32, as the reference's) is offered to the hook; a distributed caller
    (:mod:`repro_torch.dist.insitu`) ships it one shard rightward and returns
    the plane received from its left neighbour, so the shard's predictor
    starts from its true left border instead of the implicit zero plane.
    ``None`` (or no hook) keeps the zero border — the single-device
    behaviour, and the correct one for mesh-edge shards.

    ``ndim`` counts the field axes from the right, so a stacked
    ``(batch..., *field)`` tensor is differenced per field (a shard-local
    block, or stacked shards under a mocked mesh in the tests)."""
    nd = q.ndim if ndim is None else ndim
    d = q.to(torch.int64)
    for a in range(nd):
        axis = a - nd
        ext = d.shape[axis]
        prev = torch.zeros_like(d)
        prev.narrow(axis, 1, ext - 1).copy_(d.narrow(axis, 0, ext - 1))
        if exchange is not None:
            # the running intermediate is carried unwrapped in int64; its
            # face travels as the int32 value it equals mod 2**32
            face = exchange(a, _wrap_i32(d.narrow(axis, ext - 1, 1)).to(torch.int32))
            if face is not None:
                prev.narrow(axis, 0, 1).copy_(face.to(torch.int64))
        d = d - prev
    return _wrap_i32(d).to(torch.int32)


def lorenzo_reconstruct(delta: torch.Tensor, exchange=None, ndim: int | None = None) -> torch.Tensor:
    """Inverse Lorenzo: d-fold inclusive prefix sum, wrapping as int32 does.

    ``exchange`` is the reconstruction-side border hook, dual to the one on
    :func:`lorenzo_residual`: a callable ``(field_axis, local_total_plane) ->
    carry | None``.  After the local cumsum along field axis ``a``, the hook
    receives the shard's inclusive total (its last plane, int32) and returns
    the carry to add — the sum of every left shard's total, an exclusive
    cross-shard scan.  The add wraps as int32 addition does, and that is
    associative under wraparound, so local cumsum + carry is *bitwise* the
    global cumsum.  ``ndim`` as in :func:`lorenzo_residual`."""
    nd = delta.ndim if ndim is None else ndim
    q = delta.to(torch.int64)
    for a in range(nd):
        axis = a - nd
        q = _wrap_i32(torch.cumsum(q, dim=axis))
        if exchange is not None:
            ext = q.shape[axis]
            carry = exchange(a, q.narrow(axis, ext - 1, 1).to(torch.int32))
            if carry is not None:
                q = _wrap_i32(q + carry.to(torch.int64))
    return q.to(torch.int32)


def from_stream(words, widths, n: int, eb_i, shape, total_bits=None,
                block_size: int | None = None,
                device: str | torch.device | None = None) -> SZCompressed:
    """Rebuild an :class:`SZCompressed` on ``device`` (CUDA unless ``"cpu"``)
    from a true-payload word slice plus its descriptors (inverse of slicing
    ``bitpack.to_storage`` out of :func:`compress`'s result)."""
    device = resolve_device(device)
    packed = bitpack.from_storage(words, widths, n, total_bits, device=device)
    return SZCompressed(packed, f32_scalar(eb_i, device), tuple(shape), block_size)


def _padded_shape(shape: Sequence[int], b: int) -> tuple[int, ...]:
    return tuple(s + (-s) % b for s in shape)


def _to_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """Pad to multiples of ``b`` and carve independent b^d blocks."""
    pads: list[int] = []
    for s in reversed(x.shape):
        pads += [0, (-s) % b]
    xp = F.pad(x, pads)
    nd = x.ndim
    shp: list[int] = []
    for s in xp.shape:
        shp += [s // b, b]
    # (g0,b,g1,b,...) -> (g0,g1,...,b,b,...)
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    return xp.reshape(shp).permute(perm)


def _from_blocks(xb: torch.Tensor, padded_shape: Sequence[int], shape: Sequence[int]) -> torch.Tensor:
    nd = len(shape)
    perm: list[int] = []
    for i in range(nd):
        perm += [i, nd + i]
    xp = xb.permute(perm).reshape(tuple(padded_shape))
    return xp[tuple(slice(0, s) for s in shape)]


def f32_scalar(v, device) -> torch.Tensor:
    """A float32 scalar tensor on ``device`` from a tensor, numpy or Python
    number (float32 values cross exactly)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def internal_bound(absmax: torch.Tensor, eb) -> torch.Tensor:
    """Internal (guarded) bound from the field's |x|max: the user bound shrunk
    for f32 quantize/dequantize roundoff.  Every constant and operand is
    float32, so the result is the reference's bit for bit."""
    eb = f32_scalar(eb, absmax.device)
    kappa = torch.clamp(absmax / eb * f32_scalar(2.0**-22, absmax.device), 0.0, 0.25)
    return eb * (f32_scalar(0.995, absmax.device) - kappa)


def compress(x: torch.Tensor, eb, block_size: int | None = None) -> SZCompressed:
    """Error-bounded (ABS mode) compression of a 1-D/2-D/3-D float field."""
    shape = tuple(x.shape)
    n_codes = math.prod(shape if block_size is None else _padded_shape(shape, block_size))
    bitpack.check_fits("pack_codes", n_codes)  # before anything is allocated
    with obs_trace.span("sz.core_compress"):
        x = x.to(torch.float32)
        eb_i = internal_bound(x.abs().amax(), eb)
        q = bitpack.round_i32(x / (2.0 * eb_i))
        with obs_trace.span("sz.lorenzo"):
            if block_size is None:
                delta = lorenzo_residual(q)
            else:
                delta = lorenzo_residual(_to_blocks(q, block_size), ndim=x.ndim)
        with obs_trace.span("sz.pack"):
            packed = bitpack.pack_codes(delta.reshape(-1))
        return SZCompressed(packed, eb_i, shape, block_size)


def decompress(c: SZCompressed) -> torch.Tensor:
    with obs_trace.span("sz.core_decompress"):
        with obs_trace.span("sz.unpack"):
            codes = bitpack.unpack_codes(c.packed)
        with obs_trace.span("sz.reconstruct"):
            b = c.block_size
            if b is None:
                q = lorenzo_reconstruct(codes.reshape(c.shape))
            else:
                nd = len(c.shape)
                padded_shape = _padded_shape(c.shape, b)
                blk_shape = tuple(s // b for s in padded_shape) + (b,) * nd
                qb = lorenzo_reconstruct(codes.reshape(blk_shape), ndim=nd)
                q = _from_blocks(qb, padded_shape, c.shape)
            return q.to(torch.float32) * (2.0 * c.eb)


def compressed_nbytes(c: SZCompressed) -> torch.Tensor:
    return bitpack.packed_nbytes(c.packed)
