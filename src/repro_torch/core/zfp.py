"""TPU-ZFP: fixed-rate transform compression of 3-D fields (the port of
``repro.core.zfp``).

Per 4x4x4 block, following ZFP's stages:
  1. block-floating-point: align to the block max exponent, convert to
     signed fixed point with ``Q`` fractional bits (exact integers),
  2. the exact integer lifting transform along each axis (ZFP's
     fwd_lift / inv_lift shift-add sequences, bit-exact inverses),
  3. negabinary mapping so sign information lives in high bit planes,
  4. coefficients permuted to sequency order (total-degree sort),
  5. fixed-rate embedded truncation: bits are emitted plane-major,
     sequency-group-minor until the per-block budget ``rate * 64`` bits
     (header included) is spent.

The per-block header (8-bit emax + the top bit plane of each of the 10
sequency groups) makes the whole bit schedule a pure function of per-block
integers, so the coder is plane-parallel and word-level: each plane's
significant bits form a <= 64-bit payload at a header-derived offset, and
the stream is assembled with masked shifts and ORs.  The stream is bit for
bit the reference's (the twin tests pin its seed streams).

Representation.  Stored words are ``torch.uint32`` (the storage boundary,
as in :mod:`repro_torch.core.bitpack`); all bit arithmetic carries 32-bit
values in ``int64`` masked to ``[0, 2**32)``, because PyTorch has no shifts
or adds for ``uint32`` on the CPU.  The lifts carry int32 values in int64 and
wrap after every add, subtract and left shift, so they equal the
reference's wrapping int32 arithmetic, arithmetic right shifts included.

Subnormals.  The reference runs where subnormal floats are flushed to zero
(the TPU, and XLA on the CPU), so a block whose ``|x|max`` is subnormal is
a zero block there (``emax`` 0).  This port states that rule explicitly: a
block is nonzero iff its ``|x|max`` is a normal float.  Elsewhere nothing
changes: a subnormal value quantizes to 0 at every block exponent
(``e >= -100`` makes ``|x| * 2^(Q - e) < 1/2``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bitpack import MASK32, i64_to_u32, round_i32, u32_to_i64
from repro_torch.core.bitpack import code_mask as _code_mask
from repro_torch.device import resolve_device

Q = 25  # fixed-point fractional bits; transform growth (< 2^3) keeps int32 safe
_NBMASK_VAL = 0xAAAAAAAA
_EMAX_BIAS = 128  # stored emax = e + bias; 0 reserved for all-zero blocks
N_GROUPS = 10  # sequency groups: total degree i+j+k in 0..9
_HEADER_BITS = 8 + 5 * N_GROUPS  # emax + per-group top plane
BLOCK_SIDE = 4  # ZFP block edge; also the shard-seam alignment quantum
_FLT_MIN = 2.0**-126  # smallest normal float32
_2P31 = 1 << 31


def shard_extent_aligned(extent: int, n_shards: int) -> bool:
    """Whether a field axis of ``extent`` per shard may be split into
    ``n_shards`` shards without changing the stream: ZFP blocks are
    self-contained, so every seam must fall on a block boundary."""
    return n_shards <= 1 or extent % BLOCK_SIDE == 0


def _perm3() -> np.ndarray:
    """Sequency (total-degree) order over the 4x4x4 block, x fastest."""
    coords = [(i, j, k) for k in range(4) for j in range(4) for i in range(4)]
    idx = np.arange(64)
    key = sorted(idx, key=lambda t: (sum(coords[t]), coords[t][::-1]))
    return np.asarray(key, np.int32)


PERM = _perm3()
IPERM = np.argsort(PERM).astype(np.int32)

_COORDS = [(i, j, k) for k in range(4) for j in range(4) for i in range(4)]
GROUP_SIZES = np.bincount([sum(_COORDS[p]) for p in PERM], minlength=N_GROUPS)
GROUP_OF_COEF = np.asarray([sum(_COORDS[p]) for p in PERM], np.int32)  # (64,)
_gstart = np.concatenate([[0], np.cumsum(GROUP_SIZES)[:-1]])
RANK_IN_GROUP = np.asarray(
    [i - _gstart[GROUP_OF_COEF[i]] for i in range(64)], np.int32
)

def _index(perm: np.ndarray, device) -> torch.Tensor:
    """A static permutation as an index tensor on ``device``."""
    return torch.as_tensor(perm, dtype=torch.int64, device=device)


# In sequency order the 10 groups split exactly at bit 32: groups 0-4 fill
# coefficients 0..31 and groups 5-9 fill 32..63, so the uncompacted plane
# bit-matrix is two clean 32x32 transposes of the coefficient words.
_FIXED_START = tuple(int(s) for s in _gstart)  # (0,1,4,10,20,32,44,54,60,63)
assert _FIXED_START[5] == 32


@dataclasses.dataclass
class ZFPCompressed:
    """Fixed-rate compressed field."""

    words: torch.Tensor  # uint32[n_blocks, words_per_block] embedded bitstream
    emax: torch.Tensor  # uint8[n_blocks] biased block exponent (0 = zero block)
    gtops: torch.Tensor  # uint8[n_blocks, 10] per-sequency-group top bit plane
    shape: tuple[int, ...]  # original 3-D shape
    rate: int  # bits/value


# ------------------------------------------------------ stages 1-4 -------


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it equals mod 2**32 (kept in int64)."""
    return ((v + _2P31) & MASK32) - _2P31


def fwd_lift(v: torch.Tensor) -> torch.Tensor:
    """ZFP forward lift along the last axis (length 4), exact int32 (as int64)."""
    x, y, z, w = v.to(torch.int64).unbind(-1)
    x = _i32(x + w)
    x = x >> 1
    w = _i32(w - x)
    z = _i32(z + y)
    z = z >> 1
    y = _i32(y - z)
    x = _i32(x + z)
    x = x >> 1
    z = _i32(z - x)
    w = _i32(w + y)
    w = w >> 1
    y = _i32(y - w)
    w = _i32(w + (y >> 1))
    y = _i32(y - (w >> 1))
    return torch.stack([x, y, z, w], dim=-1)


def inv_lift(v: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`fwd_lift` (ZFP inv_lift)."""
    x, y, z, w = v.to(torch.int64).unbind(-1)
    y = _i32(y + (w >> 1))
    w = _i32(w - (y >> 1))
    y = _i32(y + w)
    w = _i32(w << 1)
    w = _i32(w - y)
    z = _i32(z + x)
    x = _i32(x << 1)
    x = _i32(x - z)
    y = _i32(y + z)
    z = _i32(z << 1)
    z = _i32(z - y)
    w = _i32(w + x)
    x = _i32(x << 1)
    x = _i32(x - w)
    return torch.stack([x, y, z, w], dim=-1)


def _lift3d(blocks: torch.Tensor) -> torch.Tensor:
    b = blocks
    for axis in (3, 2, 1):
        b = fwd_lift(b.movedim(axis, -1)).movedim(-1, axis)
    return b


def _inv_lift3d(blocks: torch.Tensor) -> torch.Tensor:
    b = blocks
    for axis in (1, 2, 3):  # reverse order of the forward pass
        b = inv_lift(b.movedim(axis, -1)).movedim(-1, axis)
    return b


def exact_exp2(k: torch.Tensor) -> torch.Tensor:
    """Exact 2^k for integer k in [-126, 127], built in IEEE exponent bits."""
    k = torch.clamp(k.to(torch.int32), -126, 127)
    return ((k + 127) << 23).view(torch.float32)


def negabinary(i: torch.Tensor) -> torch.Tensor:
    """int32 values (any integer dtype) -> negabinary 32-bit codes as int64."""
    u = i.to(torch.int64) & MASK32
    return ((u + _NBMASK_VAL) & MASK32) ^ _NBMASK_VAL


def inv_negabinary(u: torch.Tensor) -> torch.Tensor:
    """Negabinary codes (uint32 storage or int64) -> int32 values as int64."""
    return _i32((u32_to_i64(u) ^ _NBMASK_VAL) - _NBMASK_VAL)


def _bitlength32(u: torch.Tensor) -> torch.Tensor:
    """Exact bit length of 32-bit values (uint32 or int64), int64."""
    v = u32_to_i64(u)
    w = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        m = v >= (1 << s)
        w = w + m.to(torch.int64) * s
        v = torch.where(m, v >> s, v)
    return w + (v > 0).to(torch.int64)


def _carve_blocks(x: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (n_blocks, 4, 4, 4) with edge padding (ZFP pads blocks)."""
    pads = [(-s) % 4 for s in x.shape]
    if any(pads):
        # replicate padding takes a batched (or channel-first) 3-D tensor
        x = F.pad(x[None], (0, pads[2], 0, pads[1], 0, pads[0]), mode="replicate")[0]
    gx, gy, gz = (s // 4 for s in x.shape)
    xb = x.reshape(gx, 4, gy, 4, gz, 4).permute(0, 2, 4, 1, 3, 5)
    return xb.reshape(-1, 4, 4, 4).contiguous()  # reshape may return a strided view


def _uncarve_blocks(xb: torch.Tensor, shape) -> torch.Tensor:
    padded = tuple(s + ((-s) % 4) for s in shape)
    gx, gy, gz = (s // 4 for s in padded)
    xp = xb.reshape(gx, gy, gz, 4, 4, 4).permute(0, 3, 1, 4, 2, 5).reshape(padded)
    return xp[tuple(slice(0, s) for s in shape)]


def _group_tops(lens: torch.Tensor) -> torch.Tensor:
    """Per-group max of sequency-order bit lengths: the groups are contiguous
    static segments, so 10 slice maxes."""
    return torch.stack([lens[:, s0:s0 + int(sz)].amax(dim=1)
                        for s0, sz in zip(_FIXED_START, GROUP_SIZES)], dim=1)


def block_transform(x: torch.Tensor):
    """Stages 1-4: float field -> (negabinary sequency coeffs uint32[n, 64],
    emax uint8[n], gtops int32[n, 10])."""
    return blocks_transform(_carve_blocks(x.to(torch.float32)))


def blocks_transform(blocks: torch.Tensor):
    """Stages 2-4 on already-carved (n, 4, 4, 4) blocks."""
    maxabs = blocks.abs().amax(dim=(1, 2, 3))
    _, e = torch.frexp(maxabs)  # maxabs < 2^e
    e = torch.clamp(e, -100, 127).to(torch.int32)
    nonzero = maxabs >= _FLT_MIN  # a subnormal |x|max is a zero block (module doc)
    scale = exact_exp2(Q - e)
    ints = round_i32(blocks * scale[:, None, None, None])
    coef = _lift3d(ints)
    u = negabinary(coef.reshape(-1, 64))[:, _index(PERM, blocks.device)]
    gtops = _group_tops(_bitlength32(u)) * nonzero[:, None]
    emax = torch.where(nonzero, e + _EMAX_BIAS, 0).to(torch.uint8)
    return i64_to_u32(u), emax, gtops.to(torch.int32)


def _schedule_offsets(gtops: torch.Tensor) -> torch.Tensor:
    """Exclusive bit offsets of every (plane, group) stream item, int64[n,
    320]: plane 31 -> 0 major, group 0 -> 9 minor; item (p, g) present iff
    p < gtops[:, g], contributing GROUP_SIZES[g] bits.  The reference form
    of the schedule; the coder uses the factored per-plane form."""
    gtops = gtops.to(torch.int64)
    n = gtops.shape[0]
    planes = torch.arange(31, -1, -1, dtype=torch.int64, device=gtops.device)
    present = planes[None, :, None] < gtops[:, None, :]  # (n, 32, 10)
    sizes = torch.as_tensor(GROUP_SIZES, dtype=torch.int64, device=gtops.device)
    contrib = torch.where(present, sizes[None, None, :], 0).reshape(n, 32 * N_GROUPS)
    return torch.cumsum(contrib, dim=1) - contrib


# --------------------------- plane-parallel word-level embedded coder -----
#
# Stream items are (plane, group) bit runs, plane 31 -> 0 major, group 0 -> 9
# minor.  Plane j (stream-major, encoding bit plane p = 31 - j) owns a
# payload of ``pw[j] = sum_g w[j, g] <= 64`` bits, with group g's run at
# within-plane offset ``woff[j, g]``.  Every quantity is a pure function of
# the gtops header, so encoder and decoder derive identical layouts.


def _plane_offsets(gtops: torch.Tensor, budget: int):
    """Closed-form plane placement: group g is present in stream-major plane
    j iff ``gtops[g] + j - 32 >= 0`` and occupies ``max(0, gtops[g] + j -
    32)`` earlier planes.  Returns ``OFF`` (global exclusive bit offset of
    plane j's payload) and ``keep`` (its bits surviving the ``budget``),
    both int64[n, 32]."""
    gtops = gtops.to(torch.int64)
    j = torch.arange(32, dtype=torch.int64, device=gtops.device)[None, :]
    off = torch.zeros_like(j)
    pw = torch.zeros_like(j)
    for g in range(N_GROUPS):
        t = gtops[:, g][:, None] + j - 32  # (n, 32)
        sz = int(GROUP_SIZES[g])
        off = off + sz * torch.clamp(t, min=0)
        pw = pw + sz * (t >= 0).to(torch.int64)
    keep = torch.minimum(torch.clamp(budget - off, min=0), pw)
    return off, keep


def _mask64(keep: torch.Tensor):
    """(lo, hi) masks (int64) keeping the low ``keep`` bits of a 64-bit field."""
    return (_code_mask(torch.clamp(keep, max=32)),
            _code_mask(torch.clamp(keep - 32, 0, 32)))


def _bit_transpose32(a: torch.Tensor) -> torch.Tensor:
    """32x32 bit-matrix transpose (Hacker's Delight 7-3) of int64[n, 32]
    row words: ``b[:, c] bit k == a[:, 31 - k] bit (31 - c)`` (the
    algorithm's anti-diagonal orientation; callers flip rows)."""
    n = a.shape[0]
    m = 0x0000FFFF
    j = 16
    while j:
        r = a.reshape(n, 32 // (2 * j), 2, j)
        lo, hi = r[:, :, 0, :], r[:, :, 1, :]
        t = (lo ^ (hi >> j)) & m
        lo = lo ^ t
        hi = hi ^ ((t << j) & MASK32)
        a = torch.stack([lo, hi], dim=2).reshape(n, 32)
        j >>= 1
        if j:
            m = (m ^ (m << j)) & MASK32
    return a


def _plane_words(u: torch.Tensor):
    """Sequency coefficients [n, 64] -> (W0, W1) int64[n, 32]: ``W0[:, j]
    bit c`` = bit plane ``31 - j`` of coefficient ``c``; W1 likewise for
    coefficients 32..63."""
    u = u32_to_i64(u)
    return _bit_transpose32(u[:, :32].flip(1)), _bit_transpose32(u[:, 32:].flip(1))


def _coef_words(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_plane_words` (the transpose is an involution)."""
    return torch.cat([_bit_transpose32(w0).flip(1), _bit_transpose32(w1).flip(1)], dim=1)


def _group_widths(gtops: torch.Tensor, g: int) -> torch.Tensor:
    """int64[n, 32]: bits group ``g`` contributes to each stream-major plane."""
    j = torch.arange(32, dtype=torch.int64, device=gtops.device)[None, :]
    present = gtops[:, g].to(torch.int64)[:, None] + j >= 32  # p = 31 - j < gtops[g]
    return torch.where(present, int(GROUP_SIZES[g]), 0)


def _plane_payloads(u: torch.Tensor, gtops: torch.Tensor):
    """Every plane's <= 64-bit compacted payload, (plo, phi) int64[n, 32]:
    group runs sliced from the plane bit-matrix at static offsets and placed
    at the header-derived within-plane offsets.  A bit set at plane p implies
    the group is present, so absent groups add zero runs unmasked."""
    w0, w1 = _plane_words(u)
    plo = torch.zeros_like(w0)
    phi = torch.zeros_like(w0)
    woff = torch.zeros_like(w0)
    for g in range(N_GROUPS):
        src = w0 if _FIXED_START[g] < 32 else w1
        run = (src >> (_FIXED_START[g] & 31)) & ((1 << int(GROUP_SIZES[g])) - 1)
        o1 = woff & 31
        in_hi = woff >= 32
        lo_c = (run << o1) & MASK32
        hi_c = (run >> 1) >> (31 - o1)  # run >> (32 - o1); 0 at o1 == 0
        plo = plo | torch.where(in_hi, 0, lo_c)
        phi = phi | torch.where(in_hi, lo_c, hi_c)
        woff = woff + _group_widths(gtops, g)
    return plo, phi


def _encode_words_impl(u: torch.Tensor, gtops: torch.Tensor, rate: int) -> torch.Tensor:
    """Embedded encode: (u [n, 64], gtops [n, 10]) -> uint32[n, wpb].  Each
    plane's payload touches at most 3 of its block's words; bit positions
    are disjoint across planes, so adding the pieces equals OR-ing them."""
    budget = rate * 64 - _HEADER_BITS
    wpb = (budget + 31) // 32
    OFF, keep = _plane_offsets(gtops, budget)
    plo, phi = _plane_payloads(u, gtops)
    mlo, mhi = _mask64(keep)
    plo = plo & mlo
    phi = phi & mhi
    sh = OFF & 31
    w0 = OFF >> 5  # first word the plane payload touches
    c0 = (plo << sh) & MASK32
    c1 = ((plo >> 1) >> (31 - sh)) | ((phi << sh) & MASK32)
    c2 = (phi >> 1) >> (31 - sh)
    # A payload with kept bits ends inside the budget, so pieces aimed past
    # word wpb - 1 are zero: clamped into two spare columns and dropped.
    rows = torch.zeros(u.shape[0], wpb + 2, dtype=torch.int64, device=u.device)
    for k, c in enumerate((c0, c1, c2)):
        rows.scatter_add_(1, torch.clamp(w0 + k, max=wpb + 1), c)
    return i64_to_u32(rows[:, :wpb])


encode_words = _encode_words_impl


def _extract_coeffs(g0, g1, g2, OFF, keep, gtops) -> torch.Tensor:
    """Shared decode tail: the 3 fetched words per plane (int64[n, 32]) ->
    sequency-order coefficients int64[n, 64]."""
    sh = OFF & 31
    plo = (g0 >> sh) | (((g1 << 1) << (31 - sh)) & MASK32)
    phi = (g1 >> sh) | (((g2 << 1) << (31 - sh)) & MASK32)
    mlo, mhi = _mask64(keep)
    plo = plo & mlo
    phi = phi & mhi
    w0m = torch.zeros_like(plo)
    w1m = torch.zeros_like(plo)
    woff = torch.zeros_like(plo)
    for g in range(N_GROUPS):
        o1 = woff & 31
        in_hi = woff >= 32
        base_lo = torch.where(in_hi, phi, plo)
        base_hi = torch.where(in_hi, 0, phi)
        run = (base_lo >> o1) | (((base_hi << 1) << (31 - o1)) & MASK32)
        wg = _group_widths(gtops, g)
        run = run & _code_mask(wg)
        if _FIXED_START[g] < 32:
            w0m = w0m | ((run << _FIXED_START[g]) & MASK32)
        else:
            w1m = w1m | ((run << (_FIXED_START[g] - 32)) & MASK32)
        woff = woff + wg
    return _coef_words(w0m, w1m)


def decode_words(words: torch.Tensor, gtops: torch.Tensor, rate: int) -> torch.Tensor:
    """Inverse of :func:`encode_words`: stream -> int64[n, 64] sequency-order
    negabinary coefficients (exactly the bits the budget admitted).  Each
    plane's words come from three flat gathers clipped to the whole buffer,
    as in the reference (a plane may read the next block's words; they lie
    past ``keep`` and are masked off)."""
    budget = rate * 64 - _HEADER_BITS
    n, wpb = words.shape
    OFF, keep = _plane_offsets(gtops, budget)
    flat = u32_to_i64(words.reshape(-1))
    row0 = torch.arange(n, dtype=torch.int64, device=words.device)[:, None] * wpb
    lim = n * wpb - 1
    w0 = OFF >> 5
    g0, g1, g2 = (flat[torch.clamp(row0 + w0 + k, 0, lim)] for k in range(3))
    return _extract_coeffs(g0, g1, g2, OFF, keep, gtops)


def n_blocks_for(shape) -> int:
    """Number of 4^3 blocks :func:`_carve_blocks` produces for ``shape``."""
    nb = 1
    for s in shape:
        nb *= -(-s // BLOCK_SIDE)
    return nb


def payload_words(rate: int) -> int:
    """Stream words per block at ``rate`` bits/value (header inside budget)."""
    budget = rate * 64 - _HEADER_BITS
    if budget <= 0:
        raise ValueError(f"rate={rate} leaves no payload after the {_HEADER_BITS}-bit header")
    return (budget + 31) // 32


def _as_storage(a, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """An array or tensor -> a tensor of the storage dtype on ``device``."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int32) if a.dtype == torch.uint32 else a
        a = a.cpu().numpy()
    a = np.array(a).astype(dtype)
    if dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(a).to(device)


def from_words(words, emax, gtops, shape, rate: int,
               device: str | torch.device | None = None) -> ZFPCompressed:
    """Rebuild a :class:`ZFPCompressed` on ``device`` (CUDA unless
    ``"cpu"``, :func:`repro_torch.device.resolve_device`) from a flat word
    slice plus its header sidecars: fixed rate makes the slice bounds
    analytic (``n_blocks_for(shape) * payload_words(rate)`` words)."""
    device = resolve_device(device)
    wpb = payload_words(rate)
    return ZFPCompressed(_as_storage(words, np.uint32, device).reshape(-1, wpb),
                         _as_storage(emax, np.uint8, device),
                         _as_storage(gtops, np.uint8, device), tuple(shape), rate)


def compress(x: torch.Tensor, rate: int) -> ZFPCompressed:
    """Fixed-rate compress a 3-D float32 field at ``rate`` bits/value."""
    if x.ndim != 3:
        raise ValueError("TPU-ZFP operates on 3-D fields; reshape first (see api.py)")
    payload_words(rate)  # validates the rate
    u, emax, gtops = block_transform(x)
    words = encode_words(u, gtops, rate)
    return ZFPCompressed(words, emax, gtops.to(torch.uint8), tuple(x.shape), rate)


def _blocks_from_indexed(u_idx: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """Invert stages 1-3: index-order coefficients + emax -> f32 blocks."""
    n = u_idx.shape[0]
    ints = _inv_lift3d(inv_negabinary(u_idx).reshape(n, 4, 4, 4))
    e = emax.to(torch.int32) - _EMAX_BIAS
    scale = torch.where(emax.to(torch.int32) > 0, exact_exp2(e - Q), 0.0)
    return ints.to(torch.int32).to(torch.float32) * scale[:, None, None, None]


def _blocks_from_coeffs(u: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """Invert stages 1-4: sequency-order coefficients + emax -> f32 blocks."""
    return _blocks_from_indexed(u[:, _index(IPERM, u.device)], emax)


def blocks_from_stream(words, emax, gtops, rate: int) -> torch.Tensor:
    """Decode a stream to float32 blocks (n, 4, 4, 4)."""
    return _blocks_from_coeffs(decode_words(words, gtops, rate), emax)


def decompress(c: ZFPCompressed) -> torch.Tensor:
    blocks = blocks_from_stream(c.words, c.emax, c.gtops, c.rate)
    return _uncarve_blocks(blocks, c.shape)


def compressed_nbytes(c: ZFPCompressed) -> int:
    n_blocks = c.words.shape[0]
    return (n_blocks * c.rate * 64 + 7) // 8  # headers inside the budget


def compression_ratio(c: ZFPCompressed, n_values: int | None = None) -> float:
    """CR against the original value count (``n_values`` when the caller
    reshaped a 1-D/2-D field, so padding does not inflate the ratio)."""
    raw = 4.0 * (float(math.prod(c.shape)) if n_values is None else float(n_values))
    return raw / float(compressed_nbytes(c))
