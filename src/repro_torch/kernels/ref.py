"""Plain PyTorch oracles for the kernels (the port of ``repro.kernels.ref``).

Each mirrors its kernel's semantics, tile-blocked prediction included, with
padding and concatenation instead of the shared tile helpers, so the tests
cross-check two independent formulations.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import zfp as zfp_core
from repro_torch.core.bitpack import i64_to_u32, round_i32
from repro_torch.kernels.lorenzo3d import TILE, guarded_eb

_2P31 = 1 << 31

# sequency group of each coefficient in x-fastest index order
GROUP_OF_INDEX = np.asarray(
    [(c % 4) + ((c // 4) % 4) + (c // 16) for c in range(64)], np.int64)


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
    q = round_i32(x.to(torch.float32) * (1.0 / (2.0 * eb_i))).to(torch.int64)
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


def zfp3d_transform_ref(blocks: torch.Tensor):
    """(NB, 4, 4, 4) -> (u index-order uint32, emax int32, gtops int32) via
    :mod:`repro_torch.core.zfp`: ``frexp`` exponent and an index-order
    group map, against the kernel's exponent bits and iota groups."""
    b = blocks.to(torch.float32)
    maxabs = b.abs().amax(dim=(1, 2, 3))
    _, e = torch.frexp(maxabs)
    e = torch.clamp(e, -100, 127).to(torch.int32)
    nonzero = maxabs >= zfp_core._FLT_MIN
    scale = zfp_core.exact_exp2(zfp_core.Q - e)
    ints = round_i32(b * scale[:, None, None, None])
    u = zfp_core.negabinary(zfp_core._lift3d(ints).reshape(-1, 64))  # index order (no PERM)
    lens = zfp_core._bitlength32(u)
    groups = torch.as_tensor(GROUP_OF_INDEX, device=u.device).expand_as(lens)
    gtops = torch.zeros(u.shape[0], zfp_core.N_GROUPS, dtype=torch.int64, device=u.device)
    gtops = gtops.scatter_reduce(1, groups, lens, "amax")
    gtops = gtops * nonzero[:, None]
    emax = torch.where(nonzero, e + 128, 0)
    return i64_to_u32(u), emax, gtops.to(torch.int32)


def kvc_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, index, offset: int = 0,
                             lse: bool = False):
    """Dequantize-then-attend (the unfused two-pass baseline; the plain
    version of K10).  q: (B, H, D); codes (B, S, Hkv, D) int8 and scales
    (B, S, Hkv) f32 with Hkv dividing H: they are repeated H / Hkv times
    first, as the reference's caller does.  ``index``: () shared position
    or (B,) per-slot positions.  Row r holds global position ``offset + r``
    (a block of a cache whose sequence is split); with ``lse`` also
    returns each row's log-sum-exp of its scaled logits over the positions
    read, (B, H) float32, -inf where there are none."""
    n_rep = q.shape[1] // k_codes.shape[2]
    if n_rep > 1:
        k_codes, v_codes = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_codes, v_codes))
        k_scale, v_scale = (torch.repeat_interleave(t, n_rep, dim=2) for t in (k_scale, v_scale))
    k = k_codes.to(torch.float32) * k_scale[..., None]  # (B,S,H,D)
    v = v_codes.to(torch.float32) * v_scale[..., None]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhd,bshd->bhs", q.to(torch.float32), k) * scale
    s = k.shape[1]
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device).reshape(-1, 1, 1)
    mask = offset + torch.arange(s, device=q.device)[None, None, :] <= idx
    raw = logits
    logits = torch.where(mask, logits, -1e30)
    # fully-masked lanes (index -1 = free slot) output exactly 0 instead of
    # a uniform average over stale cache rows, as the kernel does
    p = torch.softmax(logits, dim=-1) * mask
    out = torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)
    if not lse:
        return out
    return out, torch.logsumexp(torch.where(mask, raw, -torch.inf), dim=-1)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(n_pages, page, ...) pool + (B, max_pages) table -> (B, max_pages *
    page, ...): the dense view the reference's ``cache_codes`` stitches (the
    model layer's gather too).  Unmapped entries point at the zero page."""
    b, max_pages = page_table.shape
    g = pool[page_table.to(torch.int64)]  # (B, max_pages, page, ...)
    return g.reshape((b, max_pages * pool.shape[1]) + tuple(pool.shape[2:]))


def kvc_decode_attention_paged_ref(q, k_pool, k_scale_pool, v_pool, v_scale_pool, page_table,
                                   index, offset: int = 0, lse: bool = False):
    """The plain version of K10's paged entry: the gather through the page
    table, then :func:`kvc_decode_attention_ref`."""
    return kvc_decode_attention_ref(q, *(gather_pages(p, page_table) for p in (
        k_pool, k_scale_pool, v_pool, v_scale_pool)), index, offset, lse)
