"""K5: the fused TPU-ZFP block stage (the port of ``repro.kernels.zfp3d``):
block-floating-point alignment + exact integer lifting + negabinary + the
per-group top bit planes (stages 1-3 + header).

* The block exponent comes from the IEEE bits of ``|x|max`` (``(bits >>
  23) & 0xff``), not ``frexp``; after the clip to [-100, 127] the two agree.
* ``2^(Q - e)`` is built directly in exponent bits (exact, no ``exp2``).
* Group significance: the group of index-order column ``c`` is ``(c & 3) +
  ((c >> 2) & 3) + (c >> 4)``.

This kernel backs the ``xla`` ZFP path of :mod:`repro_torch.kernels.ops`:
the embedded coder runs outside, in :func:`repro_torch.core.zfp.encode_words`.
The ``fused`` path (:mod:`repro_torch.kernels.zfp_fused`) runs the same
stages and the coder in one kernel.  :func:`block_float_negabinary` is the
one plain formulation of the stages both plain versions share, as the CUDA
kernels share ``csrc/zfp_block.cuh``: the cross-path byte identity hangs on
the stages never diverging.

On a CUDA tensor :func:`zfp3d_transform` launches the kernel in
``csrc/zfp3d.cu`` (or raises); on a CPU tensor it runs the plain version.
The kernels take any block count: a CTA holds 64 blocks (one thread each,
``csrc/zfp_block.cuh``) and threads past the last block only help move the
CTA's tile, so callers do not pad (the JAX package pads the count to a
multiple of its 256-block VMEM tile).
``launches`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.core import zfp as zfp_core
from repro_torch.core.bitpack import i64_to_u32, round_i32
from repro_torch.kernels import _build

Q = zfp_core.Q

launches = {"zfp3d_transform": 0}


def block_float_negabinary(blocks: torch.Tensor):
    """Stages 1-3 on (T, 4, 4, 4) f32 blocks -> (u index-order int64[T, 64]
    holding 32-bit values, e int32[T], nonzero bool[T]).  A block is nonzero
    iff its ``|x|max`` is a normal float (see :mod:`repro_torch.core.zfp`)."""
    b = blocks.to(torch.float32)
    maxabs = b.abs().amax(dim=(1, 2, 3))
    e_biased = (maxabs.view(torch.int32) >> 23) & 0xFF
    e = torch.clamp(e_biased - 126, -100, 127)  # frexp convention: maxabs < 2^e
    nonzero = maxabs >= zfp_core._FLT_MIN
    scale = ((Q - e + 127) << 23).view(torch.float32)  # 2^(Q - e), exact
    ints = round_i32(b * scale[:, None, None, None])
    u = zfp_core.negabinary(zfp_core._lift3d(ints).reshape(-1, 64))
    return u, e, nonzero


def _check_blocks(blocks: torch.Tensor, what: str) -> int:
    if blocks.ndim != 4 or tuple(blocks.shape[1:]) != (4, 4, 4):
        raise ValueError(f"{what}: want (NB, 4, 4, 4) blocks, got {tuple(blocks.shape)}")
    _build.check_cuda(blocks, torch.float32, what)
    return blocks.shape[0]


def zfp3d_transform_plain(blocks: torch.Tensor):
    """Plain version of K5: (NB, 4, 4, 4) f32 -> (u uint32[NB, 64] index
    order, emax uint8[NB], gtops uint8[NB, 10])."""
    u, e, nonzero = block_float_negabinary(blocks)
    lens = zfp_core._bitlength32(u)
    col = torch.arange(64, device=u.device)
    deg = (col & 3) + ((col >> 2) & 3) + (col >> 4)  # sequency group of index-order column
    gtops = torch.stack([torch.where(deg == g, lens, 0).amax(dim=1)
                         for g in range(zfp_core.N_GROUPS)], dim=1) * nonzero[:, None]
    emax = torch.where(nonzero, e + zfp_core._EMAX_BIAS, 0)
    return i64_to_u32(u), emax.to(torch.uint8), gtops.to(torch.uint8)


def zfp3d_transform(blocks: torch.Tensor):
    """(NB, 4, 4, 4) f32 -> (u uint32[NB, 64] negabinary coefficients in
    index order, emax uint8[NB], gtops uint8[NB, 10]); any NB."""
    if blocks.device.type == "cpu":
        return zfp3d_transform_plain(blocks)
    nb = _check_blocks(blocks, "zfp3d_transform blocks")
    u = torch.empty(nb, 64, dtype=torch.int32, device=blocks.device)
    emax = torch.empty(nb, dtype=torch.uint8, device=blocks.device)
    gtops = torch.empty(nb, zfp_core.N_GROUPS, dtype=torch.uint8, device=blocks.device)
    P, L = _build.P, _build.L
    _build.launch("zfp3d", "zfp3d_transform", [P, P, P, P, L],
                  blocks.data_ptr(), u.data_ptr(), emax.data_ptr(), gtops.data_ptr(), nb,
                  device=blocks.device)
    launches["zfp3d_transform"] += 1
    return u.view(torch.uint32), emax, gtops
