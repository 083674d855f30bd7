"""Compressed cross-pod collectives: the block-wise quantized gradient mean
(the port of ``repro.dist.collectives``) on ``torch.distributed``.

The inter-pod link is the slowest data-movement path of a training run —
where the paper's argument that lossy compression pays wherever data
movement dominates bites hardest.  The cross-pod gradient mean replaces the
f32 all-reduce (two f32 phases, ~8 B/param on the wire) with:

    1. carry   = grad + error_feedback          (f32, local)
    2. codes   = blockwise int8/int4 quantize   (scale = blockmax / qmax)
    3. wire    = all_gather(codes + scales)     (bits/8 B/param + scales)
    4. mean    = mean_p dequantize(codes_p)     (f32, local)
    5. ef'     = carry - dequantize(codes_own)  (the error feedback's dtype)

Error feedback makes the quantizer unbiased over time: each step's residual
is re-added on the next, so the running sum of emitted means telescopes to
the true gradient sum plus one bounded residual.  With ``enabled=False`` the
hop is a plain mean (``all_reduce`` SUM, then a divide), and ``ef`` passes
through untouched.

One process per rank: every rank of the mesh's ``pod`` group calls these
with its own pod's gradients, and the exchange is one ``all_gather`` of the
int8 codes (bits 8) or the nibble-packed uint8 codes (bits 4) plus one of
the f32 block scales — never of f32 gradients.  :data:`repro_torch.dist.
insitu.sent_bytes` counts each rank's codes and scales under
``"all_gather"``.  A ``gloo`` group sends CPU tensors, so CUDA codes and
scales cross through host copies there (two ranks sharing one card);
``nccl`` gathers them on the card.

Two forms of the same wire format, as in the reference:

* :func:`compressed_pod_mean` — each rank holds its pod's gradient tree;
* :func:`compressed_pod_mean_stacked` — the per-pod gradients are one
  ``DTensor`` per leaf, ``(n_pods, *shape)`` sharded on dim 0 over ``pod``
  (the reference's GSPMD formulation, whose reshard is one s8 all-gather).

The quantizer is plain PyTorch, as the reference's is ``jnp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.dist import insitu
from repro_torch.dist import sharding as shardlib

_F32_BYTES = 4.0
_SCALE_BYTES = 4.0  # one f32 scale per block


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    """Cross-pod gradient wire format.

    bits: code width (8 -> int8 lanes, 4 -> two codes packed per byte).
    block: quantization granularity; one f32 absmax scale per block.
    error_feedback: thread the quantization residual as state.
    """

    enabled: bool = False
    bits: int = 8
    block: int = 1024
    error_feedback: bool = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.block <= 0 or self.block % 2:
            raise ValueError(f"block must be positive and even, got {self.block}")


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)  # 127 (int8) / 7 (int4)


def _quantize_blockwise(g: torch.Tensor, bits: int = 8,
                        block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten, pad to a block multiple, and quantize per block.

    Returns ``(codes, scale)``: int8 codes in [-qmax, qmax] of padded flat
    length, and one f32 scale per block (``blockmax / qmax``; zero blocks
    get scale 0 and all-zero codes).  Every operation rounds as the
    reference's float32 ``jnp`` program reads (round half to even, true
    divisions: a CUDA tensor divided by a Python number is multiplied by
    its reciprocal, so the divisors here are tensors)."""
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    qmax = _qmax(bits)
    amax = fp.abs().amax(dim=1)
    scale = amax / torch.full_like(amax, qmax)
    safe = torch.where(scale > 0, scale, 1.0)
    inv = torch.where(scale > 0, torch.ones_like(scale) / safe, 0.0)  # a true divide
    codes = torch.clamp(torch.round(fp * inv[:, None]), -qmax, qmax).to(torch.int8)
    return codes.reshape(-1), scale


def _dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, n: int,
                          block: int = 1024) -> torch.Tensor:
    """Inverse of :func:`_quantize_blockwise`; trailing padding dropped."""
    c = codes.to(torch.float32).reshape(-1, block) * scale[:, None]
    return c.reshape(-1)[:n]


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Two int4 codes per wire byte (block is even, so pairs never straddle
    a block boundary)."""
    u = (codes.view(torch.uint8) & 0xF).reshape(-1, 2)
    return u[:, 0] | (u[:, 1] << 4)


def _unpack_nibbles(wire: torch.Tensor) -> torch.Tensor:
    lo = wire & 0xF
    hi = (wire >> 4) & 0xF
    both = torch.stack([lo, hi], dim=-1).reshape(*wire.shape[:-1], -1)
    # sign-extend 4 -> 8 bits
    return (both ^ 0x8).to(torch.int8) - 8


def wire_bytes_per_param(cfg: GradCompressionConfig) -> float:
    """Wire bytes per gradient element *per crossing* (format-level).

    Uncompressed: an all-reduce pays two f32 phases (reduce-scatter then
    all-gather), ~``2 * 4`` B/param.  Compressed: a code crosses as
    ``bits/8`` B plus one f32 scale per block.  Pod-count independent; the
    gather's aggregate per-device traffic grows with the pod count
    (:func:`pod_hop_device_bytes`)."""
    if not cfg.enabled:
        return 2 * _F32_BYTES
    return cfg.bits / 8.0 + _SCALE_BYTES / cfg.block


def pod_hop_device_bytes(cfg: GradCompressionConfig, n_params: int,
                         n_pods: int = 2) -> int:
    """Aggregate per-device bytes for one gradient exchange at ``n_pods``
    pods: ``(n_pods - 1) * (bits/8 + 4/block)`` B/param received by the
    gather, against ``2 (n_pods - 1) / n_pods * 4`` for the f32 all-reduce."""
    if n_pods <= 1:
        return 0
    if not cfg.enabled:
        return int(2 * (n_pods - 1) / n_pods * _F32_BYTES * n_params)
    per = (n_pods - 1) * (cfg.bits / 8.0 + _SCALE_BYTES / cfg.block)
    return int(per * n_params)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in group rank order, this
    rank's bytes counted as sent."""
    n = dist.get_world_size(group)
    insitu.count_sent("all_gather", t.numel() * t.element_size())
    host = insitu.via_host(group, t)
    wire = t.contiguous().cpu() if host else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts)
    return out.to(t.device) if host else out


def _pod_group(mesh, axis_name: str):
    if mesh is None:
        return None
    return mesh.get_group(axis_name)


def _gather_codes(codes: torch.Tensor, scale: torch.Tensor, cfg: GradCompressionConfig,
                  group) -> tuple[torch.Tensor, torch.Tensor]:
    """Every pod's codes (unpacked to int8) and scales: the one hop."""
    wire = _pack_nibbles(codes) if cfg.bits == 4 else codes
    if group is None:  # one pod: the gather is the identity
        all_wire, all_scale = wire[None], scale[None]
    else:
        all_wire, all_scale = _all_gather(wire, group), _all_gather(scale, group)
    return (_unpack_nibbles(all_wire) if cfg.bits == 4 else all_wire), all_scale


def _mean_of(all_codes: torch.Tensor, all_scale: torch.Tensor, n: int,
             cfg: GradCompressionConfig) -> torch.Tensor:
    n_pods = all_codes.shape[0]
    deq = (all_codes.to(torch.float32).reshape(n_pods, -1, cfg.block)
           * all_scale[:, :, None])
    total = deq.reshape(n_pods, -1)[:, :n].sum(dim=0)
    return total / torch.full_like(total, n_pods)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; through the host on
    ``gloo``), this rank's bytes counted under ``"all_reduce"``."""
    host = insitu.via_host(group, t)
    buf = t.detach().cpu().clone() if host else t.detach().clone()
    insitu.count_sent("all_reduce", buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if host else buf


def _plain_mean(g: torch.Tensor, group, n_pods: int) -> torch.Tensor:
    """The uncompressed hop: ``all_reduce`` SUM in ``g``'s dtype, then a
    divide (the reference's ``pmean``, ``psum(g) / n``)."""
    if group is None:
        return g / torch.full_like(g, n_pods)
    total = all_reduce_sum(g, group)
    return total / torch.full_like(total, n_pods)


def _tree_pairs(grads: Any, ef: Optional[Any]):
    flat_g, treedef = tree_util.tree_flatten(grads)
    flat_e = tree_util.tree_flatten(ef)[0] if ef is not None else [None] * len(flat_g)
    if len(flat_e) != len(flat_g):
        raise ValueError(f"error feedback has {len(flat_e)} leaves, gradients {len(flat_g)}")
    return flat_g, flat_e, treedef


def _unflatten(treedef, pairs, ef):
    mean_tree = tree_util.tree_unflatten(treedef, [p[0] for p in pairs])
    ef_tree = tree_util.tree_unflatten(treedef, [p[1] for p in pairs]) if ef is not None else None
    return mean_tree, ef_tree


def compressed_pod_mean(grads: Any, cfg: GradCompressionConfig,
                        ef: Optional[Any] = None, n_pods: Optional[int] = None,
                        axis_name: str = "pod", *, mesh=None) -> tuple[Any, Optional[Any]]:
    """Cross-pod gradient mean, optionally over the quantized wire format.

    A collective over ``mesh``'s ``axis_name`` group: each rank passes its
    pod's gradient tree (``ef`` the same tree, or ``None``); ``mesh=None``
    is one pod.  ``n_pods`` defaults to the group's size and must equal it.
    Returns ``(mean_grads, new_error_feedback)``; the second element is
    ``None`` exactly when ``ef`` is ``None``.  With ``cfg.enabled=False``
    this is a plain mean and ``ef`` passes through untouched."""
    group = _pod_group(mesh, axis_name)
    size = 1 if group is None else dist.get_world_size(group)
    if n_pods is not None and n_pods != size:
        raise ValueError(f"n_pods={n_pods}, but the {axis_name!r} group holds {size} ranks")
    if not cfg.enabled:
        flat_g, treedef = tree_util.tree_flatten(grads)
        return tree_util.tree_unflatten(treedef, [_plain_mean(g, group, size)
                                                  for g in flat_g]), ef

    def one(g, e):
        n = g.numel()
        flat = g.reshape(-1).to(torch.float32)
        if e is not None:
            flat = flat + e.reshape(-1).to(torch.float32)
        codes, scale = _quantize_blockwise(flat, cfg.bits, cfg.block)
        all_codes, all_scale = _gather_codes(codes, scale, cfg, group)
        out = _mean_of(all_codes, all_scale, n, cfg).reshape(g.shape).to(g.dtype)
        if e is None:
            return out, None
        own = _dequantize_blockwise(codes, scale, n, cfg.block)
        return out, (flat - own).reshape(g.shape).to(e.dtype)

    flat_g, flat_e, treedef = _tree_pairs(grads, ef)
    return _unflatten(treedef, [one(g, e) for g, e in zip(flat_g, flat_e)], ef)


def compressed_pod_mean_stacked(pod_grads: Any, cfg: GradCompressionConfig,
                                ef: Optional[Any] = None,
                                mesh=None, axis_name: str = "pod") -> tuple[Any, Optional[Any]]:
    """The stacked formulation of the compressed cross-pod mean.

    ``pod_grads`` leaves are per-pod gradients ``(n_pods, *shape)``: a
    ``DTensor`` sharded on dim 0 over ``mesh``'s ``axis_name`` (each rank
    holds its pod's row), or, with ``mesh=None``, a plain tensor holding
    every pod.  ``ef`` mirrors that layout.  Returns ``(mean_grads,
    new_ef)``: mean leaves drop the leading axis and are plain tensors on
    every rank; ``new_ef`` keeps the layout of ``ef``.  The hop is one
    gather of the int8 (or packed uint8) codes plus the f32 scales; with
    ``enabled=False`` it is the plain stacked mean."""
    group = _pod_group(mesh, axis_name)

    def local(t):
        return t.to_local() if shardlib.is_dtensor(t) else t

    def like(t, value):
        if not shardlib.is_dtensor(t):
            return value
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(value, t.device_mesh, t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    def one(g, e):
        rows = local(g)  # this rank's pods (all of them without a mesh)
        shape = tuple(g.shape[1:])
        n = 1
        for d in shape:
            n *= d
        n_pods = g.shape[0]
        if not cfg.enabled:
            # the stacked mean sums in float32, as jnp.mean does
            return _plain_mean(rows.to(torch.float32).sum(dim=0), group, n_pods).to(g.dtype), None
        flat = rows.reshape(rows.shape[0], -1).to(torch.float32)
        if e is not None:
            flat = flat + local(e).reshape(rows.shape[0], -1).to(torch.float32)
        qs = [_quantize_blockwise(r, cfg.bits, cfg.block) for r in flat]
        codes, scale = torch.stack([q[0] for q in qs]), torch.stack([q[1] for q in qs])
        new_e = None
        if e is not None:
            own = torch.stack([_dequantize_blockwise(c, s, n, cfg.block)
                               for c, s in zip(codes, scale)])
            new_e = like(e, (flat - own).reshape(rows.shape).to(e.dtype))
        if group is None:
            all_codes, all_scale = codes, scale
        else:
            if rows.shape[0] != 1:
                raise ValueError(f"each rank holds {rows.shape[0]} pods; the hop gathers one "
                                 "row per rank of the pod group")
            all_codes, all_scale = _gather_codes(codes[0], scale[0], cfg, group)
        return _mean_of(all_codes, all_scale, n, cfg).reshape(shape).to(g.dtype), new_e

    flat_g, flat_e, treedef = _tree_pairs(pod_grads, ef)
    return _unflatten(treedef, [one(g, e) for g, e in zip(flat_g, flat_e)], ef)
