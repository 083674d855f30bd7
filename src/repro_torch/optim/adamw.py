"""AdamW with decoupled weight decay and global-norm clipping (the port of
``repro.optim.adamw``).

State is a tree matching params (``m``, ``v`` in float32, ``step`` an int32
scalar), on the parameters' device.  Where the reference returns new arrays
from a donated state, :func:`apply_updates` writes params, ``m`` and ``v``
in place and returns them, so a full-width state is never held twice.

Every division is by a float32 tensor, where the reference's ``jnp``
program divides (the clip scale, the bias corrections ``b1c`` / ``b2c``,
``mhat``, ``vhat``): PyTorch multiplies a CUDA tensor by the reciprocal of
a Python divisor, and ``scalar / tensor`` by the tensor's reciprocal, on
either device, so those forms would round otherwise than the reference
and give the card other bits than the CPU.

In the sharded train step the gradients are ``DTensor`` blocks (and
params, ``m``, ``v`` this rank's blocks): :func:`global_norm` is the norm of
the whole gradient tree, each element counted once however its leaf is
split or replicated, so every rank clips by the same scale, and the update
runs on the local blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.dist import sharding as shardlib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init_state(params: Any) -> dict:
    leaves, treedef = tree_util.tree_flatten(params)
    zeros = lambda: tree_util.tree_unflatten(  # noqa: E731
        treedef, [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves])
    device = leaves[0].device if leaves else None
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _split_axes(g) -> tuple:
    """The mesh axes of size > 1 that a ``DTensor`` splits (none for a
    plain tensor)."""
    if not shardlib.is_dtensor(g):
        return ()
    from torch.distributed.tensor import Shard

    mesh = g.device_mesh
    return tuple(a for i, (a, p) in enumerate(zip(mesh.mesh_dim_names, g.placements))
                 if isinstance(p, Shard) and mesh.size(i) > 1)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares over the whole tree.  A ``DTensor``
    leaf's block is summed on its rank, and the sums of the leaves split over
    the same mesh axes are added over those axes (an ``all_reduce``), so each
    element counts once; a replicated leaf counts once, on every rank."""
    from repro_torch.dist import collectives

    leaves = tree_util.tree_flatten(tree)[0]
    total = sum(torch.sum(torch.square(shardlib.local(g).to(torch.float32)))
                for g in leaves if not _split_axes(g))
    groups: dict = {}
    for g in leaves:
        axes = _split_axes(g)
        if axes:
            sq = torch.sum(torch.square(g.to_local().to(torch.float32)))
            mesh, acc = groups.get(axes, (g.device_mesh, None))
            groups[axes] = (mesh, sq if acc is None else acc + sq)
    for axes, (mesh, acc) in groups.items():
        for a in axes:
            acc = collectives.all_reduce_sum(acc, mesh.get_group(a))
        total = total + acc
    return torch.sqrt(total)


def _full(t: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=t.device)


def apply_updates(params: Any, opt_state: dict, grads: Any, lr: torch.Tensor,
                  cfg: AdamWConfig = AdamWConfig()) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_opt_state, metrics); params, ``m`` and ``v``
    are updated in place (the returned trees hold the same tensors), the
    step counter is a new tensor.  Leaves may be ``DTensor`` blocks: the
    norm is global (:func:`global_norm`), the update is their local
    tensors'."""
    gnorm = global_norm(grads)
    flat_g, _ = tree_util.tree_flatten(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.minimum(_full(gnorm, 1.0),
                              _full(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9))

    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_full(stepf, cfg.b1), stepf)
    b2c = 1.0 - torch.pow(_full(stepf, cfg.b2), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    def upd(p, g, m, v):
        # the reference's expressions, operation for operation (each product
        # and sum rounded on its own, no FMA), in place where the reference
        # builds a new array, so a leaf costs a few temporaries of its size
        if scale is not None:
            g = g * scale
        g = g.to(torch.float32)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)  # m_new = b1 * m + (1 - b1) * g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)  # v_new = b2 * v + (1 - b2) * g * g
        mhat = m / b1c
        denom = (v / b2c).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        delta = mhat.div_(denom).add_(cfg.weight_decay * p.to(torch.float32))
        del denom
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_((p.to(torch.float32) - delta.mul_(lr)).to(p.dtype))

    flat_p, treedef = tree_util.tree_flatten(params)
    flat_m = tree_util.tree_flatten(opt_state["m"])[0]
    flat_v = tree_util.tree_flatten(opt_state["v"])[0]
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            upd(*(shardlib.local(t) for t in (p, g, m, v)))
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, {"grad_norm": gnorm}
