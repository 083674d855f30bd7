"""The sharded train step's compute on ``torch.distributed``: the port's
counterpart of the reference's GSPMD partitioning of the step.

The step (``repro_torch.train.step``) holds every parameter as this rank's
block of the spec ``dist.sharding.spec_for`` gives it (FSDP over ``data``,
the ``mlp`` / ``heads`` / ``vocab`` / ``experts`` axes over ``model``).  It
hands the model those blocks, each tagged with its spec and logical axes
(:func:`tag`), and computes the loss inside :func:`use`, which makes the
model's sharding hooks live:

* **Gather where used.**  :func:`gather_outer` (called at the top of a
  model's ``forward``) all-gathers the leaves that are not stacked per
  layer; :func:`remat` runs a layer under ``torch.utils.checkpoint`` and
  all-gathers that layer's slices (:func:`unbind`) *inside* it, so only
  one layer's whole weights are live at a time and the backward pass
  gathers them again.  A gather's backward is the adjoint: a reduce-scatter
  over the axes it gathered and an all-reduce over the batch axes the leaf
  is replicated on, so each rank ends with its block's gradient summed over
  its pod.
* **Expert parallelism.**  A leaf whose leading logical axis is
  ``experts`` keeps that dimension local, and the gathered stack carries
  the axis that splits it: the MoE layer runs this rank's experts on its
  share of the dispatch buffer (:func:`own_experts`) and gathers their
  outputs (:func:`all_experts`).
* **Rows.**  Each rank computes its own rows of each microbatch (pod-major,
  then ``data``, then ``model``, as ``train.step`` splits them).  The MoE routing sees every row of
  the microbatch, as the reference's does: :func:`all_rows` gathers them
  and :func:`own_rows` keeps this rank's again.

Every rank differentiates its own rows' loss; the collectives' backward
passes are their adjoints (all-gather <-> reduce-scatter, all-reduce <->
all-reduce), so the sum of the ranks' gradients is the gradient of the sum
of their losses, and the step divides by the number of ranks in a pod.

Without :func:`use` (serving, one process) every hook is the identity.  A
``gloo`` group moves CPU tensors, so CUDA tensors cross it through host
copies (ranks sharing one card); ``nccl`` moves them on the card.  Each
rank's bytes are counted in :data:`sent_bytes`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import insitu
from repro_torch.dist import sharding as shardlib

_ACTIVE: Optional["Context"] = None
# Bytes this process has sent by the step's parameter and row collectives
# since the last reset (the gradient hop and the loss mean count in
# ``dist.insitu.sent_bytes``); the autograd engine's thread adds too.
sent_bytes = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
_SENT_LOCK = threading.Lock()
SUM_AXES = ("data", "model")  # a pod's ranks: the axes a gradient sums over


@dataclasses.dataclass
class _Leaf:
    """A parameter block's spec (one entry per dimension) and logical axes;
    ``root`` is the stacked leaf a per-layer slice came from."""

    spec: tuple
    axes: tuple
    root: Optional["_Leaf"] = None
    used: bool = False


def _count(kind: str, t: torch.Tensor) -> None:
    with _SENT_LOCK:
        sent_bytes[kind] += t.numel() * t.element_size()


def reset_sent_bytes() -> None:
    with _SENT_LOCK:
        for k in sent_bytes:
            sent_bytes[k] = 0


def tag(t: torch.Tensor, spec: tuple, axes: tuple) -> torch.Tensor:
    """Mark ``t`` (this rank's block of a parameter) with its spec and
    logical axes; returns ``t``."""
    spec = tuple(spec) + (None,) * (t.ndim - len(spec))
    for ent in spec:
        if ent is not None and not isinstance(ent, str):
            raise ValueError(f"spec {spec}: a parameter dimension splits over one mesh axis")
    t._spmd = _Leaf(spec, tuple(axes))
    return t


def _info(t) -> Optional[_Leaf]:
    return getattr(t, "_spmd", None)


def unused(leaves) -> list[int]:
    """Indices of tagged ``leaves`` that no gather reached."""
    return [i for i, t in enumerate(leaves) if _info(t) is not None and not _info(t).used]


class Context:
    """A mesh's collectives for one microbatch: ``row_axes`` are the mesh
    axes that split the microbatch's rows (outer first), ``rows`` this
    rank's row count."""

    def __init__(self, mesh, row_axes: tuple = (), rows: int = 0):
        self.mesh = mesh
        self.sizes = shardlib.mesh_sizes(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.row_axes = tuple(a for a in row_axes if self.sizes.get(a, 1) > 1)
        self.rows = rows
        self.sum_axes = tuple(a for a in SUM_AXES if self.sizes.get(a, 1) > 1)

    # ------------------------------------------------------ collectives --
    def _wire(self, axis: str, t: torch.Tensor):
        group = self.mesh.get_group(axis)
        host = insitu.via_host(group, t)
        return group, host, (t.detach().contiguous().cpu() if host else t.detach().contiguous())

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` on mesh ``axis``, concatenated on ``dim`` in
        rank order."""
        group, host, wire = self._wire(axis, t)
        parts = [torch.empty_like(wire) for _ in range(self.sizes[axis])]
        _count("all_gather", wire)
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts, dim)
        return out.to(t.device) if host else out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum over mesh ``axis`` of ``t``, this rank's chunk of ``dim``."""
        group, host, wire = self._wire(axis, t)
        parts = [c.contiguous() for c in wire.chunk(self.sizes[axis], dim)]
        out = torch.empty_like(parts[0])
        _count("reduce_scatter", wire)
        dist.reduce_scatter(out, parts, group=group)
        return out.to(t.device) if host else out

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over mesh ``axis`` of ``t`` (a new tensor)."""
        group, host, wire = self._wire(axis, t)
        buf = wire if host else wire.clone()
        _count("all_reduce", buf)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf.to(t.device) if host else buf

    # ------------------------------------------------------------ rows --
    def rows_index(self) -> int:
        """This rank's block among the microbatch's row blocks (outer axis
        first)."""
        i = 0
        for a in self.row_axes:
            i = i * self.sizes[a] + self.coord[a]
        return i

    def n_row_blocks(self) -> int:
        return math.prod(self.sizes[a] for a in self.row_axes)


class _Gather(torch.autograd.Function):
    """All-gather a block over ``gathers`` ((axis, dim) pairs, in order);
    backward: reduce-scatter over them in reverse, then all-reduce over
    ``sums``."""

    @staticmethod
    def forward(fctx, local, ctx, gathers, sums):
        fctx.ctx, fctx.gathers, fctx.sums = ctx, gathers, sums
        out = local
        for axis, dim in gathers:
            out = ctx.all_gather(out, axis, dim)
        return out if gathers else out.view_as(out)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        for axis, dim in reversed(fctx.gathers):
            g = ctx.reduce_scatter(g, axis, dim)
        for axis in fctx.sums:
            g = ctx.all_reduce(g, axis)
        return g, None, None, None


def active() -> Optional[Context]:
    return _ACTIVE


@contextlib.contextmanager
def use(ctx: Context) -> Iterator[Context]:
    """Make ``ctx`` the sharding of the model calls inside."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ctx
    try:
        yield ctx
    finally:
        _ACTIVE = prev


def _gather_leaf(ctx: Context, t: torch.Tensor) -> torch.Tensor:
    info = _info(t)
    if info is None:
        return t
    (info.root or info).used = True
    gathers, held = [], set()
    for dim, (ent, name) in enumerate(zip(info.spec, info.axes)):
        if ent is None or ctx.sizes.get(ent, 1) == 1:
            continue
        held.add(ent)
        if not (dim == 0 and name == "experts"):  # expert parallelism keeps its experts
            gathers.append((ent, dim))
    sums = tuple(a for a in ctx.sum_axes if a not in held)
    out = _Gather.apply(t, ctx, tuple(gathers), sums) if gathers or sums else t
    if info.axes[:1] == ("experts",) and info.spec[0] is not None \
            and ctx.sizes.get(info.spec[0], 1) > 1:
        out._experts_axis = info.spec[0]  # the expert stack stays split here
    return out


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def gather(tree: Any, ctx: Optional[Context] = None) -> Any:
    """Every tagged tensor of ``tree`` whole (experts kept local); the
    identity outside :func:`use`."""
    ctx = ctx or _ACTIVE
    if ctx is None:
        return tree
    return _map(functools.partial(_gather_leaf, ctx), tree)


def gather_outer(params: Any) -> Any:
    """:func:`gather` of the leaves that are not stacked per layer (their
    leading logical axis is not ``layers``); stacked leaves pass through,
    to be gathered a layer at a time inside :func:`remat`."""
    ctx = _ACTIVE
    if ctx is None:
        return params

    def one(t):
        info = _info(t)
        if info is not None and info.axes[:1] == ("layers",):
            return t
        return _gather_leaf(ctx, t)

    return _map(one, params)


def unbind(t: torch.Tensor) -> list:
    """``t.unbind(0)``; a tagged stacked leaf's slices carry its spec and
    axes without the leading ``layers`` dimension (which never splits)."""
    parts = list(t.unbind(0))
    info = _info(t)
    if info is not None:
        if info.spec[0] is not None:
            raise ValueError(f"a stacked leaf splits its layers dimension: {info.spec}")
        for p in parts:
            p._spmd = _Leaf(info.spec[1:], info.axes[1:], root=info.root or info)
    return parts


def _gathered_call(ctx, fn, lp, *args):
    return fn(gather(lp, ctx), *args)


def remat(fn, lp: Any, *args):
    """``fn(lp, *args)`` under ``torch.utils.checkpoint`` (non-reentrant),
    with ``lp`` (one layer's parameters) gathered inside it, so the gathered
    weights are dropped after the forward and gathered again when the
    backward pass recomputes the layer."""
    ctx = _ACTIVE
    if ctx is None:
        return checkpoint(fn, lp, *args, use_reentrant=False)
    return checkpoint(functools.partial(_gathered_call, ctx, fn), lp, *args,
                      use_reentrant=False)


def all_rows(x: torch.Tensor) -> torch.Tensor:
    """Every row block of the microbatch (dim 0), outer axis first: what the
    MoE routing sees.  The identity outside :func:`use` or when one rank
    holds every row."""
    ctx = _ACTIVE
    if ctx is None or not ctx.row_axes:
        return x
    return _Gather.apply(x, ctx, tuple((a, 0) for a in reversed(ctx.row_axes)), ())


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``x``: ``x`` itself when it holds this rank's
    rows, its block when it holds every row of the microbatch
    (:func:`all_rows`); any other row count raises."""
    ctx = _ACTIVE
    if ctx is None:
        return x
    n = ctx.n_row_blocks()
    if x.shape[0] == ctx.rows:
        return x
    if n > 1 and x.shape[0] == ctx.rows * n:
        return x.narrow(0, ctx.rows_index() * ctx.rows, ctx.rows)
    raise ValueError(f"activation of {x.shape[0]} rows: this rank holds {ctx.rows} of the "
                     f"microbatch's {ctx.rows * n}")


def experts_axis(w: torch.Tensor) -> Optional[str]:
    """The mesh axis that splits the expert stack ``w`` (dim 0: experts)
    as :func:`gather` left it, from the leaf's tagged spec; ``None`` when
    ``w`` holds every expert."""
    return getattr(w, "_experts_axis", None) if _ACTIVE is not None else None


def own_experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """This rank's experts of ``x`` (dim 0 is the expert axis): the block
    that the expert stack ``w`` holds on its axis; ``x`` when ``w`` holds
    every expert."""
    axis = experts_axis(w)
    if axis is None:
        return x
    k = w.shape[0]
    return x.narrow(0, _ACTIVE.coord[axis] * k, k)


def all_experts(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`own_experts`: every rank's experts of ``y``
    gathered over ``w``'s expert axis (backward: a reduce-scatter)."""
    axis = experts_axis(w)
    if axis is None:
        return y
    return _Gather.apply(y, _ACTIVE, ((axis, 0),), ())
