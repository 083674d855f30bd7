"""The sharded train step's compute on ``torch.distributed``: the port's
counterpart of the reference's GSPMD partitioning of the step.

The step (``repro_torch.train.step``) holds every parameter as this rank's
block of the spec ``dist.sharding.spec_for`` gives it (FSDP over ``data``,
the ``mlp`` / ``heads`` / ``vocab`` / ``experts`` axes over ``model``).  It
hands the model those blocks, each tagged with its spec and logical axes
(:func:`tag`), and computes the loss inside :func:`use`, which makes the
model's sharding hooks live:

* **Gather where used.**  :func:`gather_outer` (called at the top of a
  model's ``forward``) gathers the leaves that are not stacked per layer;
  :func:`remat` runs a layer under ``torch.utils.checkpoint`` and gathers
  that layer's slices (:func:`unbind`) *inside* it, so only one layer's
  gathered weights are live at a time and the backward pass gathers them
  again.  A gather all-gathers over ``data`` (FSDP).  Every model
  computes on Megatron blocks over ``model``: a leaf keeps its ``model``
  block wherever its logical axis on that dimension is ``heads``,
  ``kv_heads``, ``mlp`` or ``vocab`` and its spec splits it there, and the
  layer that uses it takes it as a block (:func:`model_split`) between the
  two region operators, :func:`to_model` (identity forward, all-reduce
  over ``model`` backward) and :func:`from_model` (all-reduce over
  ``model`` forward, identity backward); a block no layer took as one
  makes the step raise (:func:`unused`).  A layer whose blocks cut a head
  (rwkv6's time mix at a ``model`` extent that does not divide its heads)
  gathers them whole (:func:`model_gather`) and computes every head on
  every rank.  Other leaves (norms, ``embed``-only vectors, heads that
  fall back to replication, the MoE router) are gathered whole.
* **Gradients.**  A gather's backward is its adjoint over the axes whose
  ranks computed distinct rows (a reduce-scatter, and an all-reduce over
  such axes the leaf is replicated on); over an axis whose ranks share
  their rows (``model``) every rank computed the same whole gradient, so
  it keeps its own block of it and sums nothing.  A replicated weight that
  ranks use in part (k and v heads replicated beside split q heads, the
  decay LoRA and token-shift mixes of rwkv6's time mix) enters the model
  region through :func:`to_model`, whose backward sums its parts.
* **Expert parallelism.**  A leaf whose leading logical axis is
  ``experts`` keeps that dimension local, and the gathered stack carries
  the axis that splits it: the MoE layer runs this rank's experts on its
  share of the dispatch buffer (:func:`own_experts`) and gathers their
  outputs (:func:`all_experts`).
* **Rows.**  Each rank computes the rows of each microbatch that the
  step's row axes give it (``Context.row_axes``, outer first): pod-major
  and ``data``, the axes of ``dist.sharding.batch_sharding``; the ranks
  along ``model`` share those rows (``train.step``).  The MoE routing sees every row of
  the microbatch, as the reference's does: :func:`all_rows` gathers them
  over the row axes and :func:`own_rows` keeps this rank's again.

Every rank differentiates its own rows' loss; the collectives' backward
passes are their adjoints, so the sum over the ranks that hold distinct
rows of their gradients is the gradient of the sum of their losses, and
the step divides by the number of such ranks in a pod.

The sharded serving step (``train.step.build_serve_step``) runs a
model's decode under :func:`use` too, without gradients: the parameters
are gathered as above, and a KV cache whose sequence the step split over a
mesh axis carries its block (:func:`tag_seq`, read back by
:func:`seq_block`); attention over such a cache combines the blocks'
partial softmaxes with :func:`reduce_over` (``models.layers``).

Without :func:`use` (serving on one card) every hook is the identity.  A
``gloo`` group moves CPU tensors, so CUDA tensors cross it through host
copies (ranks sharing one card); ``nccl`` moves them on the card.  Each
rank's bytes are counted by kind in :data:`sent_bytes` and by kind and
mesh axis in :data:`sent_by_axis`.
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
# ``dist.insitu.sent_bytes``), by kind and by kind and mesh axis; the
# autograd engine's thread adds too.
KINDS = ("all_gather", "reduce_scatter", "all_reduce")
sent_bytes = dict.fromkeys(KINDS, 0)
sent_by_axis: dict = {k: {} for k in KINDS}
_SENT_LOCK = threading.Lock()
SUM_AXES = ("data",)  # a pod's axes that split rows: a gradient sums over them
# logical axes whose ``model`` blocks a layer computes on (Megatron column
# and row blocks, a vocab-parallel table); ``experts`` keeps its blocks too
BLOCK_AXES = ("heads", "kv_heads", "mlp", "vocab")


@dataclasses.dataclass
class _Leaf:
    """A parameter block's spec (one entry per dimension) and logical axes;
    ``root`` is the stacked leaf a per-layer slice came from.  ``blocked``:
    a gather handed a layer its ``model`` block; ``claimed``: a layer took
    it as one (:func:`model_split`)."""

    spec: tuple
    axes: tuple
    root: Optional["_Leaf"] = None
    used: bool = False
    blocked: bool = False
    claimed: bool = False


@dataclasses.dataclass(frozen=True)
class Block:
    """A tensor that holds block ``index`` of ``count`` along ``model``
    (a parameter's, from a gather, or a layer's output); ``leaf`` is the
    parameter's record."""

    index: int
    count: int
    leaf: Optional[_Leaf] = None


def _count(kind: str, axis: str, t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    with _SENT_LOCK:
        sent_bytes[kind] += n
        sent_by_axis[kind][axis] = sent_by_axis[kind].get(axis, 0) + n


def reset_sent_bytes() -> None:
    with _SENT_LOCK:
        for k in KINDS:
            sent_bytes[k] = 0
            sent_by_axis[k] = {}


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
    """Indices of tagged ``leaves`` that no gather reached, or whose
    ``model`` block no layer took as a block (:func:`model_split`)."""
    return [i for i, t in enumerate(leaves) if _info(t) is not None
            and (not _info(t).used or (_info(t).blocked and not _info(t).claimed))]


class Context:
    """A mesh's collectives for one microbatch: ``row_axes`` are the mesh
    axes that split the microbatch's rows (outer first), ``rows`` this
    rank's row count.  ``model_blocks``: the mesh has a ``model`` axis of
    more than one rank, whose ranks compute on Megatron blocks and share
    their rows."""

    def __init__(self, mesh, row_axes: tuple = (), rows: int = 0):
        self.mesh = mesh
        self.sizes = shardlib.mesh_sizes(mesh)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.row_axes = tuple(a for a in row_axes if self.sizes.get(a, 1) > 1)
        self.rows = rows
        self.model_blocks = self.sizes.get("model", 1) > 1
        if self.model_blocks and "model" in self.row_axes:
            raise ValueError("ranks that compute on model blocks share their rows: 'model' is "
                             "not a row axis")
        self.sum_axes = tuple(a for a in SUM_AXES if a in self.row_axes)

    # ------------------------------------------------------ collectives --
    def _wire(self, axis: str, t: torch.Tensor):
        group = self.mesh.get_group(axis)
        host = insitu.via_host(group, t)
        return group, host, (t.detach().contiguous().cpu() if host else t.detach().contiguous())

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` on mesh ``axis``, concatenated on ``dim`` in
        rank order.  Through the host, the parts land on the device before
        they are joined, so the device holds what a device transport's
        parts and result take (the dry run's count of the same step)."""
        group, host, wire = self._wire(axis, t)
        parts = [torch.empty_like(wire) for _ in range(self.sizes[axis])]
        _count("all_gather", axis, wire)
        dist.all_gather(parts, wire, group=group)
        return torch.cat([p.to(t.device) for p in parts] if host else parts, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum over mesh ``axis`` of ``t``, this rank's chunk of ``dim``
        (the chunks made contiguous on ``t``'s device, as a device
        transport's are, before a host copy crosses)."""
        group = self.mesh.get_group(axis)
        host = insitu.via_host(group, t)
        parts = [c.contiguous() for c in t.detach().chunk(self.sizes[axis], dim)]
        if host:
            parts = [c.cpu() for c in parts]
        out = torch.empty_like(parts[0])
        _count("reduce_scatter", axis, t)
        dist.reduce_scatter(out, parts, group=group)
        return out.to(t.device) if host else out

    def all_reduce(self, t: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The sum (or ``op``) over mesh ``axis`` of ``t`` (a new tensor)."""
        group, host, wire = self._wire(axis, t)
        buf = wire if host else wire.clone()
        _count("all_reduce", axis, buf)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device) if host else buf

    def own_chunk(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's chunk of ``dim`` among the ranks of ``axis``."""
        k = t.shape[dim] // self.sizes[axis]
        return t.narrow(dim, self.coord[axis] * k, k)

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
    backward, in reverse: a reduce-scatter over an axis whose ranks computed
    distinct rows, this rank's chunk over one whose ranks share them (each
    computed the same whole gradient); then an all-reduce over ``sums``."""

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
            g = (ctx.reduce_scatter(g, axis, dim) if axis in ctx.row_axes
                 else ctx.own_chunk(g, axis, dim).contiguous())
        for axis in fctx.sums:
            g = ctx.all_reduce(g, axis)
        return g, None, None, None


class _ToModel(torch.autograd.Function):
    """Copy to the model region: the identity; backward, the sum over
    ``model`` of the ranks' partial gradients."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.all_reduce(g, "model"), None


class _FromModel(torch.autograd.Function):
    """Reduce from the model region: the sum over ``model`` of the ranks'
    partial results; backward, the identity (every rank holds the whole
    gradient of the sum)."""

    @staticmethod
    def forward(fctx, x, ctx):
        return ctx.all_reduce(x, "model")

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """This rank's chunk of ``dim`` over ``axis`` of a tensor every rank on
    the axis holds whole; backward, every rank's chunk gradient gathered
    (the whole tensor's gradient, on every rank)."""

    @staticmethod
    def forward(fctx, x, ctx, axis, dim):
        fctx.ctx, fctx.axis, fctx.dim = ctx, axis, dim
        return ctx.own_chunk(x, axis, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.all_gather(g, fctx.axis, fctx.dim), None, None, None


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
    root = info.root or info
    root.used = True
    gathers, held, block = [], set(), None
    for dim, (ent, name) in enumerate(zip(info.spec, info.axes)):
        if ent is None or ctx.sizes.get(ent, 1) == 1:
            continue
        held.add(ent)
        if dim == 0 and name == "experts":  # expert parallelism keeps its experts
            continue
        if ctx.model_blocks and ent == "model" and name in BLOCK_AXES:
            block = Block(ctx.coord["model"], ctx.sizes["model"], root)  # Megatron keeps its block
            continue
        gathers.append((ent, dim))
    sums = tuple(a for a in ctx.sum_axes if a not in held)
    out = _Gather.apply(t, ctx, tuple(gathers), sums) if gathers or sums else t
    if info.axes[:1] == ("experts",) and info.spec[0] is not None \
            and ctx.sizes.get(info.spec[0], 1) > 1:
        out._experts_axis = info.spec[0]  # the expert stack stays split here
    if block is not None:
        root.blocked = True
        out._model_block = block
    return out


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def gather(tree: Any, ctx: Optional[Context] = None) -> Any:
    """Every tagged tensor of ``tree`` gathered for use (experts and
    Megatron ``model`` blocks kept local); the identity outside
    :func:`use`."""
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
    axes without the leading ``layers`` dimension (which never splits), and
    a stacked cache leaf's slices its sequence block (:func:`tag_seq`)."""
    parts = list(t.unbind(0))
    seq = getattr(t, "_seq", None)
    if seq is not None:
        for p in parts:
            p._seq = seq
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


# ---------------------------------------------------- Megatron blocks --

def model_split(*ts) -> Optional[tuple[int, int]]:
    """``(index, count)`` of the ``model`` blocks that ``ts`` hold (the
    leaves of one parallel region, split alike), taking each leaf's block
    as a block for :func:`unused`; ``None`` when they are whole (outside
    :func:`use`, without ``model_blocks``, or a spec that fell back to
    replication).  Leaves that are split unlike each other raise."""
    ctx = _ACTIVE
    if ctx is None or not ctx.model_blocks:
        return None
    blocks = [getattr(t, "_model_block", None) for t in ts]
    if all(b is None for b in blocks):
        return None
    if any(b is None or (b.index, b.count) != (blocks[0].index, blocks[0].count)
           for b in blocks):
        raise ValueError(f"one region's leaves are split unlike each other on model: {blocks}")
    for b in blocks:
        if b.leaf is not None:
            b.leaf.claimed = True
    return blocks[0].index, blocks[0].count


def model_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A kept ``model`` block ``t`` (taken by :func:`model_split`) gathered
    whole along ``dim``, for a layer that computes the whole leaf on every
    ``model`` rank because its blocks cut a head: backward, this rank's
    chunk of the gradient, which every rank computed whole alike.  ``t``
    itself where it is whole."""
    if getattr(t, "_model_block", None) is None:
        return t
    return _Gather.apply(t, _ACTIVE, (("model", dim),), ())


def as_block(t: torch.Tensor, split: Optional[tuple[int, int]]) -> torch.Tensor:
    """``t`` marked as block ``split`` (from :func:`model_split`) of a
    layer output split over ``model`` (a vocab block of logits); ``t``
    itself when ``split`` is ``None``."""
    if split is not None:
        t._model_block = Block(*split)
    return t


def to_model(x: torch.Tensor) -> torch.Tensor:
    """Copy ``x`` (whole on every ``model`` rank) into a model-parallel
    region: the identity forward; backward, the sum over ``model`` of the
    ranks' partial gradients.  The identity without ``model_blocks``."""
    ctx = _ACTIVE
    if ctx is None or not ctx.model_blocks:
        return x
    return _ToModel.apply(x, ctx)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """Reduce a model-parallel region's partial result ``x``: the sum over
    ``model`` forward, the identity backward.  The identity without
    ``model_blocks``."""
    ctx = _ACTIVE
    if ctx is None or not ctx.model_blocks:
        return x
    return _FromModel.apply(x, ctx)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over ``model`` of ``x`` (no gradient); ``x``
    without ``model_blocks``."""
    ctx = _ACTIVE
    if ctx is None or not ctx.model_blocks:
        return x
    return ctx.all_reduce(x.detach(), "model", op=dist.ReduceOp.MAX)


# --------------------------------------------------- rows and experts --

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
    every expert.  Where the axis's ranks share their rows (``x`` is the
    same on each), the backward gathers every rank's experts' gradient."""
    axis = experts_axis(w)
    if axis is None:
        return x
    if axis in _ACTIVE.row_axes:
        return _ACTIVE.own_chunk(x, axis, 0)
    return _Split.apply(x, _ACTIVE, axis, 0)


def all_experts(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`own_experts`: every rank's experts of ``y``
    gathered over ``w``'s expert axis (backward: a reduce-scatter, or this
    rank's chunk where the axis's ranks share their rows)."""
    axis = experts_axis(w)
    if axis is None:
        return y
    return _Gather.apply(y, _ACTIVE, ((axis, 0),), ())


# ------------------------------------------------ serving: cache blocks --

@dataclasses.dataclass(frozen=True)
class SeqBlock:
    """The block of a KV cache's sequence that this rank holds: position
    ``offset + r`` lies at row ``r``; ``count`` blocks along mesh ``axis``."""

    axis: str
    offset: int
    count: int


def tag_seq(t: torch.Tensor, block: Optional[SeqBlock]) -> torch.Tensor:
    """Mark cache leaf ``t`` (layers first, the sequence on dim 2) as
    holding ``block`` of the sequence; ``None`` leaves it unmarked.  Its
    per-layer slices (:func:`unbind`) carry the mark."""
    if block is not None:
        t._seq = block
    return t


def seq_block(t: torch.Tensor) -> Optional[SeqBlock]:
    """The sequence block that cache leaf ``t`` holds inside :func:`use`;
    ``None`` for a whole sequence (or outside :func:`use`)."""
    return getattr(t, "_seq", None) if _ACTIVE is not None else None


def model_index() -> int:
    """This rank's coordinate along ``model`` (0 without ``model_blocks``)."""
    ctx = _ACTIVE
    return ctx.coord["model"] if ctx is not None and ctx.model_blocks else 0


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every ``model`` rank's block of ``x`` along ``dim``, in rank order
    (no gradient); ``x`` without ``model_blocks``."""
    ctx = _ACTIVE
    if ctx is None or not ctx.model_blocks:
        return x
    return ctx.all_gather(x, "model", dim)


def reduce_over(x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The elementwise sum (or ``op``) over mesh ``axis`` of ``x`` (no
    gradient); ``x`` itself where the axis has one rank."""
    ctx = _ACTIVE
    if ctx is None or ctx.sizes.get(axis, 1) == 1:
        return x
    return ctx.all_reduce(x.detach(), axis, op=op)
