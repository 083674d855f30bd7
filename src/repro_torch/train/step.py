"""The train step with the compressed cross-pod gradient hop, and the
sharded serving step (the port of ``repro.train.step``'s
``build_train_step`` and ``build_serve_step``).

``build_train_step`` returns ``(state, batch) -> (state, metrics)``: the
loss and its gradient (per-layer activation checkpointing is in the model),
gradient accumulation over ``microbatches`` in a float32 accumulator, the
gradient mean over the mesh, and AdamW under the step's schedule.

The state is sharded as the reference's ``DEFAULT_RULES`` say
(:func:`make_state_specs`): each leaf of ``params``, ``opt.m`` and
``opt.v`` is this rank's block of ``dist.sharding.spec_for(shape,
logical_axes, mesh)`` (FSDP over ``"data"``, tensor and expert axes over
``"model"``), a ``DTensor`` where it splits and a plain tensor where it
is replicated; ``opt.step`` is replicated.  One process per rank of a
``DeviceMesh`` with axes from ``"pod"``, ``"data"`` and ``"model"``:

* **Rows.**  Every rank gets the whole global batch and takes its rows:
  pod-major, then ``data`` within a pod and within each microbatch (the
  axes of ``dist.sharding.batch_sharding``, the reference's ``("pod",
  "data")``).  Every family computes on Megatron blocks over ``model``,
  so the ranks along ``model`` share those rows, as under the reference's
  GSPMD program.  A microbatch whose rows do not divide over the row axes
  raises: no rank repeats another's rows.
* **Compute.**  The model computes on this rank's blocks through
  ``repro_torch.dist.spmd``: each leaf is all-gathered over ``data`` where
  it is used (a layer's inside its activation checkpoint); attention, the
  MLPs, rwkv6's time and channel mixes, hymba's SSD heads, the embedding
  and the loss run on their ``model`` blocks between the region operators,
  the expert stacks stay split over ``model`` (expert parallelism), and
  the MoE routing sees the whole microbatch, as the reference's global
  program does.  A gather's backward reduce-scatters the gradient over the
  axes whose ranks hold distinct rows, so each rank ends with its block's
  gradient summed over those ranks of its pod; the step divides by their
  number (``data``).
* **Pods.**  The gradient mean over ``"pod"`` runs on each block: with
  ``grad_comp.enabled`` it is :func:`repro_torch.dist.collectives.
  compressed_pod_mean` (int8 or int4 codes and float32 block scales cross
  the pods, never float32 gradients, with the quantisation residual fed
  back), so a rank's hop bytes shrink by its leaf's shard factor, as the
  reference's partitioned s8 all-gather does.
* A mesh axis of size 1 takes no collective except the compressed hop,
  whose one-rank gather still counts its bytes.  ``mesh=None`` is one
  process holding plain tensors.

What differs from the reference:

* The reference partitions one global program under GSPMD; here the
  collectives are explicit: Megatron's two region operators around each
  column- and row-parallel pair, a vocab-parallel embedding and loss, and
  the MoE's row and expert gathers (``dist.spmd``).  Where XLA may choose
  another partition of an op (it may, for instance, gather a small weight
  rather than reduce a large activation), the port's is fixed.  The
  numbers are the same function within float32 rounding.
* Error feedback is per pod: the reference stacks it as ``(n_pods, *shape)``
  bfloat16 on ``PS("pod", *spec)``; here each pod's ranks keep their pod's
  row, ``shape`` bfloat16 on the param's spec.
* The step writes params, ``m``, ``v`` and ``ef`` in place (the reference
  donates its state) and returns the same tensors.
* The reference's jitted step is not its ``jnp`` program bit for bit (XLA
  rewrites divisions by constants and contracts products into FMAs); the
  port follows the program, so the two agree within float32 rounding.

:func:`build_serve_step` is the reference's decode step on the same mesh:
parameters placed as :func:`make_state_specs` places them and gathered
inside each layer (``dist.spmd``), the cache placed as the reference's
``cache_shardings`` says (:func:`cache_shardings`: batch over (``pod``,
``data``), the sequence over ``model`` from 4096 positions, a batch that
does not split takes the sequence over ``data``), and each rank attending
to its block of a split cache, the blocks' partial softmaxes combined
exactly (``models.layers``).  The serving engine (``serving/engine.py``)
stays on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import re
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shardlib
from repro_torch.dist import spmd
from repro_torch.models.layers import KVCodecConfig, TensorSpec
from repro_torch.models.spec import init_params, spec_items
from repro_torch.optim import adamw, schedules

_PLAIN = collectives.GradCompressionConfig(enabled=False)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"
    adam: adamw.AdamWConfig = adamw.AdamWConfig()
    grad_comp: collectives.GradCompressionConfig = collectives.GradCompressionConfig()
    microbatches: int = 1  # gradient accumulation (per-layer remat is in-model)
    param_dtype: torch.dtype = torch.float32


def _sizes(mesh) -> dict:
    return {} if mesh is None else shardlib.mesh_sizes(mesh)


def _has_ef(mesh, step_cfg: TrainStepConfig) -> bool:
    gc = step_cfg.grad_comp
    # meshes without a pod axis have no compressed hop and no ef
    return gc.enabled and gc.error_feedback and "pod" in _sizes(mesh)


def _map_specs(fn, specs: Any) -> dict:
    out: dict = {}
    for path, p in spec_items(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(p)
    return out


def _check_mesh(mesh) -> None:
    for axis in _sizes(mesh):
        if axis not in ("pod", "data", "model"):
            raise ValueError(f"mesh axis {axis!r}: the train step's mesh has axes from "
                             "'pod', 'data' and 'model'")


def make_state_specs(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig()):
    """(abstract state, state shardings) for init, the dry run and
    checkpoint restore: ``TensorSpec`` leaves of the whole arrays, and
    :class:`repro_torch.dist.sharding.NamedSharding` leaves on ``mesh``
    (``None`` without a mesh): each param, ``m`` and ``v`` leaf on
    ``spec_for(shape, logical_axes, mesh)``, the error feedback row on its
    param's spec, ``step`` replicated."""
    specs = model.specs()
    p_abs = _map_specs(lambda p: TensorSpec(tuple(p.shape), step_cfg.param_dtype), specs)
    f32 = _map_specs(lambda p: TensorSpec(tuple(p.shape), torch.float32), specs)
    state_abs = {"params": p_abs, "opt": {"m": f32, "v": dict(f32),
                                          "step": TensorSpec((), torch.int32)}}
    if _has_ef(mesh, step_cfg):
        # this pod's error-feedback row (the reference's (n_pods, *shape) stack)
        state_abs["ef"] = _map_specs(lambda p: TensorSpec(tuple(p.shape), torch.bfloat16), specs)
    if mesh is None:
        return state_abs, tree_util.tree_unflatten(
            tree_util.tree_structure(state_abs),
            [None] * tree_util.tree_structure(state_abs).num_leaves)
    _check_mesh(mesh)
    p_shard = shardlib.tree_shardings(_map_specs(lambda p: p.axes, specs), p_abs, mesh)
    state_shard = {"params": p_shard,
                   "opt": {"m": p_shard, "v": p_shard,
                           "step": shardlib.NamedSharding(mesh, ())}}
    if "ef" in state_abs:
        state_shard["ef"] = p_shard
    return state_abs, state_shard


def _flat_shardings(shard: Any, mesh, n: int) -> list:
    """The leaves of a :func:`make_state_specs` sharding tree (``n`` Nones
    without a mesh, whose tree has no leaves)."""
    return [None] * n if mesh is None else tree_util.tree_flatten(shard)[0]


def _block(t: torch.Tensor, sh) -> Any:
    """This rank's block of the whole ``t`` as placed by ``sh``: a
    ``DTensor`` where the spec splits it, ``t`` itself where it is
    replicated (or without a mesh)."""
    if sh is None or not sh.spec:
        return t
    return shardlib.place(t, sh)


def _zeros_like_block(x, dtype) -> Any:
    """Zeros shaped and placed like ``x`` (a block or a plain tensor)."""
    if not shardlib.is_dtensor(x):
        return torch.zeros(x.shape, dtype=dtype, device=x.device)
    z = torch.zeros(x.to_local().shape, dtype=dtype, device=x.to_local().device)
    return shardlib.from_local(z, shardlib.NamedSharding(x.device_mesh, shardlib.spec_of(x)),
                               x.shape)


def init_state(model, mesh=None, generator: Optional[torch.Generator] = None,
               step_cfg: TrainStepConfig = TrainStepConfig()) -> dict:
    """Fresh state on the model's device: params drawn from ``generator``
    (seed 0 on the model's device when ``None``), zero moments, step 0, and
    zero error feedback when the step has a compressed pod hop.  On a mesh
    each leaf is drawn whole, in the order and with the values of the
    replicated state, and only this rank's block of it is kept (the whole
    leaf is dropped before the next draw)."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    params = init_param_blocks(model, mesh, generator, step_cfg.param_dtype)
    leaves, treedef = tree_util.tree_flatten(params)
    zeros = lambda dt: tree_util.tree_unflatten(  # noqa: E731
        treedef, [_zeros_like_block(p, dt) for p in leaves])
    state = {"params": params,
             "opt": {"m": zeros(torch.float32), "v": zeros(torch.float32),
                     "step": torch.zeros((), dtype=torch.int32, device=model.device)}}
    if _has_ef(mesh, step_cfg):
        state["ef"] = zeros(torch.bfloat16)
    return state


def init_param_blocks(model, mesh, generator: torch.Generator,
                      dtype: torch.dtype = torch.float32) -> Any:
    """The parameters drawn from ``generator`` on the model's device, each
    leaf drawn whole in the order and with the values of the replicated
    draw and only this rank's block of it kept (:func:`make_state_specs`'
    placement; every leaf whole without a mesh)."""
    _, shard = make_state_specs(model, mesh, TrainStepConfig(param_dtype=dtype))
    p_shard = shard["params"]

    def keep(path, _p, leaf):
        sh = p_shard
        for k in path:
            sh = sh[k]
        return _block(leaf, sh)

    return init_params(model.specs(), generator, model.device, dtype,
                       keep=None if mesh is None else keep)


def empty_blocks(abs_tree: Any, shardings: Any, mesh, device) -> Any:
    """Uninitialised tensors on ``device`` for a tree of ``TensorSpec``
    leaves, each this rank's block under its sharding (``shardings``: a
    matching tree, ``None`` without a mesh): a ``DTensor`` where it splits."""
    leaves, treedef = tree_util.tree_flatten(abs_tree)
    out = []
    for s, sh in zip(leaves, _flat_shardings(shardings, mesh, len(leaves))):
        if sh is None or not sh.spec:
            out.append(torch.empty(s.shape, dtype=s.dtype, device=device))
            continue
        local = torch.empty(shardlib.local_shape(s.shape, sh.spec, mesh), dtype=s.dtype,
                            device=device)
        out.append(shardlib.from_local(local, sh, s.shape))
    return tree_util.tree_unflatten(treedef, out)


def empty_state(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig()) -> dict:
    """The state of :func:`make_state_specs` as uninitialised tensors on the
    model's device, each leaf this rank's block on a mesh: on ``meta``, the
    cost sweep's state (no data, no draw)."""
    state_abs, shard = make_state_specs(model, mesh, step_cfg)
    return empty_blocks(state_abs, shard, mesh, model.device)


def tagged_params(model, params: Any, shardings: Any) -> Any:
    """This rank's parameter blocks of ``params`` (``DTensor`` or plain
    leaves placed by ``shardings``, :func:`make_state_specs`' ``params``),
    each a local tensor tagged with its spec and logical axes for
    ``dist.spmd``'s gathers (:func:`spmd.tag`)."""
    leaves, treedef = tree_util.tree_flatten(params)
    shs = tree_util.tree_flatten(shardings)[0]
    items = list(spec_items(model.specs()))
    return tree_util.tree_unflatten(treedef, [
        spmd.tag(shardlib.local(x).detach(), sh.spec, p.axes)
        for x, sh, (_, p) in zip(leaves, shs, items)])



def _schedule(step_cfg: TrainStepConfig):
    fn = schedules.SCHEDULES[step_cfg.schedule]
    return functools.partial(fn, peak_lr=step_cfg.peak_lr, warmup_steps=step_cfg.warmup_steps,
                             total_steps=step_cfg.total_steps)


_local = shardlib.local


def _mean_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The plain mean of ``t`` over one mesh axis (``all_reduce`` SUM, then
    a divide by the axis size)."""
    return collectives.compressed_pod_mean(t, _PLAIN, None, axis_name=axis, mesh=mesh)[0]


def build_train_step(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig(),
                     extra_keys: tuple[str, ...] = ()):
    """``(state, batch) -> (state, metrics)``; ``batch`` holds the global
    batch (numpy arrays or tensors, leading dim the batch), of which this
    rank uses its rows, and ``state`` is sharded as :func:`make_state_specs`
    says (:func:`init_state`, ``CheckpointManager.restore(shardings=)``).
    extra_keys: additional batch entries (prefix / frames) fed to loss.
    Metrics: ``loss`` (the global mean), ``lr`` and ``grad_norm``, float32
    scalars on the model's device, equal on every rank.

    ``step(state, batch, trace_microbatches=n)`` runs only the first ``n``
    of the ``microbatches`` iterations, then the rest of the step: a cost
    trace (:mod:`repro_torch.launch.dryrun`), since every iteration runs the
    same operations; its update is not the step's."""
    _check_mesh(mesh)
    sizes = _sizes(mesh)
    lr_fn = _schedule(step_cfg)
    gc = step_cfg.grad_comp
    k = max(1, step_cfg.microbatches)
    n_pods = sizes.get("pod", 1)
    compressed = gc.enabled and "pod" in sizes
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())) if mesh is not None else {}
    device = model.device
    items = list(spec_items(model.specs()))
    shardings = _flat_shardings(make_state_specs(model, mesh, step_cfg)[1]["params"], mesh,
                                len(items))
    specs = [() if sh is None else sh.spec for sh in shardings]

    # the batch's rows: pod-major over the whole batch, then the other axes
    # of ``batch_sharding`` (``data``) within each microbatch; the model
    # ranks share their rows
    bspec = shardlib.batch_sharding(mesh).spec if mesh is not None else ()
    batch_axes = () if not bspec else (bspec[0],) if isinstance(bspec[0], str) else bspec[0]
    outer = tuple(a for a in batch_axes if a == "pod")
    inner = tuple(a for a in batch_axes if a != "pod")
    # the ranks of a pod whose rows differ: a pod's gradient sums over them
    in_pod = math.prod(sizes[a] for a in inner)
    # the routing's rows: the pods' too unless each pod routes its own
    route_axes = tuple(a for a in outer + inner if not (a == "pod" and compressed))

    def local_batch(batch) -> dict:
        """(k, rows, ...) per key: this rank's rows of each microbatch.  Rows
        that do not split evenly over every row axis raise: no rank repeats
        another's rows."""
        out = {}
        ranks = math.prod(sizes.get(a, 1) for a in outer + inner)
        for key, x in batch.items():
            x = torch.as_tensor(x)
            b, rest = x.shape[0], tuple(x.shape[1:])
            rows, r = divmod(b, k * ranks)
            if r or not rows:
                raise ValueError(
                    f"batch {key!r} of {b} rows does not split over {k} microbatches and the "
                    f"row axes {dict((a, sizes[a]) for a in outer + inner)}: the step does not "
                    "repeat rows over ranks")
            x = x.reshape(tuple(sizes[a] for a in outer) + (k,)
                          + tuple(sizes[a] for a in inner) + (rows,) + rest)
            index = tuple(coord[a] for a in outer) + (slice(None),) + tuple(coord[a] for a in inner)
            out[key] = x[index].to(device)
        return out

    def loss_grads(leaves, treedef, mb, ctx):
        req = [p.detach().requires_grad_(True) for p in leaves]
        if ctx is not None:
            for r, (_, p), spec in zip(req, items, specs):
                spmd.tag(r, spec, p.axes)
        params = tree_util.tree_unflatten(treedef, req)
        extras = [mb[key] for key in extra_keys]
        with spmd.use(ctx) if ctx is not None else contextlib.nullcontext():
            loss = model.loss(params, mb["tokens"], mb["labels"], *extras)
            missed = spmd.unused(req)
            if missed:
                raise RuntimeError("the model used parameter leaves without gathering them, "
                                   "or their model blocks without taking them as blocks "
                                   f"(spmd.model_split): {[items[i][0] for i in missed]}")
            grads = torch.autograd.grad(loss, req)
        return loss.detach(), list(grads)

    def grads_of(leaves, treedef, micro, runs, ctx):
        if k == 1:
            return loss_grads(leaves, treedef, {key: v[0] for key, v in micro.items()}, ctx)
        # gradient accumulation: k microbatches, float32 accumulator
        loss = torch.zeros((), dtype=torch.float32, device=device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(runs):
            l, g = loss_grads(leaves, treedef, {key: v[i] for key, v in micro.items()}, ctx)
            loss = loss + l
            for a, gi in zip(acc, g):
                a.add_(gi.to(torch.float32))
            del g
        kk = torch.full((), float(k), dtype=torch.float32, device=device)
        return loss / kk, [a / kk for a in acc]

    def train_step(state: dict, batch, *, trace_microbatches: Optional[int] = None
                   ) -> tuple[dict, dict]:
        params = state["params"]
        leaves, treedef = tree_util.tree_flatten(params)
        leaves = [_local(p) for p in leaves]
        runs = k if trace_microbatches is None else min(max(1, trace_microbatches), k)
        micro = local_batch(batch)
        ctx = None
        if mesh is not None:
            ctx = spmd.Context(mesh, route_axes, next(iter(micro.values())).shape[1])
        loss, grads = grads_of(leaves, treedef, micro, runs, ctx)
        if in_pod > 1:  # the gathers' backward summed each block over the pod's rows
            grads = [g / torch.full_like(g, in_pod) for g in grads]
            for axis in inner:
                if sizes[axis] > 1:
                    loss = _mean_over(loss, mesh, axis)
        if compressed:
            ef = (tree_util.tree_flatten(state["ef"])[0] if gc.error_feedback
                  else [None] * len(grads))
            for i, e in enumerate(ef):
                e = None if e is None else _local(e)
                grads[i], e_new = collectives.compressed_pod_mean(
                    grads[i], gc, e, axis_name="pod", mesh=mesh)
                if e is not None:
                    e.copy_(e_new)
            loss = _mean_over(loss, mesh, "pod") if n_pods > 1 else loss
        elif n_pods > 1:
            grads = [_mean_over(g, mesh, "pod") for g in grads]
            loss = _mean_over(loss, mesh, "pod")

        opt = state["opt"]
        blocks = [g if sh is None or not sh.spec else shardlib.from_local(g, sh, p.shape)
                  for g, sh, (_, p) in zip(grads, shardings, items)]
        lr = lr_fn(_local(opt["step"]))
        _, new_opt, metrics = adamw.apply_updates(
            params, {"m": opt["m"], "v": opt["v"], "step": _local(opt["step"])},
            tree_util.tree_unflatten(treedef, blocks), lr, step_cfg.adam)
        del grads, blocks
        new_state = {"params": params,
                     "opt": {"m": opt["m"], "v": opt["v"], "step": new_opt["step"]}}
        if "ef" in state:
            new_state["ef"] = state["ef"]
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step


# ----------------------------------------------------------- serving --

SEQ_SPLIT_MIN = 4096  # the reference's shortest cache sequence that splits
# cache leaves whose dim 2 is a sequence of positions (a model's attention
# caches, under an optional "self_" or "attn_" prefix)
_ATTN_LEAVES = ("k", "v", "k_codes", "v_codes", "k_scale", "v_scale")


def _row_axes(mesh) -> tuple[str, ...]:
    """The mesh axes a serving batch splits over: ``pod`` and ``data``."""
    return tuple(a for a in ("pod", "data") if a in _sizes(mesh))


def _first(axes: tuple):
    """A spec entry over ``axes``: one name, or the composed tuple."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def cache_shardings(cache_abs: Any, mesh) -> Any:
    """The reference's ``cache_shardings``: a
    :class:`repro_torch.dist.sharding.NamedSharding` per cache leaf
    (``TensorSpec`` or tensor, layers first), rule for rule: the batch (dim
    1) over (``pod``, ``data``) where it divides, and in addition the
    sequence (dim 2) over ``model`` where it divides and holds 4096
    positions or more; a batch that does not divide (batch 1,
    ``long_500k``) takes a sequence of 4096 or more over ``data`` where it
    divides; every other leaf is replicated.  The mesh needs only axis
    names and sizes."""
    sizes = _sizes(mesh)
    axes = _row_axes(mesh)
    size = math.prod(sizes[a] for a in axes)
    first = _first(axes)
    d, tp = sizes.get("data", 1), sizes.get("model", 1)

    def one(s):
        shape = tuple(s.shape)
        batch_ok = len(shape) >= 2 and size > 1 and shape[1] % size == 0
        seq_model = (len(shape) >= 3 and tp > 1 and shape[2] % tp == 0
                     and shape[2] >= SEQ_SPLIT_MIN)
        if batch_ok and seq_model:
            spec = (None, first, "model")
        elif batch_ok:
            spec = (None, first)
        elif len(shape) >= 3 and d > 1 and shape[2] % d == 0 and shape[2] >= SEQ_SPLIT_MIN:
            spec = (None, None, "data")  # batch 1 (long-context decode): sequence over data
        else:
            spec = ()
        return shardlib.NamedSharding(mesh, spec)

    leaves, treedef = tree_util.tree_flatten(cache_abs)
    return tree_util.tree_unflatten(treedef, [one(s) for s in leaves])


def place_tree(tree: Any, shardings: Any) -> Any:
    """Each whole tensor of ``tree`` as this rank's block under its
    sharding (``DTensor`` where it splits, the tensor on the mesh's device
    where it is replicated): :func:`build_serve_step`'s parameters from a
    whole tree (``models.interop.params_from_jax``, ``init_params``)."""
    leaves, treedef = tree_util.tree_flatten(tree)
    shs = tree_util.tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"tree has {len(leaves)} leaves, its shardings {len(shs)}")
    out = []
    for x, sh in zip(leaves, shs):
        out.append(shardlib.place(x, sh) if sh.spec else x.to(shardlib.mesh_device(sh.mesh)))
    return tree_util.tree_unflatten(treedef, out)


def build_serve_step(model, mesh=None, codec: KVCodecConfig = KVCodecConfig(),
                     param_dtype: torch.dtype = torch.bfloat16, attention: str = "xla"):
    """Decode step on ``mesh``: ``(serve_step, place_cache, (param_specs,
    param_shardings))``, the reference's ``(serve_step, jit_step, (p_abs,
    p_shard))``.

    ``serve_step(params, cache, token, index) -> (logits, cache)``:
    ``params`` this rank's blocks as placed by ``param_shardings``
    (:func:`make_state_specs`' ``params``; :func:`place_tree` or
    :func:`init_state`), ``cache`` as ``place_cache`` placed it (written in
    place), ``token`` the global (B,) batch and ``index`` a scalar or the
    global (B,) per-slot positions.  Each rank computes its rows (the
    reference's ``bshard``: the batch over (``pod``, ``data``) where it
    divides, else every row), the ranks along ``model`` sharing them, and
    returns their logits over the whole (padded) vocabulary: a ``DTensor``
    split on the batch where the rows split, a tensor otherwise.
    ``attention="fused"`` sends blockfloat8 decode attention through K10
    (on a split cache each rank's block, with its log-sum-exp).

    ``place_cache(cache)``: a whole cache as this rank's blocks under
    :func:`cache_shardings`.  ``mesh=None``: one process, ``serve_step`` is
    ``model.decode_step`` and ``place_cache`` the identity."""
    scfg = TrainStepConfig(param_dtype=param_dtype)
    state_abs, shard = make_state_specs(model, mesh, scfg)
    p_abs, p_shard = state_abs["params"], shard["params"]
    if mesh is None:
        def serve_local(params, cache, token, index):
            return model.decode_step(params, cache, torch.as_tensor(token, device=model.device),
                                     torch.as_tensor(index, device=model.device), codec,
                                     attention)

        return serve_local, lambda cache: cache, (p_abs, p_shard)

    _check_mesh(mesh)
    sizes = _sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    axes = _row_axes(mesh)
    n_rows = math.prod(sizes[a] for a in axes)
    items = list(spec_items(model.specs()))
    vocab = model.cfg.padded_vocab
    device = model.device

    def place_cache(cache):
        return place_tree(cache, cache_shardings(cache, mesh))

    def seq_blocks(names, leaves):
        """Each local cache leaf marked with the sequence block it holds."""
        out = []
        for name, x in zip(names, leaves):
            local = shardlib.local(x)
            spec = shardlib.spec_of(x) if shardlib.is_dtensor(x) else ()
            axis = spec[2] if len(spec) > 2 else None
            if axis is not None:
                if name.split("_", 1)[-1] not in _ATTN_LEAVES and name not in _ATTN_LEAVES:
                    raise ValueError(f"cache leaf {name!r} splits its dim 2 over {axis!r}: only "
                                     "attention caches hold a sequence there")
                block = spmd.SeqBlock(axis, coord[axis] * local.shape[2], sizes[axis])
                spmd.tag_seq(local, block)
            out.append(local)
        return out

    def serve_step(params, cache, token, index):
        token = torch.as_tensor(token, device=device)
        index = torch.as_tensor(index, device=device)
        b = token.shape[0]
        split = n_rows > 1 and b % n_rows == 0
        rows = b // n_rows if split else b
        if split:
            r = 0
            for a in axes:
                r = r * sizes[a] + coord[a]
            token = token[r * rows:(r + 1) * rows]
            if index.ndim == 1:
                index = index[r * rows:(r + 1) * rows]
        blocks = tagged_params(model, params, p_shard)
        names = [re.findall(r"\['([^']*)'\]", path)[-1]
                 for path, _ in tree_util.tree_flatten_with_path(cache)[0]]
        c_leaves, c_def = tree_util.tree_flatten(cache)
        local_cache = tree_util.tree_unflatten(c_def, seq_blocks(names, c_leaves))
        ctx = spmd.Context(mesh, axes if split else (), rows)
        with spmd.use(ctx):
            logits, _ = model.decode_step(blocks, local_cache, token, index, codec, attention)
            wrong = [items[i][0] for i, t in enumerate(tree_util.tree_flatten(blocks)[0])
                     if spmd._info(t).blocked and not spmd._info(t).claimed]
            if wrong:
                raise RuntimeError("the model used model blocks of parameter leaves as whole "
                                   f"leaves (spmd.model_split): {wrong}")
            if logits.shape[-1] != vocab:  # a vocab-parallel unembedding's block
                logits = spmd.gather_model(logits, logits.ndim - 1)
        if logits.shape[-1] != vocab:
            raise RuntimeError(f"logits of width {logits.shape[-1]}, the vocabulary {vocab}")
        if split:
            logits = shardlib.from_local(
                logits, shardlib.NamedSharding(mesh, (_first(axes),)), (b, vocab))
        return logits, cache

    return serve_step, place_cache, (p_abs, p_shard)
