"""The train step with the compressed cross-pod gradient hop (the port of
``repro.train.step``'s ``build_train_step``).

``build_train_step`` returns ``(state, batch) -> (state, metrics)``: the
loss and its gradient (per-layer activation checkpointing is in the model),
gradient accumulation over ``microbatches`` in a float32 accumulator, the
gradient mean over the mesh, and AdamW under the step's schedule.

Data parallelism is one process per rank of a ``DeviceMesh`` with axes
``"pod"`` and / or ``"data"``: every rank holds the whole state and gets
the whole global batch, takes its own rows (pod-major, then ``data`` within
a pod and within each microbatch: the rows the reference's shardings give
each device), and the gradients are averaged over ``"data"`` and then over
``"pod"``.  With ``grad_comp.enabled`` and a ``"pod"`` axis the pod hop is
:func:`repro_torch.dist.collectives.compressed_pod_mean`: int8 (or int4)
codes and float32 block scales cross the pods, never float32 gradients,
with the quantisation residual fed back (error feedback).  A mesh axis of
size 1 takes no collective except the compressed hop, whose one-rank gather
still counts its bytes.  ``mesh=None`` is one process.

What differs from the reference:

* The reference shards parameters and optimiser state over ``data`` and
  ``model`` (FSDP and tensor parallelism under GSPMD); here every rank holds
  the whole state, so the state's shardings are replicated and a ``"model"``
  axis larger than 1 is refused.
* Error feedback is per pod: the reference stacks it as ``(n_pods, *shape)``
  bfloat16 with the leading axis on ``"pod"``; here each pod's ranks keep
  their pod's row, ``shape`` bfloat16.
* The step writes params, ``m``, ``v`` and ``ef`` in place (the reference
  donates its state) and returns the same tensors; leaves may be plain
  tensors or replicated ``DTensor`` objects, whose local tensors are
  written.
* The reference's jitted step is not its ``jnp`` program bit for bit (XLA
  rewrites divisions by constants and contracts products into FMAs); the
  port follows the program, so the two agree within float32 rounding.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shardlib
from repro_torch.models.layers import TensorSpec
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


def make_state_specs(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig()):
    """(abstract state, state shardings) for init and checkpoint restore:
    ``TensorSpec`` leaves, and replicated
    :class:`repro_torch.dist.sharding.NamedSharding` leaves on ``mesh``
    (``None`` without a mesh)."""
    specs = model.specs()
    p_abs = _map_specs(lambda p: TensorSpec(tuple(p.shape), step_cfg.param_dtype), specs)
    state_abs = {"params": p_abs,
                 "opt": {"m": _map_specs(lambda p: TensorSpec(tuple(p.shape), torch.float32),
                                         specs),
                         "v": _map_specs(lambda p: TensorSpec(tuple(p.shape), torch.float32),
                                         specs),
                         "step": TensorSpec((), torch.int32)}}
    if _has_ef(mesh, step_cfg):
        # this pod's error-feedback row (the reference's (n_pods, *shape) stack)
        state_abs["ef"] = _map_specs(lambda p: TensorSpec(tuple(p.shape), torch.bfloat16), specs)
    rep = None if mesh is None else shardlib.NamedSharding(mesh, ())
    state_shard = tree_util.tree_unflatten(
        tree_util.tree_structure(state_abs),
        [rep] * tree_util.tree_structure(state_abs).num_leaves)
    return state_abs, state_shard


def init_state(model, mesh=None, generator: Optional[torch.Generator] = None,
               step_cfg: TrainStepConfig = TrainStepConfig()) -> dict:
    """Fresh state on the model's device: params drawn from ``generator``
    (seed 0 on the model's device when ``None``), zero moments, step 0, and
    zero error feedback when the step has a compressed pod hop."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    params = init_params(model.specs(), generator, model.device, step_cfg.param_dtype)
    state = {"params": params, "opt": adamw.init_state(params)}
    if _has_ef(mesh, step_cfg):
        leaves, treedef = tree_util.tree_flatten(params)
        state["ef"] = tree_util.tree_unflatten(
            treedef, [torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                      for p in leaves])
    return state


def empty_state(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig()) -> dict:
    """The state of :func:`make_state_specs` as uninitialised tensors on the
    model's device: on ``meta``, the cost sweep's state (no data, no draw)."""
    state_abs, _ = make_state_specs(model, mesh, step_cfg)
    leaves, treedef = tree_util.tree_flatten(state_abs)
    return tree_util.tree_unflatten(treedef, [
        torch.empty(s.shape, dtype=s.dtype, device=model.device) for s in leaves])


def _schedule(step_cfg: TrainStepConfig):
    fn = schedules.SCHEDULES[step_cfg.schedule]
    return functools.partial(fn, peak_lr=step_cfg.peak_lr, warmup_steps=step_cfg.warmup_steps,
                             total_steps=step_cfg.total_steps)


def _local(x):
    return x.to_local() if shardlib.is_dtensor(x) else x


def _mean_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The plain mean of ``t`` over one mesh axis (``all_reduce`` SUM, then
    a divide by the axis size)."""
    return collectives.compressed_pod_mean(t, _PLAIN, None, axis_name=axis, mesh=mesh)[0]


def build_train_step(model, mesh=None, step_cfg: TrainStepConfig = TrainStepConfig(),
                     extra_keys: tuple[str, ...] = ()):
    """``(state, batch) -> (state, metrics)``; ``batch`` holds the global
    batch (numpy arrays or tensors, leading dim the batch), of which this
    rank uses its rows.  extra_keys: additional batch entries (prefix /
    frames) fed to loss.  Metrics: ``loss`` (the global mean), ``lr`` and
    ``grad_norm``, float32 scalars on the model's device.

    ``step(state, batch, trace_microbatches=n)`` runs only the first ``n``
    of the ``microbatches`` iterations, then the rest of the step: a cost
    trace (:mod:`repro_torch.launch.dryrun`), since every iteration runs the
    same operations; its update is not the step's."""
    sizes = _sizes(mesh)
    for axis, n in sizes.items():
        if axis not in ("pod", "data") and n > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {n}: the port's trainer is data-parallel "
                "(every rank holds the whole state)")
    lr_fn = _schedule(step_cfg)
    gc = step_cfg.grad_comp
    k = max(1, step_cfg.microbatches)
    n_pods, n_data = sizes.get("pod", 1), sizes.get("data", 1)
    compressed = gc.enabled and "pod" in sizes
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())) if mesh is not None else {}
    pod_i, data_i = coord.get("pod", 0), coord.get("data", 0)
    device = model.device

    def local_batch(batch) -> dict:
        """(k, rows, ...) per key: this rank's rows of each microbatch."""
        out = {}
        for key, x in batch.items():
            x = torch.as_tensor(x)
            b, rest = x.shape[0], tuple(x.shape[1:])
            if b % (n_pods * k * n_data):
                raise ValueError(f"batch {key!r} of {b} rows does not split over {n_pods} pods, "
                                 f"{k} microbatches and {n_data} data ranks")
            per_pod = b // n_pods
            x = x.reshape((n_pods, per_pod) + rest)[pod_i]  # pod-major rows
            x = x.reshape((k, n_data, per_pod // k // n_data) + rest)[:, data_i]
            out[key] = x.to(device)
        return out

    def loss_grads(leaves, treedef, mb):
        req = [p.detach().requires_grad_(True) for p in leaves]
        params = tree_util.tree_unflatten(treedef, req)
        extras = [mb[key] for key in extra_keys]
        loss = model.loss(params, mb["tokens"], mb["labels"], *extras)
        grads = torch.autograd.grad(loss, req)
        return loss.detach(), list(grads)

    def grads_of(leaves, treedef, micro, runs):
        if k == 1:
            return loss_grads(leaves, treedef, {key: v[0] for key, v in micro.items()})
        # gradient accumulation: k microbatches, float32 accumulator
        loss = torch.zeros((), dtype=torch.float32, device=device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(runs):
            l, g = loss_grads(leaves, treedef, {key: v[i] for key, v in micro.items()})
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
        loss, grads = grads_of(leaves, treedef, local_batch(batch), runs)
        if n_data > 1:
            grads = [_mean_over(g, mesh, "data") for g in grads]
            loss = _mean_over(loss, mesh, "data")
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
        local_opt = {"m": tree_util.tree_unflatten(
                         treedef, [_local(x) for x in tree_util.tree_flatten(opt["m"])[0]]),
                     "v": tree_util.tree_unflatten(
                         treedef, [_local(x) for x in tree_util.tree_flatten(opt["v"])[0]]),
                     "step": _local(opt["step"])}
        lr = lr_fn(local_opt["step"])
        _, new_opt, metrics = adamw.apply_updates(
            tree_util.tree_unflatten(treedef, leaves), local_opt,
            tree_util.tree_unflatten(treedef, grads), lr, step_cfg.adam)
        del grads
        new_state = {"params": params,
                     "opt": {"m": opt["m"], "v": opt["v"], "step": new_opt["step"]}}
        if "ef" in state:
            new_state["ef"] = state["ef"]
        return new_state, {"loss": loss, "lr": lr, **metrics}

    return train_step
