"""Elastic scaling: rebuild the mesh after node loss and re-shard state
(the port of ``repro.train.elastic``).

On a real fleet the control plane detects dead hosts (missed heartbeats),
drains the slice, and relaunches with the surviving topology; the trainer's
job is only to (a) pick a coherent smaller mesh and (b) re-shard the last
checkpoint onto it.  :func:`degraded_mesh_shape` and
:func:`rebalance_batch` are pure functions with the reference's guards;
:func:`make_degraded_mesh` builds the ``DeviceMesh`` over the surviving
ranks (one process per rank, the process group already up) and
:func:`reshard_state` places a state on it through
:func:`repro_torch.dist.sharding.place`, the function
``CheckpointManager.restore(shardings=)`` places leaves with.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch import tree as tree_util
from repro_torch.dist import sharding as shd


def degraded_mesh_shape(old: dict[str, int], lost_pods: int = 0,
                        lost_data_rows: int = 0) -> dict[str, int]:
    """Shrink the mesh along fault domains. Pods are the natural failure
    unit (a DCN partition); within a pod we drop whole data rows so the
    model axis (which carries TP collectives) stays intact.  Losses along
    an axis the mesh doesn't have are an error, not a silent no-op — the
    supervisor must know its shrink request was impossible."""
    if lost_pods < 0 or lost_data_rows < 0:
        raise ValueError(f"negative loss counts (pods={lost_pods}, "
                         f"data_rows={lost_data_rows})")
    new = dict(old)
    if lost_pods:
        if "pod" not in new:
            raise ValueError(f"mesh {old} has no 'pod' axis to lose "
                             f"{lost_pods} pods from")
        if lost_pods >= new["pod"]:
            raise ValueError("cannot lose every pod")
        new["pod"] -= lost_pods
    if lost_data_rows:
        if "data" not in new:
            raise ValueError(f"mesh {old} has no 'data' axis to lose "
                             f"{lost_data_rows} rows from")
        if lost_data_rows >= new["data"]:
            raise ValueError("cannot lose every data row")
        new["data"] -= lost_data_rows
    return new


def make_degraded_mesh(shape: dict[str, int], device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``shape`` over the lowest-numbered ranks of the
    current group (a one-rank mesh starts a one-process group when none is
    up).  On a real fleet the lost ranks are gone; in the drill they stay
    alive, and the lost pods and data rows are the highest-indexed, so the
    survivors are ranks ``0 .. n - 1`` on every rank.  Construction is
    collective: every rank of the world calls this, and a rank the mesh
    leaves out gets a mesh whose ``get_coordinate()`` is None."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as mesh_lib

    dims = tuple(int(s) for s in shape.values())
    n = math.prod(dims)
    if not dist.is_initialized() or dist.get_world_size() <= n:
        return mesh_lib.make_mesh(dims, tuple(shape.keys()), device_type)
    return DeviceMesh(device_type, torch.arange(n).view(dims), mesh_dim_names=tuple(shape.keys()))


def reshard_state(state: Any, model, new_mesh, step_cfg=None) -> Any:
    """Re-shard a (restored) train state onto a different mesh: each leaf a
    ``DTensor`` on ``new_mesh`` placed as ``train.step.make_state_specs``
    says (replicated: the port's trainer holds the whole state per rank)."""
    from repro_torch.train import step as step_lib

    cfg = step_cfg or step_lib.TrainStepConfig()
    _, shardings = step_lib.make_state_specs(model, new_mesh, cfg)
    leaves, treedef = tree_util.tree_flatten(state)
    shs = tree_util.tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"state has {len(leaves)} leaves, its specs {len(shs)}")
    return tree_util.tree_unflatten(treedef, [
        shd.place(x.to_local() if shd.is_dtensor(x) else x, sh) for x, sh in zip(leaves, shs)])


def broadcast_state(state: Any, group=None) -> None:
    """Every tensor leaf of ``state`` (a ``DTensor``'s local tensor)
    overwritten in place with the group's first rank's, bit for bit: one
    broadcast of all leaves' bytes through the host (``gloo`` moves CPU
    tensors).  Every rank of ``group`` calls it with a state of the same
    structure; the supervisor's grow-back carries the live state onto the
    full mesh with it."""
    import torch
    import torch.distributed as dist

    src = 0 if group is None else dist.get_global_rank(group, 0)
    leaves = [x.to_local() if shd.is_dtensor(x) else x
              for x in tree_util.tree_flatten(state)[0] if isinstance(x, torch.Tensor)]
    sizes = [t.numel() * t.element_size() for t in leaves]
    if dist.get_rank() == src:
        buf = torch.cat([t.detach().reshape(-1).view(torch.uint8).cpu() for t in leaves]
                        or [torch.empty(0, dtype=torch.uint8)])
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8)
    dist.broadcast(buf, src=src, group=group)
    if dist.get_rank() == src:
        return
    off = 0
    for t, n in zip(leaves, sizes):
        # clone: a byte slice at an odd offset cannot be viewed as a wider dtype
        t.copy_(buf[off:off + n].clone().view(t.dtype).view(t.shape))
        off += n


def rebalance_batch(global_batch: int, new_mesh) -> int:
    """Largest batch <= global_batch divisible by the new data-parallel
    extent (keeps per-step token budget as close as possible).  A batch
    that cannot be balanced (zero/negative input, or smaller than the
    data-parallel extent — which would silently *grow* the token budget)
    is rejected explicitly.  ``new_mesh`` is a mesh or its shape (a dict of
    axis sizes, before the mesh is built)."""
    sizes = dict(new_mesh) if isinstance(new_mesh, dict) else shd.mesh_sizes(new_mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    if global_batch <= 0:
        raise ValueError(f"global_batch must be positive, got {global_batch}")
    out = (global_batch // dp) * dp
    if out <= 0:
        raise ValueError(
            f"global_batch={global_batch} cannot be balanced across the "
            f"data-parallel extent {dp} of mesh {sizes}")
    return out
