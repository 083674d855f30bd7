"""Mesh construction on ``torch.distributed`` (the port of
``repro.launch.mesh``).

Never touches device or process-group state at import time — call the
functions.  A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`,
one process per rank.  The production shapes are the reference's: a
``(16, 16)`` ``("data", "model")`` pod slice, two of them under ``"pod"``;
a launcher of that many processes sets the process group up first
(``torch.distributed.init_process_group`` with the rendezvous address, the
world size and this rank), and ``make_production_mesh`` lays the world out.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SINGLE_POD = (16, 16)  # 256 chips (one pod slice)
MULTI_POD = (2, 16, 16)  # 2 pods = 512 chips


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _init_one_rank(device_type: str) -> None:
    """A one-process group on an in-process store (no address, no network),
    unless a group is already up."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the ranks of the
    default group.  A mesh of one rank starts a one-process group when none
    is up."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= int(s)
    if n == 1:
        _init_one_rank(device_type)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device="cuda"):
    """A one-rank ``("data",)`` mesh on ``device`` (tests / examples)."""
    return make_mesh((1,), ("data",), torch.device(device).type)


def describe(mesh) -> str:
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return f"mesh{sizes} on {mesh.size()} devices"
