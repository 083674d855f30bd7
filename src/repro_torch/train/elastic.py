"""Elastic scaling: rebuild the mesh after node loss and re-shard state
(the port of ``repro.train.elastic``).

On a real fleet the control plane detects dead hosts (missed heartbeats),
drains the slice, and relaunches with the surviving topology; the trainer's
job is only to (a) pick a coherent smaller mesh and (b) re-shard the last
checkpoint onto it.  :func:`degraded_mesh_shape` and
:func:`rebalance_batch` are pure functions with the reference's guards;
:func:`make_degraded_mesh` builds the ``DeviceMesh`` over the surviving
ranks (one process per rank, the process group already up),
:func:`reshard_state` places a state on a mesh by the train state's specs
through :func:`repro_torch.dist.sharding.place` (the function
``CheckpointManager.restore(shardings=)`` places leaves with), and
:func:`grow_back` carries the survivors' blocks to the rejoining pods, or
after lost data rows each survivor's rows to the full mesh's blocks.
"""

from __future__ import annotations

import math
from typing import Any, Optional

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
    says (FSDP over ``data``, tensor and expert axes over ``model``).
    Leaves are whole tensors, or ``DTensor``s whose whole value is
    assembled first (``full_tensor``: a collective over their mesh, which
    every rank of it joins).  A rank that ``new_mesh`` leaves out gets
    ``None``."""
    from repro_torch.train import step as step_lib

    cfg = step_cfg or step_lib.TrainStepConfig()
    _, shardings = step_lib.make_state_specs(model, new_mesh, cfg)
    leaves, treedef = tree_util.tree_flatten(state)
    shs = tree_util.tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"state has {len(leaves)} leaves, its specs {len(shs)}")
    whole = [x.full_tensor() if shd.is_dtensor(x) else x for x in leaves]
    if new_mesh.get_coordinate() is None:
        return None
    return tree_util.tree_unflatten(treedef, [shd.place(x, sh) for x, sh in zip(whole, shs)])


def grow_back(state: Any, shardings: Any, source_shape: Optional[dict] = None) -> Any:
    """The live state carried onto the full mesh that ``shardings`` (the
    full mesh's state shardings, ``make_state_specs``) name, bit for bit:
    the counterpart of the reference's ``device_put`` onto the full
    shardings.  Collective: every rank of that mesh calls it.
    ``source_shape``: the degraded mesh's shape (``None``: lost pods).

    After lost pods the survivors are the full mesh's lowest pods (the lost
    pods are the highest-indexed) and hold their blocks on the degraded
    mesh, whose ``data`` and ``model`` extents are the full mesh's: a block
    depends on the (data, model) coordinate alone.  So each rank of a
    rejoining pod gets the blocks of the pod-0 rank at its own (data,
    model) coordinate: one broadcast of all its leaves' bytes over its
    ``pod`` group (through the host on ``gloo``).  After lost data rows the
    degraded mesh's ``data`` extent is smaller, so its blocks are not the
    full mesh's: :func:`_grow_rows` sends each rank of the full mesh the
    parts of its blocks from the survivors that hold them.  What a
    rejoining rank held is not read, only the tree's structure.  Returns
    the state with each split leaf a ``DTensor`` on the full mesh
    (replicated leaves plain tensors)."""
    import torch
    import torch.distributed as dist

    leaves, treedef = tree_util.tree_flatten(state)
    shs = tree_util.tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"state has {len(leaves)} leaves, its shardings {len(shs)}")
    mesh = shs[0].mesh
    full = shd.mesh_sizes(mesh)
    if source_shape is not None and any(dict(source_shape).get(a, 1) != full.get(a, 1)
                                        for a in ("data", "model")):
        return tree_util.tree_unflatten(treedef, _grow_rows(leaves, shs, dict(source_shape)))
    sizes = shd.mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    group = mesh.get_group("pod") if sizes.get("pod", 1) > 1 else None
    mine = coord.get("pod", 0) == 0
    device = shd.mesh_device(mesh)
    blocks = []
    for x, sh in zip(leaves, shs):
        shape = shd.local_shape(x.shape, sh.spec, mesh)
        local = shd.local(x)
        if mine and tuple(local.shape) != shape:
            raise ValueError(f"a survivor's block of {tuple(x.shape)} is {tuple(local.shape)}, "
                             f"the full mesh's {shape}: grow-back carries blocks whose data "
                             "and model extents are unchanged (a lost pod)")
        blocks.append(local if mine else torch.empty(shape, dtype=x.dtype, device=device))
    if group is not None:
        sizes_b = [t.numel() * t.element_size() for t in blocks]
        if mine:
            buf = torch.cat([t.detach().reshape(-1).view(torch.uint8).cpu() for t in blocks]
                            or [torch.empty(0, dtype=torch.uint8)])
        else:
            buf = torch.empty(sum(sizes_b), dtype=torch.uint8)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        if not mine:
            off = 0
            for t, n in zip(blocks, sizes_b):
                # clone: a byte slice at an odd offset cannot be viewed as a wider dtype
                t.copy_(buf[off:off + n].clone().view(t.dtype).view(t.shape))
                off += n
    return tree_util.tree_unflatten(treedef, [
        shd.from_local(t, sh, x.shape) if sh.spec else t
        for t, sh, x in zip(blocks, shs, leaves)])


def _block_box(shape, spec, sizes: dict, coord: dict) -> list[tuple[int, int]]:
    """``[(start, stop), ...]`` per dimension of the block of an array of
    ``shape`` that the rank at ``coord`` holds under ``spec`` (a composed
    entry splits outer first)."""
    box = []
    for d, n in enumerate(shape):
        ent = spec[d] if d < len(spec) else None
        axes = (ent,) if isinstance(ent, str) else tuple(ent or ())
        i, count = 0, 1
        for a in axes:
            i, count = i * sizes[a] + coord[a], count * sizes[a]
        box.append((i * (n // count), (i + 1) * (n // count)))
    return box


def _grow_rows(leaves: list, shs: list, source_shape: dict) -> list:
    """Each full-mesh rank's blocks from the survivors' blocks on the
    degraded mesh of ``source_shape`` (over ranks ``0 .. n - 1`` in the
    full mesh's axis order, :func:`make_degraded_mesh`), bit for bit.  Rank
    0 (a survivor) sends every rank the degraded specs; for each part of a
    full-mesh block one survivor holds it: where the degraded spec leaves
    an axis unused, the survivor at the receiving rank's coordinate on it
    (``data`` modulo its degraded extent).  Each pair of ranks exchanges
    one byte buffer of all its parts over the default group (host copies:
    ``gloo``).  Returns this rank's blocks as the leaves
    :func:`grow_back` returns."""
    import torch
    import torch.distributed as dist

    mesh = shs[0].mesh
    names = tuple(mesh.mesh_dim_names)
    full = shd.mesh_sizes(mesh)
    small = {a: int(source_shape.get(a, 1)) for a in names}
    if set(source_shape) - set(names):
        raise ValueError(f"degraded mesh {source_shape} has axes the full mesh {full} lacks")
    me = dist.get_rank()

    def coords(sizes: dict) -> list[dict]:  # row-major, as a mesh lays out its ranks
        out = []
        for r in range(math.prod(sizes[a] for a in names)):
            c = {}
            for a in reversed(names):
                c[a], r = r % sizes[a], r // sizes[a]
            out.append(c)
        return out

    full_coord = dict(zip((int(r) for r in mesh.mesh.reshape(-1).tolist()), coords(full)))
    small_coord = dict(enumerate(coords(small)))
    box = [None]
    if me == 0:
        box = [[shd.spec_of(x) if shd.is_dtensor(x) else () for x in leaves]]
    dist.broadcast_object_list(box, src=0)
    small_specs = box[0]

    def pick(axis: str, dest: dict) -> int:  # the source coordinate on an unused axis
        return dest.get(axis, 0) % small[axis]

    # plan: for each (source, dest) pair the parts, in leaf order
    plan: dict = {}
    for li, (x, sh, sspec) in enumerate(zip(leaves, shs, small_specs)):
        shape = tuple(x.shape)
        used = {a for ent in sspec for a in ((ent,) if isinstance(ent, str) else ent or ())}
        for dst, dcoord in full_coord.items():
            need = _block_box(shape, sh.spec, full, dcoord)
            for src, scoord in small_coord.items():
                if any(scoord[a] != pick(a, dcoord) for a in names if a not in used):
                    continue
                have = _block_box(shape, sspec, small, scoord)
                part = [(max(n0, h0), min(n1, h1)) for (n0, n1), (h0, h1) in zip(need, have)]
                if all(lo < hi for lo, hi in part) or not shape:
                    plan.setdefault((src, dst), []).append((li, part, have, need))

    device = shd.mesh_device(mesh)
    blocks = [torch.empty(shd.local_shape(x.shape, sh.spec, mesh), dtype=x.dtype, device=device)
              for x, sh in zip(leaves, shs)]

    def view(t, part, box_):
        for d, ((lo, hi), (b0, _)) in enumerate(zip(part, box_)):
            t = t.narrow(d, lo - b0, hi - lo)
        return t

    def as_bytes(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()

    sends, recvs = [], []
    for (src, dst), parts in sorted(plan.items()):
        if src == me:
            mine = [view(shd.local(leaves[li]), part, have) for li, part, have, _ in parts]
            if dst == me:
                for (li, part, _, need), t in zip(parts, mine):
                    view(blocks[li], part, need).copy_(t)
            else:
                buf = torch.cat([as_bytes(t) for t in mine])
                sends.append((dst, buf))
        elif dst == me:
            n = sum(math.prod(hi - lo for lo, hi in part) * leaves[li].element_size()
                    for li, part, _, _ in parts)
            recvs.append((src, parts, torch.empty(n, dtype=torch.uint8)))
    work = [dist.irecv(buf, src=src) for src, _, buf in recvs]
    work += [dist.isend(buf, dst=dst) for dst, buf in sends]
    for w in work:
        w.wait()
    for _, parts, buf in recvs:
        off = 0
        for li, part, _, need in parts:
            dest = view(blocks[li], part, need)
            n = dest.numel() * dest.element_size()
            # clone: a byte slice at an odd offset cannot be viewed as a wider dtype
            dest.copy_(buf[off:off + n].clone().view(dest.dtype).view(dest.shape))
            off += n
    return [shd.from_local(t, sh, x.shape) if sh.spec else t
            for t, sh, x in zip(blocks, shs, leaves)]


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
