"""Logical-axis sharding: map declared axis names onto the axes of a
``torch.distributed`` device mesh (the port of ``repro.dist.sharding``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`: its axis
names come from ``mesh_dim_names`` and their sizes from ``mesh.shape``
(spec math needs nothing else, so any object with those two attributes
will do, as the reference accepts an ``AbstractMesh``).  A partition spec
is a tuple with one entry per array dimension: a mesh axis name, a tuple of
names (a composed axis, outer first), or ``None`` (replicated); trailing
``None`` entries are trimmed, as ``jax.sharding.PartitionSpec`` compares.

Inference rules (as the reference's):

* **divisibility fallback** — a dimension only shards over a mesh axis (or
  composed axis tuple) that divides it exactly; otherwise the composed tuple
  is shortened from the right, and if nothing fits the dimension replicates;
* **no axis reuse per array** — a mesh axis appears at most once in one
  spec; the left-most dimension wins and later claimants replicate;
* **missing mesh axes are ignored** — rules naming an absent axis map to
  replication.

:func:`placements` and :func:`spec_of` translate a spec to and from the
``Shard``/``Replicate`` placements of a ``DTensor``.  ``tree_shardings``
and ``batch_sharding`` wait for the port's training slice.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Union

# logical axis -> mesh axis (str), composed mesh axes (tuple, outer first),
# or None (never sharded).  Explicit Nones document intent; unknown logical
# names also replicate.
DEFAULT_RULES: Mapping[str, Union[str, tuple, None]] = {
    "batch": ("pod", "data"),  # data parallelism composes across pods
    "embed": "data",  # FSDP: params + optimizer state over the data axis
    "mlp": "model",  # megatron TP: hidden/ffn/vocab over the model axis
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "vocab": "model",
    "seq": None,
    "head_dim": None,
    "layers": None,
}

# Cosmology-field logical axes (the in-situ snapshot path,
# ``repro_torch.dist.insitu``): a 3-D Nyx-style field shards plane-major —
# the slowest-varying axis over the largest data-parallel extent — and a 1-D
# HACC particle stream shards over ``data``.  Each field dimension maps to a
# *single* mesh axis (no composed tuples): the halo machinery ships one face
# per partitioned axis with one point-to-point exchange, and a composed axis
# would need a carry-propagating chain (DESIGN.md §7).
FIELD_RULES: Mapping[str, Union[str, tuple, None]] = {
    "field_z": "pod",
    "field_y": "data",
    "field_x": "model",
    "particles": "data",
}

FIELD_AXES: Mapping[int, tuple] = {
    1: ("particles",),
    2: ("field_y", "field_x"),
    3: ("field_z", "field_y", "field_x"),
}


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a device mesh (``mesh_dim_names`` x
    ``mesh.shape``)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names: specs name its axes")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def field_spec(shape: Sequence[int], mesh, rules: Mapping = FIELD_RULES) -> tuple:
    """Partition spec for a raw simulation field (1-D/2-D/3-D) — the
    ``dist.insitu`` default when the caller passes none.  Same inference
    rules as :func:`spec_for`, driven by the :data:`FIELD_RULES` table."""
    if len(shape) not in FIELD_AXES:
        raise ValueError(f"fields are 1-D/2-D/3-D, got shape {tuple(shape)}")
    return spec_for(shape, FIELD_AXES[len(shape)], mesh, rules)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: Mapping = DEFAULT_RULES) -> tuple:
    """Infer the partition spec for one array: a tuple of mesh axis names
    (or composed tuples, or ``None``), trailing replicated entries trimmed."""
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        target = rules.get(name) if name is not None else None
        if isinstance(target, str):
            target = (target,)
        entry = None
        if target:
            cand = tuple(a for a in target if a in sizes and a not in used)
            # divisibility fallback: shorten the composed tuple from the
            # right (drop the innermost axis first) until it divides
            while cand:
                extent = math.prod(sizes[a] for a in cand)
                if extent > 1 and dim % extent == 0:
                    entry = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
                cand = cand[:-1]
        entries.append(entry)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Sequence, mesh) -> tuple:
    """The ``DTensor`` placements of a spec on ``mesh``: one per mesh axis,
    ``Shard(d)`` for the axis that splits dimension ``d``, else
    ``Replicate()``.  A composed entry (several mesh axes on one dimension)
    gives one ``Shard(d)`` per axis, outer first."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, ent in enumerate(spec):
        for a in ((ent,) if isinstance(ent, str) else tuple(ent or ())):
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names {a!r}, not an axis of the mesh {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_of(dtensor) -> tuple:
    """The partition spec a ``DTensor``'s placements describe (the inverse
    of :func:`placements`); any placement but ``Shard``/``Replicate`` is
    refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = dtensor.device_mesh.mesh_dim_names
    entries: list[list[str]] = [[] for _ in range(dtensor.ndim)]
    for name, p in zip(names, dtensor.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} on mesh axis {name!r}: a field is Shard or Replicate")
    spec = [None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)
