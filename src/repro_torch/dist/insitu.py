"""In-situ snapshot planning (the port of ``repro.dist.insitu``), single
device only.

Only :func:`plan_kernel_buckets` is ported, for the single-device case: no
mesh, every leaf replicated.  The sharded compress/decompress paths, the
halo and carry exchanges, the sharded arena and the host-side shard
streams (codec ``insitu-*``) wait for the port's ``dist`` slice (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import Sequence

from repro_torch.core import arena as arena_core
from repro_torch.kernels.lorenzo3d import TILE


def plan_kernel_buckets(entries: Sequence[tuple],
                        elem_budget: int = arena_core.ROW_ELEM_BUDGET):
    """Carve out the leaves the fused tile kernel (K8) batches: 3-D,
    TILE-aligned, small enough for the kernel's int32 bit offsets.
    ``entries`` are ``(name, shape, dtype)``.  Returns ``(buckets, rest)``:
    shape-uniform :class:`repro_torch.core.arena.Bucket` groups
    (``padded == n``: tile rows carry no pad) for
    :func:`repro_torch.core.arena.szk_compress_bucket`, plus the remaining
    entries to feed :func:`repro_torch.core.arena.plan_buckets`.  Those
    leaves would fit the flat route too, but the tile-blocked coder is the
    field path of the paper, so it wins the route."""
    tz, ty, tx = TILE
    groups: dict[tuple, list] = {}
    rest = []
    for name, shape, dtype in entries:
        shape_t = tuple(int(s) for s in shape)
        n = math.prod(shape_t) if shape_t else 1
        ok = (len(shape_t) == 3 and n * 32 < 2**31
              and shape_t[0] % tz == 0 and shape_t[1] % ty == 0 and shape_t[2] % tx == 0)
        if not ok:
            rest.append((name, shape, dtype))
            continue
        groups.setdefault(shape_t, []).append(
            (str(name), shape_t, arena_core.dtype_name(dtype), n))
    buckets = []
    for shape_t in sorted(groups):
        n = math.prod(shape_t)
        for sub in arena_core.split_budget(groups[shape_t], n, elem_budget):
            buckets.append(arena_core.Bucket(
                n, tuple(e[0] for e in sub), tuple(e[1] for e in sub),
                tuple(e[2] for e in sub), tuple(e[3] for e in sub)))
    return buckets, rest
