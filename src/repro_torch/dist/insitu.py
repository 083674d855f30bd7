"""In-situ sharded field compression on ``torch.distributed`` (the port of
``repro.dist.insitu``): run TPU-SZ / TPU-ZFP *where the field lives*, one
shard per rank of a device mesh, with a halo exchange closing the seams.

The paper's premise is that cosmology fields are compressed at simulation
scale on the accelerators that produced them, not gathered to one host
first.  The reference runs one controller that sees every shard
(``shard_map``); ``torch.distributed`` runs one process per rank, so here
every call below that takes a mesh is a *collective*: each rank of the mesh
calls it with its own shard, and gets back its own part.

* The field partition comes from a spec (a tuple of mesh axis names per
  dimension, :mod:`repro_torch.dist.sharding`): a ``DTensor``'s own
  ``Shard`` placements, or the ``spec`` passed beside a rank's local shard,
  or :func:`repro_torch.dist.sharding.field_spec` of a ``DTensor`` that
  carries none.
* Each shard's order-1 Lorenzo predictor sees its **true left neighbours**:
  before differencing a partitioned axis, the running intermediate's last
  face (int32) goes one shard rightward by point-to-point send/recv on that
  mesh axis's group — exactly one face per partitioned axis.  Mesh-edge
  shards keep the implicit zero plane (the single-device boundary
  condition), and axes that are not partitioned (or of size 1) skip the
  exchange entirely.
* The only other collectives are a scalar ``all_reduce(MAX)`` (so every
  shard derives the same internal error bound from the *global* |x|max —
  an f32 max is exact under any grouping) and, on decompression, a log-step
  Hillis-Steele scan of faces that turns local prefix sums into the global
  inverse-Lorenzo cumsum (int32 addition is associative even under
  wraparound, and the port wraps every carry add as int32 does, so the
  result is *bitwise* the single-device cumsum).
* The raw field never leaves its rank: the encode is shard-local (the
  ``core`` formulation or the ``repro_torch.kernels.ops`` kernel paths), and
  :func:`to_host` gathers **compressed** per-shard payloads only.  Instead
  of the reference's HLO assertion, :data:`sent_bytes` counts what each
  rank sends: faces, scalars and compressed payloads.

The invariant (held by ``tests/test_torch_insitu.py`` and
``chip_smoke.py``): ``sharded_decompress(sharded_compress(x))`` is
**bitwise** the single-device ``decompress(compress(x))``, and the
per-shard streams reassemble without the mesh (:func:`host_decode`), which
lets ``checkpoint.manager`` restore them on another mesh or none.

ZFP needs no halo — its 4x4x4 blocks are self-contained — but every seam
must fall on a block boundary; misaligned shards are rejected
(:func:`repro_torch.core.zfp.shard_extent_aligned`, DESIGN.md §7).
Composed-axis partitions (one field dim over several mesh axes) are not
supported, as in the reference.

Backends follow the device: SZ ``auto`` is ``core`` (the reference's
choice), ZFP ``auto`` is the kernel on CUDA and ``core`` on the CPU.  Where
a mesh runs ``gloo`` over CUDA tensors (two ranks sharing one card, as
NCCL refuses), the faces and scalars cross through host copies, since gloo
sends and receives CPU tensors; the shard itself stays on its device.

The sharded arena (``ShardedSZArena``, ``plan_arena``) and the raw
mesh-sharded checkpoint leaf wait for the port's next dist slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import arena as arena_core
from repro_torch.core import bitpack
from repro_torch.core import sz as sz_core
from repro_torch.core import zfp as zfp_core
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shardlib
from repro_torch.kernels.lorenzo3d import TILE

# Bytes this process has sent since the last reset, by collective: halo and
# carry faces (``ppermute``), scalars (``all_reduce``: the global |x|max and
# the stored-bytes sum) and compressed payloads (``gather``, in ``to_host``).
sent_bytes = {"ppermute": 0, "all_reduce": 0, "gather": 0}


def reset_sent_bytes() -> None:
    for k in sent_bytes:
        sent_bytes[k] = 0


# ------------------------------------------------------------ partition ----


def _single_axis(ent):
    """A spec entry as one mesh axis name or ``None``; a composed tuple of
    several axes raises ``NotImplementedError`` (module docstring)."""
    if isinstance(ent, (tuple, list)):
        if len(ent) > 1:
            raise NotImplementedError(
                f"composed-axis field partition {ent} unsupported: the halo "
                "shift of a composed shard index needs a carry-propagating "
                "chain; shard each field dim over a single mesh axis")
        return ent[0] if ent else None
    return ent


def _entries(shape, spec) -> list:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than field rank {len(shape)}")
    return [_single_axis(e) for e in list(spec) + [None] * (len(shape) - len(spec))]


def partition_layout(shape: Sequence[int], spec, mesh) -> tuple:
    """Normalize a partition spec into a per-field-dim mesh-axis layout.

    Returns a tuple of length ``len(shape)`` whose entries are a mesh axis
    name (the dim is split over it) or ``None`` (replicated / absent /
    size-1 axis).  Composed tuples raise ``NotImplementedError`` (module
    docstring); non-divisible partitions raise ``ValueError``.
    """
    sizes = shardlib.mesh_sizes(mesh)
    out = []
    for dim, ent in zip(shape, _entries(shape, spec)):
        if ent is None or sizes.get(ent, 1) <= 1:
            out.append(None)
            continue
        n = sizes[ent]
        if dim % n:
            raise ValueError(f"dim {dim} not divisible by mesh axis {ent!r} ({n})")
        out.append(ent)
    return tuple(out)


def _local_shape(shape, layout, sizes) -> tuple:
    return tuple(d // (sizes[a] if a else 1) for d, a in zip(shape, layout))


def _grid(layout, sizes) -> tuple:
    return tuple(sizes[a] if a else 1 for a in layout)


def _stack_axes(layout) -> tuple:
    """Partitioned mesh axes in field-dim order (the reference's stacking
    order of per-shard streams; here the axes of the scalar reductions)."""
    return tuple(a for a in layout if a is not None)


# ----------------------------------------------------------- collectives ---


def _ring_perm(n: int) -> list:
    """One-face-rightward halo ring: shard ``i`` sends to ``i + 1``; shard 0
    has no source pair, so it receives zeros — the mesh-edge shard keeps the
    zero border for free."""
    return [(i, i + 1) for i in range(n - 1)]


def _scan_perms(n: int) -> list:
    """Hillis-Steele inclusive-scan schedule: ``(offset, perm)`` steps where
    ``perm`` ships shard ``i``'s partial to ``i + offset`` (receivers below
    the offset get zeros).  After all log2(n) steps every shard holds the
    inclusive prefix of the per-shard totals."""
    out, off = [], 1
    while off < n:
        out.append((off, [(i, i + off) for i in range(n - off)]))
        off *= 2
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DistOps:
    """The collectives of the halo machinery over a device mesh, one process
    per rank (the reference's ``_LaxOps``): ``ppermute`` is point-to-point
    send/recv on a mesh axis's group, ``pmax`` an ``all_reduce(MAX)`` over
    each named axis.  Tests substitute a stacked-tensor mock with the same
    two methods to run the machinery on one process."""

    def __init__(self, mesh):
        self.mesh = mesh

    @staticmethod
    def _via_host(group, t: torch.Tensor) -> bool:
        # gloo sends, receives and reduces CPU tensors: a face or scalar of
        # a CUDA shard crosses through an explicit host copy
        return t.device.type != "cpu" and dist.get_backend(group) == "gloo"

    def ppermute(self, x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
        """``x`` from shard ``s`` lands on shard ``d`` for each ``(s, d)``
        of ``perm`` along ``axis_name``; a shard that is no destination
        gets zeros."""
        group = self.mesh.get_group(axis_name)
        me = self.mesh.get_local_rank(axis_name)
        host = self._via_host(group, x)
        wire = x.contiguous().cpu() if host else x.contiguous()
        recv, p2p = None, []
        for s, d in perm:
            if s == me:
                p2p.append(dist.P2POp(dist.isend, wire, dist.get_global_rank(group, d), group))
                sent_bytes["ppermute"] += _nbytes(wire)
            if d == me:
                recv = torch.empty_like(wire)
                p2p.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, s), group))
        if p2p:  # one batch, so no rank's send waits on its own receive
            for r in dist.batch_isend_irecv(p2p):
                r.wait()
        if recv is None:
            return torch.zeros_like(x)
        return recv.to(x.device) if host else recv

    def pmax(self, x: torch.Tensor, axis_names) -> torch.Tensor:
        return self._reduce(x, axis_names, dist.ReduceOp.MAX)

    def psum(self, x: torch.Tensor, axis_names) -> torch.Tensor:
        return self._reduce(x, axis_names, dist.ReduceOp.SUM)

    def _reduce(self, x: torch.Tensor, axis_names, op) -> torch.Tensor:
        for name in axis_names:
            group = self.mesh.get_group(name)
            host = self._via_host(group, x)
            buf = x.detach().cpu().clone() if host else x.detach().clone()
            dist.all_reduce(buf, op=op, group=group)
            sent_bytes["all_reduce"] += _nbytes(buf)
            x = buf.to(x.device) if host else buf
        return x


def halo_exchange(layout, sizes, ops):
    """Border-override hook for :func:`repro_torch.core.sz.lorenzo_residual`:
    ship the intermediate's last face one shard rightward along each
    partitioned axis (one exchange per face); ``None`` for non-partitioned
    axes keeps the zero border and skips the exchange."""

    def exchange(field_axis, last_plane):
        name = layout[field_axis]
        if name is None or sizes[name] <= 1:
            return None
        return ops.ppermute(last_plane, name, _ring_perm(sizes[name]))

    return exchange


def carry_exchange(layout, sizes, ops):
    """Reconstruction-side hook for
    :func:`repro_torch.core.sz.lorenzo_reconstruct`: given the shard's
    inclusive total face (int32) after the local cumsum, return the carry
    (the exclusive cross-shard scan of those totals) via the log-step
    schedule, every add wrapping as int32 addition does."""

    def exchange(field_axis, total_plane):
        name = layout[field_axis]
        if name is None or sizes[name] <= 1:
            return None
        total = total_plane.to(torch.int64)
        inc = total
        for _off, perm in _scan_perms(sizes[name]):
            got = ops.ppermute(inc.to(torch.int32), name, perm)
            inc = sz_core._wrap_i32(inc + got.to(torch.int64))
        return sz_core._wrap_i32(inc - total).to(torch.int32)  # exclusive prefix

    return exchange


# -------------------------------------------------------------- streams ----


@dataclasses.dataclass
class ShardedSZStream:
    """This rank's TPU-SZ stream of a sharded field (the reference stacks
    every shard's on a leading axis; here each rank holds its own)."""

    words: torch.Tensor  # uint32[cap] worst-case packed buffer
    widths: torch.Tensor  # uint8[n_blocks]
    total_bits: torch.Tensor  # int64[]
    eb: torch.Tensor  # float32[] internal bound (global, from the all-reduced |x|max)
    shape: tuple  # global field shape
    layout: tuple  # per-dim mesh axis name or None
    grid: tuple  # shards per field dim
    halo: bool  # predictor saw true neighbours (vs zero borders)
    backend: str  # "core" (global Lorenzo + halo) | "kernel" (tile-blocked)
    position: tuple  # this shard's index in the grid
    mesh: Any


@dataclasses.dataclass
class ShardedZFPStream:
    """This rank's fixed-rate TPU-ZFP stream of a sharded field."""

    words: torch.Tensor  # uint32[n_blocks, words_per_block]
    emax: torch.Tensor  # uint8[n_blocks]
    gtops: torch.Tensor  # uint8[n_blocks, 10]
    shape: tuple
    layout: tuple
    grid: tuple
    rate: int
    position: tuple
    mesh: Any


def stream_nbytes(stream) -> int:
    """True stored bytes across all shards (the ratio-accounting figure).
    For SZ a collective: a scalar sum over the partitioned mesh axes."""
    if isinstance(stream, ShardedSZStream):
        mine = (stream.total_bits.to(torch.int64) + 7) // 8
        return int(DistOps(stream.mesh).psum(mine, _stack_axes(stream.layout)))
    n_blocks = int(stream.words.shape[0])
    return math.prod(stream.grid) * ((n_blocks * stream.rate * 64 + 7) // 8)


def compression_ratio(stream) -> float:
    raw = 4.0 * float(math.prod(stream.shape))
    return raw / max(stream_nbytes(stream), 1)


# ------------------------------------------------------------- compress ----


def _check_mesh_device(mesh, t: torch.Tensor) -> None:
    if mesh.device_type != t.device.type:
        raise ValueError(f"mesh on {mesh.device_type!r}, field on {t.device}: a sharded "
                         "call runs where its shard lives")


def _local_field(field, mesh, spec):
    """(this rank's shard, the global shape, the spec) from a ``DTensor``
    or from a local shard plus its spec."""
    if hasattr(field, "to_local") and hasattr(field, "device_mesh"):
        if field.device_mesh != mesh:
            raise ValueError("the DTensor lives on another mesh")
        own = shardlib.spec_of(field)
        if spec is None:
            spec = own
        elif partition_layout(field.shape, spec, mesh) != partition_layout(field.shape, own, mesh):
            raise ValueError(f"spec {tuple(spec)} disagrees with the DTensor's placements {own}")
        return field.to_local(), tuple(field.shape), spec
    if spec is None:
        raise ValueError("a local shard needs spec=; or pass a DTensor")
    sizes = shardlib.mesh_sizes(mesh)
    shape = tuple(ext * (sizes.get(ent, 1) if ent else 1)
                  for ext, ent in zip(field.shape, _entries(field.shape, spec)))
    return field, shape, spec


def _position(mesh, layout) -> tuple:
    return tuple(mesh.get_local_rank(a) if a else 0 for a in layout)


def sharded_compress(field, codec: str, mesh, spec=None, *, eb=None,
                     rate: Optional[int] = None, halo: bool = True,
                     backend: str = "auto", path: str = "auto"):
    """Compress a mesh-sharded field shard-locally; no raw field crosses
    ranks.  A collective: every rank of ``mesh`` calls it, with a
    ``DTensor`` (its placements give the spec) or with its local shard and
    the ``spec``; each gets back its own shard's stream.

    ``codec`` is ``"sz"`` (error-bounded, needs ``eb=``) or ``"zfp"``
    (fixed-rate, needs ``rate=``).

    SZ backends:
      * ``"core"`` (``auto``) — global-Lorenzo formulation with the halo
        exchange; bitwise the single-device ``core.sz`` stream.
      * ``"kernel"`` — the tile-blocked ``repro_torch.kernels.ops`` path
        (``path=fused|xla|auto``: K3 on CUDA); prediction resets at tile
        borders, so no halo is needed, but every local extent must be a
        multiple of the (8, 64, 128) tile.  Bitwise the single-device kernel
        path.
    ``halo=False`` (core backend only) keeps the zero border at every seam:
    each shard decodes alone, but the stitched global reconstruction breaks
    the bound.

    ZFP ``backend``: ``auto`` is the kernel on CUDA (K6), ``core``
    elsewhere; every ZFP path emits the same stream.
    """
    local, shape, spec = _local_field(field, mesh, spec)
    _check_mesh_device(mesh, local)
    sizes = shardlib.mesh_sizes(mesh)
    layout = partition_layout(shape, spec, mesh)
    want = _local_shape(shape, layout, sizes)
    if tuple(local.shape) != want:
        raise ValueError(f"local shard {tuple(local.shape)} is not {want} of {shape} over {layout}")
    stack = _stack_axes(layout)
    grid = _grid(layout, sizes)

    if codec == "sz":
        if eb is None:
            raise ValueError("SZ requires eb=")
        if backend == "auto":
            backend = "core"
        if backend not in ("core", "kernel"):
            raise ValueError(f"unknown SZ backend {backend!r}; want core|kernel")
        if backend == "kernel":
            if len(want) != 3:
                raise ValueError("SZ kernel backend operates on 3-D fields")
            # every local extent must be a tile multiple — partitioned axes
            # because per-tile prediction must not straddle the seam, and
            # the others because the per-shard stream carries no padded shape
            for ext, ax, tile in zip(want, layout, TILE):
                if ext % tile:
                    raise ValueError(
                        f"SZ kernel backend: shard extent {ext} (axis {ax!r}) "
                        f"not a multiple of the {TILE} tile")
        x = local.to(torch.float32)
        ops = DistOps(mesh)
        m = x.abs().amax()
        if stack:
            m = ops.pmax(m, stack)
        eb_i = sz_core.internal_bound(m, eb)
        if backend == "kernel":
            from repro_torch.kernels import ops as kops

            packed, _, _ = kops.sz_compress_kernel(x, eb, path=path, eb_i=eb_i)
        else:
            q = bitpack.round_i32(x / (2.0 * eb_i))
            ex = halo_exchange(layout, sizes, ops) if halo else None
            delta = sz_core.lorenzo_residual(q, exchange=ex)
            packed = bitpack.pack_codes(delta.reshape(-1))
        return ShardedSZStream(packed.words, packed.widths, packed.total_bits, eb_i, shape,
                               layout, grid, bool(halo) if backend == "core" else True,
                               backend, _position(mesh, layout), mesh)

    if codec == "zfp":
        if rate is None:
            raise ValueError("ZFP requires rate=")
        if len(want) != 3:
            raise ValueError("ZFP operates on 3-D fields; reshape first "
                             "(the HACC 1-D layout is (N/64, 8, 8))")
        if backend not in ("auto", "core", "kernel"):
            raise ValueError(f"unknown ZFP backend {backend!r}; want auto|core|kernel")
        for ext, ax in zip(want, layout):
            if not zfp_core.shard_extent_aligned(ext, sizes.get(ax, 1) if ax else 1):
                raise ValueError(
                    f"ZFP shard extent {ext} on axis {ax!r} not a multiple of "
                    f"{zfp_core.BLOCK_SIDE}: a seam inside a 4^3 block would "
                    "change the stream (DESIGN.md §7)")
        x = local.to(torch.float32)
        if backend == "kernel" or (backend == "auto" and x.device.type == "cuda"):
            from repro_torch.kernels import ops as kops

            c = kops.zfp_compress_kernel(x, rate, path=path)
        else:
            c = zfp_core.compress(x, rate)
        return ShardedZFPStream(c.words, c.emax, c.gtops, shape, layout, grid, rate,
                                _position(mesh, layout), mesh)

    raise ValueError(f"unknown codec {codec!r}; want sz|zfp")


def _as_dtensor(local: torch.Tensor, mesh, layout, shape):
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, shardlib.placements(layout, mesh), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def sharded_decompress(stream, mesh):
    """Inverse of :func:`sharded_compress` on the same mesh (a collective):
    per-shard decode + the carry scan, returning the global field as a
    ``DTensor`` sharded as the original.  Bitwise the single-device
    ``decompress(compress(x))`` when the stream was built with
    ``halo=True``."""
    _check_mesh_device(mesh, stream.words)
    sizes = shardlib.mesh_sizes(mesh)
    layout = stream.layout
    local = _local_shape(stream.shape, layout, sizes)
    if isinstance(stream, ShardedSZStream):
        packed = bitpack.PackedCodes(stream.words, stream.widths, stream.total_bits,
                                     math.prod(local))
        if stream.backend == "kernel":
            from repro_torch.kernels import ops as kops

            x = kops.sz_decompress_kernel(packed, local, local, stream.eb)
        else:
            delta = bitpack.unpack_codes(packed).reshape(local)
            ex = carry_exchange(layout, sizes, DistOps(mesh)) if stream.halo else None
            q = sz_core.lorenzo_reconstruct(delta, exchange=ex)
            x = q.to(torch.float32) * (2.0 * stream.eb)
        return _as_dtensor(x, mesh, layout, stream.shape)
    c = zfp_core.ZFPCompressed(stream.words, stream.emax, stream.gtops, local, stream.rate)
    # every ZFP path reads the others' streams: decode picks the kernel on CUDA
    if stream.words.device.type == "cuda":
        from repro_torch.kernels import ops as kops

        x = kops.zfp_decompress_kernel(c)
    else:
        x = zfp_core.decompress(c)
    return _as_dtensor(x, mesh, layout, stream.shape)


# ------------------------------------------------------------ host side ----


@dataclasses.dataclass
class HostShardedStream:
    """Host-side view of a sharded stream: per-shard compressed payloads +
    index slices, no raw field.  ``checkpoint.manager`` treats it as a
    single leaf and persists each shard with its ``leaf_i_sNNN.bin``
    writer."""

    codec: str  # "insitu-sz" | "insitu-zfp"
    shape: tuple  # global field shape
    local_shape: tuple
    grid: tuple  # shards per field dim (np.ndindex order)
    halo: bool
    backend: str
    params: dict  # {"eb_i": float} | {"rate": int}
    shards: list  # [(((start, stop), ...), {name: np.ndarray}), ...]

    @property
    def nbytes_raw(self) -> int:
        return int(np.prod(self.shape)) * 4

    def accounting(self) -> dict:
        """Observatory record skeleton for this in-situ field (DESIGN.md
        §11): codec, backend, shard grid, the error bound or rate it was
        compressed with, raw bytes.  The checkpoint manager adds stored
        bytes + wall when it persists the shards."""
        rec = {
            "kind": "insitu", "codec": self.codec, "backend": self.backend,
            "launches": 1,  # one sharded compress per field
            "shards": len(self.shards),
            "raw_bytes": int(self.nbytes_raw),
        }
        if "eb_i" in self.params:
            rec["eb_min"] = rec["eb_max"] = float(self.params["eb_i"])
        if "rate" in self.params:
            rec["rate"] = int(self.params["rate"])
        return rec


def _shard_indices(shape, grid):
    local = tuple(s // g for s, g in zip(shape, grid))
    for pos in np.ndindex(*grid):
        yield tuple((p * l, (p + 1) * l) for p, l in zip(pos, local))


def _shard_blobs(stream) -> dict:
    """This rank's compressed payload, sliced to its true length (the
    ``bitpack.to_storage`` contract)."""
    if isinstance(stream, ShardedSZStream):
        bits = int(stream.total_bits)
        n_words = (bits - stream.widths.shape[0] * 8 + 31) // 32
        return {"words": bitpack.to_numpy(stream.words[:n_words]).copy(),
                "widths": bitpack.to_numpy(stream.widths).copy(),
                "total_bits": np.int32(bits)}
    return {"words": bitpack.to_numpy(stream.words).copy(),
            "emax": bitpack.to_numpy(stream.emax).copy(),
            "gtops": bitpack.to_numpy(stream.gtops).copy()}


def to_host(stream) -> Optional[HostShardedStream]:
    """Gather the shards' **compressed** payloads to the mesh's first rank
    (a collective; the mesh must span the process group).  Returns the
    :class:`HostShardedStream` there, in ``np.ndindex(grid)`` order, and
    ``None`` on every other rank."""
    grid = tuple(stream.grid)
    local = tuple(s // g for s, g in zip(stream.shape, grid))
    mine = (int(np.ravel_multi_index(stream.position, grid)), _shard_blobs(stream))
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = stream.mesh.mesh.flatten().tolist()
    if len(ranks) != world:
        raise ValueError(f"the mesh holds {len(ranks)} of {world} ranks; to_host gathers "
                         "over the whole process group")
    if world == 1:
        got = [mine]
    else:
        dst = ranks[0]
        got = [None] * world if dist.get_rank() == dst else None
        if dist.get_rank() != dst:
            sent_bytes["gather"] += sum(a.nbytes for a in mine[1].values())
        dist.gather_object(mine, got, dst=dst)
        if got is None:
            return None
    by_shard: dict[int, dict] = {}
    for s, blobs in got:
        by_shard.setdefault(s, blobs)  # ranks along replicated axes hold copies
    idx = list(_shard_indices(stream.shape, grid))
    shards = [(idx[s], by_shard[s]) for s in range(len(idx))]
    if isinstance(stream, ShardedSZStream):
        return HostShardedStream("insitu-sz", stream.shape, local, grid, stream.halo,
                                 stream.backend, {"eb_i": float(stream.eb)}, shards)
    return HostShardedStream("insitu-zfp", stream.shape, local, grid, True, "any",
                             {"rate": int(stream.rate)}, shards)


def host_decode(hss: HostShardedStream, device: str | torch.device | None = None) -> torch.Tensor:
    """Reassemble + decode a host stream without the mesh (the elastic
    restore path), on ``device`` (CUDA unless ``"cpu"``): stitch per-shard
    residual/coefficient planes, then run the *global* inverse — bitwise
    both the sharded and the single-device decode for halo streams.
    Returns a float32 CPU tensor."""
    device = resolve_device(device)
    shape = tuple(hss.shape)
    if hss.codec == "insitu-zfp":
        out = torch.empty(shape, dtype=torch.float32)
        rate = int(hss.params["rate"])
        for idx, blobs in hss.shards:
            local = tuple(e - s for s, e in idx)
            c = zfp_core.from_words(blobs["words"], blobs["emax"], blobs["gtops"], local, rate,
                                    device=device)
            out[tuple(slice(s, e) for s, e in idx)] = zfp_core.decompress(c).cpu()
        return out
    eb_i = torch.tensor(np.float32(hss.params["eb_i"]), device=device)
    if hss.backend == "kernel" or not hss.halo:
        # tile-blocked / zero-border streams decode shard-locally
        out = torch.empty(shape, dtype=torch.float32)
        for idx, blobs in hss.shards:
            local = tuple(e - s for s, e in idx)
            packed = _rebuild_packed(blobs, math.prod(local), device)
            if hss.backend == "kernel":
                from repro_torch.kernels import ops as kops

                x = kops.sz_decompress_kernel(packed, local, local, eb_i)
            else:
                delta = bitpack.unpack_codes(packed).reshape(local)
                x = sz_core.lorenzo_reconstruct(delta).to(torch.float32) * (2.0 * eb_i)
            out[tuple(slice(s, e) for s, e in idx)] = x.cpu()
        return out
    delta = torch.empty(shape, dtype=torch.int32, device=device)
    for idx, blobs in hss.shards:
        local = tuple(e - s for s, e in idx)
        packed = _rebuild_packed(blobs, math.prod(local), device)
        delta[tuple(slice(s, e) for s, e in idx)] = bitpack.unpack_codes(packed).reshape(local)
    q = sz_core.lorenzo_reconstruct(delta)
    return (q.to(torch.float32) * (2.0 * eb_i)).cpu()


# One wire format for every compressed shard payload (per-leaf streams here,
# bucket arenas in ``core.arena``): json header + concatenated array bytes.
shard_payload_encode = arena_core.payload_encode
shard_payload_decode = arena_core.payload_decode


def host_stream_meta(hss: HostShardedStream) -> dict:
    """Manifest entry fields for a :class:`HostShardedStream` leaf."""
    return {
        "shape": list(hss.shape),
        "dtype": "float32",
        "codec": hss.codec,
        "insitu": {"local_shape": list(hss.local_shape),
                   "grid": list(hss.grid), "halo": bool(hss.halo),
                   "backend": hss.backend, "params": hss.params},
    }


def host_restore(meta: dict, payloads: list,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Rebuild + decode from manifest metadata and per-shard payload bytes
    (what ``checkpoint.manager.restore`` read back), without the mesh, on
    ``device`` (CUDA unless ``"cpu"``).  Returns a float32 CPU tensor."""
    info = meta["insitu"]
    shape = tuple(meta["shape"])
    grid = tuple(info["grid"])
    n_shards = int(np.prod(grid))
    if len(payloads) != n_shards:
        # a sparse manifest (partial write, one process of a multi-process
        # mesh) must never leak an empty buffer through the stitched field
        raise IOError(f"insitu leaf has {len(payloads)} shard payloads, "
                      f"grid {grid} needs {n_shards}")
    shards = [(idx, shard_payload_decode(p))
              for idx, p in zip(_shard_indices(shape, grid), payloads)]
    hss = HostShardedStream(meta["codec"], shape, tuple(info["local_shape"]),
                            grid, bool(info["halo"]), info["backend"],
                            dict(info["params"]), shards)
    return host_decode(hss, device=device)


def _rebuild_packed(blobs: dict, n: int, device) -> bitpack.PackedCodes:
    return bitpack.from_storage(blobs["words"], blobs["widths"], n,
                                int(blobs["total_bits"]), device=device)


# ------------------------------------------------------- snapshot buckets --


def plan_kernel_buckets(entries: Sequence[tuple],
                        elem_budget: int = arena_core.ROW_ELEM_BUDGET):
    """Carve out the leaves the fused tile kernel (K8) batches: 3-D,
    TILE-aligned, small enough for the kernel's int32 bit offsets.
    ``entries`` are ``(name, shape, dtype)``, every leaf replicated (the
    sharded form waits for the port's sharded arena).  Returns
    ``(buckets, rest)``: shape-uniform :class:`repro_torch.core.arena.Bucket`
    groups (``padded == n``: tile rows carry no pad) for
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
