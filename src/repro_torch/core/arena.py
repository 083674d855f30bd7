"""Device-resident stream arena: whole-pytree snapshot compression in
O(#buckets) kernel launches instead of O(#leaves) (the port of
``repro.core.arena``).

A snapshot's float leaves go to one of two routes:

* **kernel buckets** (codec ``arena-szk``): same-shape, TILE-aligned 3-D
  fields stack into a (B, Z, Y, X) megabatch and go through K8
  (:func:`repro_torch.kernels.sz_fused.fused_compress_batched`) in one
  launch per bucket, each row with its own guarded bound; row ``b``'s arena
  slice equals ``ops.sz_compress_kernel(leaf_b, eb)``'s tile-blocked
  stream.  :func:`szk_decompress_bucket` decodes a bucket with one K9
  launch;
* **flat buckets** (codec ``arena-sz``): every other float leaf flattens to
  a 1-D row in a bucket keyed by its padded row length ``P`` (``BLOCK``
  times the next power of two of its block count), and the bucket runs
  quantize + 1-D Lorenzo + zigzag + width + word-level pack batched over
  its rows (``bitpack.pack_codes_rows``), in plain PyTorch as the reference
  runs it in jnp.  Row ``b``'s stream equals ``sz.compress`` on the flat
  leaf.

Either way every row's stream compacts into one contiguous uint32 arena
with a single exclusive scan (``bitpack.compact_streams``), and the only
host sync of a snapshot is one ``used`` readback per bucket before one D2H
copy of the arena slice (:func:`to_host`, or :func:`to_host_async`, which
defers both to the checkpoint manager's drain thread).

ZFP is fixed-rate, so its arena needs no scan: leaf ``l`` owns words
``[ranges[l] * wpb, ranges[l + 1] * wpb)``; it runs through
:mod:`repro_torch.core.zfp` as in the reference, with no kernel.

The host format (:class:`HostArena`, :func:`payload_encode`) is the
reference's byte for byte, so either package restores the other's
snapshots.  Compressing functions run on CUDA unless ``device="cpu"`` is
passed.  :func:`sz_encode_rows` and :func:`sz_decode_rows` take the
reference's distribution hooks, which
:func:`repro_torch.dist.insitu.sharded_compress_arena` and
:func:`repro_torch.dist.insitu.sharded_decompress_arena` use for buckets of
leaves split over a mesh axis.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import bitpack
from repro_torch.core import sz as sz_core
from repro_torch.core import zfp as zfp_core
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

# Megabatch element budget per bucket launch: stacking multiplies every
# intermediate by the row count, so larger buckets split into chunks —
# still O(buckets) launches.
ROW_ELEM_BUDGET = 1 << 26

CODEC_SZ = "arena-sz"
CODEC_ZFP = "arena-zfp"
# Tile-blocked kernel streams: the CODEC_SZ arena + sidecar layout, but each
# row is the tile-major stream of the 3-D tile coder, decoded through the
# kernel path instead of the flat 1-D inverse Lorenzo.
CODEC_SZK = "arena-szk"


# ----------------------------------------------------------------- dtypes ---


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch or numpy dtype or a name ("float32",
    "bfloat16"): what manifests record, with no need for ``ml_dtypes``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return dtype
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name`."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


# ------------------------------------------------------------- planning ----


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One size bucket of a snapshot plan: the (B, P) launch signature plus
    the per-leaf descriptor sidecar (all static)."""

    padded: int  # P: row length, a BLOCK multiple (power-of-two blocks)
    names: tuple  # leaf names (tree key paths)
    shapes: tuple  # original leaf shapes
    dtypes: tuple  # original leaf dtype names (restore casts back)
    ns: tuple  # flat element counts

    @property
    def rows(self) -> int:
        return len(self.names)

    @property
    def nbytes_raw(self) -> int:
        return sum(math.prod(s) * torch_dtype(d).itemsize
                   for s, d in zip(self.shapes, self.dtypes))


def row_length(n: int) -> int:
    """Bucket key: pad ``ceil(n / BLOCK)`` blocks to the next power of two,
    which bounds both the padding waste (< 2x) and the bucket count."""
    nb = -(-n // bitpack.BLOCK)
    return bitpack.BLOCK << max(0, (nb - 1).bit_length())


def split_budget(group: list, row_len: int, elem_budget: int):
    """Split one bucket's entry list into megabatch chunks of at most
    ``max(1, elem_budget // row_len)`` rows (the chunking rule of every
    bucket planner)."""
    chunk = max(1, elem_budget // row_len)
    for s in range(0, len(group), chunk):
        yield group[s : s + chunk]


def plan_buckets(entries: Sequence[tuple], elem_budget: int = ROW_ELEM_BUDGET) -> list[Bucket]:
    """Group leaf descriptors ``(name, shape, dtype)`` into size buckets:
    insertion order within a bucket, buckets by ascending ``P``, and
    buckets past ``elem_budget`` elements split into chunks."""
    by_p: dict[int, list[tuple]] = {}
    for name, shape, dtype in entries:
        n = math.prod(shape) if len(shape) else 1
        by_p.setdefault(row_length(n), []).append(
            (str(name), tuple(int(s) for s in shape), dtype_name(dtype), n))
    out = []
    for p in sorted(by_p):
        for sub in split_budget(by_p[p], p, elem_budget):
            out.append(Bucket(p, tuple(e[0] for e in sub), tuple(e[1] for e in sub),
                              tuple(e[2] for e in sub), tuple(e[3] for e in sub)))
    return out


def is_float_leaf(leaf: Any) -> bool:
    """A tensor or array of a floating-point dtype (bfloat16 included)."""
    if not hasattr(leaf, "dtype"):
        return False
    try:
        return torch_dtype(dtype_name(leaf.dtype)).is_floating_point
    except (TypeError, ValueError):
        return False


def plan_for_tree(tree: Any, elem_budget: int = ROW_ELEM_BUDGET) -> list[Bucket]:
    """Bucket plan over every floating-point leaf of a tree, named by
    ``jax.tree_util.keystr`` paths (:mod:`repro_torch.tree`)."""
    entries = [(path, tuple(leaf.shape), leaf.dtype)
               for path, leaf in tree_util.tree_flatten_with_path(tree)[0] if is_float_leaf(leaf)]
    return plan_buckets(entries, elem_budget)


# ----------------------------------------------------------- device side ---


@dataclasses.dataclass
class SZArena:
    """One bucket's compressed megabatch.  Row ``b``'s stream is
    ``arena[offsets[b] : offsets[b] + counts[b]]``; ``used`` is the single
    scalar the host reads back before the one D2H copy of the arena slice."""

    arena: torch.Tensor  # uint32[capacity] contiguous streams, zeros past used
    widths: torch.Tensor  # uint8[B, P // BLOCK] block-width sidecar
    offsets: torch.Tensor  # int32[B] word offset of each row's stream
    counts: torch.Tensor  # int32[B] true payload words per row
    total_bits: torch.Tensor  # int32[B] per-row PackedCodes accounting
    eb_i: torch.Tensor  # float32[B] per-row internal (guarded) bounds
    used: torch.Tensor  # int32[] total arena words in use
    ns: tuple  # per-row flat element counts
    padded: int  # P


def _row_mask(padded: int, n: torch.Tensor) -> torch.Tensor:
    return torch.arange(padded, device=n.device)[None, :] < n[:, None]


def sz_encode_rows(rows: torch.Tensor, n: torch.Tensor, eb, capacity: int, *,
                   absmax=None, exchange=None):
    """Batched row codec: f32 [B, P] left-justified rows -> ``(arena,
    widths, offsets, counts, total_bits, eb_i, used)``.

    ``absmax`` and ``exchange`` are the distribution hooks
    (:func:`repro_torch.dist.insitu.sharded_compress_arena` passes both): the
    per-row |x|max reduced over the mesh, so every shard derives the same
    bound, and a callable ``exchange(last) -> prev`` that receives each row's
    last real quantum (int32 [B, 1]) and returns the left neighbour's (zeros
    at the mesh edge), one exchange for the whole bucket.  The defaults, the
    masked local max and a zero border, are the semantics of ``sz.compress``
    on the flat leaf."""
    mask = _row_mask(rows.shape[1], n)
    x = torch.where(mask, rows.to(torch.float32), 0.0)
    if absmax is None:
        absmax = x.abs().amax(dim=1)
    eb_i = sz_core.internal_bound(absmax, eb)  # [B]
    # divide, as sz.compress does (a reciprocal multiply differs in ulps)
    q = bitpack.round_i32(x / (2.0 * eb_i[:, None]))
    q = torch.where(mask, q, 0)
    prev = None
    if exchange is not None:
        last = q.gather(1, (n.to(torch.int64) - 1).clamp(min=0)[:, None])
        prev = exchange(last)  # [B, 1] from the left shard (zeros at the edge)
    if prev is None:
        prev = torch.zeros((rows.shape[0], 1), dtype=torch.int32, device=rows.device)
    shifted = torch.cat([prev.to(torch.int32), q[:, :-1]], dim=1)
    # the 1-D Lorenzo difference, wrapping as int32 does, padding zeroed
    delta = torch.where(mask, sz_core._wrap_i32(q.to(torch.int64) - shifted.to(torch.int64))
                        .to(torch.int32), 0)
    buf, counts, widths, total_bits = bitpack.pack_codes_rows(delta, n)
    arena, offsets, used = bitpack.compact_streams(buf, counts, capacity)
    return (arena, widths, offsets.to(torch.int32), counts, total_bits, eb_i,
            used.to(torch.int32))


def sz_decode_rows(arena: torch.Tensor, widths: torch.Tensor, offsets: torch.Tensor,
                   counts: torch.Tensor, eb_i: torch.Tensor, *, carry=None,
                   n=None) -> torch.Tensor:
    """Inverse of :func:`sz_encode_rows`: arena + sidecars -> f32 [B, P]
    rows (entries past each row's ``n`` are meaningless; callers slice).

    ``carry`` is the reconstruction-side distribution hook: a callable that
    receives each row's inclusive total after the local cumsum (int32
    [B, 1], taken at ``n - 1``, so ``n`` is required with it) and returns
    the exclusive cross-shard prefix to add; every add wraps as int32 does,
    so local cumsum + carry is bitwise the global cumsum.  ``None`` is the
    single-device case."""
    padded = widths.shape[1] * bitpack.BLOCK
    j = torch.arange(padded + 2, dtype=torch.int64, device=arena.device)
    idx = offsets.to(torch.int64)[:, None] + j[None, :]
    words = arena.view(torch.int32)
    vals = words[idx.clamp(0, words.shape[0] - 1)]
    buf = torch.where(j[None, :] < counts.to(torch.int64)[:, None], vals, 0)
    delta = bitpack.unpack_codes_rows(buf.view(torch.uint32), widths)
    q = sz_core.lorenzo_reconstruct(delta, ndim=1)  # int32 cumsum, wrapping
    if carry is not None:
        if n is None:
            raise ValueError("sz_decode_rows: carry= needs n=, the rows' lengths")
        totals = q.gather(1, (torch.as_tensor(n, device=q.device).to(torch.int64) - 1)
                          .clamp(min=0)[:, None])
        q = sz_core._wrap_i32(q.to(torch.int64) + carry(totals).to(torch.int64)).to(torch.int32)
    return q.to(torch.float32) * (2.0 * eb_i[:, None])


def _as_leaf(leaf, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(leaf).to(device)


def _stack_rows(leaves: Sequence, ns: Sequence[int], padded: int,
                device: torch.device) -> torch.Tensor:
    rows = torch.zeros(len(ns), padded, dtype=torch.float32, device=device)
    for b, (leaf, n) in enumerate(zip(leaves, ns)):
        rows[b, :n] = _as_leaf(leaf, device).reshape(-1)
    return rows


def sz_capacity(ns: Sequence[int]) -> int:
    """Static worst-case arena words for a bucket: each row stores at most
    ``min(2 * sum(width), n + 2)`` words (see ``bitpack.pack_codes_rows``)."""
    return int(sum(min(2 * 32 * (-(-n // bitpack.BLOCK)), n + 2) for n in ns))


def sz_compress_bucket(leaves: Sequence, bucket: Bucket, eb, *,
                       staged: bool = False,  # ignored: every call stages
                       device: str | torch.device | None = None) -> SZArena:
    """Compress a flat bucket's leaves into a device arena in one batched
    pass, on CUDA unless ``device="cpu"``.  ``eb`` is one bound, or a
    float32 tensor [B] with one per row (as the reference takes an array).

    Every call copies the leaves into a [B, P] buffer of its own, freed when
    the encode returns, so the caller may overwrite them the moment this
    returns: what the reference's ``staged=True`` buys with a donated
    staging buffer.  The keyword is accepted for the reference's API only
    (PyTorch has no donation, and both settings give the same arena)."""
    device = resolve_device(device)
    rows = _stack_rows(leaves, bucket.ns, bucket.padded, device)
    # a pinned, non-blocking copy: a pageable one would wait for the stream
    n = torch.tensor(bucket.ns, dtype=torch.int64,
                     pin_memory=device.type == "cuda").to(device, non_blocking=True)
    arena, widths, offsets, counts, total_bits, eb_i, used = sz_encode_rows(
        rows, n, eb, sz_capacity(bucket.ns))
    return SZArena(arena, widths, offsets, counts, total_bits, eb_i, used,
                   tuple(bucket.ns), bucket.padded)


def sz_decompress_bucket(a: SZArena, bucket: Bucket) -> list[torch.Tensor]:
    """Decode a flat bucket arena back to its leaves (shapes and dtypes from
    the bucket descriptors), on the arena's device."""
    rows = sz_decode_rows(a.arena, a.widths, a.offsets, a.counts, a.eb_i)
    return [rows[b, :n].reshape(s).to(torch_dtype(d))
            for b, (n, s, d) in enumerate(zip(a.ns, bucket.shapes, bucket.dtypes))]


# ------------------------------------------------- kernel (tile) buckets ----


def szk_compress_bucket(leaves: Sequence, bucket: Bucket, eb, *,
                        device: str | torch.device | None = None) -> SZArena:
    """One K8 launch for a shape-uniform bucket of 3-D TILE-aligned leaves,
    on CUDA unless ``device="cpu"``: row ``b``'s arena slice equals the
    tile-blocked stream of ``kernels.ops.sz_compress_kernel(leaf_b, eb)``
    (``eb`` one bound, or a float32 tensor [B] with one per row).
    The (B, Z, Y, X) stack is the snapshot's own staging copy."""
    from repro_torch.kernels import sz_fused as _szf  # core -> kernels only on use

    if len(set(bucket.shapes)) != 1:
        raise ValueError(f"kernel buckets are shape-uniform, got {set(bucket.shapes)}")
    device = resolve_device(device)
    x = torch.stack([_as_leaf(leaf, device).to(torch.float32) for leaf in leaves])
    # Each row's guarded bound from its own |x|max: lorenzo3d.guarded_eb on
    # the TILE-aligned (hence unpadded) field, so the streams match.
    eb_i = sz_core.internal_bound(x.abs().amax(dim=(1, 2, 3)), eb)
    arena, widths, offsets, counts, total_bits, used = _szf.fused_compress_batched(x, eb_i)
    n = math.prod(x.shape[1:])
    return SZArena(arena, widths, offsets, counts, total_bits, eb_i, used,
                   (n,) * x.shape[0], n)


def szk_decompress_bucket(a: SZArena, bucket: Bucket) -> list[torch.Tensor]:
    """One K9 launch: decode a kernel-bucket arena back to its 3-D leaves
    (inverse of :func:`szk_compress_bucket`), on the arena's device."""
    from repro_torch.kernels import sz_fused as _szf

    rows = _szf.fused_decompress_batched(a.arena, a.widths, tuple(bucket.shapes[0]), a.eb_i)
    return [rows[b].to(torch_dtype(d)) for b, d in enumerate(bucket.dtypes)]


# -------------------------------------------------------------- ZFP arena --


@dataclasses.dataclass
class ZFPArena:
    """Fixed-rate arena: every leaf's 4^3 blocks coded in one call.  Leaf
    ``l`` owns block rows ``[ranges[l], ranges[l+1])`` and therefore arena
    words ``[ranges[l] * wpb, ranges[l+1] * wpb)`` — offsets are analytic."""

    words: torch.Tensor  # uint32[NB * wpb] flat contiguous streams
    emax: torch.Tensor  # uint8[NB]
    gtops: torch.Tensor  # uint8[NB, 10]
    ranges: tuple  # per-leaf block starts, len = n_leaves + 1
    rate: int


def zfp_ranges(shapes: Sequence[tuple]) -> tuple:
    starts = [0]
    for s in shapes:
        starts.append(starts[-1] + zfp_core.n_blocks_for(s))
    return tuple(starts)


def zfp_compress_bucket(leaves: Sequence, rate: int, *,
                        device: str | torch.device | None = None) -> ZFPArena:
    """Fixed-rate compress any number of 3-D leaves in one coder call, on
    CUDA unless ``device="cpu"``.  Each leaf's slice equals
    ``zfp.compress(leaf, rate)``."""
    device = resolve_device(device)
    xs = [_as_leaf(leaf, device).to(torch.float32) for leaf in leaves]
    blocks = torch.cat([zfp_core._carve_blocks(x) for x in xs])
    u, emax, gtops = zfp_core.blocks_transform(blocks)
    words = zfp_core.encode_words(u, gtops, rate)
    return ZFPArena(words.reshape(-1), emax, gtops.to(torch.uint8),
                    zfp_ranges([tuple(x.shape) for x in xs]), rate)


def zfp_leaf_view(a: ZFPArena, i: int, shape) -> zfp_core.ZFPCompressed:
    """Descriptor-based view of leaf ``i``'s stream inside the arena."""
    b0, b1 = a.ranges[i], a.ranges[i + 1]
    wpb = zfp_core.payload_words(a.rate)
    return zfp_core.ZFPCompressed(a.words[b0 * wpb : b1 * wpb].reshape(-1, wpb),
                                  a.emax[b0:b1], a.gtops[b0:b1], tuple(shape), a.rate)


def zfp_decompress_bucket(a: ZFPArena, shapes: Sequence[tuple]) -> list[torch.Tensor]:
    """Decode every leaf of a fixed-rate arena in one coder call."""
    wpb = zfp_core.payload_words(a.rate)
    blocks = zfp_core.blocks_from_stream(a.words.reshape(-1, wpb), a.emax, a.gtops, a.rate)
    return [zfp_core._uncarve_blocks(blocks[a.ranges[i]:a.ranges[i + 1]], tuple(s))
            for i, s in enumerate(shapes)]


# -------------------------------------------------------------- host side --


@dataclasses.dataclass
class HostArena:
    """Host-side view of one bucket's arena: the compacted word buffer plus
    the per-leaf descriptor sidecar, per shard, as numpy arrays with the
    reference's dtypes (uint32 arena, uint8 widths, int32 offsets, counts
    and total_bits).  ``checkpoint.manager`` persists it as one
    ``arena_iNNNNN_sNNN.bin`` per shard.

    ``grid`` is the flat-axis shard count (1 on the single-device path); a
    snapshot of the reference's sharded arena stitches shard ``s``'s
    residual segments before one global inverse Lorenzo on restore."""

    codec: str  # CODEC_SZ or CODEC_SZK
    names: tuple
    shapes: tuple
    dtypes: tuple
    ns: tuple
    padded: int
    grid: int  # shards over the flat axis
    halo: bool  # rows saw true left borders at shard seams
    eb_i: list  # per-row internal bounds (global, shard-invariant)
    shards: list  # per shard: {"arena", "widths", "offsets", "counts", "total_bits"}

    @property
    def nbytes_raw(self) -> int:
        return sum(math.prod(s) * torch_dtype(d).itemsize
                   for s, d in zip(self.shapes, self.dtypes))

    def nbytes_stored(self) -> int:
        """Stored bytes including the descriptor sidecars, not just the word
        arena — the quantity the manager's payload writer charges."""
        return sum(int(np.asarray(a).nbytes) for sh in self.shards for a in sh.values())

    def accounting(self) -> dict:
        """Observatory record skeleton for this bucket: what is known at
        encode time (codec, field count, bound range, launches, raw bytes);
        the manager's drain thread adds the stored bytes and timings."""
        rec = {
            "kind": "arena", "codec": self.codec,
            "n_fields": len(self.names),
            "launches": 1,  # the whole bucket compressed in one launch
            "shards": len(self.shards),
            "raw_bytes": int(self.nbytes_raw),
        }
        ebs = [float(e) for e in self.eb_i]
        if ebs:
            rec["eb_min"] = min(ebs)
            rec["eb_max"] = max(ebs)
        return rec


def payload_encode(blobs: dict) -> bytes:
    """Named arrays -> one self-describing byte payload (json header +
    concatenated array bytes), byte for byte the reference's format."""
    header, parts = {}, []
    for name in sorted(blobs):
        a = np.asarray(blobs[name])
        b = a.tobytes()
        header[name] = {"dtype": str(a.dtype), "shape": list(a.shape), "len": len(b)}
        parts.append(b)
    hdr = json.dumps(header).encode()
    return len(hdr).to_bytes(4, "little") + hdr + b"".join(parts)


def payload_decode(payload: bytes) -> dict:
    """Inverse of :func:`payload_encode`; a short buffer (torn write,
    truncated file) is rejected with a clear error."""
    if len(payload) < 4:
        raise ValueError(f"truncated payload: {len(payload)} bytes, header length missing")
    hlen = int.from_bytes(payload[:4], "little")
    if 4 + hlen > len(payload):
        raise ValueError(f"truncated payload: header needs {4 + hlen} bytes, "
                         f"have {len(payload)}")
    header = json.loads(payload[4 : 4 + hlen])
    need = 4 + hlen + sum(int(m["len"]) for m in header.values())
    if len(payload) < need:
        raise ValueError(f"truncated payload: arrays need {need} bytes, have {len(payload)}")
    off = 4 + hlen
    out = {}
    for name in sorted(header):
        m = header[name]
        a = np.frombuffer(payload[off : off + m["len"]], np.dtype(m["dtype"])).reshape(m["shape"])
        out[name] = a.copy() if a.ndim else a.reshape(())[()]
        off += m["len"]
    return out


def _host_arena(a: SZArena, bucket: Bucket, halo: bool, codec: str, shard: dict,
                eb_i: np.ndarray) -> HostArena:
    return HostArena(codec, bucket.names, bucket.shapes, bucket.dtypes, bucket.ns, a.padded,
                     1, halo, [float(v) for v in eb_i], [shard])


def to_host(a: SZArena, bucket: Bucket, halo: bool = True, codec: str = CODEC_SZ) -> HostArena:
    """Pull a device arena to the host: one scalar readback (``used``), then
    one D2H copy of the live arena slice."""
    with obs_trace.span("arena.to_host", n_fields=len(bucket.names)):
        used = int(a.used)  # the single host sync
        shard = {
            "arena": bitpack.to_numpy(a.arena[:used]),  # the single arena D2H
            "widths": bitpack.to_numpy(a.widths),
            "offsets": bitpack.to_numpy(a.offsets.to(torch.int32)),
            "counts": bitpack.to_numpy(a.counts.to(torch.int32)),
            "total_bits": bitpack.to_numpy(a.total_bits.to(torch.int32)),
        }
    return _host_arena(a, bucket, halo, codec, shard, a.eb_i.cpu().numpy())


class PendingHostArena:
    """Deferred :class:`HostArena`: a thread-safe fetch-once handle.

    The checkpoint manager's drain thread resolves it, so the simulation
    thread never waits on the ``used`` readback or the arena D2H:
    ``result()`` performs them (exactly once, caching value or error) on
    whichever thread first asks.  The handle keeps the device arena alive
    until resolved."""

    def __init__(self, fetch: Callable[[], HostArena], names: tuple = ()):
        self._fetch = fetch
        self.names = tuple(names)  # leaf names, for accounting before fetch
        self._lock = threading.Lock()
        self._result: Optional[HostArena] = None
        self._error: Optional[BaseException] = None
        self._done = False

    def result(self) -> HostArena:
        with self._lock:
            if not self._done:
                try:
                    self._result = self._fetch()
                except BaseException as e:  # cached: every caller sees it
                    self._error = e
                finally:
                    self._fetch = None  # release the device-arena closure
                    self._done = True
            if self._error is not None:
                raise self._error
            return self._result


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def to_host_async(a: SZArena, bucket: Bucket, halo: bool = True,
                  codec: str = CODEC_SZ) -> PendingHostArena:
    """Non-blocking :func:`to_host`.  On CUDA it enqueues copies of ``used``
    and the sidecars into pinned host buffers on the current stream, behind
    the compression, records an event and returns: nothing here waits on
    the device.  ``result()`` (on the manager's drain thread) waits for the
    event, reads ``used`` and copies the arena slice, whose kernels have
    finished by then; the handle holds the device arena until it has."""
    if not a.arena.is_cuda:
        return PendingHostArena(lambda: to_host(a, bucket, halo, codec), names=bucket.names)
    side = {name: _pinned_copy(t) for name, t in (
        ("used", a.used), ("widths", a.widths), ("offsets", a.offsets), ("counts", a.counts),
        ("total_bits", a.total_bits), ("eb_i", a.eb_i))}
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(a.arena.device))

    def fetch() -> HostArena:
        with obs_trace.span("arena.to_host", n_fields=len(bucket.names)):
            done.synchronize()
            used = int(side["used"])
            with torch.cuda.device(a.arena.device):
                arena = bitpack.to_numpy(a.arena[:used])
            shard = {"arena": arena, **{k: bitpack.to_numpy(side[k]) for k in (
                "widths", "offsets", "counts", "total_bits")}}
        return _host_arena(a, bucket, halo, codec, shard, side["eb_i"].numpy())

    return PendingHostArena(fetch, names=bucket.names)


class SnapshotSlots:
    """Bounded pool of in-flight device snapshot buffers (default 2: one
    draining, one filling).  ``acquire()`` blocks the snapshot hook when
    every slot is occupied — the backpressure that keeps device memory for
    snapshots at O(slots x arena).  ``release()`` accepts (and ignores)
    positional args so it can be the manager's ``on_complete`` callback."""

    def __init__(self, slots: int = 2):
        self.slots = int(slots)
        self._sem = threading.BoundedSemaphore(self.slots)
        self._lock = threading.Lock()
        self._in_flight = 0

    def acquire(self) -> None:
        self._sem.acquire()
        with self._lock:
            self._in_flight += 1

    def release(self, *_args) -> None:
        with self._lock:
            self._in_flight -= 1
        self._sem.release()

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight


def leaf_stream(h: HostArena, b: int, shard: int = 0) -> dict:
    """Leaf ``b``'s stream slice + sidecar on shard ``shard`` (equals
    ``bitpack.to_storage`` of the per-leaf coder on the same row)."""
    sh = h.shards[shard]
    off, cnt = int(sh["offsets"][b]), int(sh["counts"][b])
    n_loc = int(h.ns[b]) // h.grid
    nb = -(-n_loc // bitpack.BLOCK) if n_loc else 0
    return {
        "words": sh["arena"][off : off + cnt],
        "widths": sh["widths"][b][:nb],
        "total_bits": int(sh["total_bits"][b]),
        "n": n_loc,
    }


def host_meta(h: HostArena) -> dict:
    """Manifest entry for a :class:`HostArena` leaf (sidecars live in the
    binary payloads, descriptors in the manifest)."""
    return {
        "codec": h.codec,
        "arena": {
            "names": list(h.names),
            "shapes": [list(s) for s in h.shapes],
            "dtypes": list(h.dtypes),
            "ns": list(h.ns),
            "padded": h.padded,
            "grid": h.grid,
            "halo": bool(h.halo),
            "eb_i": list(h.eb_i),
        },
    }


def _two_eb(eb_i: float, device: torch.device) -> torch.Tensor:
    # np.float32(2.0 * eb_i), as the reference scales
    return torch.tensor(np.float32(2.0 * eb_i), device=device)


def host_restore(meta: dict, payloads: list,
                 device: str | torch.device | None = None) -> dict:
    """Rebuild + decode every leaf of an arena bucket from its manifest
    descriptor index and per-shard payload bytes, on ``device`` (CUDA unless
    ``"cpu"``), without a mesh.  Returns ``{name: CPU tensor}`` in each
    leaf's manifest dtype (``torch.bfloat16`` included).

    ``arena-sz``: each leaf's per-shard residual segments are stitched, then
    one int32-wrapping inverse 1-D Lorenzo runs — equal to ``sz.decompress``
    of the per-leaf stream.  ``arena-szk``: each row decodes as the
    reference does, through ``ops.sz_decompress_kernel(path="xla")`` (K2 on
    CUDA).  A descriptor index that disagrees with its payloads raises
    ``ValueError`` before that leaf's device work; a kernel that fails to
    build or launch raises what it raised."""
    device = resolve_device(device)
    info = meta["arena"]
    grid = int(info["grid"])
    if len(payloads) != grid:
        # a sparse manifest must never leak a partial buffer into a leaf
        raise ValueError(f"arena leaf has {len(payloads)} shard payloads, needs {grid}")
    shards = [payload_decode(p) for p in payloads]
    if meta.get("codec") == CODEC_SZK:
        return _host_restore_szk(info, shards, device)
    out = {}
    for b, name in enumerate(info["names"]):
        n = int(info["ns"][b])
        _check_shape(name, info["shapes"][b], n)
        n_loc = n // grid
        nb = -(-n_loc // bitpack.BLOCK)
        segs = []
        for sh in shards:
            off, cnt = int(sh["offsets"][b]), int(sh["counts"][b])
            packed = bitpack.from_storage(sh["arena"][off : off + cnt], sh["widths"][b][:nb],
                                          n_loc, int(sh["total_bits"][b]), device=device)
            segs.append(bitpack.unpack_codes(packed))
        if not info["halo"]:
            # zero-border segments reconstruct shard-locally
            q = torch.cat([sz_core.lorenzo_reconstruct(s) for s in segs])
        else:
            # halo'd segments stitch into the global residual first
            q = sz_core.lorenzo_reconstruct(torch.cat(segs))
        x = q.to(torch.float32) * _two_eb(info["eb_i"][b], device)
        out[name] = x[:n].reshape(tuple(info["shapes"][b])).to(
            torch_dtype(info["dtypes"][b])).cpu()
    return out


def _check_shape(name: str, shape, n: int) -> None:
    if math.prod(shape) != n:
        raise ValueError(f"arena leaf {name}: shape {list(shape)} does not hold {n} values")


def _host_restore_szk(info: dict, shards: list, device: torch.device) -> dict:
    """Kernel-bucket (``arena-szk``) restore: each row is the tile-major
    stream of the 3-D tile coder, decoded through the kernel ``xla`` path."""
    from repro_torch.kernels import ops as kops  # core -> kernels only on use
    from repro_torch.kernels.lorenzo3d import TILE

    if int(info["grid"]) != 1:
        raise ValueError(f"arena-szk leaves are replicated-only; got grid={info['grid']}")
    sh = shards[0]
    out = {}
    for b, name in enumerate(info["names"]):
        n = int(info["ns"][b])
        shape = tuple(info["shapes"][b])
        _check_shape(name, shape, n)
        if len(shape) != 3 or any(s % t for s, t in zip(shape, TILE)):
            raise ValueError(f"arena-szk leaf {name} of shape {shape} is not TILE-aligned")
        nb = n // bitpack.BLOCK  # TILE-aligned rows have only full blocks
        off, cnt = int(sh["offsets"][b]), int(sh["counts"][b])
        packed = bitpack.from_storage(sh["arena"][off : off + cnt], sh["widths"][b][:nb], n,
                                      int(sh["total_bits"][b]), device=device)
        eb_i = torch.tensor(np.float32(info["eb_i"][b]), device=device)
        x = kops.sz_decompress_kernel(packed, shape, shape, eb_i, path="xla")
        out[name] = x.to(torch_dtype(info["dtypes"][b])).cpu()
    return out


# ------------------------------------------------------------ accounting ---


def arena_nbytes(a: SZArena) -> int:
    """True stored bytes across the bucket (sum of per-row accounting)."""
    bits = a.total_bits.to(torch.int64)
    return int(((bits + 7) // 8).sum())


def compression_ratio(a: SZArena, bucket: Bucket) -> float:
    return bucket.nbytes_raw / max(arena_nbytes(a), 1)
