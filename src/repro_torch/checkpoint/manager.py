"""Checkpointing with optional error-bounded lossy compression — the
paper's snapshot-I/O use case (the port of ``repro.checkpoint.manager``).

Layout (one directory per step, atomic rename on completion), the
reference's byte for byte, so either package restores the other's
snapshots given the same ``state_like``:

    ckpt_dir/step_000123/
        MANIFEST.json          tree structure, shapes, dtypes, crc32 per
                               payload, codec + error bound per leaf, extra,
                               and a digest of the whole body, written last
        leaf_00000.bin         a raw leaf (its bytes; bf16 as its bits) or a
                               TPU-SZ stream (``sz_abs`` / ``sz_pwrel``)
        arena_00001_s000.bin   one arena bucket (``core.arena.HostArena``):
                               every leaf of the bucket in one payload per
                               shard, its descriptor index in the manifest
        leaf_00002_s000.bin    one shard of an in-situ sharded stream
                               (``dist.insitu.HostShardedStream``, codec
                               ``insitu-sz`` / ``insitu-zfp``) or of a raw
                               mesh-sharded leaf (a ``DTensor``, encoded with
                               the policy), its index slice in the manifest
        obs_i000000123.json    the observatory record (advisory)

Each payload may be zstd-compressed when ``zstandard`` imports
(``CodecPolicy.zstd_level > 0``).  Design points, as in the reference:

  * async save: raw leaves are copied to the host on the caller thread (the
    caller may overwrite them next); arena buckets arrive as
    ``PendingHostArena`` handles whose device buffers the snapshot owns, so
    their D2H resolves on the persistent drain thread, which also encodes
    and writes every payload.  A bounded queue (``max_in_flight``) gives
    backpressure; a drain failure re-raises on the next ``save()`` or
    ``wait()``, and transient ``OSError``s are retried with backoff;
  * per-shard leaves: a ``DTensor`` split over a mesh is never assembled.
    With one process per rank, :meth:`CheckpointManager.save` is a
    collective once a leaf is split: every rank saves the same tree, each
    encodes the unique shards it holds (one copy of a replicated shard) on
    its drain thread, and the group's first rank gathers the payloads and
    writes every file in the reference's sorted shard order; the other ranks
    write nothing;
  * atomic finalization: payloads are written + fsync'd into a tmp dir, the
    manifest last, then the dir renames into place;
  * integrity: crc32 per payload + the manifest digest, verified before any
    byte reaches a leaf; a corrupt step is quarantined by
    :meth:`CheckpointManager.restore_latest_valid`;
  * keep_last: bounded disk usage.

Restored leaves are CPU tensors in their manifest dtype (an arena leaf is a
``{name: tensor}`` dict), or, with ``shardings=``, ``DTensor`` leaves on the
meshes it names (which need not be the mesh that saved the step);
compressed payloads decode on the manager's device, CUDA unless
``device="cpu"``.  An in-situ leaf restores through
``dist.insitu.host_restore``, which needs no mesh.  One departure from the
reference: a zstd-compressed single leaf is expanded once on restore (the
reference expands it twice and fails, ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import queue
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core import arena, bitpack, sz, transforms
from repro_torch.core.api import get_compressor
from repro_torch.device import resolve_device
from repro_torch.dist import insitu
from repro_torch.dist import sharding as shardlib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import observatory as obs_observatory
from repro_torch.obs import trace as obs_trace

_log = logging.getLogger("repro_torch.checkpoint")

# Leaf dtypes the lossy codecs take (as the reference's float32, bfloat16
# and float16).
_LOSSY_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# What a payload's content can raise once its CRC has passed: a descriptor
# index and a payload that disagree (the decoders check lengths and shapes
# before any device work).  A kernel library that fails to build or load
# (RuntimeError, OSError), a failed launch or an exhausted device is no
# corruption: it propagates, and nothing is quarantined for it.
_PAYLOAD_ERRORS = (ValueError, IndexError, KeyError, TypeError, OverflowError)

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None


class SnapshotCorruptionError(IOError):
    """A snapshot failed verification (manifest digest, per-payload CRC, or
    payload decode).  Names the offending payload so operators — and the
    supervisor's fallback — know exactly which bytes went bad.  Subclasses
    ``IOError`` so pre-existing ``except IOError`` callers keep working."""

    def __init__(self, msg: str, *, step: Optional[int] = None,
                 payload: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.payload = payload  # file name inside the step dir


@dataclasses.dataclass(frozen=True)
class CodecPolicy:
    mode: str = "none"  # none | sz_abs | sz_pwrel | zfp_rate
    eb: float = 1e-4  # abs bound or pw_rel bound
    rate: int = 8  # zfp bits/value
    min_bytes: int = 1 << 20  # only compress leaves at least this large
    zstd_level: int = 3  # lossless stage on the storage path (host side)


@dataclasses.dataclass
class SaveResult:
    step: int
    path: Path
    nbytes_raw: int
    nbytes_stored: int
    # transient-I/O retries the drain worker spent before this save landed
    # (0 on a clean write) — visible so tests and fleet telemetry can tell
    # "survived a flaky disk" from "never saw one"
    retries: int = 0

    @property
    def ratio(self) -> float:
        return self.nbytes_raw / max(self.nbytes_stored, 1)


def _crc(buf: bytes) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _write_bytes(path: Path, data: bytes) -> None:
    """Write + flush + fsync one payload file.  Module-level so the
    kill-mid-write tests can fault-inject a failing disk."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _leaf_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in C order (a bf16 leaf as its bits), as
    numpy's ``tobytes`` gives them."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _leaf_from_bytes(payload: bytes, dtype: str, shape: tuple) -> torch.Tensor:
    dt = arena.torch_dtype(dtype)
    need = math.prod(shape) * dt.itemsize
    if len(payload) != need:
        raise ValueError(f"raw payload holds {len(payload)} bytes, {dtype}{list(shape)} "
                         f"needs {need}")
    raw = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    return raw.view(dt).reshape(shape)


def _encode_leaf(arr: torch.Tensor, policy: CodecPolicy,
                 device: torch.device) -> tuple[bytes, dict]:
    """Returns (payload bytes, leaf manifest entry) for a host tensor; the
    lossy codecs run on ``device``."""
    meta: dict[str, Any] = {"shape": list(arr.shape), "dtype": arena.dtype_name(arr.dtype)}
    raw = _leaf_bytes(arr)
    lossy = (
        policy.mode != "none"
        and arr.dtype in _LOSSY_DTYPES
        and len(raw) >= policy.min_bytes
        and arr.ndim >= 1
    )
    if lossy:
        comp = get_compressor("tpu-sz", device=device)
        x = arr.to(torch.float32).reshape(-1)
        if policy.mode == "sz_pwrel":
            r = comp.compress(x, pw_rel=policy.eb)
        else:
            r = comp.compress(x, eb=policy.eb)
        parts = []
        for c in r.payload["parts"]:
            st = bitpack.to_storage(c.packed)
            parts.append({
                "words": st["words"].tobytes(),
                "widths": st["widths"].tobytes(),
                "n": int(st["n"]),
                "eb": float(c.eb),
                "shape3d": list(c.shape),
            })
        signs = r.payload["signs"]
        blob_items = []
        header = {
            "codec": policy.mode,
            "orig_len": r.payload["orig_len"],
            "was_1d": r.payload["was_1d"],
            "mode": r.meta["mode"],
            "parts": [],
        }
        for p in parts:
            header["parts"].append({
                "n": p["n"], "eb": p["eb"], "shape3d": p["shape3d"],
                "words_len": len(p["words"]), "widths_len": len(p["widths"]),
            })
            blob_items.append(p["words"])
            blob_items.append(p["widths"])
        if signs is not None:
            sb = signs.to(torch.int8).cpu().numpy().tobytes()
            header["signs_len"] = len(sb)
            blob_items.append(sb)
        hdr = json.dumps(header).encode()
        payload = len(hdr).to_bytes(8, "little") + hdr + b"".join(blob_items)
        meta["codec"] = policy.mode
        meta["eb"] = policy.eb
    else:
        payload = raw
        meta["codec"] = "raw"
    if _zstd is not None and policy.zstd_level > 0:
        payload = _zstd.ZstdCompressor(level=policy.zstd_level).compress(payload)
        meta["zstd"] = True
    meta["crc32"] = _crc(payload)
    meta["stored_bytes"] = len(payload)
    meta["raw_bytes"] = len(raw)
    return payload, meta


def _decode_leaf(payload: bytes, meta: dict, device: torch.device) -> torch.Tensor:
    """Inverse of :func:`_encode_leaf` on a payload that
    :meth:`CheckpointManager._read_payload` has verified and, if it was
    zstd-compressed, expanded: a CPU tensor of the leaf's dtype."""
    shape = tuple(meta["shape"])
    if meta["codec"] == "raw":
        return _leaf_from_bytes(payload, meta["dtype"], shape)
    hlen = int.from_bytes(payload[:8], "little")
    header = json.loads(payload[8 : 8 + hlen])
    off = 8 + hlen
    parts = []
    for p in header["parts"]:
        words = np.frombuffer(payload[off : off + p["words_len"]], np.uint32)
        off += p["words_len"]
        widths = np.frombuffer(payload[off : off + p["widths_len"]], np.uint8)
        off += p["widths_len"]
        if math.prod(p["shape3d"]) != p["n"]:
            raise ValueError(f"part of {p['n']} codes has shape {p['shape3d']}")
        c = sz.from_stream(words, widths, p["n"], p["eb"], p["shape3d"], device=device)
        parts.append(sz.decompress(c).cpu().numpy())
    flats = []
    total = header["orig_len"]
    for i, part in enumerate(parts):
        take = min(transforms.HACC_PARTITION, total - i * transforms.HACC_PARTITION)
        flats.append(part.reshape(-1)[:take])
    x = np.concatenate(flats)[:total]
    if header["mode"] == "pw_rel":
        sb = payload[-header["signs_len"]:]
        signs = np.frombuffer(sb, np.int8)
        x = np.where(signs == 0, 0.0, signs.astype(np.float32) * np.exp(x))
    return torch.from_numpy(np.ascontiguousarray(x.reshape(shape), np.float32)).to(
        arena.torch_dtype(meta["dtype"]))


@dataclasses.dataclass
class _ShardedLeaf:
    """Host-side view of a mesh-sharded leaf on this rank: one (index,
    block) pair per unique shard index this rank holds (a replicated shard
    is held by one rank only), never the assembled array.  ``gathered`` is
    filled once, on the drain thread: every shard's ``(index, payload,
    meta)`` on the group's first rank, in sorted index order."""

    shape: tuple
    dtype: str
    shards: list  # [(((start, stop), ...) per dim, CPU tensor), ...]
    gathered: Optional[list] = None
    done: bool = False


def _dtensor_index(x) -> tuple[tuple, bool, int]:
    """``(index, lead, unique)`` of a ``DTensor`` on this rank: its block's
    ``(start, stop)`` per dimension, whether this rank holds the copy of the
    block that is saved (local rank 0 on every mesh axis that replicates
    it), and how many distinct blocks the leaf has."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, shape = x.device_mesh, tuple(x.shape)
    coord = mesh.get_coordinate()
    start, length = [0] * len(shape), list(shape)
    lead, unique = True, 1
    for i, p in enumerate(x.placements):
        size = mesh.size(i)
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            if length[d] % size:
                raise ValueError(f"dim {d} of {shape} does not split evenly over mesh dim {i}")
            length[d] //= size
            start[d] += coord[i] * length[d]
            unique *= size
        elif isinstance(p, Replicate):
            lead = lead and coord[i] == 0
        else:
            raise ValueError(f"placement {p}: a saved leaf is Shard or Replicate")
    return tuple((s, s + n) for s, n in zip(start, length)), lead, unique


def _needs_gather(x: Any) -> bool:
    """A leaf whose save is a collective: a ``DTensor`` with more than one
    distinct block, or a deferred arena fetch (which may gather)."""
    if isinstance(x, arena.PendingHostArena):
        return True
    return shardlib.is_dtensor(x) and _dtensor_index(x)[2] > 1


def _to_host(x: Any) -> Any:
    """A state leaf on the host.  Raw leaves are copied *here*, on the
    caller thread, since the caller may overwrite them next; a ``DTensor``
    with several distinct blocks becomes a :class:`_ShardedLeaf` holding
    this rank's (never the assembled array), one with a single block (fully
    replicated) a whole leaf; arena buckets (``HostArena``, or
    ``PendingHostArena`` whose device buffers the snapshot owns) and in-situ
    streams (``HostShardedStream``: compressed bytes already on the host,
    never the raw field) pass through for the drain thread."""
    if isinstance(x, (arena.HostArena, arena.PendingHostArena, insitu.HostShardedStream)):
        return x
    if shardlib.is_dtensor(x):
        idx, lead, unique = _dtensor_index(x)
        local = x.to_local().detach().to("cpu", copy=True)
        if unique == 1:  # fully replicated: stored once, as a whole leaf
            return local
        return _ShardedLeaf(tuple(x.shape), arena.dtype_name(x.dtype),
                            [(idx, local)] if lead else [])
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def _place(node: Any, sh: Any) -> Any:
    """Place a restored tree by ``sh``, a tree prefix of it whose leaves are
    :class:`repro_torch.dist.sharding.NamedSharding` (every tensor below it
    goes there) or ``None`` (stays a host tensor)."""
    if sh is None:
        return node
    if isinstance(sh, shardlib.NamedSharding):
        if isinstance(node, dict):
            return {k: _place(v, sh) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(_place(v, sh) for v in node)
        return shardlib.place(node, sh) if isinstance(node, torch.Tensor) else node
    if isinstance(sh, dict) and isinstance(node, dict) and set(sh) == set(node):
        return {k: _place(node[k], sh[k]) for k in node}
    if isinstance(sh, (list, tuple)) and isinstance(node, (list, tuple)) \
            and len(sh) == len(node):
        return type(node)(_place(v, s) for v, s in zip(node, sh))
    raise ValueError(f"shardings do not match the restored tree at {type(node).__name__}: "
                     f"{sh!r}")


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3,
                 policy: CodecPolicy = CodecPolicy(), async_save: bool = True,
                 max_in_flight: int = 2, io_retries: int = 3,
                 retry_backoff_s: float = 0.05,
                 write_bytes: Optional[Callable[[Path, bytes], None]] = None,
                 fetch_hook: Optional[Callable[[int], None]] = None,
                 observatory: bool = True, device: str | torch.device | None = None,
                 group=None):
        """``io_retries``: total write attempts the drain worker makes per
        snapshot before poisoning itself with the error (transient
        ``OSError``/``BlockingIOError`` only; backoff doubles from
        ``retry_backoff_s``, capped at 1 s).  ``write_bytes``/``fetch_hook``
        are injection points (fault drills, alternative filesystems): the
        payload writer and a callable run on the drain thread right before
        deferred host fetches resolve.  ``observatory``: persist a
        per-snapshot ``obs_iNNNNNNNNN.json`` compression record beside the
        manifest (advisory, excluded from the digest — DESIGN.md §11).
        ``device``: where compressed leaves are encoded and decoded, CUDA
        unless ``"cpu"``.  ``group``: the process group of a save that every
        rank of a mesh makes (one process per rank); its first rank writes
        the files, the others hand it their shards' payloads over this
        group, on the drain thread.  Give a group that only the drain thread
        uses (``torch.distributed.new_group``, created by every rank in the
        same order), whose first rank is the mesh's.  ``None``: the first
        save holding a split ``DTensor`` in a multi-process run creates one
        (a ``gloo`` group over the whole world, since the payloads are host
        bytes); without one every process writes."""
        self.device = resolve_device(device)
        self._group = group
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.policy = policy
        self.async_save = async_save
        self.max_in_flight = max(1, int(max_in_flight))
        self.io_retries = max(1, int(io_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self._write_hook = write_bytes
        self._fetch_hook = fetch_hook
        self.observatory = bool(observatory)
        # shared process-global instruments: every manager in the process
        # reports into the same registry (no-ops until obs is enabled)
        self._g_depth = obs_metrics.gauge("ckpt.queue_depth")
        self._g_inflight = obs_metrics.gauge("ckpt.in_flight")
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._last_result: Optional[SaveResult] = None

    def _wb(self, path: Path, data: bytes) -> None:
        # default stays a late-bound module lookup so the kill-mid-write
        # subprocess tests can still swap _write_bytes wholesale
        (self._write_hook if self._write_hook is not None else _write_bytes)(
            path, data)

    # ------------------------------------------------------------- save --
    def save(self, step: int, state: Any, extra: Optional[dict] = None,
             on_complete: Optional[Callable[[int], None]] = None) -> None:
        """Snapshot `state`.  Device->host of raw leaves happens here (they
        may alias donated buffers); payload encode + disk I/O drain on the
        persistent background thread.  Blocks only when ``max_in_flight``
        snapshots are already queued (backpressure), never on the disk
        itself.  A failure on the drain thread re-raises here or in
        ``wait()``.  ``on_complete(step)`` fires on the drain thread once
        the snapshot is durable (or failed) — the overlapped snapshot hook
        passes ``SnapshotSlots.release`` to recycle its device slot."""
        self._raise_pending()
        leaves, treedef = tree_util.tree_flatten(state)
        self._join_group(leaves)
        writer = self.is_writer()
        # raw leaves copied here; a rank that writes nothing keeps only the
        # leaves whose save is a collective
        host = [_to_host(x) if writer or _needs_gather(x) else None for x in leaves]
        treedef_str = str(treedef)
        if self.async_save:
            self._ensure_worker()
            # blocks iff max_in_flight snapshots are already queued/draining
            self._queue.put((step, host, treedef_str, extra or {}, on_complete))
            # sampled here (training thread) and in the drain loop: between
            # the two, enqueue spikes and drain progress are both visible
            self._g_depth.set(self._queue.qsize())
            self._g_inflight.set(self._queue.unfinished_tasks)
        else:
            try:
                # same bounded-backoff policy as the drain thread: a
                # transient OSError must not kill a synchronous save either
                self._write_with_retry(step, host, treedef_str, extra or {})
            finally:
                if on_complete is not None:
                    on_complete(step)

    def _join_group(self, leaves: list) -> None:
        if (self._group is None and dist.is_initialized() and dist.get_world_size() > 1
                and any(shardlib.is_dtensor(x) and _dtensor_index(x)[2] > 1 for x in leaves)):
            # every rank saves the same tree, so every rank creates it here
            self._group = dist.new_group(backend="gloo")

    def set_group(self, group) -> None:
        """Save over ``group`` from now on (an elastic run's new mesh); the
        caller has waited for the saves in flight (:meth:`wait`)."""
        self._group = group

    def is_writer(self) -> bool:
        """Whether this process writes the files: the group's first rank
        (every process without a group)."""
        return self._group is None or dist.get_rank(self._group) == 0

    def _shard_payloads(self, leaf: _ShardedLeaf) -> Optional[list]:
        """Encode this rank's blocks of a split leaf with the policy and
        gather every rank's ``(index, payload, meta)`` to the group's first
        rank: sorted by index there, ``None`` elsewhere.  Done once per
        leaf, so a retried write reuses it."""
        if not leaf.done:
            mine = [(idx, *_encode_leaf(block, self.policy, self.device))
                    for idx, block in leaf.shards]
            size = 1 if self._group is None else dist.get_world_size(self._group)
            if size == 1:
                got = [mine]
            else:
                writer = self.is_writer()
                got = [None] * size if writer else None
                if not writer:
                    insitu.count_sent("gather", sum(len(p) for _, p, _ in mine))
                dist.gather_object(mine, got, dst=dist.get_global_rank(self._group, 0),
                                   group=self._group)
            if got is not None:
                unique = {idx: (idx, p, m) for part in got for idx, p, m in part}
                leaf.gathered = [unique[idx] for idx in sorted(unique)]
            leaf.shards, leaf.done = [], True  # the host blocks are encoded now
        return leaf.gathered

    def _participate(self, step: int, host: list) -> None:
        """A rank that writes nothing: its share of the save's collectives,
        in the writer's leaf order (deferred arena gathers, shard payloads)."""
        for arr in host:
            if isinstance(arr, arena.PendingHostArena):
                if self._fetch_hook is not None:
                    self._fetch_hook(step)
                arr.result()
            elif isinstance(arr, _ShardedLeaf):
                self._shard_payloads(arr)

    def _ensure_worker(self) -> None:
        if self._queue is None:
            self._queue = queue.Queue(maxsize=self.max_in_flight)
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True,
                                            name="ckpt-drain")
            self._worker.start()

    def _drain(self) -> None:
        while True:
            step, host, treedef_str, extra, on_complete = self._queue.get()
            self._g_depth.set(self._queue.qsize())
            try:
                # the span lives on the drain thread — its track in the
                # exported trace shows exactly how far saves lag training
                with obs_trace.span("ckpt.drain.save", step=step):
                    self._write_with_retry(step, host, treedef_str, extra)
            except BaseException as e:
                self._set_error(e)
            finally:
                try:
                    if on_complete is not None:
                        on_complete(step)
                except BaseException as e:
                    self._set_error(e)
                self._queue.task_done()
                self._g_inflight.set(self._queue.unfinished_tasks)

    def _write_with_retry(self, step: int, host: list, treedef_str: str,
                          extra: dict) -> None:
        """Drain-thread write with bounded exponential backoff on transient
        I/O errors.  ``BlockingIOError`` is an ``OSError`` subclass; a
        :class:`SnapshotCorruptionError` is *not* transient and never
        retried.  ``_write`` cleans its tmp dir on failure, so every
        attempt starts from a blank slate.  A rank that writes nothing only
        takes its part in the save's collectives."""
        if not self.is_writer():
            self._participate(step, host)
            return
        for attempt in range(self.io_retries):
            try:
                self._write(step, host, treedef_str, extra, retries=attempt)
                return
            except SnapshotCorruptionError:
                raise
            except OSError as e:
                if attempt + 1 >= self.io_retries:
                    raise
                # a degraded disk must be visible without reading the step
                # dir: warn on the logger and count/log the event
                _log.warning(
                    "checkpoint step %d transient write error "
                    "(attempt %d/%d, retrying): %s",
                    step, attempt + 1, self.io_retries, e)
                obs_metrics.event("ckpt.retry", step=step,
                                  attempt=attempt + 1, error=str(e))
                time.sleep(min(self.retry_backoff_s * (2 ** attempt), 1.0))

    def _set_error(self, e: BaseException) -> None:
        with self._error_lock:
            if self._error is None:  # first failure wins
                self._error = e

    def _raise_pending(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _write(self, step: int, host: list, treedef_str: str, extra: dict,
               retries: int = 0) -> None:
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        try:
            self._write_into(tmp, final, step, host, treedef_str, extra, retries)
        except BaseException:
            # a partial tmp dir is invisible to restore (only step_* dirs
            # are scanned), but don't leave it to shadow a retried save
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_into(self, tmp: Path, final: Path, step: int, host: list,
                    treedef_str: str, extra: dict, retries: int = 0) -> None:
        tmp.mkdir(parents=True, exist_ok=True)
        manifest: dict[str, Any] = {"step": step, "treedef": treedef_str,
                                    "extra": extra, "leaves": []}

        raw = stored = 0
        records: list[dict] = []  # observatory: one entry per manifest leaf
        for i, arr in enumerate(host):
            fetch_s = 0.0
            if isinstance(arr, arena.PendingHostArena):
                # deferred overlapped-snapshot fetch: the one `used` readback
                # + arena D2H happen here, on the drain thread — the training
                # thread never waited on them.  Timing this resolve is the
                # observatory's fetch wall: measured around a sync that was
                # already mandatory, so observing it adds no device sync
                if self._fetch_hook is not None:
                    self._fetch_hook(step)
                t0 = time.perf_counter()
                with obs_trace.span("ckpt.drain.fetch", step=step, leaf=i):
                    arr = arr.result()
                fetch_s = time.perf_counter() - t0
            if isinstance(arr, (arena.HostArena, insitu.HostShardedStream)):
                # compressed on the device: one binary per shard, the codec
                # tag in the manifest routing restore through a decoder that
                # needs no mesh.  An arena bucket (``arena_*``) holds every
                # leaf of the bucket, its per-leaf descriptors in the
                # manifest (O(1) files where the per-leaf path wrote
                # O(#leaves)); an in-situ stream (``leaf_*_sNNN``) one field,
                # each shard's index slice beside its payload
                if isinstance(arr, arena.HostArena):
                    meta, prefix = arena.host_meta(arr), "arena"
                    shards = [({}, blobs) for blobs in arr.shards]
                else:
                    meta, prefix = insitu.host_stream_meta(arr), "leaf"
                    shards = [({"index": [list(se) for se in idx]}, blobs)
                              for idx, blobs in arr.shards]
                meta["shards"] = []
                leaf_stored = 0
                enc_s = wr_s = 0.0
                for j, (bmeta, blobs) in enumerate(shards):
                    t0 = time.perf_counter()
                    payload = arena.payload_encode(blobs)
                    if _zstd is not None and self.policy.zstd_level > 0:
                        payload = _zstd.ZstdCompressor(
                            level=self.policy.zstd_level).compress(payload)
                        bmeta["zstd"] = True
                    enc_s += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    self._wb(tmp / f"{prefix}_{i:05d}_s{j:03d}.bin", payload)
                    wr_s += time.perf_counter() - t0
                    bmeta["crc32"] = _crc(payload)
                    bmeta["stored_bytes"] = len(payload)
                    meta["shards"].append(bmeta)
                    stored += len(payload)
                    leaf_stored += len(payload)
                raw += arr.nbytes_raw
                manifest["leaves"].append(meta)
                records.append({**arr.accounting(), "leaf": i,
                                "stored_bytes": leaf_stored,
                                "fetch_s": round(fetch_s, 6),
                                "encode_s": round(enc_s, 6),
                                "write_s": round(wr_s, 6)})
                continue
            if isinstance(arr, _ShardedLeaf):
                # a raw mesh-sharded leaf: one payload per unique shard, encoded
                # by the rank holding it and gathered here, in index order
                t0 = time.perf_counter()
                pairs = self._shard_payloads(arr)
                enc_s = time.perf_counter() - t0
                meta = {"shape": list(arr.shape), "dtype": arr.dtype, "shards": []}
                leaf_raw = leaf_stored = 0
                wr_s = 0.0
                for j, (idx, payload, bmeta) in enumerate(pairs):
                    t0 = time.perf_counter()
                    self._wb(tmp / f"leaf_{i:05d}_s{j:03d}.bin", payload)
                    wr_s += time.perf_counter() - t0
                    bmeta = {**bmeta, "index": [list(se) for se in idx]}
                    meta["shards"].append(bmeta)
                    leaf_raw += bmeta["raw_bytes"]
                    leaf_stored += bmeta["stored_bytes"]
                raw += leaf_raw
                stored += leaf_stored
                rec = {"leaf": i, "kind": "sharded",
                       "codec": meta["shards"][0]["codec"] if meta["shards"] else "raw",
                       "raw_bytes": leaf_raw, "stored_bytes": leaf_stored,
                       "shards": len(pairs), "launches": 0,
                       "encode_s": round(enc_s, 6), "write_s": round(wr_s, 6)}
                if meta["shards"] and "eb" in meta["shards"][0]:
                    rec["eb"] = meta["shards"][0]["eb"]
                manifest["leaves"].append(meta)
                records.append(rec)
                continue
            t0 = time.perf_counter()
            payload, meta = _encode_leaf(arr, self.policy, self.device)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            self._wb(tmp / f"leaf_{i:05d}.bin", payload)
            wr_s = time.perf_counter() - t0
            raw += meta["raw_bytes"]
            stored += meta["stored_bytes"]
            rec = {"leaf": i, "kind": "leaf", "codec": meta["codec"],
                   "raw_bytes": meta["raw_bytes"],
                   "stored_bytes": meta["stored_bytes"],
                   "shards": 1, "launches": 0,
                   "encode_s": round(enc_s, 6), "write_s": round(wr_s, 6)}
            if "eb" in meta:
                rec["eb"] = meta["eb"]
            manifest["leaves"].append(meta)
            records.append(rec)
        if self.observatory:
            # advisory sidecar, durable whenever the manifest is (written
            # strictly before it), excluded from the digest, and emitted
            # through the module-level writer — NOT self._wb — so fault
            # drills keyed to payload writes keep their exact semantics
            doc = obs_observatory.build_doc(step, records, retries=retries)
            _write_bytes(tmp / obs_observatory.obs_name(step),
                         json.dumps(doc, indent=1).encode())
        # digest covers the whole manifest body (leaves, treedef, extra,
        # step), not just the leaf index — a bit flip anywhere in the
        # manifest is detected, not just inside a leaf entry
        manifest["digest"] = _crc(json.dumps(manifest, sort_keys=True).encode())
        # manifest LAST, fsync'd, then the directory itself: after a crash,
        # either the manifest (and everything it indexes, already durable)
        # exists, or the snapshot is invisible — never a partial that
        # restore would adopt
        self._wb(tmp / "MANIFEST.json", json.dumps(manifest, indent=1).encode())
        _fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic adoption
        _fsync_dir(self.dir)
        self._last_result = SaveResult(step, final, raw, stored, retries)
        self._gc()

    def wait(self) -> Optional[SaveResult]:
        """Drain every queued snapshot; re-raise any drain-thread failure;
        return the last completed :class:`SaveResult`."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()
        return self._last_result

    def flush(self) -> None:
        """Block until every queued snapshot is durably written *or*
        failed, without consuming or re-raising a pending drain error
        (unlike :meth:`wait`).  The fault injector uses this so "corrupt
        the newest snapshot" names a deterministic victim even while the
        drain is mid-write — the pending error (if any) still belongs to
        whoever calls :meth:`wait`/:meth:`quiesce` next."""
        if self._queue is not None:
            self._queue.join()

    def quiesce(self, timeout: float) -> tuple[bool, Optional[BaseException]]:
        """Bounded-deadline :meth:`wait` for fault handling: wait up to
        ``timeout`` seconds for the drain queue to empty, then return
        ``(drained, error)`` instead of blocking forever or raising — a
        supervisor deciding how to fail over must regain control even when
        the drain worker is wedged.  Any pending drain error is *consumed*
        (the caller owns it now); snapshots still queued at the deadline
        keep draining in the background and remain adoptable when they
        finish."""
        drained = True
        if self._queue is not None:
            deadline = time.monotonic() + timeout
            with self._queue.all_tasks_done:
                while self._queue.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        drained = False
                        break
                    self._queue.all_tasks_done.wait(remaining)
        with self._error_lock:
            err, self._error = self._error, None
        return drained, err

    @property
    def last_result(self) -> Optional[SaveResult]:
        """Most recently completed save (no drain, no error re-raise) — what
        an ``on_complete`` callback may consult on the drain thread."""
        return self._last_result

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[: -self.keep_last]:
            shutil.rmtree(old)

    # ---------------------------------------------------------- restore --
    def latest_step(self) -> Optional[int]:
        steps = sorted(self.dir.glob("step_*"))
        return int(steps[-1].name.split("_")[1]) if steps else None

    def available_steps(self) -> list[int]:
        """Restorable-looking steps, newest first (verification happens at
        restore time — a listed step may still fail its CRCs)."""
        return sorted((int(p.name.split("_")[1]) for p in
                       self.dir.glob("step_*")), reverse=True)

    def _quarantine(self, step: int) -> Path:
        """Move a corrupt step dir into ``quarantine/`` — out of the
        restore scan, but preserved for forensics (never deleted: the bytes
        are the only evidence of *what* corrupted)."""
        qdir = self.dir / "quarantine"
        qdir.mkdir(exist_ok=True)
        src = self.dir / f"step_{step:09d}"
        dst = qdir / src.name
        k = 0
        while dst.exists():  # same step quarantined twice across restarts
            k += 1
            dst = qdir / f"{src.name}.{k}"
        src.rename(dst)
        return dst

    def _read_payload(self, d: Path, name: str, bmeta: dict,
                      step: int) -> bytes:
        """Read + CRC-verify + (optionally) zstd-expand one payload file.
        Every failure mode — missing file, checksum mismatch, truncated
        zstd frame — surfaces as :class:`SnapshotCorruptionError` naming
        the payload."""
        try:
            payload = (d / name).read_bytes()
        except OSError as e:
            raise SnapshotCorruptionError(
                f"missing/unreadable payload {name} in {d}: {e}",
                step=step, payload=name) from e
        if _crc(payload) != bmeta["crc32"]:
            raise SnapshotCorruptionError(
                f"crc mismatch in payload {name} of {d} "
                f"(stored {bmeta['crc32']:#010x}, got {_crc(payload):#010x})",
                step=step, payload=name)
        if bmeta.get("zstd"):
            if _zstd is None:
                raise IOError(f"payload {name} is zstd-compressed but "
                              "zstandard is not installed on this host")
            try:
                payload = _zstd.ZstdDecompressor().decompress(payload)
            except Exception as e:
                raise SnapshotCorruptionError(
                    f"zstd decode of payload {name} in {d} failed: {e}",
                    step=step, payload=name) from e
        return payload

    def _load_manifest(self, d: Path, step: int) -> dict:
        try:
            manifest = json.loads((d / "MANIFEST.json").read_text())
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise SnapshotCorruptionError(
                f"unreadable manifest in {d}: {e}", step=step,
                payload="MANIFEST.json") from e
        body = {k: v for k, v in manifest.items() if k != "digest"}
        if manifest.get("digest") != _crc(
                json.dumps(body, sort_keys=True).encode()):
            raise SnapshotCorruptionError(
                f"manifest digest mismatch in {d}", step=step,
                payload="MANIFEST.json")
        return manifest

    def restore(self, step: Optional[int] = None, state_like: Any = None,
                shardings: Any = None, fallback: bool = False) -> tuple[Any, dict]:
        """Restore (state, extra). Verifies the manifest digest and every
        payload's stored crc32 before any byte reaches a leaf; failures
        raise :class:`SnapshotCorruptionError` naming the bad payload.
        Leaves come back as CPU tensors; with ``shardings`` (a tree prefix
        of the restored state whose leaves are
        :class:`repro_torch.dist.sharding.NamedSharding` or ``None``) each
        placed leaf is a ``DTensor`` on the mesh it names, this rank's block
        sliced from the leaf assembled on the host.  That mesh need not be
        the one that saved the step: re-sharding onto another mesh is how
        elastic restarts work.  With one process per rank every rank
        restores, after the writer's save has finished.
        ``fallback=True`` delegates to :meth:`restore_latest_valid`:
        corrupt steps are quarantined and skipped instead of raised."""
        if fallback:
            if step is not None:
                raise ValueError("fallback=True restores the newest valid "
                                 "step; do not pin one")
            state, extra, _ = self.restore_latest_valid(state_like, shardings)
            return state, extra
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return self._restore_step(step, state_like, shardings)

    def restore_latest_valid(self, state_like: Any = None, shardings: Any = None,
                             max_fallbacks: Optional[int] = None
                             ) -> tuple[Any, dict, int]:
        """Restore the newest step that passes full verification, walking
        past (and quarantining) corrupt ones.  Returns
        ``(state, extra, step)`` — the step actually adopted, which a
        resuming loop must treat as its start step.  Raises the *last*
        corruption error if every candidate (or ``max_fallbacks + 1`` of
        them) fails, and ``FileNotFoundError`` if there are none."""
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        last_err: Optional[SnapshotCorruptionError] = None
        for k, step in enumerate(steps):
            if max_fallbacks is not None and k > max_fallbacks:
                break
            try:
                state, extra = self._restore_step(step, state_like, shardings)
                return state, extra, step
            except SnapshotCorruptionError as e:
                q = self._quarantine(step)
                # logger + event counters, not print: a degraded run must
                # show up in the log stream and the metrics JSONL without
                # anyone listing the quarantine dir
                _log.warning(
                    "checkpoint step %d failed verification (%s); "
                    "quarantined to %s, falling back", step, e.payload, q)
                obs_metrics.event("ckpt.corruption", step=step,
                                  payload=str(e.payload))
                obs_metrics.event("ckpt.quarantine", step=step, dest=q.name)
                last_err = e
        assert last_err is not None
        raise last_err

    def _restore_step(self, step: int, state_like: Any,
                      shardings: Any = None) -> tuple[Any, dict]:
        with obs_trace.span("ckpt.restore", step=step):
            state, extra = self._restore_step_impl(step, state_like)
        return _place(state, shardings), extra

    def _restore_step_impl(self, step: int, state_like: Any) -> tuple[Any, dict]:
        d = self.dir / f"step_{step:09d}"
        if not d.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self.dir}")
        manifest = self._load_manifest(d, step)
        host = []
        for i, meta in enumerate(manifest["leaves"]):
            if meta.get("codec", "").startswith("arena-"):
                names = [f"arena_{i:05d}_s{j:03d}.bin"
                         for j in range(len(meta["shards"]))]
                payloads = [self._read_payload(d, nm, bm, step)
                            for nm, bm in zip(names, meta["shards"])]
                # the whole bucket decodes to a {name: array} dict leaf;
                # a descriptor index and payload that disagree past the
                # CRCs are still corruption, not a crash
                try:
                    host.append(arena.host_restore(meta, payloads, device=self.device))
                except _PAYLOAD_ERRORS as e:
                    raise SnapshotCorruptionError(
                        f"arena decode of leaf {i} in {d} failed: {e}",
                        step=step, payload=names[0]) from e
                continue
            if meta.get("codec", "").startswith("insitu-"):
                shards = meta.get("shards", [])
                names = [f"leaf_{i:05d}_s{j:03d}.bin" for j in range(len(shards))]
                payloads = [self._read_payload(d, nm, bm, step)
                            for nm, bm in zip(names, shards)]
                try:
                    grid = meta["insitu"]["grid"]
                    if len(payloads) != math.prod(grid):
                        # a sparse manifest must never leak an empty buffer
                        raise ValueError(f"{len(payloads)} shard payloads, grid {grid}")
                    host.append(insitu.host_restore(meta, payloads, device=self.device))
                except _PAYLOAD_ERRORS as e:
                    raise SnapshotCorruptionError(
                        f"in-situ decode of leaf {i} in {d} failed: {e}",
                        step=step, payload=names[0] if names else None) from e
                continue
            if "shards" in meta:
                shape = tuple(meta["shape"])
                full = torch.empty(shape, dtype=arena.torch_dtype(meta["dtype"]))
                covered = 0
                for j, bmeta in enumerate(meta["shards"]):
                    name = f"leaf_{i:05d}_s{j:03d}.bin"
                    payload = self._read_payload(d, name, bmeta, step)
                    sl = tuple(slice(s, e) for s, e in bmeta["index"])
                    try:
                        full[sl] = _decode_leaf(payload, bmeta, self.device)
                    except _PAYLOAD_ERRORS as e:
                        raise SnapshotCorruptionError(
                            f"decode of payload {name} in {d} failed: {e}",
                            step=step, payload=name) from e
                    blk = 1
                    for s, e in bmeta["index"]:
                        blk *= e - s
                    covered += blk
                # disjoint shard blocks must tile the leaf exactly — an
                # empty buffer must never leak through a sparse manifest
                # (e.g. one written by a single process of a multi-process
                # mesh, which only sees its addressable shards)
                total = 1
                for s in shape:
                    total *= s
                if covered != total:
                    raise SnapshotCorruptionError(
                        f"leaf {i} shards cover {covered}/{total} elements "
                        f"in {d}", step=step)
                host.append(full)
            else:
                name = f"leaf_{i:05d}.bin"
                payload = self._read_payload(d, name, meta, step)
                try:
                    host.append(_decode_leaf(payload, meta, self.device))
                except _PAYLOAD_ERRORS as e:
                    raise SnapshotCorruptionError(
                        f"decode of payload {name} in {d} failed: {e}",
                        step=step, payload=name) from e
        if state_like is not None:
            treedef = tree_util.tree_structure(state_like)
        else:
            raise ValueError("state_like tree required to rebuild structure")
        return tree_util.tree_unflatten(treedef, host), manifest["extra"]
