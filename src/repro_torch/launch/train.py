"""The training launcher's in-situ snapshot hook (the port of
``repro.launch.train``'s ``_leaf_entries`` and ``build_insitu_hook``).

The trainer itself (the loop, the optimiser and the launcher's command
line) waits for ROADMAP Queue 1 item 4; until then the hook is driven
directly, with one process per rank of a ``torch.distributed`` mesh:

    hook = build_insitu_hook(mesh, "/ckpt/insitu", eb=1e-3)
    hook(step, state)   # every rank, with the same tree of DTensors
    hook.wait()         # every rank: the drain has finished
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import arena as arena_core
from repro_torch.dist import insitu
from repro_torch.dist import sharding as shardlib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def _leaf_entries(state: Any, min_bytes: int) -> list:
    """(key, leaf) pairs of the float leaves worth snapshotting: at least
    one dimension and ``min_bytes`` (of the whole leaf, for a ``DTensor``)."""
    out = []
    for path, leaf in tree_util.tree_flatten_with_path(state)[0]:
        if not arena_core.is_float_leaf(leaf):
            continue
        if leaf.ndim < 1 or leaf.numel() * leaf.element_size() < min_bytes:
            continue
        out.append((path, leaf))
    return out


def _spec(leaf) -> tuple:
    return shardlib.spec_of(leaf) if shardlib.is_dtensor(leaf) else ()


def _local(leaf) -> torch.Tensor:
    return leaf.to_local() if shardlib.is_dtensor(leaf) else leaf


def build_insitu_hook(mesh, out_dir: str, eb: float, min_bytes: int = 1 << 20,
                      arena: bool = True, overlap: bool = True, slots: int = 2,
                      backend: str = "auto"):
    """Snapshot hook: compress every float leaf >= ``min_bytes``
    shard-locally (halo-exchanged TPU-SZ at the absolute bound ``eb``) and
    persist the streams through the checkpoint manager.  The raw leaves
    never gather: only compressed bytes cross ranks and reach the host —
    the paper's in-situ snapshot applied to a sharded state tree.  Every
    rank of ``mesh`` (one process each) builds the hook and calls it with
    the same tree, whose leaves are ``DTensor`` objects on ``mesh`` or plain
    tensors (replicated).

    ``arena=True`` (default) is the arena-batched path: 3-D TILE-aligned
    replicated leaves batch through the fused tile kernel
    (``insitu.plan_kernel_buckets`` -> ``arena.szk_compress_bucket``, K8,
    codec ``arena-szk``); everything else flattens and size-buckets
    (``insitu.plan_arena``) into ``insitu.sharded_compress_arena``.  A
    snapshot issues O(#buckets) launches, one halo exchange and one
    ``all_reduce`` per flat bucket split over an axis.  Kernel buckets and
    replicated flat buckets are compressed and saved by the mesh's first
    rank only; the other ranks launch nothing for them.  Arena-ineligible
    leaves (partitions off the leading dim) take the per-leaf path
    (``insitu.sharded_compress`` with ``backend``, as the reference's ``auto``
    by default), said once.  ``arena=False`` is that per-leaf path for every
    leaf.

    ``overlap=True`` (default): each bucket's host fetch is deferred
    (``PendingHostArena``) to the manager's drain thread and the hook
    returns at once; a pool of ``slots`` (``arena.SnapshotSlots``) bounds
    the snapshots in flight, and the hook blocks only when all are
    draining.  The drain thread's gathers run on a process group of their
    own, which every rank creates here, once and in the same order: the
    caller's thread goes on issuing the next snapshot's collectives, and
    two threads sharing one group can order them differently on each rank.
    The files are the same as with ``overlap=False`` (a synchronous save).
    The hook exposes ``hook.wait()`` (drain everything; every rank calls
    it), ``hook.manager``, ``hook.slots`` and ``hook.group``."""
    multi = dist.is_initialized() and dist.get_world_size() > 1
    group = dist.new_group(backend="gloo") if multi else None
    first = insitu.is_first_rank(mesh)
    device = torch.device(mesh.device_type)
    snap = CheckpointManager(out_dir, keep_last=2, async_save=overlap, max_in_flight=slots,
                             device=device, group=group)
    pool = arena_core.SnapshotSlots(slots) if (overlap and arena) else None
    _c_launch = obs_metrics.counter("snapshot.launches")
    failed: set = set()  # leaf keys the per-leaf path refused, said once
    cache: dict = {"sig": None, "kbuckets": [], "buckets": [], "legacy": []}

    def _legacy_compress(key, leaf, fields) -> None:
        if key in failed:
            return
        try:
            stream = insitu.sharded_compress(leaf, "sz", mesh, None if shardlib.is_dtensor(leaf) else (),
                                             eb=eb, backend=backend)
        except (NotImplementedError, ValueError) as e:
            # composed-axis / non-divisible / misaligned leaves — say so once
            # instead of silently shrinking the snapshot
            print(f"  in-situ snapshot: skipping {key}: {e}")
            failed.add(key)
            return
        h = insitu.to_host(stream)  # the compressed shards, on the first rank
        if h is not None:
            fields[key] = h

    def _replan(named) -> None:
        entries = [(key, tuple(leaf.shape), leaf.dtype, _spec(leaf)) for key, leaf in named]
        kbuckets, rest = insitu.plan_kernel_buckets(entries, mesh)
        buckets, skipped = insitu.plan_arena(rest, mesh)
        for key, why in skipped:
            print(f"  in-situ snapshot: {key} not arena-eligible ({why}); "
                  "using the per-leaf path")
        cache.update(kbuckets=kbuckets, buckets=buckets, legacy=[k for k, _ in skipped])

    def hook(step: int, state) -> None:
        named = _leaf_entries(state, min_bytes)
        fields = {}
        acquired = False
        try:
            if arena:
                sig = tuple((k, tuple(v.shape), str(v.dtype), _spec(v)) for k, v in named)
                if cache["sig"] != sig:
                    _replan(named)
                    cache["sig"] = sig
                by_key = dict(named)
                if pool is not None:
                    pool.acquire()  # backpressure: <= `slots` snapshots in flight
                    acquired = True
                for k, b in enumerate(cache["kbuckets"] if first else []):
                    # dispatch-only span: the launch is asynchronous
                    with obs_trace.span("snapshot.bucket", kind="szk", bucket=k,
                                        n_fields=len(b.names)):
                        a = arena_core.szk_compress_bucket(
                            [_local(by_key[nm]) for nm in b.names], b, eb, device=device)
                        fields[f"karena{k:03d}"] = (
                            arena_core.to_host_async(a, b, codec=arena_core.CODEC_SZK)
                            if overlap else arena_core.to_host(a, b, codec=arena_core.CODEC_SZK))
                    _c_launch.inc()
                for k, b in enumerate(cache["buckets"]):
                    if b.axis is None and not first:
                        continue  # a replicated bucket: the first rank's copy
                    with obs_trace.span("snapshot.bucket", kind="flat", bucket=k,
                                        n_fields=len(b.names)):
                        stream = insitu.sharded_compress_arena(
                            [by_key[nm] for nm in b.names], b, mesh, eb)
                        h = (insitu.arena_to_host_async(stream, group) if overlap
                             else insitu.arena_to_host(stream))
                        if h is not None:
                            fields[f"arena{k:03d}"] = h
                    _c_launch.inc()
                for key in cache["legacy"]:
                    _legacy_compress(key, by_key[key], fields)
                    _c_launch.inc()
            else:
                for key, leaf in named:
                    _legacy_compress(key, leaf, fields)
                    _c_launch.inc()
            if not fields:
                if acquired:
                    pool.release()
                return
            n_leaves = sum(len(v.names) if hasattr(v, "names") else 1 for v in fields.values())
            extra = {"eb": eb, "n_fields": n_leaves, "arena": bool(arena)}
            if overlap:
                release = pool.release if acquired else (lambda *_: None)

                def _done(s, _n=n_leaves, _g=len(fields), _rel=release):
                    _rel(s)  # the slot recycles only after the drain finished
                    res = snap.last_result
                    if first:
                        ratio = (f", {res.ratio:.2f}x on-device compression"
                                 if res is not None and res.step == s else "")
                        print(f"  in-situ snapshot step {s}: {_n} fields in "
                              f"{_g} payload groups drained in background{ratio}")

                snap.save(step, fields, extra=extra, on_complete=_done)
                acquired = False  # the drain queue owns the release now
            else:
                snap.save(step, fields, extra=extra)
                res = snap.wait()
                if res is not None:
                    print(f"  in-situ snapshot step {step}: {n_leaves} fields in "
                          f"{len(fields)} payload groups, "
                          f"{res.ratio:.2f}x on-device compression")
        except BaseException:
            if acquired:
                pool.release()
            raise

    hook.wait = snap.wait
    hook.manager = snap
    hook.slots = pool
    hook.group = group
    return hook
