"""Training launcher (the port of ``repro.launch.train``): the command line,
the run-wide telemetry switches, and the in-situ snapshot hook.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 1000 --batch 32 --seq 512 --ckpt-dir /ckpt \\
        [--smoke] [--grad-comp] [--lossy-ckpt] [--insitu-snapshot]

It trains on one rank of a one-rank ``("data",)`` mesh
(``launch.mesh.make_host_mesh``) on ``--device`` (CUDA unless ``cpu``): the
train step (``train/step.py``), AdamW under the arch's schedule (``wsd`` for
minicpm-2b, else ``cosine``), and the fault-tolerant loop
(``train/loop.py``), which resumes from the newest valid checkpoint under
``--ckpt-dir`` and saves on SIGTERM.  ``--lossy-ckpt`` stores leaves of
1 MiB or more as TPU-SZ streams at a point-wise relative bound of 1e-4;
``--insitu-snapshot`` adds :func:`build_insitu_hook` at every checkpoint,
writing compressed state leaves under ``<ckpt-dir>/fields``.
``--layers N`` cuts the arch's depth at its published widths.
``--supervise`` runs the loop under ``train.supervisor.run_supervised``:
a detected fault quiesces the checkpoint drain, shrinks the mesh, restores
the newest valid snapshot and grows back; ``--fault-seed`` (or
``--fault-plan``) injects the seeded drill of ``train/faults.py``.

The hook, driven directly, with one process per rank of a
``torch.distributed`` mesh:

    hook = build_insitu_hook(mesh, "/ckpt/insitu", eb=1e-3)
    hook(step, state)   # every rank, with the same tree of DTensors
    hook.wait()         # every rank: the drain has finished
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager, CodecPolicy
from repro_torch.configs import registry
from repro_torch.core import arena as arena_core
from repro_torch.data.tokens import DataConfig, TokenPipeline, frontend_stub
from repro_torch.device import resolve_device
from repro_torch.dist import insitu
from repro_torch.dist import sharding as shardlib
from repro_torch.dist.collectives import GradCompressionConfig
from repro_torch.launch.mesh import describe, make_host_mesh
from repro_torch.models.spec import param_count
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train import loop as loop_lib
from repro_torch.train import step as step_lib


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
    The caller thread's own gathers (per-leaf streams, synchronous arenas)
    run on a second group over the mesh's ranks, so a mesh that leaves ranks
    of the world out (a shrunk mesh) gathers too.
    The files are the same as with ``overlap=False`` (a synchronous save).
    The hook exposes ``hook.wait()`` (drain everything; every rank calls
    it), ``hook.manager``, ``hook.slots`` and ``hook.group``."""
    multi = dist.is_initialized() and dist.get_world_size() > 1
    # over the mesh's ranks: a supervised run's shrunk mesh leaves ranks out;
    # the drain thread's gathers on one group, the caller thread's on another
    ranks = mesh.mesh.flatten().tolist()
    group = dist.new_group(ranks=ranks, backend="gloo") if multi else None
    fetch_group = dist.new_group(ranks=ranks, backend="gloo") if multi else None
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
        h = insitu.to_host(stream, fetch_group)  # the compressed shards, on the first rank
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
                             else insitu.arena_to_host(stream, fetch_group))
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


def _setup_obs(args) -> Optional[Path]:
    """Wire --metrics-dir / --trace into the process-global observability
    layer.  Returns the output dir (None when observability is off)."""
    if args.metrics_dir is None and not args.trace:
        return None
    out = Path(args.metrics_dir if args.metrics_dir is not None else args.ckpt_dir)
    out.mkdir(parents=True, exist_ok=True)
    # metrics always come on with observability (the registry is the cheap
    # half); the JSONL sink only attaches when --metrics-dir names a home
    obs_metrics.enable(out / "metrics.jsonl" if args.metrics_dir is not None else None)
    if args.trace:
        obs_trace.enable()
    return out


def _finish_obs(out: Optional[Path], args, tag: str) -> None:
    """End-of-run export: final metrics line + human summary, and the
    Chrome-trace JSON (one track per thread — open in chrome://tracing)."""
    if out is None:
        return
    obs_metrics.export_snapshot(final=True)
    print(obs_metrics.summary())
    if args.trace:
        p = obs_trace.export(out / f"trace_{tag}.json")
        print(f"  trace written to {p} ({len(obs_trace.TRACER.events)} spans)")


def _arch_config(args):
    """The arch's config (``--smoke``: reduced), cut to ``--layers``."""
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    return cfg if args.layers is None else cfg.scaled(n_layers=args.layers)


def _step_config(args) -> step_lib.TrainStepConfig:
    """AdamW under ``--schedule`` (the arch's default: ``wsd`` for
    minicpm-2b, else ``cosine``), warmup over a twentieth of the steps."""
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    return step_lib.TrainStepConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps, schedule=schedule,
        microbatches=args.microbatches,
        grad_comp=GradCompressionConfig(enabled=args.grad_comp),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers at the arch's widths")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None, help="cosine|wsd (default per arch)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-comp", action="store_true",
                    help="int8 + error-feedback cross-pod gradient hop (meshes with a "
                         "'pod' axis; the one-rank host mesh has none)")
    ap.add_argument("--lossy-ckpt", action="store_true")
    ap.add_argument("--insitu-snapshot", action="store_true",
                    help="at every checkpoint, also compress the large state "
                         "leaves on their devices (TPU-SZ, dist.insitu) into "
                         "<ckpt-dir>/fields")
    ap.add_argument("--insitu-eb", type=float, default=1e-3,
                    help="ABS error bound for --insitu-snapshot")
    ap.add_argument("--insitu-per-leaf", action="store_true",
                    help="disable arena batching for --insitu-snapshot: one "
                         "compress and one stream file per leaf")
    ap.add_argument("--insitu-sync", action="store_true",
                    help="disable snapshot overlap for --insitu-snapshot: block "
                         "the loop for the compress, the host copy and the disk "
                         "write instead of draining in the background")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--supervise", action="store_true",
                    help="run under train.supervisor.run_supervised: detected "
                         "faults quiesce the checkpoint drain, shrink the "
                         "mesh, restore the newest *valid* snapshot, resume, "
                         "and grow back — instead of crashing the run")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="with --supervise: inject the canonical seeded "
                         "fault drill (train.faults.FaultPlan.drill)")
    ap.add_argument("--fault-plan", default=None,
                    help="with --supervise: JSON fault plan file "
                         "(FaultPlan.to_json) — exact replay of a prior run")
    ap.add_argument("--fault-lost-pods", type=int, default=0)
    ap.add_argument("--fault-lost-data-rows", type=int, default=0)
    ap.add_argument("--drain-deadline", type=float, default=30.0,
                    help="seconds the supervisor waits for the checkpoint "
                         "drain to quiesce after a fault")
    ap.add_argument("--grow-back-after", type=int, default=None,
                    help="degraded-mesh steps before resharding back onto "
                         "the full mesh (default: stay degraded)")
    ap.add_argument("--metrics-dir", default=None,
                    help="enable run-wide telemetry (repro_torch.obs): counters, "
                         "gauges, step_s/queue-depth histograms exported as "
                         "JSONL lines into <dir>/metrics.jsonl, plus an "
                         "end-of-run summary")
    ap.add_argument("--trace", action="store_true",
                    help="record nested span timers and write Chrome-trace "
                         "JSON (trace_*.json, one track per thread) into "
                         "--metrics-dir (or --ckpt-dir)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    obs_out = _setup_obs(args)
    if args.supervise:
        try:
            return _main_supervised(args, device)
        finally:
            _finish_obs(obs_out, args, tag="supervised")

    cfg = _arch_config(args)
    model = registry.build_model(cfg, device=device)
    mesh = make_host_mesh(device)
    scfg = _step_config(args)
    print(f"{cfg.name}: {param_count(model.specs())/1e6:.1f}M params, {cfg.n_layers} layers, "
          f"{describe(mesh)} ({device}), schedule={scfg.schedule}")

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    extra = {}
    if cfg.family in ("vlm", "audio"):
        kind = "vlm" if cfg.family == "vlm" else "audio"
        extra["prefix" if kind == "vlm" else "frames"] = torch.from_numpy(
            frontend_stub(cfg, args.batch, 0, kind)).to(torch.bfloat16)

    state = step_lib.init_state(model, mesh, torch.Generator(device=device).manual_seed(0),
                                step_cfg=scfg)
    step = step_lib.build_train_step(model, mesh, step_cfg=scfg, extra_keys=tuple(extra))
    policy = CodecPolicy(mode="sz_pwrel", eb=1e-4) if args.lossy_ckpt else CodecPolicy()
    ckpt = CheckpointManager(args.ckpt_dir, policy=policy, device=device)
    hook = (build_insitu_hook(mesh, f"{args.ckpt_dir}/fields", args.insitu_eb,
                              arena=not args.insitu_per_leaf, overlap=not args.insitu_sync)
            if args.insitu_snapshot else None)
    state, res = loop_lib.run(
        step, state, pipe, ckpt,
        loop_lib.LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                            snapshot_hook=hook),
        extra_batch=extra)
    if res.losses:
        print(f"done at step {res.final_step}; loss {res.losses[0]:.3f} -> "
              f"{res.losses[-1]:.3f}{' (preempted)' if res.preempted else ''}")
    else:
        print(f"done at step {res.final_step}; no step to run")
    _finish_obs(obs_out, args, tag="train")
    return 0


def _main_supervised(args, device: torch.device) -> int:
    """--supervise: the elastic fault drill / supervised production loop, on
    the one-rank host mesh of ``device``."""
    import functools

    # lazy: the supervisor pulls in faults/elastic; keep the plain path lean
    from repro_torch.train import faults as faults_lib
    from repro_torch.train import supervisor as sup

    cfg = _arch_config(args)
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise SystemExit("--supervise currently drives token-LM families only "
                         f"(got {cfg.family})")
    model = registry.build_model(cfg, device=device)
    mesh = make_host_mesh(device)
    full_shape = shardlib.mesh_sizes(mesh)
    if args.grad_comp and (args.fault_lost_pods or args.fault_lost_data_rows):
        # ef state is per pod — it cannot be restored across a pod-count
        # change (DESIGN.md §10, out of scope)
        raise SystemExit("--supervise with mesh shrink requires grad_comp "
                         "disabled (per-pod error-feedback state does not "
                         "survive a pod-count change)")
    scfg = _step_config(args)
    print(f"{cfg.name}: {param_count(model.specs())/1e6:.1f}M params, {cfg.n_layers} layers, "
          f"{describe(mesh)} ({device}, supervised), schedule={scfg.schedule}")

    injector = None
    if args.fault_plan is not None:
        plan = faults_lib.FaultPlan.from_json(Path(args.fault_plan).read_text())
    elif args.fault_seed is not None:
        plan = faults_lib.FaultPlan.drill(
            args.fault_seed, args.steps, args.ckpt_every,
            lost_pods=args.fault_lost_pods,
            lost_data_rows=args.fault_lost_data_rows)
    else:
        plan = None
    if plan is not None:
        injector = faults_lib.FaultInjector(plan, ckpt_dir=args.ckpt_dir)
        print(f"  fault plan: {plan.to_json()}")

    policy = CodecPolicy(mode="sz_pwrel", eb=1e-4) if args.lossy_ckpt else CodecPolicy()
    ckpt = CheckpointManager(
        args.ckpt_dir, policy=policy, device=device,
        write_bytes=injector.write_bytes if injector else None,
        fetch_hook=injector.fetch_hook if injector else None)
    if injector is not None:
        injector.manager = ckpt  # deterministic corrupt-newest under async

    builder = functools.partial(
        sup.make_trainer, model, vocab=cfg.vocab, seq_len=args.seq,
        step_cfg=scfg,
        insitu_dir=f"{args.ckpt_dir}/fields" if args.insitu_snapshot else None,
        insitu_eb=args.insitu_eb, insitu_overlap=not args.insitu_sync)
    scfg_sup = sup.SupervisorConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        drain_deadline_s=args.drain_deadline,
        grow_back_after=args.grow_back_after)
    _, res = sup.run_supervised(builder, full_shape, args.batch, ckpt,
                                scfg_sup, injector=injector)
    shrinks = [t for t in res.transitions if t.kind == "shrink"]
    grows = [t for t in res.transitions if t.kind == "grow"]
    print(f"done at step {res.final_step}; {len(shrinks)} shrink / "
          f"{len(grows)} grow transition(s), "
          f"{sum(t.quarantined for t in shrinks)} snapshot(s) quarantined; "
          f"loss {res.loss_trace[0][1]:.3f} -> {res.loss_trace[-1][1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
