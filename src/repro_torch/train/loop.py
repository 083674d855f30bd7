"""Fault-tolerant training loop (the port of ``repro.train.loop``).

Posture for 1000+ nodes, as the reference's:
  * resume-from-step: data pipeline is a pure function of step, checkpoint
    carries (step, data seed) — restart is exact, no dup/skip batches;
  * preemption safety: SIGTERM/SIGINT triggers save-then-exit at the next
    step boundary;
  * straggler mitigation: per-step wall-clock deadline; steps that exceed it
    are logged (on real fleets this feeds the scheduler's replace-node
    logic; here it feeds metrics + tests);
  * heartbeat file: external watchdogs detect a hung trainer by mtime;
  * NaN circuit breaker: non-finite loss aborts before corrupting the
    checkpoint chain (the last good checkpoint stays adoptable).

The loss is read back once per step (``float(metrics["loss"])``, which
waits for the device), as the reference blocks on it.  A restored state
comes back from the checkpoint manager as host tensors and is moved onto
the devices of the state the caller passed.  :class:`TrainingFault`
(defined in ``train/faults.py``, one class for both modules) is the base of
the faults a ``fault_check`` raises to abort into the supervisor
(``train/supervisor.py``).
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import sharding as shardlib
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.faults import TrainingFault


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 100
    log_every: int = 10
    step_deadline_s: float = 600.0  # straggler threshold
    heartbeat_path: Optional[str] = None
    abort_on_nan: bool = True
    # called as snapshot_hook(step, state) at every checkpoint boundary —
    # the in-situ field-snapshot hook (launch.train.build_insitu_hook:
    # large leaves are compressed on their devices and only compressed
    # bytes reach the host)
    snapshot_hook: Optional[Callable[[int, Any], None]] = None
    # called as fault_check(step) before each step's compute — the fault
    # detector (on a real fleet: heartbeat/membership watch; in the drill:
    # the fault injector's check).  Raises a TrainingFault to abort into
    # the supervisor, which owns
    # quiescing the checkpoint drain under a deadline — the loop must NOT
    # block on ckpt.wait() on that path (the drain may be the casualty)
    fault_check: Optional[Callable[[int], None]] = None


@dataclasses.dataclass
class LoopResult:
    final_step: int
    losses: list
    stragglers: list
    preempted: bool
    nan_abort: bool
    # wall-clock of each snapshot_hook call — for an overlapped hook
    # (launch.train.build_insitu_hook(overlap=True)) this is only the
    # *dispatch* cost: the compress + D2H + disk drain hide behind later
    # steps, so the accountable number is the step-time blip, not this
    snapshot_s: list = dataclasses.field(default_factory=list)
    # wall-clock of every train step (loss readback included): step_s at a
    # snapshot boundary minus the steady-state p50 IS the snapshot's
    # step-time blip
    step_s: list = dataclasses.field(default_factory=list)


def run(train_step: Callable, state: Any, pipeline: TokenPipeline,
        ckpt: CheckpointManager, cfg: LoopConfig,
        put_batch: Optional[Callable] = None,
        start_step: Optional[int] = None,
        extra_batch: Optional[dict] = None) -> tuple[Any, LoopResult]:
    """Run until total_steps, resuming from the checkpoint chain."""
    preempted = {"flag": False}

    def _on_signal(signum, frame):  # noqa: ARG001
        preempted["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _on_signal)
    old_int = signal.signal(signal.SIGINT, _on_signal)

    if start_step is None:
        if ckpt.latest_step() is None:
            start_step = 0
        else:
            # newest *valid* snapshot: corrupt steps are quarantined and
            # fallen past, and the loop resumes from the step actually
            # adopted (which may be older than latest_step said)
            restored, extra, start_step = ckpt.restore_latest_valid(
                state_like=state)
            state = _onto(restored, state)

    losses: list[float] = []
    stragglers: list[int] = []
    snapshot_s: list[float] = []
    step_s: list[float] = []
    nan_abort = False
    step = start_step
    hb = Path(cfg.heartbeat_path) if cfg.heartbeat_path else None
    # process-global instruments (no-ops until repro_torch.obs is enabled): the
    # step histogram is what the end-of-run summary's p50/p99 come from
    _h_step = obs_metrics.histogram("train.step_s")
    _h_snap = obs_metrics.histogram("train.snapshot_dispatch_s")

    def _snapshot(s, st) -> None:
        t = time.time()
        with obs_trace.span("snapshot.dispatch", step=s):
            cfg.snapshot_hook(s, st)
        dt = time.time() - t
        snapshot_s.append(dt)
        _h_snap.observe(dt)

    faulted = False
    try:
        while step < cfg.total_steps:
            if cfg.fault_check is not None:
                cfg.fault_check(step)
            t0 = time.time()
            with obs_trace.span("train.step", step=step):
                batch = pipeline.batch_at(step)
                if extra_batch:
                    batch = {**batch, **extra_batch}
                if put_batch is not None:
                    batch = put_batch(batch)
                state, metrics = train_step(state, batch)
                loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            step_s.append(dt)
            _h_step.observe(dt)
            if not np.isfinite(loss):
                nan_abort = True
                obs_metrics.event("train.nan", step=step)
                if cfg.abort_on_nan:
                    break
            losses.append(loss)
            if dt > cfg.step_deadline_s:
                stragglers.append(step)
                obs_metrics.event("train.straggler", step=step,
                                  step_s=round(dt, 6))
            if hb is not None:
                hb.write_text(json.dumps({"step": step, "t": time.time(), "loss": loss}))
            step += 1
            if cfg.log_every and step % cfg.log_every == 0:
                # periodic metrics line: step_s percentiles plus whatever
                # the drain thread's gauges read right now (queue depth,
                # in-flight) — the run's JSONL heartbeat
                obs_metrics.export_snapshot(step=step)
            snapped = False
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                with obs_trace.span("ckpt.save", step=step):
                    ckpt.save(step, state, extra={"data_step": step})
                if cfg.snapshot_hook is not None:
                    _snapshot(step, state)
                    snapped = True
            if preempted["flag"]:
                ckpt.save(step, state, extra={"data_step": step, "preempted": True})
                if cfg.snapshot_hook is not None and not snapped:
                    # the preemption save is a checkpoint boundary too — the
                    # field snapshot must not lag the state you restart from
                    _snapshot(step, state)
                break
    except Exception as e:
        # an injected/detected fault aborts into the supervisor, which
        # quiesces the drain under its own deadline — blocking on
        # ckpt.wait() here could hang forever on the very component that
        # just failed
        faulted = isinstance(e, TrainingFault)
        if faulted:
            obs_metrics.event("train.fault", step=step,
                              fault=type(e).__name__)
            # the supervisor needs the partial segment's trace (losses up
            # to the fault) for its loss-continuity check across restore
            e.partial = LoopResult(step, losses, stragglers, preempted["flag"],
                                   nan_abort, snapshot_s, step_s)
        raise
    finally:
        if not faulted:
            ckpt.wait()
            if cfg.snapshot_hook is not None and hasattr(cfg.snapshot_hook, "wait"):
                # overlapped hooks drain in the background; the loop must not
                # exit with snapshots still in flight (their device slots and
                # disk writes would die with the process)
                cfg.snapshot_hook.wait()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)

    return state, LoopResult(step, losses, stragglers, preempted["flag"],
                             nan_abort, snapshot_s, step_s)


def _onto(restored: Any, like: Any) -> Any:
    """The restored tree with each tensor leaf where its counterpart in
    ``like`` is: on its device, and where ``like``'s leaf is a ``DTensor``
    block and the restored one a whole host tensor, this rank's block of it
    placed the same way (the manager restores onto the host unless given
    shardings)."""
    flat_r, treedef = tree_util.tree_flatten(restored)
    flat_l = tree_util.tree_flatten(like)[0]
    if len(flat_r) != len(flat_l):
        raise ValueError(f"restored state has {len(flat_r)} leaves, the live one {len(flat_l)}")

    def one(r, l):
        if not isinstance(r, torch.Tensor) or not isinstance(l, torch.Tensor):
            return r
        if shardlib.is_dtensor(r):
            return r
        if shardlib.is_dtensor(l):
            return shardlib.place(r, shardlib.NamedSharding(l.device_mesh, shardlib.spec_of(l)))
        return r.to(l.device)

    return tree_util.tree_unflatten(treedef, [one(r, l) for r, l in zip(flat_r, flat_l)])
