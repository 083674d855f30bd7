"""Supervised elastic training (the port of ``repro.train.supervisor``): the
layer between "the pieces compose" and "the run survives".

``run_supervised`` drives ``train.loop.run`` in mesh-homogeneous *segments*
and owns every reconfiguration between them.  On a detected fault
(:class:`train.faults.PodLossFault`, raised out of the loop by the
``fault_check`` hook — on a real fleet, by the membership watchdog):

  1. **quiesce** the checkpoint drain queue under ``drain_deadline_s``
     (``CheckpointManager.quiesce`` — bounded, never hangs on a wedged
     drain worker; a pending drain error is consumed and logged, not
     fatal: the snapshot it lost is exactly what the restore rolls past);
  2. **shrink** the mesh along fault domains
     (``train.elastic.degraded_mesh_shape``) and rebalance the global
     batch (``train.elastic.rebalance_batch``);
  3. **restore** the newest *valid* snapshot
     (``CheckpointManager.restore_latest_valid`` — CRC-verified, corrupt
     steps quarantined and fallen past) onto the shrunk mesh;
  4. **resume** training from the restored step, re-checking that the
     replayed step's loss matches the pre-fault trace (the restore was
     real, not garbage) when the batch schedule is unchanged;
  5. **grow back** ``grow_back_after`` steps later: the live state is
     carried onto the full mesh — no restore, no lost steps — and training
     continues to completion.

Guarantees asserted (violations raise :class:`SupervisorError`):
  * step-count monotonicity: every segment advances; a rollback only
    happens at a shrink transition and never exceeds one checkpoint
    interval per snapshot that failed verification (at-most-one lost
    interval when the newest snapshot is intact);
  * loss continuity: the first replayed loss after a restore matches the
    pre-fault loss at the same step within ``continuity_rtol`` (same
    batch schedule), and the first post-grow-back loss stays within
    ``grow_jump_rtol`` of the last degraded-mesh loss;
  * no silent corrupt restore: a snapshot either passes every CRC or is
    quarantined — inherited from the manager, surfaced here as the
    ``quarantined`` count per transition.

One process per rank (what the port adds; the reference runs its drill on
forced single-process devices).  Every rank of the world calls
``run_supervised`` with the same plan, so a planned pod loss rises on every
rank at the same step.

  * **Survivors** are the lowest-numbered ranks
    (``elastic.make_degraded_mesh``): the lost pods and data rows are the
    highest-indexed.  Rank 0 always survives.
  * **Lost ranks** stay alive and take no steps, but take part in every
    collective construction (``builder``'s ``DeviceMesh`` and groups are
    built by every rank of the world), then wait for the grow-back or the
    end of the run.  After each segment rank 0 sends every rank its outcome (the
    fault, or the final step, and the losses) on a ``gloo`` group over the
    world, so every rank records the same trace and transitions.
  * **One writer.**  ``ckpt`` must write on rank 0 alone (a
    ``CheckpointManager`` with a ``group``); the injector applies its disk
    faults there alone (``FaultInjector.manager``).
  * **Restore is decided once**: rank 0 runs ``restore_latest_valid`` (it
    verifies, quarantines and adopts a step), and the other survivors
    restore that step onto their blocks (``restore(shardings=)`` with the
    shrunk mesh's :attr:`Trainer.shardings`).
  * **Grow-back is bitwise and loses no step**: each rank of a rejoining
    pod gets the blocks of the surviving rank at its own (data, model)
    coordinate, and after lost data rows each rank of the full mesh gets
    its blocks' rows from the survivors that hold them
    (``elastic.grow_back``).  There is no restore.
  * **Checkpoints follow the mesh**: a save of split leaves is a collective
    of the mesh's ranks, so each rebuild gives the manager a ``gloo`` group
    over the new mesh's ranks (after its pending saves have drained).

The state is sharded as ``train.step.make_state_specs`` says (FSDP over
``data``, tensor and expert axes over ``model``) and :class:`Trainer`
carries its shardings, as the reference's does.  Out of scope, as in the
reference (DESIGN.md §10): Byzantine hosts, and in-flight optimizer-state
reshaping (``ef`` is per pod, so ``--grad-comp`` is refused with a shrink).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train import elastic
from repro_torch.train import faults as faults_lib
from repro_torch.train import loop as loop_lib


class SupervisorError(RuntimeError):
    """A survivability guarantee was violated (lost more than the allowed
    checkpoint intervals, discontinuous loss after restore, no progress)."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    total_steps: int
    ckpt_every: int = 10
    drain_deadline_s: float = 30.0
    # steps to train on the degraded mesh before growing back to the full
    # mesh (None: stay degraded to completion)
    grow_back_after: Optional[int] = None
    # replayed-step loss agreement after a restore (same batch schedule);
    # loose enough for cross-mesh reduction-order drift, tight enough that
    # a wrong restore (different weights) cannot pass
    continuity_rtol: float = 0.05
    # adjacent-step loss jump allowed across the grow-back reshard
    grow_jump_rtol: float = 0.5
    max_restore_fallbacks: int = 4
    max_faults: int = 4


@dataclasses.dataclass
class Trainer:
    """Everything mesh-specific the supervisor needs for one segment.
    Built by a ``builder(mesh_shape, global_batch)`` callable so shrink /
    grow-back can rebuild it for any surviving topology.  On a rank the
    mesh leaves out, ``train_step`` is never called (it may be None)."""

    mesh: Any
    mesh_shape: dict
    global_batch: int
    train_step: Optional[Callable]  # (state, batch) -> (state, metrics)
    pipeline: Any  # batch_at(step), pure function of step
    put_batch: Optional[Callable]
    make_state: Callable[[], Any]  # fresh step-0 state on this mesh
    snapshot_hook: Optional[Callable] = None
    shardings: Any = None  # the state's NamedSharding tree on this mesh


@dataclasses.dataclass
class Transition:
    kind: str  # "shrink" | "grow"
    at_step: int  # loop step where the transition was taken
    resume_step: int  # step training resumed from afterwards
    mesh_shape: dict
    global_batch: int
    restored_step: Optional[int] = None  # shrink only
    drain_clean: bool = True  # drain queue empty within the deadline
    drain_error: Optional[str] = None  # consumed drain-thread failure
    quarantined: int = 0  # corrupt snapshots fallen past


@dataclasses.dataclass
class SupervisorResult:
    final_step: int
    loss_trace: list  # (step, loss) in execution order, across segments
    transitions: list
    segments: list  # {"start", "end", "mesh_shape", "global_batch"}
    continuity: list  # (step, loss_before, loss_after, kind) checks made


def make_trainer(model, mesh_shape: dict, global_batch: int, *, vocab: int,
                 seq_len: int = 16, data_seed: int = 0, param_seed: int = 0,
                 step_cfg=None, insitu_dir=None, insitu_eb: float = 1e-3,
                 insitu_min_bytes: int = 1 << 20,
                 insitu_overlap: bool = True) -> Trainer:
    """Concrete :class:`Trainer` builder over ``train.step`` +
    ``data.tokens`` (+ optionally ``launch.train.build_insitu_hook``), on
    the model's device.  Partially apply everything but ``(mesh_shape,
    global_batch)`` to get the ``builder`` callable ``run_supervised``
    wants.  Collective with one process per rank: every rank of the world
    calls it."""
    from repro_torch.data.tokens import DataConfig, TokenPipeline
    from repro_torch.train import step as step_lib

    device = model.device
    mesh = elastic.make_degraded_mesh(mesh_shape, device.type)
    scfg = step_cfg or step_lib.TrainStepConfig()
    pipe = TokenPipeline(DataConfig(vocab=vocab, seq_len=seq_len,
                                    global_batch=global_batch, seed=data_seed))
    member = mesh.get_coordinate() is not None
    train_step = step_lib.build_train_step(model, mesh, scfg) if member else None
    _, shardings = step_lib.make_state_specs(model, mesh, scfg)

    hook = None
    if insitu_dir is not None:
        from repro_torch.launch.train import build_insitu_hook  # lazy: no cycle

        hook = build_insitu_hook(mesh, insitu_dir, insitu_eb,
                                 min_bytes=insitu_min_bytes,
                                 overlap=insitu_overlap)

    def make_state():
        return step_lib.init_state(model, mesh,
                                   torch.Generator(device=device).manual_seed(param_seed),
                                   step_cfg=scfg)

    return Trainer(mesh=mesh, mesh_shape=dict(mesh_shape),
                   global_batch=global_batch, train_step=train_step,
                   pipeline=pipe, put_batch=None, make_state=make_state,
                   snapshot_hook=hook, shardings=shardings)


def _quiesce_all(trainer: Trainer, ckpt: CheckpointManager,
                 deadline_s: float) -> tuple[bool, Optional[BaseException]]:
    """Quiesce the state-checkpoint drain and (if present) the in-situ
    snapshot hook's manager under one shared deadline."""
    t0 = time.monotonic()
    drained, err = ckpt.quiesce(deadline_s)
    hook_mgr = getattr(trainer.snapshot_hook, "manager", None)
    if hook_mgr is not None:
        left = max(0.0, deadline_s - (time.monotonic() - t0))
        d2, e2 = hook_mgr.quiesce(left)
        drained = drained and d2
        err = err or e2
    return drained, err


def _check_continuity(trace: dict, step: int, loss: float, rtol: float,
                      kind: str, out: list) -> None:
    before = trace.get(step)
    if before is None:
        return
    out.append((step, before, loss, kind))
    if not np.isfinite(loss):
        raise SupervisorError(f"non-finite loss {loss} at step {step} "
                              f"after {kind}")
    if abs(loss - before) > rtol * max(abs(before), 1e-8):
        raise SupervisorError(
            f"loss discontinuity after {kind} at step {step}: "
            f"{before:.6f} -> {loss:.6f} (rtol {rtol})")


def _member(trainer: Trainer) -> bool:
    """Whether this process is a rank of the trainer's mesh."""
    return trainer.mesh.get_coordinate() is not None


class _Ranks:
    """The processes of a supervised run: one, or one per rank of the world
    (rank 0 decides, restores and writes; the others follow)."""

    def __init__(self, ckpt: CheckpointManager):
        self.multi = dist.is_initialized() and dist.get_world_size() > 1
        self.first = not self.multi or dist.get_rank() == 0
        if ckpt.is_writer() != self.first:
            raise ValueError("one process per rank: the checkpoint manager must write on "
                             "rank 0 alone (give it a group, CheckpointManager(group=...))")
        self.ctl = dist.new_group(backend="gloo") if self.multi else None
        self.ckpt = ckpt

    def share(self, obj: Any) -> Any:
        """Rank 0's ``obj``, on every rank of the world."""
        if not self.multi:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.ctl)
        return box[0]

    def rebuilt(self, trainer: Trainer) -> Trainer:
        """Called on every rank after each builder call: the checkpoint
        manager saves over a group of the new mesh's ranks (created by every
        rank of the world, once this rank's pending saves have drained)."""
        if self.multi:
            self.ckpt.wait()
            group = dist.new_group(ranks=list(range(trainer.mesh.size())), backend="gloo")
            self.ckpt.set_group(group)
        return trainer

    def restore(self, ckpt: CheckpointManager, state: Any, trainer: Trainer,
                max_fallbacks: int) -> tuple[Any, int, int]:
        """Rank 0 restores the newest valid step; the mesh's other ranks
        restore that step: ``(state, step, quarantined)``, each rank's blocks
        on ``trainer``'s mesh."""
        info, err, restored = None, None, None
        if self.first:
            before = len(list(ckpt.dir.glob("quarantine/*")))
            try:
                restored, _, rstep = ckpt.restore_latest_valid(
                    state_like=state, shardings=trainer.shardings,
                    max_fallbacks=max_fallbacks)
                info = (rstep, len(list(ckpt.dir.glob("quarantine/*"))) - before, None)
            except Exception as e:  # every rank must learn that the restore failed
                err, info = e, (None, 0, repr(e))
        rstep, quarantined, failed = self.share(info)
        if failed is not None:
            if err is not None:
                raise err
            raise SupervisorError(f"rank 0 could not restore: {failed}")
        if restored is None and _member(trainer):
            restored, _ = ckpt.restore(rstep, state_like=state, shardings=trainer.shardings)
        if restored is not None:
            state = loop_lib._onto(restored, state)
        return state, rstep, quarantined


def _segment(trainer: Trainer, state: Any, ckpt: CheckpointManager,
             lcfg: loop_lib.LoopConfig, step: int, injector) -> tuple[Any, dict]:
    """One segment of ``train.loop.run`` on this rank: the state and the
    segment's outcome (plain data, what rank 0 sends the others)."""
    try:
        state, res = loop_lib.run(trainer.train_step, state, trainer.pipeline, ckpt, lcfg,
                                  put_batch=trainer.put_batch, start_step=step)
    except faults_lib.PodLossFault as f:
        out = {"fault": {"step": f.step, "lost_pods": f.lost_pods,
                         "lost_data_rows": f.lost_data_rows, "name": type(f).__name__,
                         "text": str(f)},
               "losses": None if f.partial is None else list(f.partial.losses)}
    else:
        out = {"fault": None, "losses": list(res.losses), "final_step": res.final_step,
               "preempted": res.preempted, "nan_abort": res.nan_abort}
    out["log"] = list(getattr(injector, "log", []))
    return state, out


def run_supervised(builder: Callable[[dict, int], Trainer],
                   full_shape: dict, global_batch: int,
                   ckpt: CheckpointManager, cfg: SupervisorConfig,
                   injector=None,
                   log: Callable[[str], None] = print
                   ) -> tuple[Any, SupervisorResult]:
    """Run to ``cfg.total_steps`` surviving injected/detected faults.
    ``builder(mesh_shape, global_batch) -> Trainer`` is called for the
    full mesh, again after every shrink, and once more at grow-back.
    ``injector`` (e.g. ``faults.FaultInjector``) supplies the loop's
    ``fault_check``; pass None to supervise without injection (real
    detectors can raise ``PodLossFault`` from their own hook).  With one
    process per rank every rank calls this with the same arguments (module
    docstring); each returns its state and the same result."""
    full_shape = dict(full_shape)
    ranks = _Ranks(ckpt)
    if ranks.multi and injector is not None and getattr(injector, "manager", None) is None:
        injector.manager = ckpt  # disk faults on the writing rank alone
    trainer = ranks.rebuilt(builder(dict(full_shape), global_batch))
    state = trainer.make_state()
    step = 0
    if ranks.share(ckpt.latest_step() is not None):  # process-restart resume
        state, step, _ = ranks.restore(ckpt, state, trainer, cfg.max_restore_fallbacks)

    fault_check = getattr(injector, "check_step", None)
    trace: dict[int, float] = {}  # step -> most recent executed loss
    result = SupervisorResult(step, [], [], [], [])
    degraded = False
    grow_at: Optional[int] = None
    faults_handled = 0

    def _record(seg_start: int, losses, pending_check=None) -> int:
        for i, loss in enumerate(losses):
            s = seg_start + i
            if i == 0 and pending_check is not None:
                rtol, kind = pending_check
                _check_continuity(trace, s, loss, rtol, kind,
                                  result.continuity)
            trace[s] = loss
            result.loss_trace.append((s, loss))
        return seg_start + len(losses)

    pending_check = None
    while step < cfg.total_steps:
        target = cfg.total_steps
        if degraded and grow_at is not None:
            target = min(target, grow_at)
        lcfg = loop_lib.LoopConfig(total_steps=target,
                                   ckpt_every=cfg.ckpt_every,
                                   snapshot_hook=trainer.snapshot_hook,
                                   fault_check=fault_check)
        seg_start = step
        out = None
        if _member(trainer):  # a lost rank waits here for rank 0's outcome
            state, out = _segment(trainer, state, ckpt, lcfg, step, injector)
        out = ranks.share(out)
        f = out["fault"]
        if f is not None:
            faults_handled += 1
            if faults_handled > cfg.max_faults:
                raise SupervisorError(
                    f"{faults_handled} faults exceed max_faults="
                    f"{cfg.max_faults}")
            if out["losses"] is not None:
                _record(seg_start, out["losses"], pending_check)
                pending_check = None
            result.segments.append({
                "start": seg_start, "end": f["step"],
                "mesh_shape": dict(trainer.mesh_shape),
                "global_batch": trainer.global_batch})
            log(f"  supervisor: {f['text']} — quiescing drain "
                f"(deadline {cfg.drain_deadline_s}s)")
            obs_metrics.event("supervisor.casualty", step=f["step"],
                              fault=f["name"],
                              lost_pods=f["lost_pods"],
                              lost_data_rows=f["lost_data_rows"])
            with obs_trace.span("supervisor.quiesce", step=f["step"]):
                drained, derr = _quiesce_all(trainer, ckpt,
                                             cfg.drain_deadline_s)
            # the writer's drain is the one that can fail
            drained, derr_s, derr_r = ranks.share(
                (drained, None if derr is None else str(derr),
                 None if derr is None else repr(derr)))
            if derr_s is not None:
                # the drain's casualty is at most the newest in-flight
                # snapshot — exactly what the restore is allowed to lose
                log(f"  supervisor: drain error consumed: {derr_s}")
                obs_metrics.event("supervisor.drain_error", step=f["step"],
                                  error=derr_r)
            if injector is not None and hasattr(injector, "repair_drain"):
                injector.repair_drain()  # "replace" the drain worker host

            new_shape = elastic.degraded_mesh_shape(
                trainer.mesh_shape, f["lost_pods"], f["lost_data_rows"])
            new_batch = elastic.rebalance_batch(global_batch, new_shape)
            trainer = ranks.rebuilt(builder(new_shape, new_batch))
            with obs_trace.span("supervisor.restore", at_step=f["step"]):
                state, rstep, quarantined = ranks.restore(
                    ckpt, state, trainer, cfg.max_restore_fallbacks)
            if rstep > f["step"]:
                raise SupervisorError(
                    f"restored step {rstep} is ahead of the fault step "
                    f"{f['step']} — monotonicity broken")
            # at-most-one lost interval per *casualty*: the partial interval
            # being trained (+1), each snapshot that failed verification
            # (quarantined), and — when the drain itself was the casualty —
            # the one snapshot that may have died in flight
            max_lost = cfg.ckpt_every * (
                1 + quarantined + (1 if derr_s is not None else 0))
            if f["step"] - rstep > max_lost:
                raise SupervisorError(
                    f"lost {f['step'] - rstep} steps (> {max_lost}) restoring "
                    f"from step {rstep}: more than one checkpoint interval "
                    f"per casualty ({quarantined} quarantined, drain "
                    f"{'failed' if derr_s is not None else 'clean'})")
            result.transitions.append(Transition(
                "shrink", f["step"], rstep, dict(new_shape), new_batch,
                restored_step=rstep, drain_clean=drained,
                drain_error=derr_r, quarantined=quarantined))
            log(f"  supervisor: restored step {rstep} onto mesh "
                f"{new_shape} (batch {new_batch}, "
                f"{quarantined} quarantined)")
            obs_metrics.event("supervisor.shrink", at_step=f["step"],
                              resume_step=rstep, mesh=str(new_shape),
                              batch=new_batch, quarantined=quarantined,
                              drain_clean=drained)
            step = rstep
            degraded = True
            if cfg.grow_back_after is not None:
                grow_at = rstep + cfg.grow_back_after
            # replaying the restored step must reproduce its loss — only
            # checkable when the batch schedule is unchanged
            if new_batch == global_batch:
                pending_check = (cfg.continuity_rtol, "shrink-restore")
            continue

        _record(seg_start, out["losses"], pending_check)
        pending_check = None
        result.segments.append({
            "start": seg_start, "end": out["final_step"],
            "mesh_shape": dict(trainer.mesh_shape),
            "global_batch": trainer.global_batch})
        if out["nan_abort"]:
            raise SupervisorError(f"NaN loss at step {out['final_step']}")
        if out["final_step"] <= seg_start and not out["preempted"]:
            raise SupervisorError(
                f"no progress in segment starting at {seg_start}")
        step = out["final_step"]
        if out["preempted"]:
            break
        if degraded and grow_at is not None and step >= grow_at \
                and step < cfg.total_steps:
            # grow back: the live state carries onto the full mesh —
            # bitwise (each surviving block to its rejoining pods), no
            # restore, zero lost steps
            shrunk = dict(trainer.mesh_shape)
            trainer = ranks.rebuilt(builder(dict(full_shape), global_batch))
            with obs_trace.span("supervisor.grow_back", step=step):
                if trainer.shardings is not None:
                    state = elastic.grow_back(state, trainer.shardings, shrunk)
            if not ranks.first and hasattr(injector, "adopt_log"):
                injector.adopt_log(out["log"])  # a rejoining rank's fired events
            result.transitions.append(Transition(
                "grow", step, step, dict(full_shape), global_batch))
            log(f"  supervisor: grew back to mesh {full_shape} at "
                f"step {step}")
            obs_metrics.event("supervisor.grow", step=step,
                              mesh=str(full_shape), batch=global_batch)
            degraded = False
            grow_at = None
            if trace:
                last = max(trace)
                # continuity across grow: the next loss may move one
                # step's worth, not jump — anchor the check on the step
                # about to execute against the last executed loss
                trace[step] = trace[last]
                pending_check = (cfg.grow_jump_rtol, "grow-back")

    result.final_step = step
    # executed-step monotonicity over the whole run: within and across
    # segments steps advance by exactly one; the only allowed backward jump
    # is a shrink-restore rollback (already bounded above)
    for a, b in zip(result.loss_trace, result.loss_trace[1:]):
        if b[0] > a[0] + 1:
            raise SupervisorError(
                f"step trace skipped {a[0]} -> {b[0]} — monotonicity broken")
    return state, result
