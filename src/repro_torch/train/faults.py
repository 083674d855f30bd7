"""Deterministic fault injection for the elastic training drill (the port of
``repro.train.faults``).

The paper's compressed snapshots only pay off if a run can actually lose
hardware and come back from one.  This module is the *adversary* half of
that story: a seeded :class:`FaultPlan` (a list of :class:`FaultEvent`
keyed by step) and a :class:`FaultInjector` that delivers the plan through
explicit hook points — never by monkeypatching — so the exact same plan
replays the exact same failure sequence:

  * ``injector.check_step``   -> ``train.loop.LoopConfig.fault_check``
    (raises :class:`PodLossFault` at planned steps; applies scheduled disk
    corruption; arms drain/fetch faults)
  * ``injector.write_bytes``  -> ``CheckpointManager(write_bytes=...)``
    (transient ``OSError`` bursts that exercise the drain retry, or a
    persistent poison that kills the drain worker)
  * ``injector.fetch_hook``   -> ``CheckpointManager(fetch_hook=...)``
    (stalls the deferred host fetch on the drain thread)

Fault kinds
-----------
``pod_loss``          simulated loss of ``lost_pods`` pods and/or
                      ``lost_data_rows`` data rows; raised into the loop as
                      :class:`PodLossFault` for the supervisor to handle.
``drain_io``          the next ``count`` payload writes raise a transient
                      ``OSError`` (the drain worker's bounded backoff retry
                      must absorb ``count <= io_retries - 1``).
``drain_poison``      every payload write fails until the supervisor calls
                      :meth:`FaultInjector.repair_drain` — the moral
                      equivalent of the drain worker's host dying.
``corrupt_payload``   flip or truncate bytes of one payload file in the
                      newest completed snapshot (seeded choice).
``corrupt_manifest``  same, against ``MANIFEST.json``.
``fetch_stall``       the next deferred host fetch sleeps ``stall_s`` on
                      the drain thread (what a wedged DMA looks like to the
                      supervisor's quiesce deadline).

Every fired event lands in ``injector.log`` as ``(step, kind)`` so tests
can assert a replayed plan fired identically.  Events fire **at most
once**: after a pod loss rolls the run back past the fault step, the
replayed steps must not lose the same pod twice.

With one process per rank every rank holds an injector over the same plan,
so a pod loss rises on every rank at the same step.  The disk faults
(corruption, drain I/O, fetch stalls) are applied only where the
injector's ``manager`` writes the snapshots (``CheckpointManager.is_writer``):
a bit flipped by two ranks would flip back.

``TrainingFault`` is ``train.loop.TrainingFault``, one class: the loop
tells an injected fault from a crash by it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

# sort order doubles as same-step application order (plans sort by
# (step, kind index)): pod_loss is last so same-step corruption/arming is
# already applied when the loss is raised into the supervisor
FAULT_KINDS = ("drain_io", "drain_poison", "fetch_stall", "corrupt_payload",
               "corrupt_manifest", "pod_loss")
CORRUPT_MODES = ("bitflip", "truncate")


class TrainingFault(RuntimeError):
    """Base class for injected faults that abort the training loop.  The
    loop lets these propagate to the supervisor *without* draining the
    checkpoint queue first (the supervisor quiesces under a deadline), and
    attaches the partial segment's ``LoopResult`` as ``.partial`` so the
    supervisor can check loss continuity across the restore."""

    partial = None  # set by train.loop on the abort path


class PodLossFault(TrainingFault):
    """Simulated loss of part of the mesh, detected at a step boundary."""

    def __init__(self, step: int, lost_pods: int = 0, lost_data_rows: int = 0):
        super().__init__(
            f"pod loss at step {step}: -{lost_pods} pods, "
            f"-{lost_data_rows} data rows")
        self.step = step
        self.lost_pods = lost_pods
        self.lost_data_rows = lost_data_rows


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault.  ``step`` is the loop step at whose *start* the
    event fires (before that step's compute)."""

    step: int
    kind: str
    lost_pods: int = 0
    lost_data_rows: int = 0
    count: int = 1          # drain_io: number of consecutive failing writes
    mode: str = "bitflip"   # corrupt_*: bitflip | truncate
    stall_s: float = 0.0    # fetch_stall
    seed: int = 0           # corrupt_*: RNG for byte/file choice

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"one of {CORRUPT_MODES}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, replayable fault schedule.  Two plans built from the
    same seed/arguments are equal, serialize to the same JSON, and drive
    byte-identical injections."""

    events: tuple[FaultEvent, ...]

    @classmethod
    def from_events(cls, events) -> "FaultPlan":
        evs = tuple(sorted(events, key=lambda e: (e.step, FAULT_KINDS.index(e.kind))))
        return cls(evs)

    @classmethod
    def drill(cls, seed: int, total_steps: int, ckpt_every: int,
              lost_pods: int = 0, lost_data_rows: int = 0) -> "FaultPlan":
        """The canonical drill: one transient-I/O burst, one corruption of
        the newest snapshot, one fetch stall, then a pod loss — all placed
        deterministically from ``seed`` inside the first two checkpoint
        intervals so the run still has room to recover and grow back."""
        rng = np.random.default_rng(seed)
        # the pod loss lands strictly after the second checkpoint boundary
        fault_step = 2 * ckpt_every + 1 + int(rng.integers(0, ckpt_every))
        if fault_step >= total_steps:
            raise ValueError(f"total_steps={total_steps} too short for a "
                             f"drill with ckpt_every={ckpt_every}")
        return cls.from_events([
            FaultEvent(step=ckpt_every + 1, kind="drain_io",
                       count=int(rng.integers(1, 3))),
            FaultEvent(step=ckpt_every + 1, kind="fetch_stall",
                       stall_s=float(rng.uniform(0.05, 0.2))),
            FaultEvent(step=fault_step, kind="corrupt_payload",
                       mode=CORRUPT_MODES[int(rng.integers(0, 2))],
                       seed=int(rng.integers(0, 2**31))),
            FaultEvent(step=fault_step, kind="pod_loss",
                       lost_pods=lost_pods, lost_data_rows=lost_data_rows),
        ])

    def at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    # ------------------------------------------------------ serialization --
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_events(FaultEvent(**d) for d in json.loads(text))


# ------------------------------------------------------- disk corruption --


def corrupt_snapshot(step_dir: Path, target: str = "payload",
                     mode: str = "bitflip", seed: int = 0) -> Path:
    """Corrupt one file of a completed snapshot directory in place and
    return its path.  ``target`` is ``payload`` (a seeded choice among the
    ``*.bin`` payloads) or ``manifest``; ``mode`` is ``bitflip`` (one
    seeded byte XOR 0xFF) or ``truncate`` (drop the tail half).  Used by
    the injector and directly by the corruption-matrix tests."""
    step_dir = Path(step_dir)
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    rng = np.random.default_rng(seed)
    if target == "manifest":
        victim = step_dir / "MANIFEST.json"
    elif target == "payload":
        bins = sorted(step_dir.glob("*.bin"))
        if not bins:
            raise FileNotFoundError(f"no payloads to corrupt in {step_dir}")
        victim = bins[int(rng.integers(0, len(bins)))]
    else:
        raise ValueError(f"unknown corrupt target {target!r}")
    raw = bytearray(victim.read_bytes())
    if not raw:
        raise IOError(f"{victim} is empty; nothing to corrupt")
    if mode == "truncate":
        victim.write_bytes(bytes(raw[: max(1, len(raw) // 2)]))
    else:
        raw[int(rng.integers(0, len(raw)))] ^= 0xFF
        victim.write_bytes(bytes(raw))
    return victim


def newest_snapshot_dir(ckpt_dir: Path) -> Optional[Path]:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    return steps[-1] if steps else None


# ------------------------------------------------------------- injector --


class FaultInjector:
    """Delivers a :class:`FaultPlan` through hook points.

    Thread-safety: ``check_step`` runs on the training thread;
    ``write_bytes``/``fetch_hook`` run on the checkpoint drain thread.
    Armed-fault state is guarded by one lock."""

    def __init__(self, plan: FaultPlan, ckpt_dir: Optional[Path] = None,
                 manager=None):
        self.plan = plan
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir is not None else None
        # optional CheckpointManager over ckpt_dir: corrupt_* events flush
        # its in-flight saves first so "newest snapshot" is deterministic
        # under async drains, and only its writing rank applies disk faults
        # (assignable after construction)
        self.manager = manager
        self.log: list[tuple[int, str]] = []  # fired (step, kind), in order
        self._fired: set[tuple[int, str]] = set()
        self._lock = threading.Lock()
        self._transient_io = 0
        self._transient_from: Optional[int] = None
        self._poisoned = False
        self._poison_from: Optional[int] = None
        self._stall_s = 0.0

    def _applies(self) -> bool:
        """Whether this process applies disk faults: the rank whose manager
        writes the snapshots (every process without a manager)."""
        return self.manager is None or self.manager.is_writer()

    # ------------------------------------------------------- loop hook --
    def check_step(self, step: int) -> None:
        """``LoopConfig.fault_check``: fire every not-yet-fired event
        planned for ``step``.  A ``pod_loss`` raises (after the other
        events of the step were applied, so e.g. a same-step corruption
        lands before the supervisor goes looking for a snapshot)."""
        pod_loss: Optional[FaultEvent] = None
        for ev in self.plan.at(step):
            key = (ev.step, ev.kind)
            if key in self._fired:
                continue  # replayed step after rollback: hardware is
            self._fired.add(key)  # already lost / disk already corrupted
            self.log.append(key)
            if ev.kind == "pod_loss":
                pod_loss = ev
            elif ev.kind == "drain_io":
                with self._lock:
                    self._transient_io += ev.count
                    self._transient_from = (ev.step if self._transient_from
                                            is None else
                                            min(self._transient_from, ev.step))
            elif ev.kind == "drain_poison":
                with self._lock:
                    self._poisoned = True
                    self._poison_from = (ev.step if self._poison_from is None
                                         else min(self._poison_from, ev.step))
            elif ev.kind == "fetch_stall":
                with self._lock:
                    self._stall_s = max(self._stall_s, ev.stall_s)
            else:  # corrupt_payload | corrupt_manifest
                self._corrupt(ev)
        if pod_loss is not None:
            raise PodLossFault(step, pod_loss.lost_pods,
                               pod_loss.lost_data_rows)

    def adopt_log(self, log) -> None:
        """Take another rank's fired events as this one's: a rank that sat
        out steps (lost, then grown back) must not fire their events on a
        later replay of those steps."""
        self.log = [tuple(e) for e in log]
        self._fired = set(self.log)

    def _corrupt(self, ev: FaultEvent) -> None:
        if self.ckpt_dir is None:
            raise ValueError("corrupt_* events need FaultInjector(ckpt_dir=...)")
        if not self._applies():
            return
        if self.manager is not None:
            self.manager.flush()  # make "newest" deterministic (see __init__)
        d = newest_snapshot_dir(self.ckpt_dir)
        if d is None:  # nothing durable yet — the fault hit thin air
            return
        target = "manifest" if ev.kind == "corrupt_manifest" else "payload"
        corrupt_snapshot(d, target, ev.mode, ev.seed)

    # -------------------------------------------------- manager hooks --
    @staticmethod
    def _step_of(path: Path) -> Optional[int]:
        # checkpoint payloads land in <dir>/.tmp_step_NNNNNNNNN/; gate
        # armed drain faults on that step so an async drain still writing
        # an *earlier* snapshot when the fault arms doesn't absorb it —
        # replays stay deterministic regardless of drain-thread timing
        name = Path(path).parent.name
        for prefix in (".tmp_step_", "step_"):
            if name.startswith(prefix):
                try:
                    return int(name[len(prefix):])
                except ValueError:
                    return None
        return None

    def write_bytes(self, path: Path, data: bytes) -> None:
        """``CheckpointManager(write_bytes=...)``: the real fsync'd writer
        (the port's ``checkpoint.manager._write_bytes``) behind armed drain
        faults.  Faults apply to snapshots of the step they were armed at
        or later (unknown paths always count)."""
        from repro_torch.checkpoint import manager as manager_mod

        step = self._step_of(path)
        with self._lock:
            if self._poisoned and (step is None or self._poison_from is None
                                   or step >= self._poison_from):
                raise OSError(f"injected: drain worker poisoned (at {path.name})")
            if self._transient_io > 0 and (step is None
                                           or self._transient_from is None
                                           or step >= self._transient_from):
                self._transient_io -= 1
                raise OSError(f"injected: transient I/O failure (at {path.name})")
        manager_mod._write_bytes(path, data)

    def fetch_hook(self, step: int) -> None:
        """``CheckpointManager(fetch_hook=...)``: runs on the drain thread
        before deferred host fetches resolve; consumes one armed stall."""
        with self._lock:
            stall, self._stall_s = self._stall_s, 0.0
        if stall > 0 and self._applies():
            time.sleep(stall)

    def repair_drain(self) -> None:
        """Clear a ``drain_poison`` — the supervisor 'replacing' the drain
        worker's host as part of fault handling."""
        with self._lock:
            self._poisoned = False
