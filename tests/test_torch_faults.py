"""Twin tests of the port's fault injection (``repro_torch.train.faults``)
against the JAX package's (``repro.train.faults``), on the CPU.

* Every test of ``tests/test_faults.py``, on the port: seeded plans replay
  exactly, events fire at most once, and the manager-facing hooks inject
  precisely the armed failures (and nothing else).
* The same seed and arguments give the same ``FaultPlan.drill`` JSON in both
  packages, and ``corrupt_snapshot`` changes the same byte (or truncates to
  the same length) of the same file on identical copies of a snapshot.
* ``TrainingFault`` is one class for ``train/faults.py`` and
  ``train/loop.py``: a ``PodLossFault`` from ``fault_check`` leaves
  ``loop.run`` with ``e.partial`` set and without waiting on the drain.
* Disk faults apply only on the rank whose manager writes.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.train import faults as jfaults
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.train import faults
from repro_torch.train import loop as loop_lib


class TestFaultPlan:
    def test_drill_deterministic_from_seed(self):
        a = faults.FaultPlan.drill(seed=7, total_steps=40, ckpt_every=5,
                                   lost_pods=1)
        b = faults.FaultPlan.drill(seed=7, total_steps=40, ckpt_every=5,
                                   lost_pods=1)
        assert a == b and a.to_json() == b.to_json()
        c = faults.FaultPlan.drill(seed=8, total_steps=40, ckpt_every=5,
                                   lost_pods=1)
        assert a != c

    def test_drill_places_pod_loss_after_second_interval(self):
        p = faults.FaultPlan.drill(seed=0, total_steps=100, ckpt_every=10)
        (loss,) = [e for e in p.events if e.kind == "pod_loss"]
        assert 2 * 10 + 1 <= loss.step < 3 * 10 + 1
        # the corruption rides the same step (check_step applies it before
        # raising the pod loss, whatever the plan's storage order)
        same = p.at(loss.step)
        assert {e.kind for e in same} == {"corrupt_payload", "pod_loss"}

    def test_drill_too_short_rejected(self):
        with pytest.raises(ValueError, match="too short"):
            faults.FaultPlan.drill(seed=0, total_steps=10, ckpt_every=5)

    def test_json_roundtrip(self):
        p = faults.FaultPlan.drill(seed=3, total_steps=50, ckpt_every=6,
                                   lost_data_rows=1)
        assert faults.FaultPlan.from_json(p.to_json()) == p

    def test_invalid_kind_and_mode_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultEvent(step=0, kind="meteor_strike")
        with pytest.raises(ValueError, match="unknown corrupt mode"):
            faults.FaultEvent(step=0, kind="corrupt_payload", mode="scribble")


class TestInjector:
    def test_pod_loss_fires_once(self):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=5, kind="pod_loss", lost_pods=1)])
        inj = faults.FaultInjector(plan)
        for s in range(5):
            inj.check_step(s)
        with pytest.raises(faults.PodLossFault) as ei:
            inj.check_step(5)
        assert ei.value.step == 5 and ei.value.lost_pods == 1
        # the rollback replays step 5 — the pod is already gone, no re-fire
        inj.check_step(5)
        assert inj.log == [(5, "pod_loss")]

    def test_transient_io_counts_down(self, tmp_path):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=0, kind="drain_io", count=2)])
        inj = faults.FaultInjector(plan)
        inj.check_step(0)
        for _ in range(2):
            with pytest.raises(OSError, match="injected: transient"):
                inj.write_bytes(tmp_path / "x.bin", b"abc")
        inj.write_bytes(tmp_path / "x.bin", b"abc")  # burst exhausted
        assert (tmp_path / "x.bin").read_bytes() == b"abc"

    def test_poison_until_repair(self, tmp_path):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=0, kind="drain_poison")])
        inj = faults.FaultInjector(plan)
        inj.check_step(0)
        for _ in range(3):  # persistent, not a countdown
            with pytest.raises(OSError, match="poisoned"):
                inj.write_bytes(tmp_path / "y.bin", b"z")
        inj.repair_drain()
        inj.write_bytes(tmp_path / "y.bin", b"z")
        assert (tmp_path / "y.bin").read_bytes() == b"z"

    def test_fetch_stall_consumed_once(self):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=2, kind="fetch_stall", stall_s=0.05)])
        inj = faults.FaultInjector(plan)
        inj.check_step(2)
        t0 = time.monotonic()
        inj.fetch_hook(2)
        assert time.monotonic() - t0 >= 0.05
        t0 = time.monotonic()
        inj.fetch_hook(3)  # armed stall was consumed
        assert time.monotonic() - t0 < 0.04

    def test_corrupt_needs_ckpt_dir(self):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=0, kind="corrupt_payload")])
        inj = faults.FaultInjector(plan)
        with pytest.raises(ValueError, match="ckpt_dir"):
            inj.check_step(0)

    def test_corrupt_before_first_snapshot_is_noop(self, tmp_path):
        plan = faults.FaultPlan.from_events(
            [faults.FaultEvent(step=0, kind="corrupt_payload")])
        inj = faults.FaultInjector(plan, ckpt_dir=tmp_path)
        inj.check_step(0)  # no step_* dirs yet: the fault hit thin air
        assert inj.log == [(0, "corrupt_payload")]


def _snapdir(root):
    d = root / "step_000000004"
    d.mkdir(parents=True)
    (d / "leaf_00000.bin").write_bytes(bytes(range(64)))
    (d / "MANIFEST.json").write_text('{"leaves": []}')
    return d


class TestCorruptSnapshot:
    def test_bitflip_changes_one_byte(self, tmp_path):
        d = _snapdir(tmp_path)
        before = (d / "leaf_00000.bin").read_bytes()
        victim = faults.corrupt_snapshot(d, "payload", "bitflip", seed=1)
        after = victim.read_bytes()
        assert len(after) == len(before)
        assert sum(a != b for a, b in zip(before, after)) == 1

    def test_truncate_halves(self, tmp_path):
        d = _snapdir(tmp_path)
        victim = faults.corrupt_snapshot(d, "payload", "truncate")
        assert victim.stat().st_size == 32

    def test_manifest_target(self, tmp_path):
        d = _snapdir(tmp_path)
        victim = faults.corrupt_snapshot(d, "manifest", "truncate")
        assert victim.name == "MANIFEST.json"

    def test_deterministic_choice(self, tmp_path):
        d = _snapdir(tmp_path)
        (d / "leaf_00001.bin").write_bytes(bytes(range(64)))
        v1 = faults.corrupt_snapshot(d, "payload", "bitflip", seed=9).name
        d2 = _snapdir(tmp_path / "b")
        (tmp_path / "b/step_000000004/leaf_00001.bin").write_bytes(bytes(range(64)))
        v2 = faults.corrupt_snapshot(d2, "payload", "bitflip", seed=9).name
        assert v1 == v2


def test_newest_snapshot_dir(tmp_path):
    assert faults.newest_snapshot_dir(tmp_path) is None
    (tmp_path / "step_000000002").mkdir()
    (tmp_path / "step_000000010").mkdir()
    assert faults.newest_snapshot_dir(tmp_path).name == "step_000000010"


# ------------------------------------------------- against the reference --

@pytest.mark.parametrize("seed,total,every,pods,rows", [
    (0, 100, 10, 0, 0), (7, 40, 5, 1, 0), (3, 50, 6, 0, 1), (11, 18, 4, 1, 1),
    (2**31 - 1, 1000, 37, 2, 3), (0, 12, 3, 0, 0)])
def test_drill_json_equals_reference(seed, total, every, pods, rows):
    kw = dict(seed=seed, total_steps=total, ckpt_every=every, lost_pods=pods,
              lost_data_rows=rows)
    assert faults.FaultPlan.drill(**kw).to_json() == jfaults.FaultPlan.drill(**kw).to_json()
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert faults.CORRUPT_MODES == jfaults.CORRUPT_MODES


@pytest.mark.parametrize("target,mode,seed", [
    ("payload", "bitflip", 0), ("payload", "bitflip", 9), ("payload", "bitflip", 87989972),
    ("payload", "truncate", 3), ("manifest", "bitflip", 5), ("manifest", "truncate", 1)])
def test_corrupt_snapshot_equals_reference(tmp_path, target, mode, seed):
    """Identical copies of a snapshot with several payloads of several sizes:
    the same file changes to the same bytes in both packages."""
    digest = int(np.random.default_rng(seed).integers(0, 2**31))
    copies = []
    for name in ("port", "ref"):
        d = tmp_path / name / "step_000000004"
        d.mkdir(parents=True)
        for i, n in enumerate((64, 1000, 4097)):
            (d / f"leaf_{i:05d}.bin").write_bytes(
                np.random.default_rng(i).integers(0, 256, n, dtype=np.uint8).tobytes())
        (d / "MANIFEST.json").write_text('{"leaves": [1, 2, 3], "digest": %d}' % digest)
        copies.append(d)
    got = faults.corrupt_snapshot(copies[0], target, mode, seed)
    want = jfaults.corrupt_snapshot(copies[1], target, mode, seed)
    assert got.name == want.name
    for f in sorted(copies[1].iterdir()):
        assert (copies[0] / f.name).read_bytes() == f.read_bytes(), f.name


# ---------------------------------------------------- one TrainingFault --

def _step(state, batch):
    t = torch.as_tensor(batch["tokens"]).to(torch.float32).mean() / 100.0
    d = state["w"] - t
    return {"w": state["w"] - 0.1 * (2.0 * d / d.numel())}, {"loss": (d * d).mean()}


def test_training_fault_is_one_class():
    assert faults.TrainingFault is loop_lib.TrainingFault
    assert issubclass(faults.PodLossFault, loop_lib.TrainingFault)


def test_pod_loss_leaves_the_loop_without_waiting_on_the_drain(tmp_path):
    """The step-3 save is stuck in the drain (its writer blocks) when the
    planned pod loss rises at step 4: ``loop.run`` re-raises it at once with
    the segment it ran as ``e.partial``, and the drain finishes later."""
    gate = threading.Event()

    def stuck_writer(path, data):
        gate.wait(30)
        faults.FaultInjector(faults.FaultPlan(())).write_bytes(path, data)

    ckpt = CheckpointManager(tmp_path / "ckpt", async_save=True, write_bytes=stuck_writer,
                             device="cpu")
    inj = faults.FaultInjector(faults.FaultPlan.from_events(
        [faults.FaultEvent(step=4, kind="pod_loss", lost_pods=1)]), ckpt_dir=tmp_path / "ckpt")
    pipe = TokenPipeline(DataConfig(vocab=100, seq_len=8, global_batch=4, seed=2))
    t0 = time.monotonic()
    try:
        with pytest.raises(faults.PodLossFault) as err:
            loop_lib.run(_step, {"w": torch.zeros(4)}, pipe, ckpt, loop_lib.LoopConfig(
                total_steps=8, ckpt_every=3, fault_check=inj.check_step))
        assert time.monotonic() - t0 < 10  # did not wait for the stuck drain
        assert ckpt._queue.unfinished_tasks == 1  # the step-3 save still in flight
        assert err.value.step == 4 and err.value.lost_pods == 1
        assert err.value.partial.final_step == 4 and len(err.value.partial.losses) == 4
        assert inj.log == [(4, "pod_loss")]
    finally:
        gate.set()
    ckpt.wait()
    assert ckpt.available_steps() == [3]


class _Writer:
    def __init__(self, writes: bool):
        self.writes, self.flushed = writes, 0

    def is_writer(self) -> bool:
        return self.writes

    def flush(self) -> None:
        self.flushed += 1


@pytest.mark.parametrize("writes", [True, False])
def test_disk_faults_apply_on_the_writing_rank_only(tmp_path, writes):
    """With one process per rank, corruption and fetch stalls happen where
    the manager writes; every rank logs the events and raises the pod loss
    (a bit flipped on two ranks would flip back)."""
    d = _snapdir(tmp_path)
    before = (d / "leaf_00000.bin").read_bytes()
    mgr = _Writer(writes)
    inj = faults.FaultInjector(faults.FaultPlan.from_events([
        faults.FaultEvent(step=1, kind="fetch_stall", stall_s=0.2),
        faults.FaultEvent(step=1, kind="corrupt_payload", seed=1),
        faults.FaultEvent(step=1, kind="pod_loss")]), ckpt_dir=tmp_path, manager=mgr)
    with pytest.raises(faults.PodLossFault):
        inj.check_step(1)
    assert inj.log == [(1, "fetch_stall"), (1, "corrupt_payload"), (1, "pod_loss")]
    assert ((d / "leaf_00000.bin").read_bytes() != before) == writes
    assert mgr.flushed == int(writes)
    t0 = time.monotonic()
    inj.fetch_hook(1)
    assert (time.monotonic() - t0 >= 0.2) == writes
