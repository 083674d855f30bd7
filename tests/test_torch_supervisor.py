"""Twin tests of the port's supervised fault drill
(``repro_torch.train.supervisor``, ``train/faults.py``, ``train/elastic.py``,
``launch/train.py --supervise``) against the JAX package's, on the CPU.

* The five ``TestSupervisedFast`` tests of ``tests/test_supervisor.py``,
  each run through both packages' ``run_supervised`` on the same plan with
  the same scalar-regression micro trainer (the reference's manager at
  ``CodecPolicy(zstd_level=0)``: its zstd single leaf does not restore,
  ROADMAP Queue 3).  Transitions, ``injector.log``, segments and the step
  trace are equal; losses agree within ``rtol`` 1e-6 (float32 scalar
  arithmetic: the two sum the four squares in other orders).
* The reference's ``test_fault_drill_8dev`` on 8 ``gloo`` ranks, one
  process each, at its mesh ``{"pod": 2, "data": 2, "model": 2}`` with the
  state sharded as the reference's (FSDP over ``data``, tensor and expert
  axes over ``model``).  Its expected values hold on every rank, every
  rank ends with the same losses, and the two ranks at each ``(data,
  model)`` coordinate (one per pod) end with bitwise-equal blocks.
* ``tests/test_train_loop.py::test_elastic_grow_back_bitwise`` on the same
  8 ranks: save on the full mesh, restore onto the survivors' mesh, carry
  back to the full mesh (``elastic.grow_back``), each rank's blocks
  bitwise at every hop.
* ``tests/test_obs.py::TestSupervisedDrill``: the spans, events, counters
  and sidecars of a supervised run with the flight recorder on.
* The CLI, ``launch/train.py main --supervise``, and its refusals.
"""

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.checkpoint.manager import CodecPolicy as JCodecPolicy
from repro.data.tokens import DataConfig as JDataConfig
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.train import elastic as jelastic
from repro.train import faults as jfaults
from repro.train import supervisor as jsup
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.foresight import guideline
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import observatory
from repro_torch.obs import trace as obs_trace
from repro_torch.train import elastic, faults
from repro_torch.train import supervisor as sup

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL = 1e-6


@pytest.fixture
def one_rank():
    """Tear down the one-process group a one-rank mesh starts, and leave the
    process-global flight recorder off."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    obs_metrics.disable()
    obs_trace.disable()
    obs_trace.clear()


# ------------------------------------------------ the two micro trainers --

@jax.jit
def _jmicro_step(state, batch):
    # the reference test's scalar regression against a per-step target
    t = jnp.float32(jnp.asarray(batch["tokens"]).mean()) / 100.0

    def loss_fn(w):
        return jnp.mean((w - t) ** 2)

    loss, g = jax.value_and_grad(loss_fn)(state["w"])
    return {"w": state["w"] - 0.1 * g}, {"loss": loss}


def _micro_step(state, batch):
    """The same regression in PyTorch: loss mean((w - t)^2), gradient
    2 (w - t) / 4, step 0.1."""
    t = torch.as_tensor(batch["tokens"]).to(torch.float32).mean() / 100.0
    d = state["w"] - t
    return {"w": state["w"] - 0.1 * (2.0 * d / d.numel())}, {"loss": (d * d).mean()}


def _jbuilder(calls=None):
    def builder(mesh_shape, global_batch):
        if calls is not None:
            calls.append((dict(mesh_shape), global_batch))
        mesh = jelastic.make_degraded_mesh(mesh_shape)
        pipe = JTokenPipeline(JDataConfig(vocab=100, seq_len=8, global_batch=global_batch,
                                          seed=2))
        return jsup.Trainer(mesh=mesh, mesh_shape=dict(mesh_shape), global_batch=global_batch,
                            train_step=_jmicro_step, pipeline=pipe, put_batch=None,
                            shardings=None,
                            make_state=lambda: {"w": jnp.zeros((4,), jnp.float32)})
    return builder


def _builder(calls=None):
    def builder(mesh_shape, global_batch):
        if calls is not None:
            calls.append((dict(mesh_shape), global_batch))
        mesh = elastic.make_degraded_mesh(mesh_shape, "cpu")
        pipe = TokenPipeline(DataConfig(vocab=100, seq_len=8, global_batch=global_batch,
                                        seed=2))
        return sup.Trainer(mesh=mesh, mesh_shape=dict(mesh_shape), global_batch=global_batch,
                           train_step=_micro_step, pipeline=pipe, put_batch=None,
                           make_state=lambda: {"w": torch.zeros(4)})
    return builder


def _both(tmp_path, events, cfg_kw, *, async_save=False, hooks=True, calls=None):
    """Run one plan through both packages' ``run_supervised`` on
    ``{"data": 1}`` and batch 4: ``[(injector, ckpt, result), ...]`` for the
    port, then the reference."""
    out = []
    for pkg, fl, Mgr, kw, build in (
            ("port", faults, CheckpointManager, {"device": "cpu"}, _builder),
            ("ref", jfaults, JCheckpointManager, {"policy": JCodecPolicy(zstd_level=0)},
             _jbuilder)):
        d = tmp_path / pkg / "ckpt"
        inj = fl.FaultInjector(fl.FaultPlan.from_json(
            faults.FaultPlan.from_events(events).to_json()), ckpt_dir=d)
        if hooks:
            kw = dict(kw, write_bytes=inj.write_bytes, retry_backoff_s=0.01)
        ckpt = Mgr(d, async_save=async_save, **kw)
        S = sup if pkg == "port" else jsup
        _, res = S.run_supervised(build(calls if pkg == "port" else None), {"data": 1}, 4,
                                  ckpt, S.SupervisorConfig(**cfg_kw), injector=inj,
                                  log=lambda s: None)
        out.append((inj, ckpt, res))
    return out


def _same_runs(port, ref) -> None:
    (pinj, _, pres), (rinj, _, rres) = port, ref
    assert pinj.log == [tuple(e) for e in rinj.log]
    assert pres.final_step == rres.final_step
    assert [dataclasses.asdict(t) for t in pres.transitions] == \
        [dataclasses.asdict(t) for t in rres.transitions]
    assert pres.segments == rres.segments
    assert [s for s, _ in pres.loss_trace] == [s for s, _ in rres.loss_trace]
    np.testing.assert_allclose([v for _, v in pres.loss_trace],
                               [float(v) for _, v in rres.loss_trace], rtol=RTOL)
    assert [(s, k) for s, _, _, k in pres.continuity] == \
        [(s, k) for s, _, _, k in rres.continuity]


class TestSupervisedFast:
    def test_no_faults_plain_run(self, tmp_path, one_rank):
        port, ref = _both(tmp_path, [], dict(total_steps=8, ckpt_every=4), hooks=False)
        res = port[2]
        assert res.final_step == 8
        assert res.transitions == []
        assert [s for s, _ in res.loss_trace] == list(range(8))
        _same_runs(port, ref)

    def test_drill_corruption_fallback_and_grow(self, tmp_path, one_rank):
        """The canonical drill on one rank: transient drain I/O, the newest
        snapshot corrupted at the fault, a (same-topology) pod-loss restart
        — restore falls back past the quarantined snapshot, the replayed
        loss matches the pre-fault trace, and the grow-back fires."""
        calls = []
        port, ref = _both(tmp_path, [
            faults.FaultEvent(step=4, kind="drain_io", count=1),
            faults.FaultEvent(step=7, kind="corrupt_payload", mode="bitflip", seed=11),
            faults.FaultEvent(step=7, kind="pod_loss"),
        ], dict(total_steps=15, ckpt_every=3, drain_deadline_s=5.0, grow_back_after=3),
            calls=calls)
        inj, _, res = port
        assert res.final_step == 15
        assert inj.log == [(4, "drain_io"), (7, "corrupt_payload"), (7, "pod_loss")]
        shrink, grow = res.transitions
        assert shrink.kind == "shrink" and shrink.at_step == 7
        # newest snapshot (step 6) was corrupt: quarantined, fell back to 3
        assert shrink.restored_step == 3 and shrink.quarantined == 1
        assert (tmp_path / "port/ckpt/quarantine/step_000000006").exists()
        assert grow.kind == "grow" and grow.at_step == 6
        assert len(calls) == 3  # builder: initial + shrink + grow-back
        kinds = [k for *_, k in res.continuity]
        assert "shrink-restore" in kinds and "grow-back" in kinds
        steps = [s for s, _ in res.loss_trace]
        assert steps == list(range(7)) + list(range(3, 15))
        _same_runs(port, ref)

    def test_poisoned_drain_consumed_and_repaired(self, tmp_path, one_rank):
        """A poisoned drain worker must not wedge the fault handling:
        quiesce consumes the drain error under its deadline, the supervisor
        'replaces' the worker, and the restore is allowed the extra lost
        interval for the snapshot that died in flight."""
        port, ref = _both(tmp_path, [
            faults.FaultEvent(step=4, kind="drain_poison"),
            faults.FaultEvent(step=7, kind="pod_loss"),
        ], dict(total_steps=12, ckpt_every=3, drain_deadline_s=10.0), async_save=True)
        _, ckpt, res = port
        assert res.final_step == 12
        (shrink,) = res.transitions
        assert shrink.drain_error is not None and "poisoned" in shrink.drain_error
        assert shrink.restored_step == 3 and shrink.quarantined == 0
        assert ckpt.available_steps()[0] == 12  # post-repair saves are durable
        ckpt.wait()
        ref[1].wait()
        _same_runs(port, ref)

    def test_replay_is_exact(self, tmp_path, one_rank):
        """The same plan against the same seeds fires identically and gives
        an identical loss trace; so does the reference."""
        events = [faults.FaultEvent(step=7, kind="corrupt_payload", seed=5),
                  faults.FaultEvent(step=7, kind="pod_loss")]
        cfg = dict(total_steps=12, ckpt_every=3)
        runs = [_both(tmp_path / name, events, cfg, hooks=False) for name in ("a", "b")]
        (pa, ra), (pb, rb) = runs
        assert pa[0].log == pb[0].log
        assert [t.restored_step for t in pa[2].transitions] == \
            [t.restored_step for t in pb[2].transitions] == [3]
        np.testing.assert_array_equal([v for _, v in pa[2].loss_trace],
                                      [v for _, v in pb[2].loss_trace])
        _same_runs(pa, ra)
        _same_runs(pb, rb)

    def test_max_faults_bounds_flapping(self, tmp_path, one_rank):
        """A fault storm beyond ``max_faults`` surfaces as SupervisorError in
        both packages instead of looping forever."""
        events = [faults.FaultEvent(step=4, kind="pod_loss"),
                  faults.FaultEvent(step=5, kind="pod_loss")]
        cfg = dict(total_steps=12, ckpt_every=3, max_faults=1)
        with pytest.raises(sup.SupervisorError, match="max_faults"):
            _both(tmp_path / "p", events, cfg, hooks=False)
        jinj = jfaults.FaultInjector(jfaults.FaultPlan.from_events(
            [jfaults.FaultEvent(**dataclasses.asdict(e)) for e in events]),
            ckpt_dir=tmp_path / "r")
        with pytest.raises(jsup.SupervisorError, match="max_faults"):
            jsup.run_supervised(_jbuilder(), {"data": 1}, 4,
                                JCheckpointManager(tmp_path / "r", async_save=False,
                                                   policy=JCodecPolicy(zstd_level=0)),
                                jsup.SupervisorConfig(**cfg), injector=jinj,
                                log=lambda s: None)


# ------------------------------------------------------- four gloo ranks --

DRILL_RANK = """
import functools, hashlib, pickle, sys
import torch, torch.distributed as dist
rank, world, port, ckdir, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                 sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.dist import sharding as shardlib
from repro_torch.train import faults, step as step_lib
from repro_torch.train import supervisor as sup

cfg = registry.get_config("minicpm-2b", smoke=True)
model = registry.build_model(cfg, device="cpu")
scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1)
plan = faults.FaultPlan.from_events([
    faults.FaultEvent(step=5, kind="drain_io", count=1),
    faults.FaultEvent(step=9, kind="corrupt_payload", mode="truncate", seed=3),
    faults.FaultEvent(step=9, kind="pod_loss", lost_pods=1),
])
assert faults.FaultPlan.from_json(plan.to_json()) == plan
inj = faults.FaultInjector(plan, ckpt_dir=ckdir)
# one writer: rank 0 of a gloo group over the world
ckpt = CheckpointManager(ckdir, async_save=True, write_bytes=inj.write_bytes,
                         fetch_hook=inj.fetch_hook, retry_backoff_s=0.01, device="cpu",
                         group=dist.new_group(backend="gloo"))
inj.manager = ckpt
builder = functools.partial(sup.make_trainer, model, vocab=cfg.vocab, seq_len=16, step_cfg=scfg)
state, res = sup.run_supervised(
    builder, {"pod": 2, "data": 2, "model": 2}, 8, ckpt,
    sup.SupervisorConfig(total_steps=18, ckpt_every=4, drain_deadline_s=30.0, grow_back_after=4),
    injector=inj, log=print if rank == 0 else (lambda s: None))
ckpt.wait()
leaves = tree_util.tree_flatten(state)[0]
digests = [hashlib.sha256(shardlib.local(x).detach().reshape(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest() for x in leaves]
meshes = {tuple(x.device_mesh.shape) for x in leaves if shardlib.is_dtensor(x)}
split = sum(shardlib.is_dtensor(x) for x in leaves)
pickle.dump({"final_step": res.final_step, "log": inj.log, "meshes": meshes, "split": split,
             "transitions": [t.__dict__ for t in res.transitions],
             "loss_trace": res.loss_trace, "continuity": res.continuity,
             "digests": digests}, open(f"{out}/drill{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""

GROWBACK_RANK = """
import hashlib, pickle, sys
import torch, torch.distributed as dist
rank, world, port, ckdir, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                 sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.dist import sharding as shardlib
from repro_torch.train import elastic, step as step_lib

def digest(tree):
    return [hashlib.sha256((x.to_local() if hasattr(x, "to_local") else x).detach().reshape(-1)
                           .view(torch.uint8).numpy().tobytes()).hexdigest()
            for x in tree_util.tree_flatten(tree)[0]]

cfg = registry.get_config("minicpm-2b", smoke=True)
model = registry.build_model(cfg, device="cpu")
full_shape = {"pod": 2, "data": 2, "model": 2}
full = elastic.make_degraded_mesh(full_shape, "cpu")
state = step_lib.init_state(model, full, torch.Generator().manual_seed(0))
ref = digest(state)
ckpt = CheckpointManager(ckdir, async_save=False, device="cpu",
                         group=dist.new_group(backend="gloo"))
ckpt.save(10, state)
dist.barrier()  # the writer's save is on disk

# shrink: restore the snapshot onto the survivors' mesh
shape = elastic.degraded_mesh_shape(full_shape, lost_pods=1)
small = elastic.make_degraded_mesh(shape, "cpu")  # collective: every rank
member = small.get_coordinate() is not None
assert member == (rank < 4), (rank, small.get_coordinate())
_, small_shard = step_lib.make_state_specs(model, small)
hops = {}
if rank == 0:
    state_s, _, step = ckpt.restore_latest_valid(state_like=state, shardings=small_shard)
box = [step if rank == 0 else None]
dist.broadcast_object_list(box, src=0)
if member and rank != 0:
    state_s, _ = ckpt.restore(box[0], state_like=state, shardings=small_shard)
if member:
    assert all(x.device_mesh is small for x in tree_util.tree_flatten(state_s)[0])
    hops["shrink"] = digest(state_s)
else:  # a lost rank: what it holds is not read at the grow-back
    state_s = step_lib.init_state(model, None, torch.Generator().manual_seed(rank + 7))
assert box[0] == 10

# grow back: each survivor's blocks to the rank of the rejoining pod at its
# (data, model) coordinate
full2 = elastic.make_degraded_mesh(full_shape, "cpu")
_, full_shard = step_lib.make_state_specs(model, full2)
state_f = elastic.grow_back(state_s, full_shard)
split = [x for x in tree_util.tree_flatten(state_f)[0] if shardlib.is_dtensor(x)]
assert split and all(x.device_mesh is full2 for x in split)
hops["grow"] = digest(state_f)
hops["reshard"] = digest(elastic.reshard_state(state_f, model, full2))

# rebalance edge cases on a real data-parallel extent (2)
assert elastic.rebalance_batch(256, small) == 256
assert elastic.rebalance_batch(7, small) == 6
try:
    elastic.rebalance_batch(1, small)  # 1 < dp extent 2: would grow
    raise SystemExit("rebalance_batch(1) should have raised")
except ValueError as e:
    assert "cannot be balanced" in str(e), e
pickle.dump({"ref": ref, **hops}, open(f"{out}/grow{rank}.pkl", "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(tmp_path, script: str, tag: str, n: int = 8) -> list:
    path = tmp_path / f"{tag}.py"
    path.write_text(textwrap.dedent(script))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(n), port,
                               str(tmp_path / "ckpt"), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return [pickle.load(open(tmp_path / f"{tag}{r}.pkl", "rb")) for r in range(n)]


def test_fault_drill_four_gloo_ranks(tmp_path):
    """The reference's 8-device drill on 8 ranks at its mesh: pod loss at
    step 9 -> quiesce -> the truncated step-8 snapshot quarantined, step 4
    restored onto ``{"pod": 1, "data": 2, "model": 2}`` (ranks 0-3; ranks
    4-7 wait) -> grow back at step 8 -> step 18; the ranks at one (data,
    model) coordinate end with the same bytes."""
    runs = _ranks(tmp_path, DRILL_RANK, "drill")
    for r, run in enumerate(runs):
        assert run["final_step"] == 18, (r, run["final_step"])
        assert run["log"] == [(5, "drain_io"), (9, "corrupt_payload"), (9, "pod_loss")], r
        shrink, grow = run["transitions"]
        assert shrink["kind"] == "shrink" and shrink["at_step"] == 9
        assert shrink["restored_step"] == 4 and shrink["quarantined"] == 1, shrink
        assert shrink["mesh_shape"] == {"pod": 1, "data": 2, "model": 2}
        assert shrink["global_batch"] == 8  # dp extent 2 still divides 8
        assert grow["kind"] == "grow" and grow["at_step"] == 8
        assert grow["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
        assert run["meshes"] == {(2, 2, 2)} and run["split"] > 0  # sharded, on the full mesh
        assert any(k == "shrink-restore" for *_, k in run["continuity"])
        assert all(np.isfinite(v) for _, v in run["loss_trace"])
        assert [s for s, _ in run["loss_trace"]] == list(range(9)) + list(range(4, 18))
        assert run["loss_trace"] == runs[0]["loss_trace"]
        assert run["digests"] == runs[r % 4]["digests"], f"rank {r}'s blocks differ from pod 0's"
    assert runs[0]["digests"] != runs[1]["digests"]  # other coordinates, other blocks
    assert len(list((tmp_path / "ckpt").glob("quarantine/step_*"))) == 1


def test_elastic_grow_back_bitwise_four_gloo_ranks(tmp_path):
    """Snapshot on the full mesh -> restore onto the survivors' mesh ->
    live carry back onto the full mesh: each rank's blocks bitwise at every
    hop, equal at each (data, model) coordinate across the pods."""
    runs = _ranks(tmp_path, GROWBACK_RANK, "grow")
    for r, run in enumerate(runs):
        ref = run["ref"]
        assert ref == runs[r % 4]["ref"], r  # one block per (data, model) coordinate
        if r < 4:
            assert run["shrink"] == ref, r
        assert run["grow"] == ref, r
        assert run["reshard"] == ref, r
    assert runs[0]["ref"] != runs[1]["ref"]


# ------------------------------------------------------- flight recorder --

def _validate_chrome_trace(doc: dict) -> None:
    """The subset of the Chrome-trace schema the viewers require (as
    tests/test_obs.py checks it)."""
    assert isinstance(doc.get("traceEvents"), list) and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(ev), ev
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0, ev
        elif ev["ph"] == "M":
            assert ev["name"] == "thread_name"
            assert ev["args"]["name"]


def _manifest_stored_bytes(manifest: dict) -> int:
    total = 0
    for meta in manifest["leaves"]:
        shards = meta.get("shards")
        if isinstance(shards, list) and shards and "stored_bytes" in shards[0]:
            total += sum(b["stored_bytes"] for b in shards)
        else:
            total += meta["stored_bytes"]
    return total


def test_supervised_drill_flight_recorder(tmp_path, one_rank):
    """The port of ``TestSupervisedDrill``: a fault-injected supervised run
    with metrics and tracing on yields retry and quarantine counters, a
    Chrome trace with training-, drain- and supervisor-phase spans, the
    casualty sequence as events, and obs sidecars whose byte totals match
    each manifest, aggregating into a rate-quality trajectory."""
    jsonl = tmp_path / "metrics.jsonl"
    obs_metrics.enable(jsonl)
    obs_trace.enable()
    retry0 = obs_metrics.counter("ckpt.retry").value
    quar0 = obs_metrics.counter("ckpt.quarantine").value

    plan = faults.FaultPlan.from_events([
        faults.FaultEvent(step=4, kind="drain_io", count=1),
        faults.FaultEvent(step=7, kind="corrupt_payload", mode="bitflip", seed=11),
        faults.FaultEvent(step=7, kind="pod_loss"),
    ])
    inj = faults.FaultInjector(plan, ckpt_dir=tmp_path / "ckpt")
    ckpt = CheckpointManager(tmp_path / "ckpt", async_save=True, write_bytes=inj.write_bytes,
                             retry_backoff_s=0.01, device="cpu")
    inj.manager = ckpt  # corrupt-newest waits out in-flight saves
    cfg = sup.SupervisorConfig(total_steps=15, ckpt_every=3, drain_deadline_s=10.0,
                               grow_back_after=3)
    _, res = sup.run_supervised(_builder(), {"data": 1}, 4, ckpt, cfg, injector=inj,
                                log=lambda s: None)
    assert res.final_step == 15
    assert inj.log == [(4, "drain_io"), (7, "corrupt_payload"), (7, "pod_loss")]
    obs_metrics.export_snapshot(final=True)

    assert obs_metrics.counter("ckpt.retry").value > retry0
    assert obs_metrics.counter("ckpt.quarantine").value > quar0

    doc = json.loads(obs_trace.export(tmp_path / "trace_supervised.json").read_text())
    _validate_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    for want in ("train.step", "ckpt.save", "ckpt.drain.save", "ckpt.restore",
                 "supervisor.quiesce", "supervisor.restore", "supervisor.grow_back"):
        assert want in names, want
    train_tids = {e["tid"] for e in doc["traceEvents"] if e.get("name") == "train.step"}
    drain_tids = {e["tid"] for e in doc["traceEvents"] if e.get("name") == "ckpt.drain.save"}
    assert train_tids and drain_tids and train_tids.isdisjoint(drain_tids)
    tnames = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert "ckpt-drain" in tnames

    lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    enames = {x["name"] for x in lines if x["kind"] == "event"}
    for want in ("ckpt.retry", "ckpt.corruption", "ckpt.quarantine", "train.fault",
                 "supervisor.casualty", "supervisor.shrink", "supervisor.grow"):
        assert want in enames, want
    final = [x for x in lines if x["kind"] == "metrics"][-1]
    h = final["hists"]["train.step_s"]
    assert h["count"] >= 15 and h["p99"] >= h["p50"] > 0
    assert "ckpt.queue_depth" in final["gauges"]

    step_dirs = sorted((tmp_path / "ckpt").glob("step_*"))
    assert step_dirs
    for d in step_dirs:
        obs_doc = observatory.read_obs(d)
        assert obs_doc is not None, d
        manifest = json.loads((d / "MANIFEST.json").read_text())
        on_disk = sum(f.stat().st_size for f in d.glob("*.bin"))
        assert obs_doc["total_stored_bytes"] == _manifest_stored_bytes(manifest) == on_disk, d
    traj = observatory.run_trajectory(tmp_path / "ckpt")
    assert [t["step"] for t in traj] == [int(d.name.split("_")[1]) for d in step_dirs]
    fb = guideline.rate_quality_feedback(traj)
    assert fb["n"] == len(traj)
    assert fb["latest_ratio"] == traj[-1]["ratio"] > 0


# ------------------------------------------------------------------ CLI --

def test_supervised_launcher_and_refusals(tmp_path, one_rank, capsys):
    """``launch/train.py main --supervise`` at SMOKE on the CPU with the
    seeded drill runs to the end (a pod loss of nothing on the one-rank
    mesh: quiesce, restore past the corrupted snapshot, grow back); a
    non-LM family and ``--grad-comp`` with a shrink are refused, as in the
    reference, and a JSON plan replays the seeded drill exactly."""
    from repro_torch.launch import train as launch

    ck = tmp_path / "ck"
    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--supervise", "--steps",
            "12", "--batch", "4", "--seq", "16", "--ckpt-every", "3", "--grow-back-after", "2"]
    assert launch.main(argv + ["--fault-seed", "0", "--ckpt-dir", str(ck)]) == 0
    out = capsys.readouterr().out
    assert "fault plan: " in out
    assert "done at step 12; 1 shrink / 1 grow transition(s), 1 snapshot(s) quarantined" in out
    assert len(list(ck.glob("quarantine/step_*"))) == 1
    plan = tmp_path / "plan.json"
    plan.write_text(faults.FaultPlan.drill(0, 12, 3).to_json())
    assert launch.main(argv + ["--fault-plan", str(plan), "--ckpt-dir", str(tmp_path / "p")]) == 0
    assert "1 shrink / 1 grow" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="token-LM families"):
        launch.main(["--arch", "whisper-base", "--smoke", "--device", "cpu", "--supervise"])
    with pytest.raises(SystemExit, match="grad_comp"):
        launch.main(argv + ["--grad-comp", "--fault-lost-pods", "1",
                            "--ckpt-dir", str(tmp_path / "g")])
