"""Twin tests of the port's trainer (``repro_torch.train``, ``data/tokens``,
``launch/mesh``, ``launch/train``) against the JAX package's, on the CPU.

* ``TokenPipeline.batch_at`` equals the reference's arrays exactly.
* Three steps of ``build_train_step`` at minicpm-2b SMOKE in float32 (one
  state carried across by ``models.interop.state_from_jax``) agree with the
  reference's jitted step: losses within ``rtol`` 1e-6 and parameters
  within 1e-5 absolute, one percent of one step's largest move (lr 1e-3).
  The two compile the same program to other summation orders (XLA's fused
  matmuls and reductions against PyTorch's), and AdamW divides each
  gradient element by its own root mean square, so a parameter whose
  gradient is near zero carries that rounding into its update.  Seen: loss
  within 1e-6, parameters within 3e-6.  The second moments hold within
  ``rtol`` 1e-2: a small gradient element's relative rounding (up to ~1e-3
  seen) doubles in its square.
* The compressed pod hop inside the step is held op by op: every call the
  step makes is recorded and replayed through the reference's primitive
  (``compressed_pod_mean`` under ``jax.vmap(axis_name="pod")``, eager),
  bitwise in means and error feedback, and the bytes sent are exactly each
  leaf's padded codes plus its scales.  Under ``jit`` XLA rewrites
  ``max / qmax`` as a reciprocal multiply, so a jitted-step twin of the hop
  cannot be bitwise.
* The port of every ``TestLoop`` test of ``tests/test_train_loop.py`` (resume
  bitwise in losses and parameters), ``TestElasticGuards`` and
  ``tests/test_dist.py``'s ``TestElasticHelpers``; a checkpoint that the
  *reference* loop wrote (``zstd_level=0``) restores in the port, which
  continues it; ``launch/train.py main`` at SMOKE; and a two-rank ``gloo``
  pair (``pod`` = 2, each rank a subprocess) whose compressed-hop steps
  leave both ranks with the same parameters, bit for bit.
"""

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
from repro.configs import registry as jreg
from repro.data.tokens import DataConfig as JDataConfig
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.dist import collectives as jcol
from repro.models.spec import init_params as jinit
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager, CodecPolicy
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist import collectives, insitu
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.interop import state_from_jax
from repro_torch.models.spec import init_params
from repro_torch.optim import adamw
from repro_torch.train import elastic
from repro_torch.train import loop as loop_lib
from repro_torch.train import step as step_lib

SRC = Path(__file__).resolve().parents[1] / "src"
SEQ, BATCH, DATA_SEED = 16, 4, 3


@pytest.fixture
def one_rank():
    """Tear down the one-process group a one-rank mesh starts."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfg(reg, dtype="float32"):
    return reg.get_config("minicpm-2b", smoke=True).scaled(dtype=dtype)


def _flat(tree) -> list:
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


# ------------------------------------------------------------------ data --

class TestData:
    @pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 100, 8, 2), (3, 256, 16, 4),
                                                      (7, 122_753, 33, 3)])
    def test_batch_at_equals_reference(self, seed, vocab, seq, batch):
        mine = TokenPipeline(DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed))
        ref = JTokenPipeline(JDataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                                         seed=seed))
        for step in (0, 1, 17):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])

    def test_batch_pure_function_of_step(self):
        pipe = TokenPipeline(DataConfig(vocab=100, seq_len=8, global_batch=2, seed=1))
        a, b = pipe.batch_at(5), pipe.batch_at(5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert not np.array_equal(a["tokens"], pipe.batch_at(6)["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = TokenPipeline(DataConfig(vocab=100, seq_len=8, global_batch=2)).batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (2, 8)
        assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()


# ------------------------------------------------------------------ step --

def _reference_run(scfg, steps=3, mesh_shape=(1,), axes=("data",)):
    """The reference's jitted step from init_state(key(0)): (initial state,
    losses, final state) as numpy trees."""
    jm = jreg.build_model(_cfg(jreg))
    mesh = jax.make_mesh(mesh_shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    pipe = JTokenPipeline(JDataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=DATA_SEED))
    with jax.set_mesh(mesh):
        st = jstep.init_state(jm, mesh, jax.random.key(0), step_cfg=scfg)
        init = jax.tree.map(np.asarray, st)
        _, jit_step, _ = jstep.build_train_step(jm, mesh, step_cfg=scfg)
        b0 = pipe.batch_at(0)
        step = jit_step({k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in b0.items()})
        losses = []
        for i in range(steps):
            st, m = step(st, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
            losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(np.asarray, st)


def _port_cfg(**kw):
    return step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                                    schedule="wsd", **kw)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_agrees_with_reference_jit(microbatches):
    init, jl, jfin = _reference_run(jstep.TrainStepConfig(
        peak_lr=1e-3, warmup_steps=1, total_steps=10, schedule="wsd",
        microbatches=microbatches))
    model = registry.build_model(_cfg(registry), device="cpu")
    state = state_from_jax(init, model.specs(), "cpu")
    step = step_lib.build_train_step(model, None, _port_cfg(microbatches=microbatches))
    pipe = TokenPipeline(DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=DATA_SEED))
    losses = []
    for i in range(3):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        assert m["lr"].dtype == torch.float32 and torch.isfinite(m["grad_norm"])
    np.testing.assert_allclose(losses, jl, rtol=1e-6)
    assert int(state["opt"]["step"]) == 3
    for got, want in zip(_flat(state["params"]), _flat(jfin["params"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for got, want in zip(_flat(state["opt"]["v"]), _flat(jfin["opt"]["v"])):
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-9)


def test_compressed_hop_in_step_equals_reference_op_by_op(one_rank, monkeypatch):
    """A one-rank ("pod", "data") mesh: the step's compressed hop, call by
    call, against the reference primitive under vmap; bytes exact."""
    gc = collectives.GradCompressionConfig(enabled=True, bits=8, block=64)
    jgc = jcol.GradCompressionConfig(enabled=True, bits=8, block=64)
    model = registry.build_model(_cfg(registry), device="cpu")
    mesh = mesh_lib.make_mesh((1, 1), ("pod", "data"), "cpu")
    scfg = _port_cfg(grad_comp=gc)
    state = step_lib.init_state(model, mesh, torch.Generator().manual_seed(0), scfg)
    abs_, shard = step_lib.make_state_specs(model, mesh, scfg)
    assert set(state) == set(abs_) == {"params", "opt", "ef"}
    assert all(e.dtype == torch.bfloat16 for e in tree_util.tree_flatten(state["ef"])[0])
    assert tree_util.tree_flatten(shard)[0][0].spec == ()
    calls = []
    real = collectives.compressed_pod_mean

    def spy(g, cfg, e, **kw):
        g_in = g.clone()
        e_in = None if e is None else e.clone()
        out, e_new = real(g, cfg, e, **kw)
        if cfg.enabled:
            calls.append((g_in, e_in, out, e_new))
        return out, e_new

    monkeypatch.setattr(step_lib.collectives, "compressed_pod_mean", spy)
    step = step_lib.build_train_step(model, mesh, scfg)
    pipe = TokenPipeline(DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH, seed=DATA_SEED))
    n_leaves = len(tree_util.tree_flatten(state["params"])[0])
    hop = jax.vmap(lambda g, e: jcol.compressed_pod_mean(g, jgc, e, 1),
                   axis_name="pod", out_axes=(None, 0))
    for i in range(3):
        insitu.reset_sent_bytes()
        before = len(calls)
        state, m = step(state, pipe.batch_at(i))
        assert np.isfinite(float(m["loss"]))
        assert len(calls) - before == n_leaves
        want_bytes = 0
        for g, e, out, e_new in calls[before:]:
            jm, je = hop(jnp.asarray(g.numpy())[None],
                         jnp.asarray(e.to(torch.float32).numpy()).astype(jnp.bfloat16)[None])
            np.testing.assert_array_equal(out.numpy().view(np.int32),
                                          np.asarray(jm).view(np.int32))
            np.testing.assert_array_equal(e_new.to(torch.float32).numpy(),
                                          np.asarray(je[0]).astype(np.float32))
            blocks = -(-g.numel() // gc.block)
            want_bytes += blocks * gc.block * gc.bits // 8 + 4 * blocks
        assert insitu.sent_bytes["all_gather"] == want_bytes
        assert insitu.sent_bytes["all_reduce"] == 0  # size-1 axes: no plain mean
    # the step wrote the error feedback it was handed, in place
    last = calls[-n_leaves:]
    for e, (_, _, _, e_new) in zip(tree_util.tree_flatten(state["ef"])[0], last):
        assert torch.equal(e, e_new)


def test_state_from_jax_carries_every_leaf():
    scfg = jstep.TrainStepConfig(grad_comp=jcol.GradCompressionConfig(enabled=True))
    jm = jreg.build_model(_cfg(jreg))
    mesh = jax.make_mesh((1,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
    with jax.set_mesh(mesh):
        st = jax.tree.map(np.asarray, jstep.init_state(jm, mesh, jax.random.key(1),
                                                       step_cfg=scfg))
    st["opt"]["step"] = np.int32(7)
    st["ef"] = jax.tree.map(lambda x: (x.astype(np.float32) + 0.5).astype(x.dtype), st["ef"])
    model = registry.build_model(_cfg(registry), device="cpu")
    mine = state_from_jax(st, model.specs(), "cpu")
    assert int(mine["opt"]["step"]) == 7 and mine["opt"]["step"].dtype == torch.int32
    for got, want in zip(_flat(mine["params"]) + _flat(mine["opt"]["m"]),
                         _flat(st["params"]) + _flat(st["opt"]["m"])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jax.tree.leaves(mine["ef"]), jax.tree.leaves(st["ef"])):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      want[0].astype(np.float32))
    with pytest.raises(KeyError):
        state_from_jax({**st, "junk": {}}, model.specs(), "cpu")


# ------------------------------------------------------------------ loop --

def _tiny_setup(tmp_path, seed=0, ckpt_name="ckpt"):
    """The port of tests/test_train_loop.py's _tiny_setup: minicpm-2b SMOKE
    (bfloat16 compute), AdamW at lr 1e-3."""
    cfg = registry.get_config("minicpm-2b", smoke=True)
    model = registry.build_model(cfg, device="cpu")
    params = init_params(model.specs(), torch.Generator().manual_seed(seed), "cpu")
    state = {"params": params, "opt": adamw.init_state(params)}
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3))

    def train_step(state, batch):
        leaves, treedef = tree_util.tree_flatten(state["params"])
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree_util.tree_unflatten(treedef, req),
                          torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"]))
        grads = tree_util.tree_unflatten(treedef, list(torch.autograd.grad(loss, req)))
        new_p, new_opt, m = adamw.apply_updates(state["params"], state["opt"], grads,
                                                torch.tensor(1e-3))
        return {"params": new_p, "opt": new_opt}, {"loss": loss.detach(), **m}

    ckpt = CheckpointManager(tmp_path / ckpt_name, async_save=False, device="cpu")
    return model, state, pipe, train_step, ckpt


class TestLoop:
    def test_loss_decreases(self, tmp_path):
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        _, res = loop_lib.run(step_fn, state, pipe, ckpt,
                              loop_lib.LoopConfig(total_steps=12, ckpt_every=6))
        assert res.final_step == 12
        assert np.mean(res.losses[-3:]) < np.mean(res.losses[:3])

    def test_resume_is_exact(self, tmp_path):
        """Interrupted run + resume == uninterrupted run, bit for bit in
        losses and parameters."""
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        full_state, full = loop_lib.run(step_fn, state, pipe, ckpt,
                                        loop_lib.LoopConfig(total_steps=8, ckpt_every=4))
        _, state2, pipe2, step_fn2, ckpt2 = _tiny_setup(tmp_path, ckpt_name="ckpt2")
        _, first = loop_lib.run(step_fn2, state2, pipe2, ckpt2,
                                loop_lib.LoopConfig(total_steps=4, ckpt_every=4))
        # a fresh process would rebuild everything; resume from ckpt2
        _, state3, _, _, _ = _tiny_setup(tmp_path, seed=5, ckpt_name="unused")
        end_state, second = loop_lib.run(step_fn2, state3, pipe2, ckpt2,
                                         loop_lib.LoopConfig(total_steps=8, ckpt_every=4))
        assert first.losses + second.losses == full.losses
        for a, b in zip(_flat(end_state), _flat(full_state)):
            np.testing.assert_array_equal(a, b)

    def test_straggler_detection(self, tmp_path):
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        _, res = loop_lib.run(step_fn, state, pipe, ckpt, loop_lib.LoopConfig(
            total_steps=3, ckpt_every=10, step_deadline_s=0.0))
        assert res.stragglers == [0, 1, 2]

    def test_nan_circuit_breaker(self, tmp_path):
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)

        def bad_step(state, batch):
            s, m = step_fn(state, batch)
            return s, {**m, "loss": torch.tensor(float("nan"))}

        _, res = loop_lib.run(bad_step, state, pipe, ckpt,
                              loop_lib.LoopConfig(total_steps=5, ckpt_every=10))
        assert res.nan_abort and res.final_step == 0

    def test_heartbeat_written(self, tmp_path):
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        hb = tmp_path / "hb.json"
        loop_lib.run(step_fn, state, pipe, ckpt, loop_lib.LoopConfig(
            total_steps=2, ckpt_every=10, heartbeat_path=str(hb)))
        assert json.loads(hb.read_text())["step"] == 1

    def test_step_times_recorded(self, tmp_path):
        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        _, res = loop_lib.run(step_fn, state, pipe, ckpt,
                              loop_lib.LoopConfig(total_steps=4, ckpt_every=2))
        assert len(res.step_s) == 4 and all(t > 0 for t in res.step_s)

    def test_overlapped_hook_drained_at_exit(self, tmp_path, one_rank):
        """The loop calls ``hook.wait()`` on exit, and the snapshots it took
        restore within the bound."""
        from repro_torch.launch.train import _leaf_entries, build_insitu_hook

        _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)
        mesh = mesh_lib.make_host_mesh("cpu")
        hook = build_insitu_hook(mesh, tmp_path / "insitu", 1e-3, min_bytes=1 << 10,
                                 overlap=True)
        end_state, res = loop_lib.run(step_fn, state, pipe, ckpt, loop_lib.LoopConfig(
            total_steps=4, ckpt_every=2, snapshot_hook=hook))
        assert res.final_step == 4
        assert len(res.snapshot_s) == 2  # steps 2 and 4
        assert hook.slots is None or hook.slots.in_flight == 0
        steps = sorted((tmp_path / "insitu").glob("step_*"))
        assert [int(p.name.split("_")[1]) for p in steps] == [2, 4]
        live = dict(_leaf_entries(end_state, 1 << 10))
        kb, rest = insitu.plan_kernel_buckets(
            [(k, tuple(v.shape), v.dtype, ()) for k, v in live.items()], mesh)
        fb, skipped = insitu.plan_arena(rest, mesh)
        assert not skipped
        names = [f"karena{k:03d}" for k in range(len(kb))] + [f"arena{k:03d}"
                                                             for k in range(len(fb))]
        back, extra = CheckpointManager(tmp_path / "insitu", device="cpu").restore(
            4, state_like=dict.fromkeys(names, 0))
        n = 0
        for group in back.values():
            for key, x in group.items():
                want = live[key].to(torch.float32)
                assert float((x.to(torch.float32) - want).abs().max()) <= 1e-3 * (1 + 1e-5)
                n += 1
        assert n == extra["n_fields"] == len(live) > 0


def test_fault_check_aborts_with_the_partial_result(tmp_path):
    """A ``TrainingFault`` from ``fault_check`` leaves the loop at once, with
    the segment it ran as ``e.partial`` (what a supervisor resumes from)."""
    _, state, pipe, step_fn, ckpt = _tiny_setup(tmp_path)

    def fault(step):
        if step == 2:
            raise loop_lib.TrainingFault("injected at step 2")

    with pytest.raises(loop_lib.TrainingFault) as err:
        loop_lib.run(step_fn, state, pipe, ckpt, loop_lib.LoopConfig(
            total_steps=5, ckpt_every=10, fault_check=fault))
    assert err.value.partial.final_step == 2 and len(err.value.partial.losses) == 2


def _ref_step(model):
    """The reference's _tiny_setup step (fixed lr 1e-3), jitted."""
    @jax.jit
    def train_step(state, batch):
        def loss_fn(p):
            return model.loss(p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))

        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        new_p, new_opt, m = jadamw.apply_updates(state["params"], state["opt"], grads,
                                                 jnp.float32(1e-3))
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **m}
    return train_step


def test_port_continues_a_reference_checkpoint(tmp_path):
    """The reference loop writes step 4 (``zstd_level=0``); the port's loop
    restores it and runs steps 5-6, agreeing with the reference's
    uninterrupted run (float32 compute: losses within rtol 1e-6,
    parameters within 1e-5)."""
    jm = jreg.build_model(_cfg(jreg))
    params = jinit(jm.specs(), jax.random.key(0))
    jstate = {"params": params, "opt": jadamw.init_state(params)}
    jpipe = JTokenPipeline(JDataConfig(vocab=256, seq_len=16, global_batch=4, seed=3))
    policy = JCodecPolicy(zstd_level=0)
    step = _ref_step(jm)
    jloop.run(step, jstate, jpipe, JCheckpointManager(tmp_path / "ref", async_save=False,
                                                      policy=policy),
              jloop.LoopConfig(total_steps=4, ckpt_every=4))
    full_state, full = jloop.run(step, jstate, jpipe,
                                 JCheckpointManager(tmp_path / "full", async_save=False,
                                                    policy=policy),
                                 jloop.LoopConfig(total_steps=6, ckpt_every=6))

    model = registry.build_model(_cfg(registry), device="cpu")
    tparams = init_params(model.specs(), torch.Generator().manual_seed(9), "cpu")
    like = {"params": tparams, "opt": adamw.init_state(tparams)}

    def port_step(state, batch):
        leaves, treedef = tree_util.tree_flatten(state["params"])
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree_util.tree_unflatten(treedef, req),
                          torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"]))
        grads = tree_util.tree_unflatten(treedef, list(torch.autograd.grad(loss, req)))
        new_p, new_opt, m = adamw.apply_updates(state["params"], state["opt"], grads,
                                                torch.tensor(1e-3))
        return {"params": new_p, "opt": new_opt}, {"loss": loss.detach(), **m}

    ckpt = CheckpointManager(tmp_path / "ref", async_save=False, policy=CodecPolicy(zstd_level=0),
                             device="cpu")
    end, res = loop_lib.run(port_step, like, TokenPipeline(DataConfig(
        vocab=256, seq_len=16, global_batch=4, seed=3)), ckpt,
        loop_lib.LoopConfig(total_steps=6, ckpt_every=6))
    assert res.final_step == 6 and len(res.losses) == 2
    np.testing.assert_allclose(res.losses, full.losses[4:], rtol=1e-6)
    assert int(end["opt"]["step"]) == 6
    for got, want in zip(_flat(end["params"]), _flat(full_state["params"])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_train_launcher_smoke_and_resume(tmp_path, one_rank, capsys):
    """``launch/train.py main`` at SMOKE on the CPU with every switch this
    slice ports; a second invocation resumes from the checkpoint chain."""
    from repro_torch.launch import train as launch

    argv = ["--arch", "minicpm-2b", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2", "--lossy-ckpt",
            "--insitu-snapshot", "--metrics-dir", str(tmp_path / "m"), "--trace"]
    assert launch.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "done at step 4" in out and "schedule=wsd" in out
    assert (tmp_path / "m" / "metrics.jsonl").exists()
    assert list((tmp_path / "m").glob("trace_train.json"))
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_000000002", "step_000000004"]
    assert launch.main(argv + ["--steps", "6"]) == 0
    assert "done at step 6" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="grad_comp"):  # the supervised half's refusal
        launch.main(argv + ["--steps", "6", "--supervise", "--grad-comp",
                            "--fault-lost-pods", "1"])


# --------------------------------------------------------------- elastic --

class TestElasticGuards:
    """The port's twins of tests/test_train_loop.py::TestElasticGuards."""

    def test_no_pod_axis_rejected(self):
        with pytest.raises(ValueError, match="no 'pod' axis"):
            elastic.degraded_mesh_shape({"data": 4}, lost_pods=1)

    def test_no_data_axis_rejected(self):
        with pytest.raises(ValueError, match="no 'data' axis"):
            elastic.degraded_mesh_shape({"pod": 2, "model": 2}, lost_data_rows=1)

    def test_negative_losses_rejected(self):
        with pytest.raises(ValueError, match="negative"):
            elastic.degraded_mesh_shape({"pod": 2}, lost_pods=-1)

    def test_total_loss_rejected(self):
        with pytest.raises(ValueError, match="every pod"):
            elastic.degraded_mesh_shape({"pod": 2}, lost_pods=2)
        with pytest.raises(ValueError, match="every data row"):
            elastic.degraded_mesh_shape({"pod": 2, "data": 2}, lost_data_rows=2)

    def test_zero_loss_is_identity(self):
        assert elastic.degraded_mesh_shape({"pod": 2, "data": 2}) == {"pod": 2, "data": 2}

    def test_rebalance_rejects_nonpositive_batch(self, one_rank):
        mesh = elastic.make_degraded_mesh({"data": 1}, "cpu")
        with pytest.raises(ValueError, match="positive"):
            elastic.rebalance_batch(0, mesh)
        with pytest.raises(ValueError, match="positive"):
            elastic.rebalance_batch(-8, mesh)
        assert elastic.rebalance_batch(5, mesh) == 5


class TestElasticHelpers:
    """The port's twin of tests/test_dist.py::TestElasticHelpers, and the
    degraded shapes and rebalancing of the reference's elastic drives."""

    def test_degraded_shapes(self):
        from repro.train import elastic as jelastic

        for old, kw in (({"pod": 2, "data": 16, "model": 16}, {"lost_pods": 1}),
                        ({"data": 16, "model": 16}, {"lost_data_rows": 4}),
                        ({"pod": 2, "data": 2, "model": 2}, {"lost_pods": 1})):
            assert elastic.degraded_mesh_shape(old, **kw) == jelastic.degraded_mesh_shape(old, **kw)
        assert elastic.degraded_mesh_shape({"pod": 2, "data": 16, "model": 16},
                                           lost_pods=1) == {"pod": 1, "data": 16, "model": 16}
        with pytest.raises(ValueError):
            elastic.degraded_mesh_shape({"pod": 2, "data": 16, "model": 16}, lost_pods=2)

    def test_rebalance_on_shapes(self):
        mesh = type("M", (), {"shape": (1, 2, 2), "mesh_dim_names": ("pod", "data", "model")})
        assert elastic.rebalance_batch(256, mesh) == 256
        assert elastic.rebalance_batch(7, mesh) == 6
        with pytest.raises(ValueError, match="cannot be balanced"):
            elastic.rebalance_batch(1, mesh)

    def test_reshard_state_onto_a_new_mesh(self, one_rank):
        model = registry.build_model(_cfg(registry), device="cpu")
        state = step_lib.init_state(model, None, torch.Generator().manual_seed(0))
        mesh = elastic.make_degraded_mesh(
            elastic.degraded_mesh_shape({"pod": 2, "data": 1}, lost_pods=1), "cpu")
        placed = elastic.reshard_state(state, model, mesh)
        for a, b in zip(tree_util.tree_flatten(placed)[0], tree_util.tree_flatten(state)[0]):
            assert a.device_mesh is mesh
            assert torch.equal(a.to_local(), b)
        # the step takes the placed state and writes its local tensors
        before = tree_util.tree_flatten(placed["params"])[0][0].to_local().clone()
        step = step_lib.build_train_step(model, mesh, _port_cfg())
        pipe = TokenPipeline(DataConfig(vocab=256, seq_len=SEQ, global_batch=BATCH))
        for i in range(2):  # the schedule's rate is 0 at step 0
            placed, m = step(placed, pipe.batch_at(i))
            assert np.isfinite(float(m["loss"]))
        assert not torch.equal(tree_util.tree_flatten(placed["params"])[0][0].to_local(), before)


# ------------------------------------------------------ two ranks, gloo --

RANK = """
import pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist import collectives, insitu
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import step as step_lib

cfg = registry.get_config("minicpm-2b", smoke=True).scaled(dtype="float32")
model = registry.build_model(cfg, device="cpu")
mesh = make_mesh((world, 1), ("pod", "data"), "cpu")
scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, schedule="wsd",
                                grad_comp=collectives.GradCompressionConfig(enabled=True))
state = step_lib.init_state(model, mesh, torch.Generator().manual_seed(0), scfg)
step = step_lib.build_train_step(model, mesh, scfg)
pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=5))
losses = []
for i in range(3):
    state, m = step(state, pipe.batch_at(i))
    losses.append(float(m["loss"]))
res = {"losses": losses, "sent": dict(insitu.sent_bytes),
       "params": [x.numpy() for x in tree_util.tree_flatten(state["params"])[0]],
       "ef": [x.to(torch.float32).numpy() for x in tree_util.tree_flatten(state["ef"])[0]]}
pickle.dump(res, open(f"{out}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_pod_ranks_end_with_equal_parameters(tmp_path):
    """Two ``gloo`` ranks, ``pod`` = 2, three compressed-hop steps: both
    ranks hold the same parameters and loss bit for bit, each its own
    error feedback, and each sent 3 x (codes + scales) of every leaf."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", port, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]
    r0, r1 = (pickle.load(open(tmp_path / f"rank{r}.pkl", "rb")) for r in range(2))
    assert r0["losses"] == r1["losses"] and all(np.isfinite(r0["losses"]))
    for a, b in zip(r0["params"], r1["params"]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(r0["ef"], r1["ef"]))
    model = registry.build_model(_cfg(registry), device="cpu")
    sizes = [p.numel() for p in tree_util.tree_flatten(
        init_params(model.specs(), torch.Generator().manual_seed(0), "cpu"))[0]]
    blocks = [-(-n // 1024) for n in sizes]
    want = 3 * sum(b * 1024 + 4 * b for b in blocks)
    assert r0["sent"]["all_gather"] == r1["sent"]["all_gather"] == want
