"""The port's sharded serving step (``train.step.build_serve_step``, the
split-sequence attention of ``models/layers.py``, K10's block entry) and
grow-back across lost data rows (``train.elastic.grow_back``) against the
JAX package, on the CPU.

* **Cache placement.**  For all ten architectures at SMOKE size on ``(pod
  2, data 2, model 2)`` and ``(data 4, model 2)``, every cache leaf's spec
  from ``train.step.cache_shardings`` equals the reference's, read off its
  ``jit_step(cache_abs)`` compiled on an 8-device CPU mesh (a subprocess):
  a batch of 4 with 8192 positions (batch over the row axes, the sequence
  over ``model``), a batch of 1 with 8192 (the sequence over ``data``) and
  a batch of 4 with 2048 (under 4096 positions: the batch alone).
* **Serve step.**  On 4 ``gloo`` ranks as ``{"data": 2, "model": 2}`` (one
  subprocess each, one session for the module), two decode steps of every
  family (starcoder2-3b, internvl2-76b, qwen3-moe-30b-a3b, whisper-base,
  rwkv6-1.6b, hymba-1.5b; SMOKE, float32, the reference's ``key(0)``
  weights carried by ``models.interop.params_from_jax``) over a cache of
  8192 positions, split 4096 a ``model`` rank: the scalar index (at 4095,
  then across the border; codec none, attention ``xla``) and the ``(B,)``
  index (lanes at 1000, 4094, 4095 and 7000, two of them crossing the
  border; blockfloat8, attention ``fused`` where the model has K10's route,
  which runs K10's plain version with its block log-sum-exp here).  Every
  rank returns the same logits; they lie within atol 1e-5 of the port's
  one-process ``decode_step`` on the same inputs (a sharded run sums in
  other orders: up to 2.5e-6 seen, of logits up to 0.9), no farther from
  the reference's one-device ``serve_step`` than that one-process run is
  plus rtol 1e-4 / atol 1e-5 (the tolerances of
  ``tests/test_torch_models.py``), and give the reference's greedy tokens.
  The one-process run's own distance is within those tolerances for every
  family but starcoder2-3b, up to 9e-4: at positions of 1000-7000 its RoPE
  (theta 999999.44) turns the one-ulp difference of XLA's and PyTorch's
  float32 ``pow`` in a frequency into angles apart by up to 4e-4 radians.
* **K10's blocks.**  The plain version's ``(out, lse)`` over 2, 3 and 4
  blocks of a cache, combined by their log-sum-exp, equal the whole-cache
  result within rtol 1e-5 / atol 1e-6 (float32), with blocks that hold no
  position of a lane (``lse`` -inf, ``out`` exactly 0) and free lanes
  (exactly 0); the offset-0 call without ``lse`` is the whole-cache call.
* **Grow-back drill.**  The twin of the reference's supervised drill with a
  lost data row: minicpm-2b at SMOKE in float32 on ``{"data": 2, "model": 2}``, a
  ``pod_loss`` of one data row at step 5, restore onto ``{"data": 1,
  "model": 2}``, grow back 2 steps later (``elastic.grow_back`` sends each
  rank of the full mesh its rows from the survivors), 9 steps.  Both start
  from the reference's ``key(0)`` parameters; both managers at
  ``CodecPolicy(zstd_level=0)`` (the reference's zstd leaf does not
  restore, ROADMAP Queue 3).  Transitions and the step trace are equal,
  losses within rtol 1e-5 and the final state (after grow-back) within
  atol 1e-6.  AdamW runs at ``eps`` 1.0 in both: at its default 1e-8 an
  element whose gradient is at rounding level takes its step's sign from
  the rounding, and the two programs part by up to the learning rate.

The session costs about 40 s on four CPU cores (ranks and the reference's
subprocess run side by side).
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import spec as jspec
from repro_torch.configs import registry
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as TL
from repro_torch.train import step as step_lib

SRC = Path(__file__).resolve().parents[1] / "src"
RTOL, ATOL = 1e-4, 1e-5
SERVE_ARCHS = ("starcoder2-3b", "internvl2-76b", "qwen3-moe-30b-a3b", "whisper-base",
               "rwkv6-1.6b", "hymba-1.5b")
B, S = 4, 8192  # split 4096 a model rank
VECTOR = (1000, 4094, 4095, 7000)  # lanes on both sides of the block border
SCALAR = 4095  # the last position of the first block; the next step crosses
STEPS = 2
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")), "4x2": ((4, 2), ("data", "model"))}
CACHE_SHAPES = ((4, 8192), (1, 8192), (4, 2048))
DRILL = dict(total_steps=9, ckpt_every=2, drain_deadline_s=30.0, grow_back_after=2)
DRILL_SHAPE = {"data": 2, "model": 2}
STATES = ("wkv", "ssd_state")  # recurrent states: every model rank holds every head


def _cases() -> list:
    """(arch, kind, codec, attention) of the serve-step twins."""
    out = []
    for arch in SERVE_ARCHS:
        fused = registry.model_class(registry.get_config(arch, smoke=True)).supports_fused_attention
        out.append((arch, "scalar", "none", "xla"))
        out.append((arch, "vector", "blockfloat8", "fused" if fused else "xla"))
    return out


def _cache_values(model, codec: str, seed: int) -> dict:
    """A cache of B lanes and S positions filled from a numpy seed: bf16
    K/V (and memory) as float32 arrays of bf16 values, blockfloat8 codes
    and positive scales, recurrent states of unit scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in model.cache_spec(B, S, TL.KVCodecConfig(codec)).items():
        if s.dtype == torch.int8:
            out[name] = rng.integers(-127, 128, size=s.shape, dtype=np.int8)
        elif name.endswith("scale"):
            out[name] = (rng.random(s.shape, dtype=np.float32) * 0.01 + 1e-3).astype(np.float32)
        else:
            v = torch.from_numpy(rng.standard_normal(s.shape, dtype=np.float32) * 0.5)
            out[name] = v.to(s.dtype).float().numpy()
    return out


def _steps(cfg, kind: str) -> list:
    """(token (B,), index) per step."""
    rng = np.random.default_rng(11)
    out = []
    for t in range(STEPS):
        tok = rng.integers(0, cfg.vocab, size=B).astype(np.int32)
        idx = (np.asarray(VECTOR, np.int32) + t if kind == "vector"
               else np.asarray(SCALAR + t, np.int32))
        out.append((tok, idx))
    return out


RANK = """
import dataclasses, pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager, CodecPolicy
from repro_torch.configs import registry
from repro_torch.dist import sharding as shardlib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.models.interop import params_from_jax
from repro_torch.optim import adamw
from repro_torch.train import faults, step as step_lib
from repro_torch.train import supervisor as sup

inp = pickle.load(open(f"{root}/inputs.pkl", "rb"))
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
STATES = inp["states"]
out = {"serve": {}}

def whole(x):
    return (x.full_tensor() if shardlib.is_dtensor(x) else x).detach().numpy()

for (arch, kind, codec, attention), case in inp["serve"].items():
    cfg = registry.get_config(arch, smoke=True).scaled(dtype="float32")
    model = registry.build_model(cfg, device="cpu")
    params = params_from_jax(case["params"], model.specs(), "cpu", torch.float32)
    kv = L.KVCodecConfig(codec)
    serve, place_cache, (_, p_shard) = step_lib.build_serve_step(
        model, mesh, kv, torch.float32, attention)
    spec = model.cache_spec(case["b"], case["s"], kv)
    cache = place_cache({k: torch.from_numpy(v).to(spec[k].dtype) for k, v in case["cache"].items()})
    placed = {k: shardlib.spec_of(v) if shardlib.is_dtensor(v) else () for k, v in cache.items()}
    params = step_lib.place_tree(params, p_shard)
    logits, states = [], []
    for tok, idx in case["steps"]:
        lg, cache = serve(params, cache, torch.from_numpy(tok), torch.from_numpy(idx))
        logits.append(whole(lg))
        states.append({k: shardlib.local(cache[k]).numpy().copy() for k in STATES if k in cache})
    out["serve"][(arch, kind, codec, attention)] = {"logits": logits, "placed": placed,
                                                    "states": states}

# the supervised drill with a lost data row
d = inp["drill"]
cfg = registry.get_config("minicpm-2b", smoke=True).scaled(dtype="float32")
model = registry.build_model(cfg, device="cpu")
scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1,
                                adam=adamw.AdamWConfig(eps=1.0))

def builder(shape, batch):
    tr = sup.make_trainer(model, shape, batch, vocab=cfg.vocab, seq_len=16, step_cfg=scfg)

    def make_state():
        p = params_from_jax(d["params"], model.specs(), "cpu", torch.float32)
        zeros = lambda: tree_util.tree_unflatten(  # noqa: E731
            tree_util.tree_structure(p), [torch.zeros_like(x) for x in tree_util.tree_flatten(p)[0]])
        state = {"params": p, "opt": {"m": zeros(), "v": zeros(),
                                      "step": torch.zeros((), dtype=torch.int32)}}
        return step_lib.place_tree(state, tr.shardings)

    return dataclasses.replace(tr, make_state=make_state)

plan = faults.FaultPlan.from_events([faults.FaultEvent(step=5, kind="pod_loss", lost_data_rows=1)])
inj = faults.FaultInjector(plan, ckpt_dir=f"{root}/ckpt")
ckpt = CheckpointManager(f"{root}/ckpt", async_save=False, device="cpu",
                         policy=CodecPolicy(zstd_level=0), group=dist.new_group(backend="gloo"))
inj.manager = ckpt
state, res = sup.run_supervised(builder, dict(d["shape"]), 4, ckpt,
                                sup.SupervisorConfig(**d["cfg"]), injector=inj,
                                log=lambda s: None)
leaves = tree_util.tree_flatten(state)[0]
out["drill"] = {"transitions": [t.__dict__ for t in res.transitions],
                "loss_trace": res.loss_trace, "final_step": res.final_step,
                "meshes": {tuple(x.device_mesh.shape) for x in leaves if shardlib.is_dtensor(x)},
                "state": [whole(x) for x in leaves]}
pickle.dump(out, open(f"{root}/rank{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, functools
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.checkpoint.manager import CheckpointManager, CodecPolicy
from repro.configs import registry
from repro.models import layers as L
from repro.optim import adamw
from repro.train import faults, step as step_lib
from repro.train import supervisor as sup

root = sys.argv[1]
inp = pickle.load(open(f"{root}/inputs.pkl", "rb"))
out = {"placement": {}}

# the cache shardings, read off jit_step(cache_abs)
codec = L.KVCodecConfig("blockfloat8")
for mesh_name, (shape, axes) in inp["meshes"].items():
    mesh = compat.make_mesh(shape, axes)
    for arch in inp["archs"]:
        model = registry.build_model(registry.get_config(arch, smoke=True))
        with jax.set_mesh(mesh):
            _, jit_step, (p_abs, _) = step_lib.build_serve_step(model, mesh, codec=codec)
            for b, s in inp["cache_shapes"]:
                cache_abs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                             for k, v in model.cache_spec(b, s, codec).items()}
                tok = jax.ShapeDtypeStruct((b,), jnp.int32)
                idx = jax.ShapeDtypeStruct((), jnp.int32)
                sh = jit_step(cache_abs).lower(p_abs, cache_abs, tok, idx).compile()
                cache_sh = sh.input_shardings[0][1]
                out["placement"][(mesh_name, arch, b, s)] = {
                    k: tuple(v.spec) for k, v in cache_sh.items()}

# the supervised drill with a lost data row, on the first 4 devices
d = inp["drill"]
cfg = registry.get_config("minicpm-2b", smoke=True).scaled(dtype="float32")
model = registry.build_model(cfg)
scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, adam=adamw.AdamWConfig(eps=1.0))

def builder(shape, batch):
    tr = sup.make_trainer(model, shape, batch, vocab=cfg.vocab, seq_len=16, step_cfg=scfg)

    def make_state():
        p = jax.tree.map(jnp.asarray, d["params"])
        return jax.device_put({"params": p, "opt": adamw.init_state(p)}, tr.shardings)

    return dataclasses.replace(tr, make_state=make_state)

plan = faults.FaultPlan.from_events([faults.FaultEvent(step=5, kind="pod_loss", lost_data_rows=1)])
inj = faults.FaultInjector(plan, ckpt_dir=f"{root}/jckpt")
ckpt = CheckpointManager(f"{root}/jckpt", async_save=False, policy=CodecPolicy(zstd_level=0))
inj.manager = ckpt
state, res = sup.run_supervised(builder, dict(d["shape"]), 4, ckpt,
                                sup.SupervisorConfig(**d["cfg"]), injector=inj,
                                log=lambda s: None)
out["drill"] = {"transitions": [dataclasses.asdict(t) for t in res.transitions],
                "loss_trace": [(s, float(v)) for s, v in res.loss_trace],
                "final_step": res.final_step,
                "state": [np.asarray(x) for x in jax.tree.leaves(state)]}
pickle.dump(out, open(f"{root}/reference.pkl", "wb"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _port_serve(inp: dict) -> dict:
    """The port's one-process ``decode_step`` on each case: logits and
    recurrent states per step."""
    from repro_torch.models.interop import params_from_jax

    out = {}
    for (arch, kind, codec, attention), case in inp.items():
        model = registry.build_model(registry.get_config(arch, smoke=True).scaled(
            dtype="float32"), device="cpu")
        params = params_from_jax(case["params"], model.specs(), "cpu", torch.float32)
        kv = TL.KVCodecConfig(codec)
        spec = model.cache_spec(case["b"], case["s"], kv)
        cache = {k: torch.from_numpy(v).to(spec[k].dtype) for k, v in case["cache"].items()}
        logits, states = [], []
        for tok, idx in case["steps"]:
            lg, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                          torch.from_numpy(idx), kv, attention)
            logits.append(lg.numpy())
            states.append({k: cache[k].numpy().copy() for k in STATES if k in cache})
        out[(arch, kind, codec, attention)] = {"logits": logits, "states": states}
    return out


def _reference_serve(inp: dict) -> dict:
    """The reference's one-device ``serve_step`` (``model.decode_step``,
    jitted) on each case: logits per step."""
    out = {}
    for (arch, kind, codec, attention), case in inp.items():
        jm = jreg.build_model(jreg.get_config(arch, smoke=True).scaled(dtype="float32"))
        kv = JL.KVCodecConfig(codec)
        spec = jm.cache_spec(case["b"], case["s"], kv)
        cache = {k: jnp.asarray(v, dtype=spec[k].dtype) for k, v in case["cache"].items()}
        params = jax.tree.map(jnp.asarray, case["params"])
        step = jax.jit(jm.decode_step, static_argnums=4)
        logits = []
        for tok, idx in case["steps"]:
            lg, cache = step(params, cache, jnp.asarray(tok), jnp.asarray(idx), kv)
            logits.append(np.asarray(lg))
        out[(arch, kind, codec, attention)] = logits
    return out


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_serve")
    serve = {}
    for arch, kind, codec, attention in _cases():
        jm = jreg.build_model(jreg.get_config(arch, smoke=True).scaled(dtype="float32"))
        model = registry.build_model(registry.get_config(arch, smoke=True), device="meta")
        serve[(arch, kind, codec, attention)] = {
            "params": jax.tree.map(np.asarray, jspec.init_params(jm.specs(), jax.random.key(0),
                                                                 jnp.float32)),
            "cache": _cache_values(model, codec, 3), "b": B, "s": S,
            "steps": _steps(jm.cfg, kind)}
    jm = jreg.build_model(jreg.get_config("minicpm-2b", smoke=True))
    drill = {"params": jax.tree.map(np.asarray, jspec.init_params(jm.specs(), jax.random.key(0),
                                                                  jnp.float32)),
             "shape": DRILL_SHAPE, "cfg": DRILL}
    with open(root / "inputs.pkl", "wb") as f:
        pickle.dump({"serve": serve, "drill": drill, "meshes": MESHES, "states": STATES,
                     "archs": list(registry.ARCH_IDS), "cache_shapes": CACHE_SHAPES}, f)
    (root / "rank.py").write_text(textwrap.dedent(RANK))
    (root / "reference.py").write_text(textwrap.dedent(REFERENCE))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(root / "rank.py"), str(r), "4", port,
                               str(root)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(4)]
    jenv = dict(env, JAX_PLATFORMS="cpu")
    procs.append(subprocess.Popen([sys.executable, str(root / "reference.py"), str(root)],
                                  env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        want, one = _reference_serve(serve), _port_serve(serve)
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"process {i}:\n{out[-3000:]}" for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ranks = [pickle.load(open(root / f"rank{r}.pkl", "rb")) for r in range(4)]
    ref = pickle.load(open(root / "reference.pkl", "rb"))
    return {"ranks": ranks, "ref": ref, "serve_want": want, "serve_one": one}


# ------------------------------------------------------- cache placement --

def _trim(spec) -> tuple:
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCH_IDS))
def test_cache_placement_equals_reference(session, arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=shape, mesh_dim_names=axes)
    model = registry.build_model(registry.get_config(arch, smoke=True), device="meta")
    codec = TL.KVCodecConfig("blockfloat8")
    seen = set()
    for b, s in CACHE_SHAPES:
        want = session["ref"]["placement"][(mesh_name, arch, b, s)]
        got = step_lib.cache_shardings(model.cache_spec(b, s, codec), mesh)
        assert set(got) == set(want)
        for name, sh in got.items():
            assert sh.spec == _trim(want[name]), (b, s, name, sh.spec, want[name])
            seen.add(sh.spec[2] if len(sh.spec) > 2 else None)
    if arch not in ("rwkv6-1.6b",):  # rwkv6 holds no sequence of positions
        assert {"model", "data"} <= seen, seen  # both sequence rules were exercised


# -------------------------------------------------------------- serve step --

@pytest.mark.parametrize("arch,kind,codec,attention", _cases())
def test_serve_step_equals_reference(session, arch, kind, codec, attention):
    key = (arch, kind, codec, attention)
    want, one = session["serve_want"][key], session["serve_one"][key]["logits"]
    runs = [r["serve"][key] for r in session["ranks"]]
    placed = runs[0]["placed"]
    split = [k for k, spec in placed.items() if len(spec) > 2]
    if arch != "rwkv6-1.6b":
        assert split and all(placed[k] == (None, "data", "model") for k in split), placed
    for run in runs:
        for step, (got, w, o) in enumerate(zip(run["logits"], want, one)):
            assert got.shape == w.shape == (B, registry.get_config(arch, smoke=True).padded_vocab)
            np.testing.assert_array_equal(got, runs[0]["logits"][step])
            np.testing.assert_allclose(got, o, rtol=0, atol=ATOL, err_msg=f"step {step}")
            bound = np.abs(o - w) + RTOL * np.abs(w) + ATOL
            assert (np.abs(got - w) <= bound).all(), (step, float(np.abs(got - w).max()))
            np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))
    # every model rank's recurrent state holds every head of its data rank's
    # lanes, as the one-process run's after the same step: within the
    # logits' atol plus their rtol of the state's largest magnitude (hymba's
    # SSD states reach |90| at SMOKE, and each element sums decayed terms of
    # that size, where the one-process float32 run itself lies up to 5.7e-4
    # from float64; a head left stale or taken from another rank is off by
    # O(1))
    one_states = session["serve_one"][key]["states"]
    for r, run in enumerate(runs):
        lanes = slice((r // 2) * (B // 2), (r // 2 + 1) * (B // 2))  # rank r: data r // 2
        for step, (got, w) in enumerate(zip(run["states"], one_states)):
            assert set(got) == set(w) == ({"wkv"} if arch == "rwkv6-1.6b" else {"ssd_state"}
                                          if arch == "hymba-1.5b" else set())
            for name in got:
                assert run["placed"][name] == (None, "data"), run["placed"][name]
                scale = float(np.abs(w[name]).max())
                np.testing.assert_allclose(got[name], w[name][:, lanes], rtol=0,
                                           atol=ATOL + RTOL * scale,
                                           err_msg=f"rank {r} step {step} {name}")


# ---------------------------------------------------------- K10's blocks --

def _combine(parts: list) -> torch.Tensor:
    """Blocks' (out, lse) combined by their log-sum-exp (a lane with no
    position in any block gives 0)."""
    lse = torch.stack([p[1] for p in parts])
    big = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isfinite(big), big, torch.zeros_like(big)))
    acc = (w[..., None] * torch.stack([p[0] for p in parts])).sum(0)
    return acc / torch.clamp_min(w.sum(0), 1e-30)[..., None]


@pytest.mark.parametrize("b,s,h,hkv,d,blocks", [(5, 96, 4, 2, 16, 2), (5, 96, 8, 8, 32, 3),
                                                (5, 128, 24, 2, 128, 4)])
def test_k10_plain_blocks_combine_to_the_whole_cache(b, s, h, hkv, d, blocks):
    rng = np.random.default_rng(b * s + h)
    q = torch.from_numpy(rng.standard_normal((b, h, d), dtype=np.float32))
    kc, vc = (torch.from_numpy(rng.integers(-127, 128, (b, s, hkv, d), dtype=np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.random((b, s, hkv), dtype=np.float32) * 0.05 + 1e-3)
              for _ in range(2))
    blk = s // blocks
    # a free lane, a lane inside the first block only, one at the first border,
    # one at the last position, one in the middle
    idx = torch.tensor([-1, blk // 2, blk - 1, s - 1, s // 2 + 1], dtype=torch.int32)
    whole = kref.kvc_decode_attention_ref(q, kc, ks, vc, vs, idx)
    out0, lse0 = kref.kvc_decode_attention_ref(q, kc, ks, vc, vs, idx, 0, True)
    assert torch.equal(out0, whole)
    want_lse = torch.stack([torch.logsumexp(
        torch.einsum("hd,shd->hs", q[i], (kc[i].float() * ks[i][..., None]).repeat_interleave(
            h // hkv, 1))[:, :max(int(idx[i]) + 1, 0)] * d ** -0.5, -1) for i in range(b)])
    torch.testing.assert_close(lse0[1:], want_lse[1:], rtol=1e-5, atol=1e-5)
    assert torch.isinf(lse0[0]).all() and (lse0[0] < 0).all()
    parts = []
    for r in range(blocks):
        sl = slice(r * blk, (r + 1) * blk)
        o, lse = kref.kvc_decode_attention_ref(q, kc[:, sl], ks[:, sl], vc[:, sl], vs[:, sl],
                                               idx, r * blk, True)
        empty = idx < r * blk  # lanes with no position in this block
        assert torch.isinf(lse[empty]).all() and (lse[empty] < 0).all()
        assert torch.equal(o[empty], torch.zeros_like(o[empty]))
        assert torch.isfinite(lse[~empty]).all()
        parts.append((o, lse))
    got = _combine(parts)
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # the free lane
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------- grow-back drill --

def test_grow_back_drill_with_a_lost_data_row_equals_reference(session):
    want = session["ref"]["drill"]
    for r, run in enumerate(session["ranks"]):
        got = run["drill"]
        assert got["final_step"] == want["final_step"] == DRILL["total_steps"]
        assert got["transitions"] == want["transitions"], r
        shrink, grow = got["transitions"]
        assert shrink["kind"] == "shrink" and shrink["mesh_shape"] == {"data": 1, "model": 2}
        assert grow["kind"] == "grow" and grow["mesh_shape"] == DRILL_SHAPE
        assert got["meshes"] == {(2, 2)}  # the state lives on the full mesh again
        assert [s for s, _ in got["loss_trace"]] == [s for s, _ in want["loss_trace"]]
        np.testing.assert_allclose([v for _, v in got["loss_trace"]],
                                   [v for _, v in want["loss_trace"]], rtol=1e-5)
        assert len(got["state"]) == len(want["state"])
        for a, w in zip(got["state"], want["state"]):
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-6)
