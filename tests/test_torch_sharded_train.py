"""The port's sharded training state (``train/step.py``, ``dist/spmd.py``,
``dist/sharding.py``, ``optim/adamw.py``, ``train/elastic.py``,
``checkpoint/manager.py``) on the CPU.

* **Spec twins.**  For all ten architectures on the ``(16, 16)``,
  ``(2, 16, 16)``, ``(2, 2, 2)`` and ``(4, 2)`` meshes (abstract: axis
  names and sizes, no processes), every state leaf's spec from
  ``make_state_specs`` and ``tree_shardings`` and the batch's from
  ``batch_sharding`` equal the reference's ``PartitionSpec``; the port's
  error-feedback row is the reference's ``PS("pod", *spec)`` without its
  pod dimension.
* On 8 ``gloo`` ranks (one subprocess each, one session for the module):
  - **sharded vs replicated**: three steps of the sharded step on
    ``{"pod": 2, "data": 2, "model": 2}`` (minicpm-2b, phi3.5-moe and
    rwkv6 at SMOKE in float32, minicpm-2b with two microbatches, hymba in
    float64; the ranks along ``model`` share their rows and compute on
    Megatron blocks: rwkv6's one 64-wide head a rank, hymba's 2 q, 1 kv and
    2 SSD heads a rank) against the port's own one-process step (hymba's
    one-process float32 ``m`` already lies up to 5.7e-6 from float64's, 16
    elements outside ``m``'s tolerance): the tolerances of
    ``tests/test_torch_train.py`` (loss ``rtol`` 1e-6, parameters 1e-5
    absolute, second moments ``rtol`` 1e-2), the gradient norm within
    ``rtol`` 1e-5, and each rank's blocks of the shapes its specs give;
  - **the three head layouts** on ``{"data": 2, "model": 4}`` at the same
    tolerances: phi3.5-moe at SMOKE (4 q heads split, its 2 kv heads
    replicated and cut per rank), minicpm-2b at SMOKE with 2 heads (heads
    replicated, every rank computes the whole attention), whisper-base
    at SMOKE with random frames (self- and cross-attention, GELU MLPs and
    the tied table on blocks), qwen3-moe at SMOKE with 6 experts (the
    experts replicated on 4, each a Megatron MLP on its ``mlp`` blocks),
    rwkv6 at SMOKE (32 columns a rank cut its two 64-wide heads: the time
    mix gathers them whole, the channel mix splits) and hymba at SMOKE (4
    q and 4 SSD heads split, its 2 kv heads replicated and cut per rank).
    The last three run in float64 (the model modules' float32 casts made
    float64, as ``chip_smoke.py``'s phase 30 evaluates its reference).  At
    SMOKE every step is sensitive at the tolerances' level: a one-ulp change
    of the embedding's output moves the gradient by 1e-5 to 2e-5 of its
    largest element for minicpm-2b, phi3.5-moe and qwen3-moe and by 4.5e-4
    for whisper-base, whose float32 gradient lies 2.2e-3 from float64's
    (``tools/f32_conditioning.py``); in float32 the minicpm-2b (2 heads)
    and qwen3-moe (6 experts) cases part from the one-process step by more
    than the norm's ``rtol`` 1e-5 at the third step, after AdamW has
    amplified such rounding.  In float64 the tolerances hold the partition,
    not the rounding;
  - **bytes by axis**: minicpm-2b's second step on ``(2, 2, 2)`` sends no
    all-gather or reduce-scatter over ``model`` (every heads, mlp and vocab
    leaf keeps its block), and its all-reduces over ``model`` are the
    activations' count (``_model_all_reduce_bytes``);
  - **global norm**: ``adamw.global_norm`` over ``DTensor`` blocks split on
    ``data``, ``model``, both, and replicated equals the whole tree's norm
    within ``rtol`` 1e-6 and is the same on every rank;
  - **reshard and grow-back** (the twins of ``tests/test_train_loop.py::
    test_elastic_reshard`` and ``test_elastic_grow_back_bitwise``): a state
    made on ``(2, 2, 2)`` resharded onto ``(1, 2, 2)``, and the survivors'
    blocks carried back onto ``(2, 2, 2)``, bitwise;
  - **checkpoint** (the twins of ``tests/test_checkpoint.py``'s
    ``test_per_shard_save_restore_8dev`` and
    ``test_compressed_restore_different_mesh_8dev``): a leaf split over
    ``("data", "model")`` of ``(4, 2)`` saves one payload per block and
    restores onto the mesh within its bound; an in-situ stream and a leaf
    split on ``(2, 2, 2)`` restore onto a ``(4,)`` ``("data",)`` mesh.
"""

import contextlib
import inspect
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.dist import sharding as jshard
from repro.train import step as jstep
from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shardlib
from repro_torch.models.spec import init_params
from repro_torch.train import step as step_lib

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _trim(ps) -> tuple:
    out = list(ps)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(registry.ARCH_IDS))
def test_state_specs_equal_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, axes)
    mesh = types.SimpleNamespace(shape=shape, mesh_dim_names=axes)
    gc = collectives.GradCompressionConfig(enabled=True)
    jgc = jstep.collectives.GradCompressionConfig(enabled=True)
    jm = jreg.build_model(jreg.get_config(arch))
    model = registry.build_model(registry.get_config(arch), device="meta")
    jabs, jsh = jstep.make_state_specs(jm, jmesh, step_cfg=jstep.TrainStepConfig(grad_comp=jgc))
    pabs, psh = step_lib.make_state_specs(model, mesh, step_lib.TrainStepConfig(grad_comp=gc))
    assert set(psh) == set(jsh) == ({"params", "opt", "ef"} if "pod" in axes
                                     else {"params", "opt"})
    for part in ("params", "opt"):
        want = jax.tree.leaves(jsh[part], is_leaf=lambda x: hasattr(x, "spec"))
        got = tree_util.tree_flatten(psh[part])[0]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.spec == _trim(w.spec), (part, g.spec, w.spec)
    if "ef" in jsh:
        want = jax.tree.leaves(jsh["ef"], is_leaf=lambda x: hasattr(x, "spec"))
        for g, w in zip(tree_util.tree_flatten(psh["ef"])[0], want):
            assert ("pod",) + tuple(g.spec) == _trim(w.spec) or (not g.spec and
                                                                _trim(w.spec) == ("pod",))
    # tree_shardings on the params' logical axes, and the batch's sharding
    specs = model.specs()
    from repro.models.spec import logical_axes

    jtree = jshard.tree_shardings(logical_axes(jm.specs()), jabs["params"], jmesh)
    ptree = shardlib.tree_shardings(step_lib._map_specs(lambda p: p.axes, specs),
                                    pabs["params"], mesh)
    for g, w in zip(tree_util.tree_flatten(ptree)[0],
                    jax.tree.leaves(jtree, is_leaf=lambda x: hasattr(x, "spec"))):
        assert g.spec == _trim(w.spec)
    for rank in (1, 2, 3):
        assert shardlib.batch_sharding(mesh).spec == \
            _trim(jshard.batch_sharding(jmesh, rank).spec)


# ------------------------------------------------------------ 8 gloo ranks --


@contextlib.contextmanager
def float64_modules(on: bool):
    """The model modules' float32 casts (norms, RoPE, attention scores,
    routing, the loss) made float64 while ``on``, through a stand-in for
    their ``torch``; restored on exit."""
    from repro_torch.models import encdec, hybrid, layers, moe, rwkv6, transformer

    mods = (layers, transformer, moe, encdec, rwkv6, hybrid)
    saved = [m.torch for m in mods]
    if on:
        proxy = types.ModuleType("torch")
        proxy.__dict__.update(vars(torch))
        proxy.float32 = torch.float64
        for m in mods:
            m.torch = proxy
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


def batches(cfg, k: int) -> list:
    """Three global batches of 8 * k rows of 16 tokens (seed 5), and frames
    (standard normal, seed 9) for the audio family."""
    from repro_torch.data.tokens import DataConfig, TokenPipeline

    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8 * k, seed=5))
    rng = np.random.default_rng(9)
    out = []
    for i in range(3):
        b = dict(pipe.batch_at(i))
        if cfg.family == "audio":
            b["frames"] = rng.standard_normal((8 * k, cfg.encoder_len, cfg.d_model),
                                              dtype=np.float32)
        out.append(b)
    return out


RANK = """
import contextlib, hashlib, io, pickle, sys, types
import numpy as np, torch, torch.distributed as dist
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.checkpoint.manager import CheckpointManager, CodecPolicy
from repro_torch.configs import registry
from repro_torch.core import sz as sz_core
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist import insitu, sharding as shardlib, spmd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import build_insitu_hook
from repro_torch.optim import adamw
from repro_torch.train import elastic, step as step_lib

AXES = ("pod", "data", "model")
full = make_mesh((2, 2, 2), AXES, "cpu")
out = {}
# HELPERS

def whole(x):
    return (x.full_tensor() if shardlib.is_dtensor(x) else x).detach().numpy()

def digest(tree):
    return [hashlib.sha256(shardlib.local(x).detach().reshape(-1).view(torch.uint8).numpy()
                           .tobytes()).hexdigest() for x in tree_util.tree_flatten(tree)[0]]

# sharded step
mesh24 = make_mesh((2, 4), ("data", "model"), "cpu")
CASES = [("minicpm-2b", 1, full, {}, False), ("phi3.5-moe-42b-a6.6b", 1, full, {}, False),
         ("minicpm-2b", 2, full, {}, False), ("rwkv6-1.6b", 1, full, {}, False),
         ("hymba-1.5b", 1, full, {}, True), ("phi3.5-moe-42b-a6.6b", 1, mesh24, {}, False),
         ("minicpm-2b", 1, mesh24, {"n_heads": 2, "n_kv_heads": 2}, True),
         ("whisper-base", 1, mesh24, {}, True),
         ("qwen3-moe-30b-a3b", 1, mesh24, {"n_experts": 6}, True),
         ("rwkv6-1.6b", 1, mesh24, {}, False), ("hymba-1.5b", 1, mesh24, {}, False)]
for arch, k, mesh, over, f64 in CASES:
    with float64_modules(f64):
        cfg = registry.get_config(arch, smoke=True).scaled(dtype="float32", **over)
        model = registry.build_model(cfg, device="cpu")
        if f64:
            model.dtype = torch.float64
        scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                                        schedule="wsd", microbatches=k,
                                        param_dtype=torch.float64 if f64 else torch.float32)
        state = step_lib.init_state(model, mesh, torch.Generator().manual_seed(0), scfg)
        _, shard = step_lib.make_state_specs(model, mesh, scfg)
        shapes_ok = all(
            tuple(shardlib.local(x).shape) == shardlib.local_shape(x.shape, sh.spec, mesh)
            for x, sh in zip(tree_util.tree_flatten(state)[0], tree_util.tree_flatten(shard)[0]))
        split = sum(shardlib.is_dtensor(x) for x in tree_util.tree_flatten(state)[0])
        extra = ("frames",) if cfg.family == "audio" else ()
        step = step_lib.build_train_step(model, mesh, scfg, extra_keys=extra)
        losses, norms, sent = [], [], None
        for i, batch in enumerate(batches(cfg, k)):
            spmd.reset_sent_bytes()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 1:
                sent = {kind: dict(v) for kind, v in spmd.sent_by_axis.items()}
    flat = lambda t: [whole(x) for x in tree_util.tree_flatten(t)[0]]
    case = ("step", arch, k) if mesh is full else ("step24", arch)
    if case == ("step", "minicpm-2b", 1):  # the in-situ hook on the sharded state
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hook = build_insitu_hook(full, f"{root}/hook", 1e-3, min_bytes=1024, overlap=False)
            hook(3, state)
            hook.wait()
        dist.barrier()
        named = dict(tree_util.tree_flatten_with_path(state)[0])
        big = {key: x for key, x in named.items()
               if x.is_floating_point() and x.ndim and x.numel() * x.element_size() >= 1024}
        spec = lambda x: shardlib.spec_of(x) if shardlib.is_dtensor(x) else ()
        entries = [(key, tuple(x.shape), x.dtype, spec(x)) for key, x in big.items()]
        kb, rest = insitu.plan_kernel_buckets(entries, full)
        fb, skipped = insitu.plan_arena(rest, full)
        like = {f"karena{i:03d}": dict.fromkeys(b.names, 0) for i, b in enumerate(kb)}
        like.update({f"arena{i:03d}": dict.fromkeys(b.names, 0) for i, b in enumerate(fb)})
        like.update({key: 0 for key, _ in skipped if f"skipping {key}:" not in buf.getvalue()})
        sh = lambda key: shardlib.NamedSharding(full, spec(big[key]))
        got, _ = hook.manager.restore(3, state_like=like, shardings={
            f: ({n: sh(n) for n in v} if isinstance(v, dict) else sh(f)) for f, v in like.items()})
        names = {}
        for key, field in got.items():
            for name, x in (field.items() if isinstance(field, dict) else [(key, field)]):
                names[name] = x
        out["hook"] = {"big": sorted(big), "restored": sorted(names), "log": buf.getvalue(),
                       "err": max(float((names[key].to_local() - shardlib.local(big[key]))
                                        .abs().max()) for key in names)}
    out[case] = {"losses": losses, "norms": norms, "shapes_ok": shapes_ok, "sent": sent,
                 "split": split, "params": flat(state["params"]),
                 "m": flat(state["opt"]["m"]), "v": flat(state["opt"]["v"])}

# global norm over blocks
rng = np.random.default_rng(3)
leaves = {"dm": rng.normal(size=(8, 6)), "m": rng.normal(size=(4, 10)),
          "d": rng.normal(size=(6,)), "r": rng.normal(size=(5, 3)), "p": rng.normal(size=(3,))}
specs = {"dm": ("data", "model"), "m": (None, "model"), "d": ("data",), "r": (), "p": None}
tree = {}
for key, x in leaves.items():
    t = torch.from_numpy(x.astype(np.float32))
    tree[key] = t if specs[key] is None else shardlib.place(t, shardlib.NamedSharding(
        full, specs[key]))
out["norm"] = float(adamw.global_norm(tree))
out["norm_want"] = float(np.sqrt(sum((x.astype(np.float32).astype(np.float64) ** 2).sum()
                                     for x in leaves.values())))

# reshard onto the survivors' mesh, then grow back
cfg = registry.get_config("minicpm-2b", smoke=True)
model = registry.build_model(cfg, device="cpu")
state = step_lib.init_state(model, full, torch.Generator().manual_seed(0))
out["ref"] = digest(state)
shape = elastic.degraded_mesh_shape({"pod": 2, "data": 2, "model": 2}, lost_pods=1)
small = elastic.make_degraded_mesh(shape, "cpu")
state_s = elastic.reshard_state(state, model, small)
if state_s is not None:
    out["shrink"] = digest(state_s)
    out["shrink_meshes"] = {tuple(x.device_mesh.shape) for x in tree_util.tree_flatten(state_s)[0]}
else:  # a lost rank: only the structure is read at the grow-back
    state_s = step_lib.init_state(model, None, torch.Generator().manual_seed(rank + 7))
_, full_shard = step_lib.make_state_specs(model, full)
out["grow"] = digest(elastic.grow_back(state_s, full_shard))

# checkpoint: a (4, 2) ("data", "model") split leaf, one payload per block
dm = make_mesh((4, 2), ("data", "model"), "cpu")
rng = np.random.default_rng(7)
w = torch.from_numpy(rng.normal(size=(512, 1024)).astype(np.float32))
axes = {"w": ("embed", "mlp"), "b": ("embed",), "step": ()}
vals = {"w": w, "b": torch.ones(512), "step": torch.tensor(3, dtype=torch.int32)}
sh = shardlib.tree_shardings(axes, vals, dm)
st = {k: shardlib.place(v, sh[k]) for k, v in vals.items()}
pol = CodecPolicy(mode="sz_abs", eb=1e-3, min_bytes=1 << 16)
group = dist.new_group(backend="gloo")
mgr = CheckpointManager(f"{root}/ck42", async_save=False, policy=pol, device="cpu", group=group)
mgr.save(1, st)
dist.barrier()
if rank == 0:
    d = sorted(__import__("pathlib").Path(f"{root}/ck42").glob("step_*"))[0]
    out["names"] = sorted(p.name for p in d.glob("leaf_*.bin"))
got, _ = mgr.restore(state_like=st, shardings=sh)
out["ck42"] = {"specs": [shardlib.spec_of(got[k]) for k in ("w", "b")],
               "w_err": float((got["w"].to_local() - st["w"].to_local()).abs().max()),
               "b_equal": bool(torch.equal(got["b"].to_local(), st["b"].to_local())),
               "step": int(shardlib.local(got["step"]))}

# checkpoint: an in-situ stream and a split leaf saved on (2, 2, 2), restored on (4,)
EB = 1e-2
field = torch.from_numpy((rng.normal(size=(16, 8, 8)) * 10).astype(np.float32))
fspec = ("pod", "data", "model")
hss = insitu.to_host(insitu.sharded_compress(
    shardlib.place(field, shardlib.NamedSharding(full, fspec)), "sz", full, fspec, eb=EB))
w2 = shardlib.place(w, shardlib.NamedSharding(full, ("data", "model")))
state = {"rho": hss, "w": w2, "step": torch.tensor(3, dtype=torch.int32)}
mgr = CheckpointManager(f"{root}/ck222", async_save=False, policy=pol, device="cpu", group=group)
mgr.save(1, state)
dist.barrier()
new = elastic.make_degraded_mesh({"data": 4}, "cpu")
if new.get_coordinate() is not None:
    shn = {"rho": shardlib.NamedSharding(new, ("data",)), "w": shardlib.NamedSharding(new, ("data",)),
           "step": shardlib.NamedSharding(new, ())}
    # the stream is gathered to the first rank: the others' trees lack it
    got, _ = mgr.restore(state_like={"rho": 0, "step": 0, "w": 0}, shardings=shn)
    ref = sz_core.decompress(sz_core.compress(field, EB))
    lo = new.get_coordinate()[0] * 4
    out["ck222"] = {
        "rho_equal": bool(torch.equal(got["rho"].to_local(), ref[lo:lo + 4])),
        "rho_err": float((got["rho"].to_local() - field[lo:lo + 4]).abs().max()),
        "w_err": float((got["w"].to_local() - w[lo * 32:lo * 32 + 128]).abs().max()),
        "step": int(got["step"].to_local())}
pickle.dump(out, open(f"{root}/rank{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    path = d / "rank.py"
    helpers = inspect.getsource(float64_modules) + "\n" + inspect.getsource(batches)
    path.write_text(textwrap.dedent(RANK).replace("# HELPERS\n", helpers))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(path), str(r), "8", port, str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(8)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}:\n{out[-1500:]}" for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(8)]


def _replicated(arch: str, k: int, over: dict = {}, f64: bool = False) -> dict:  # noqa: B006
    with float64_modules(f64):
        cfg = registry.get_config(arch, smoke=True).scaled(dtype="float32", **over)
        model = registry.build_model(cfg, device="cpu")
        if f64:
            model.dtype = torch.float64
        scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                                        schedule="wsd", microbatches=k,
                                        param_dtype=torch.float64 if f64 else torch.float32)
        state = step_lib.init_state(model, None, torch.Generator().manual_seed(0), scfg)
        step = step_lib.build_train_step(model, None, scfg, extra_keys=(
            ("frames",) if cfg.family == "audio" else ()))
        losses, norms = [], []
        for batch in batches(cfg, k):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    flat = lambda t: [x.numpy() for x in tree_util.tree_flatten(t)[0]]  # noqa: E731
    return {"losses": losses, "norms": norms, "params": flat(state["params"]),
            "m": flat(state["opt"]["m"]), "v": flat(state["opt"]["v"])}


def _hold(got: dict, want: dict, first: dict) -> None:
    """The sharded run ``got`` against the one-process ``want`` (the
    tolerances of ``tests/test_torch_train.py``); ``first``: rank 0's run."""
    assert got["shapes_ok"] and got["split"] > 0
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
    assert got["losses"] == first["losses"]
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for a, b in zip(got["v"], want["v"]):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-9)
    for a, b in zip(got["m"], want["m"]):
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-7)


@pytest.mark.parametrize("arch,k", [("minicpm-2b", 1), ("phi3.5-moe-42b-a6.6b", 1),
                                    ("minicpm-2b", 2), ("rwkv6-1.6b", 1), ("hymba-1.5b", 1)])
def test_sharded_step_equals_replicated(ranks, arch, k):
    want = _replicated(arch, k, f64=arch == "hymba-1.5b")
    for run in ranks:
        _hold(run[("step", arch, k)], want, ranks[0][("step", arch, k)])


@pytest.mark.parametrize("arch,over,f64", [
    ("phi3.5-moe-42b-a6.6b", {}, False),  # 4 q heads split, 2 kv heads replicated on 4
    ("minicpm-2b", {"n_heads": 2, "n_kv_heads": 2}, True),  # heads replicated on 4
    ("whisper-base", {}, True),
    ("qwen3-moe-30b-a3b", {"n_experts": 6}, True),  # 6 experts replicated, mlp split on 4
    ("rwkv6-1.6b", {}, False),  # 32 columns a rank cut its 2 heads of 64: gathered whole
    ("hymba-1.5b", {}, False)])  # 4 q and 4 SSD heads split, 2 kv heads replicated on 4
def test_head_layouts_on_data_2_model_4(ranks, arch, over, f64):
    """The step on ``{"data": 2, "model": 4}`` against the one-process step
    (module docstring: the three head layouts)."""
    want = _replicated(arch, 1, over, f64)
    for run in ranks:
        _hold(run[("step24", arch)], want, ranks[0][("step24", arch)])


def _model_all_reduce_bytes(cfg, rows: int, seq: int) -> int:
    """The bytes one rank all-reduces over ``model`` in a step of the dense
    family whose heads, MLP and vocab all split: per layer the attention's
    and the MLP's reductions forward, the attention's again when the
    backward pass recomputes the layer (``torch.utils.checkpoint`` stops
    recomputing once the layer's last saved tensor is back, before the
    MLP's reduction), and the copies into both regions backward; the
    embedding's reduction and the unembedding's copy backward; each a
    (rows, seq, d_model) float32 activation.  Plus the loss's three
    (rows, seq) reductions: the max, the sum of exponents, the target
    logit."""
    act = rows * seq * cfg.d_model * 4
    return (5 * cfg.n_layers + 2) * act + 3 * rows * seq * 4


def test_bytes_over_model_are_activations(ranks):
    cfg = registry.get_config("minicpm-2b", smoke=True)
    want = _model_all_reduce_bytes(cfg, 8 // 4, 16)  # 8 rows over pod x data
    for r, run in enumerate(ranks):
        sent = run[("step", "minicpm-2b", 1)]["sent"]
        assert "model" not in sent["all_gather"] and "model" not in sent["reduce_scatter"], sent
        assert sent["all_reduce"]["model"] == want, (r, sent, want)
        assert sent["all_gather"]["data"] > 0 and sent["reduce_scatter"]["data"] > 0


def test_insitu_hook_codes_or_names_every_sharded_leaf(ranks):
    """The in-situ hook on the sharded minicpm-2b state: every float leaf
    of 1 KiB or more reaches a coder (and restores within the bound) or is
    named once in a "skipping" line, on every rank."""
    for r, run in enumerate(ranks):
        h = run["hook"]
        skipped = [line for line in h["log"].splitlines() if "skipping" in line]
        for key in h["big"]:
            named = sum(f"skipping {key}:" in line for line in skipped)
            assert (key in h["restored"]) + named == 1, (r, key, named, h["log"])
        assert set(h["restored"]) <= set(h["big"]) and h["restored"], r
        assert h["err"] <= 1e-3 * (1 + 1e-5), r


def test_global_norm_counts_each_element_once(ranks):
    for run in ranks:
        assert run["norm"] == ranks[0]["norm"]
        np.testing.assert_allclose(run["norm"], run["norm_want"], rtol=1e-6)


def test_reshard_and_grow_back_bitwise(ranks):
    for r, run in enumerate(ranks):
        assert run["ref"] == ranks[r % 4]["ref"], r  # one block per (data, model) coordinate
        if r < 4:
            assert run["shrink"] == run["ref"], r
            assert run["shrink_meshes"] == {(1, 2, 2)}
        else:
            assert "shrink" not in run
        assert run["grow"] == run["ref"], r
    assert ranks[0]["ref"] != ranks[1]["ref"]


def test_checkpoint_split_over_data_and_model(ranks):
    names = ranks[0]["names"]
    # w: 4 x 2 blocks -> 8 payloads; b: 4 data blocks; step: one whole leaf
    assert sum(n.startswith("leaf_00002") for n in names) == 8, names
    assert sum(n.startswith("leaf_00000") for n in names) == 4, names
    for run in ranks:
        c = run["ck42"]
        assert c["specs"] == [("data", "model"), ("data",)]
        assert c["w_err"] <= 1e-3 * (1 + 1e-5) and c["b_equal"] and c["step"] == 3


def test_checkpoint_restores_onto_another_mesh(ranks):
    for r, run in enumerate(ranks):
        if r >= 4:
            assert "ck222" not in run
            continue
        c = run["ck222"]
        assert c["rho_equal"] and c["rho_err"] <= 1e-2 * (1 + 1e-5)
        assert c["w_err"] <= 1e-3 * (1 + 1e-5) and c["step"] == 3


def test_init_state_keeps_blocks_of_the_replicated_draw():
    """One process, a one-rank mesh: every spec replicates, and the state
    is the replicated draw leaf for leaf (a larger mesh keeps blocks of the
    same draw, as the 8-rank session checks through its steps)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    model = registry.build_model(registry.get_config("minicpm-2b", smoke=True), device="cpu")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        state = step_lib.init_state(model, mesh, torch.Generator().manual_seed(0))
    finally:
        dist.destroy_process_group()
    want = init_params(model.specs(), torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(tree_util.tree_flatten(state["params"])[0], tree_util.tree_flatten(want)[0]):
        assert torch.equal(shardlib.local(a), b)
