"""Twin test of the port's sharded train step against the reference's
jitted step, on the CPU.

The reference runs ``build_train_step``'s jitted step under GSPMD on 8
forced host devices as ``{"pod": 2, "data": 2, "model": 2}`` (a
subprocess, as ``tests/test_train_loop.py`` runs its 8-device tests); the
port runs its sharded step on 8 ``gloo`` ranks of the same mesh, one
subprocess each, from the reference's initial state carried across by
``models.interop.state_from_jax`` and placed by the port's specs
(``elastic.reshard_state``).  minicpm-2b and phi3.5-moe at SMOKE in float32,
three steps of the plain (uncompressed) pod mean: losses within ``rtol``
1e-6, every gathered parameter within 1e-5 absolute, ``m`` and ``v``
within ``rtol`` 1e-2 and the gradient norm within ``rtol`` 1e-5 (the
tolerances of ``tests/test_torch_train.py``).

phi3.5-moe's step is not that well conditioned: the reference's own step
on one device and on the 8 devices differ by up to 8.3e-5 in the embedding
table and 1.4e-4 (relative) in the gradient norm after three steps (seen),
and the port's one-process step lies as far from it.  So its parameters,
moments and norms are held within twice the reference's own one-device to
8-device spread, measured in the same run (and never tighter than the
tolerances above); its losses keep ``rtol`` 1e-6.  The compressed hop is not
twinned here: the port quantises each rank's block of a gradient, the
reference the whole per-pod gradient, so their block scales differ by
design.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("minicpm-2b", "phi3.5-moe-42b-a6.6b")

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.data.tokens import DataConfig, TokenPipeline
from repro.train import step as jstep

root = sys.argv[1]
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
for arch in ARCHS:
    cfg = registry.get_config(arch, smoke=True).scaled(dtype="float32")
    jm = registry.build_model(cfg)
    scfg = jstep.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, schedule="wsd")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=5))
    with jax.set_mesh(mesh):
        st = jstep.init_state(jm, mesh, jax.random.key(0), step_cfg=scfg)
        tmp = os.path.join(root, f"init_{arch}.tmp")
        pickle.dump(jax.tree.map(np.asarray, st), open(tmp, "wb"))
        os.replace(tmp, os.path.join(root, f"init_{arch}.pkl"))  # the port's ranks start
        _, jit_step, _ = jstep.build_train_step(jm, mesh, step_cfg=scfg)
        b0 = pipe.batch_at(0)
        step = jit_step({k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in b0.items()})
        losses, norms = [], []
        for i in range(3):
            st, m = step(st, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    res = {"losses": losses, "norms": norms, "state": jax.tree.map(np.asarray, st)}
    if cfg.family == "moe":  # the reference's own spread: the same steps on one device
        one = jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        with jax.set_mesh(one):
            st = jstep.init_state(jm, one, jax.random.key(0), step_cfg=scfg)
            _, jit_step, _ = jstep.build_train_step(jm, one, step_cfg=scfg)
            step = jit_step({k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in b0.items()})
            norms = []
            for i in range(3):
                st, m = step(st, {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()})
                norms.append(float(m["grad_norm"]))
        res["one"] = {"norms": norms, "state": jax.tree.map(np.asarray, st)}
    pickle.dump(res, open(os.path.join(root, f"ref_{arch}.pkl"), "wb"))
"""

RANK = """
import os, pickle, sys, time
import numpy as np, torch, torch.distributed as dist
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist import sharding as shardlib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.interop import state_from_jax
from repro_torch.train import elastic, step as step_lib

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
out = {}
for arch in ARCHS:
    path = os.path.join(root, f"init_{arch}.pkl")
    t0 = time.time()
    while not os.path.exists(path):  # the reference writes it before compiling its step
        if time.time() - t0 > 240:
            raise SystemExit(f"no {path}")
        time.sleep(0.1)
    cfg = registry.get_config(arch, smoke=True).scaled(dtype="float32")
    model = registry.build_model(cfg, device="cpu")
    scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, schedule="wsd")
    whole = state_from_jax(pickle.load(open(path, "rb")), model.specs(), "cpu")
    state = elastic.reshard_state(whole, model, mesh, scfg)
    del whole
    step = step_lib.build_train_step(model, mesh, scfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=5))
    losses, norms = [], []
    for i in range(3):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = lambda t: [(x.full_tensor() if shardlib.is_dtensor(x) else x).numpy()
                      for x in tree_util.tree_flatten(t)[0]]
    out[arch] = {"losses": losses, "norms": norms, "params": full(state["params"]),
                 "m": full(state["opt"]["m"]), "v": full(state["opt"]["v"]),
                 "step": int(shardlib.local(state["opt"]["step"]))}
pickle.dump(out, open(os.path.join(root, f"rank{rank}.pkl"), "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's 8 forced devices and the port's 8 ranks, started
    together."""
    d = tmp_path_factory.mktemp("sharded_step")
    head = f"ARCHS = {ARCHS!r}\n"
    (d / "reference.py").write_text(head + textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(head + textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), str(r), "8", port, str(d)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
              for r in range(8)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"process {i}:\n{out[-1500:]}" for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    ref = {a: pickle.load(open(d / f"ref_{a}.pkl", "rb")) for a in ARCHS}
    return ref, [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(8)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_agrees_with_reference_jit(runs, arch):
    import jax

    ref, ranks = runs
    want = ref[arch]
    st = want["state"]
    one = want.get("one")

    def spread(part, i):  # twice the reference's own 1-device vs 8-device difference
        if one is None:
            return 0.0
        a = jax.tree.leaves(one["state"]["params"] if part == "params"
                            else one["state"]["opt"][part])[i]
        b = jax.tree.leaves(st["params"] if part == "params" else st["opt"][part])[i]
        return 2 * float(np.abs(a - b).max())

    norm_rtol = 1e-5 if one is None else max(1e-5, 2 * float(np.max(
        np.abs(np.subtract(one["norms"], want["norms"])) / np.abs(want["norms"]))))
    for r, run in enumerate(ranks):
        got = run[arch]
        assert got["step"] == 3
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=norm_rtol)
        for i, (a, b) in enumerate(zip(got["params"], jax.tree.leaves(st["params"]))):
            np.testing.assert_allclose(a, b, rtol=0, atol=max(1e-5, spread("params", i)))
        for part in ("m", "v"):
            for i, (a, b) in enumerate(zip(got[part], jax.tree.leaves(st["opt"][part]))):
                np.testing.assert_allclose(a, b, rtol=1e-2, atol=max(
                    1e-9 if part == "v" else 1e-7, spread(part, i)))
