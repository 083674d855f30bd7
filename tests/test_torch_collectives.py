"""Twin tests of the port's compressed cross-pod collectives
(``repro_torch.dist.collectives``) against the JAX package's
(``repro.dist.collectives``).

* The wire format in one process: the block-wise quantizer, its inverse and
  the nibble packing, bitwise the reference's on seeded inputs (zero
  blocks, odd lengths, bits 4 and 8), and the wire-byte accounting (the
  port's twins of ``tests/test_dist.py::TestWireAccounting``).
* Both forms of the hop on a two-rank ``gloo`` group (each rank a
  subprocess) against the reference's ``_MULTIDEV`` and ``_STACKED``
  drives on two forced host devices: means and error feedback over three
  steps, bits 8 and 4, bitwise (two pods sum in any order alike; the
  reference runs op by op, since under jit XLA's CPU backend multiplies by
  ``1 / qmax`` and contracts the second pod's dequantize into the sum), the
  uncompressed hop bitwise the plain mean, the gathered tensors int8 or
  uint8, and the bytes each rank sends exactly its codes plus scales.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import collectives as jcol
from repro_torch.dist import collectives as tcol

SRC = Path(__file__).resolve().parents[1] / "src"


def _grad(n, seed, zero_blocks=()):
    g = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 3
    for b in zero_blocks:
        g[b * 64:(b + 1) * 64] = 0.0
    return g


QUANT_CASES = {
    # name: (n, bits, block, zero blocks of 64)
    "b8-odd": (5000, 8, 1024, ()),
    "b4-odd": (4097, 4, 64, (0, 3)),
    "b8-zero-blocks": (640, 8, 64, (1, 2, 9)),
    "b4-one-short-block": (37, 4, 64, ()),
    "b4-all-zero": (256, 4, 64, (0, 1, 2, 3)),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_blockwise_quantizer_equals_reference(case):
    n, bits, block, zeros = QUANT_CASES[case]
    g = _grad(n, len(case), zeros)
    tc, ts = tcol._quantize_blockwise(torch.from_numpy(g), bits, block)
    jc, js = jcol._quantize_blockwise(jnp.asarray(g), bits, block)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    if zeros:
        assert (ts.numpy() == 0).any()
    td = tcol._dequantize_blockwise(tc, ts, n, block)
    jd = jcol._dequantize_blockwise(jc, js, n, block)
    np.testing.assert_array_equal(td.numpy().view(np.int32), np.asarray(jd).view(np.int32))
    if bits == 4:
        tw, jw = tcol._pack_nibbles(tc), jcol._pack_nibbles(jc)
        assert tw.dtype == torch.uint8 and tw.numel() == tc.numel() // 2
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tcol._unpack_nibbles(tw).numpy(), tc.numpy())


class TestWireAccounting:
    """The port's twins of ``tests/test_dist.py::TestWireAccounting``."""

    def test_nibble_pack_roundtrip(self):
        rng = np.random.default_rng(3)
        codes = rng.integers(-7, 8, size=4096).astype(np.int8)
        packed = tcol._pack_nibbles(torch.from_numpy(codes))
        assert packed.numel() == codes.size // 2
        np.testing.assert_array_equal(tcol._unpack_nibbles(packed).numpy(), codes)
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jcol._pack_nibbles(jnp.asarray(codes))))

    def test_bits4_halves_the_wire(self):
        b8 = tcol.GradCompressionConfig(enabled=True, bits=8)
        b4 = tcol.GradCompressionConfig(enabled=True, bits=4)
        w8, w4 = map(tcol.wire_bytes_per_param, (b8, b4))
        assert abs((w4 - tcol._SCALE_BYTES / b4.block) * 2
                   - (w8 - tcol._SCALE_BYTES / b8.block)) < 1e-9

    @pytest.mark.parametrize("enabled,bits,block", [(False, 8, 1024), (True, 8, 1024),
                                                    (True, 4, 1024), (True, 4, 64)])
    def test_byte_counts_equal_reference(self, enabled, bits, block):
        t = tcol.GradCompressionConfig(enabled=enabled, bits=bits, block=block)
        j = jcol.GradCompressionConfig(enabled=enabled, bits=bits, block=block)
        assert tcol.wire_bytes_per_param(t) == jcol.wire_bytes_per_param(j)
        for n_params, n_pods in ((96_000_000, 2), (5000, 1), (4097, 8)):
            assert (tcol.pod_hop_device_bytes(t, n_params, n_pods)
                    == jcol.pod_hop_device_bytes(j, n_params, n_pods))

    def test_config_validation(self):
        with pytest.raises(ValueError):
            tcol.GradCompressionConfig(bits=3)
        with pytest.raises(ValueError):
            tcol.GradCompressionConfig(block=7)


# ------------------------------------------------ the hop on two ranks ----

N_PODS = 2
LEAVES = {"w": (5000,), "m": (48, 40)}  # odd lengths: the last block is short
STEPS = 3
CONFIGS = {"b8": dict(bits=8, block=1024), "b4": dict(bits=4, block=64)}

CASES = """
import numpy as np
N_PODS, STEPS = 2, 3
LEAVES = {"w": (5000,), "m": (48, 40)}
CONFIGS = {"b8": dict(bits=8, block=1024), "b4": dict(bits=4, block=64)}

def pod_grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(size=(N_PODS,) + s) * (3 if k == "w" else 0.01)).astype(np.float32)
            for k, s in LEAVES.items()}
"""

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.dist import collectives
from cases import N_PODS, STEPS, LEAVES, CONFIGS, pod_grads

# The reference's functions run op by op, as the jnp program reads: under
# jit XLA's CPU backend turns ``max / qmax`` into ``max * (1 / qmax)`` and
# contracts the second pod's dequantize into the sum (an FMA), choices the
# program leaves to the compiler.  The primitive's all_gather over "pod"
# runs under vmap's named axis (an eager shard_map costs seconds a call).
mesh = jax.make_mesh((N_PODS,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))

def hop(cfg):
    return jax.vmap(lambda g, e: collectives.compressed_pod_mean(g, cfg, e, N_PODS),
                    axis_name="pod", out_axes=(None, 0))

out = {}
shard = NamedSharding(mesh, PS("pod"))
for label, kw in CONFIGS.items():
    cfg = collectives.GradCompressionConfig(enabled=True, **kw)
    ef = {k: jnp.zeros((N_PODS,) + s, jnp.bfloat16) for k, s in LEAVES.items()}
    efs = dict(ef)
    step = hop(cfg)
    for t in range(STEPS):
        g = {k: jax.device_put(jnp.asarray(v), shard) for k, v in pod_grads(t).items()}
        m, ef = step({k: jnp.asarray(v) for k, v in pod_grads(t).items()}, ef)
        ms, efs = collectives.compressed_pod_mean_stacked(g, cfg, efs, mesh)
        out[("pod_mean", label, t)] = ({k: np.asarray(v) for k, v in m.items()},
                                       {k: np.asarray(v.astype(jnp.float32)) for k, v in ef.items()})
        out[("stacked", label, t)] = ({k: np.asarray(v) for k, v in ms.items()},
                                      {k: np.asarray(v.astype(jnp.float32)) for k, v in efs.items()})
g = {k: jax.device_put(jnp.asarray(v), shard) for k, v in pod_grads(0).items()}
off = collectives.GradCompressionConfig(enabled=False)
ef0 = {k: jnp.zeros((N_PODS,) + s, jnp.bfloat16) for k, s in LEAVES.items()}
m, _ = hop(off)({k: jnp.asarray(v) for k, v in pod_grads(0).items()}, ef0)
out[("pod_mean", "off", 0)] = ({k: np.asarray(v) for k, v in m.items()}, None)
ms, _ = collectives.compressed_pod_mean_stacked(g, off, None, mesh)
out[("stacked", "off", 0)] = ({k: np.asarray(v) for k, v in ms.items()}, None)
pickle.dump(out, open(sys.argv[1], "wb"))
"""

RANK = """
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.dist import collectives, insitu
from cases import N_PODS, STEPS, LEAVES, CONFIGS, pod_grads

mesh = init_device_mesh("cpu", (N_PODS,), mesh_dim_names=("pod",))
wires = []
gather = collectives._all_gather
def spy(t, group):
    wires.append((str(t.dtype), t.numel() * t.element_size()))
    return gather(t, group)
collectives._all_gather = spy

def stacked(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return DTensor.from_local(t[rank:rank + 1].contiguous(), mesh, [Shard(0)], run_check=False,
                              shape=t.shape, stride=t.stride())

res = {}
for label, kw in CONFIGS.items():
    cfg = collectives.GradCompressionConfig(enabled=True, **kw)
    ef = {k: torch.zeros(s, dtype=torch.bfloat16) for k, s in LEAVES.items()}
    efs = {k: stacked(np.zeros((N_PODS,) + s, np.float32)).to(torch.bfloat16) for k, s in LEAVES.items()}
    for t in range(STEPS):
        g = pod_grads(t)
        insitu.reset_sent_bytes(); wires.clear()
        m, ef = collectives.compressed_pod_mean({k: torch.from_numpy(v[rank]) for k, v in g.items()},
                                                cfg, ef, mesh=mesh)
        res[("pod_mean", label, t)] = ({k: v.numpy() for k, v in m.items()},
                                       {k: v.float().numpy() for k, v in ef.items()},
                                       dict(insitu.sent_bytes), list(wires))
        insitu.reset_sent_bytes(); wires.clear()
        ms, efs = collectives.compressed_pod_mean_stacked({k: stacked(v) for k, v in g.items()},
                                                          cfg, efs, mesh)
        res[("stacked", label, t)] = ({k: v.numpy() for k, v in ms.items()},
                                      {k: v.to_local().float().numpy() for k, v in efs.items()},
                                      dict(insitu.sent_bytes), list(wires))
g = pod_grads(0)
off = collectives.GradCompressionConfig(enabled=False)
m, none = collectives.compressed_pod_mean({k: torch.from_numpy(v[rank]) for k, v in g.items()}, off,
                                          None, mesh=mesh)
assert none is None
res[("pod_mean", "off", 0)] = ({k: v.numpy() for k, v in m.items()}, None, None, None)
ms, _ = collectives.compressed_pod_mean_stacked({k: stacked(v) for k, v in g.items()}, off, None, mesh)
res[("stacked", "off", 0)] = ({k: v.numpy() for k, v in ms.items()}, None, None, None)
pickle.dump(res, open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on two forced host devices and the port's two-rank
    gloo group, started together."""
    d = tmp_path_factory.mktemp("collectives")
    (d / "cases.py").write_text(CASES)
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{d}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), str(d / "ref.pkl")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), str(r), str(N_PODS), str(port),
                                str(d)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT) for r in range(N_PODS)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, out.decode(errors="replace")))
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    ref = pickle.load(open(d / "ref.pkl", "rb"))
    return ref, [pickle.load(open(d / f"rank{r}.pkl", "rb")) for r in range(N_PODS)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


KEYS = [(form, label, t) for form in ("pod_mean", "stacked") for label in CONFIGS
        for t in range(STEPS)]


@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}-{k[1]}-step{k[2]}")
def test_means_and_error_feedback_equal_reference(runs, key):
    """Every rank's mean and its pod's error feedback, bitwise the
    reference's, at every step of three."""
    ref, ranks = runs
    jm, jef = ref[key]
    for rank, res in enumerate(ranks):
        tm, tef, _sent, _wires = res[key]
        for k in LEAVES:
            np.testing.assert_array_equal(_bits(tm[k]), _bits(jm[k]), err_msg=k)
            np.testing.assert_array_equal(_bits(tef[k].reshape(jef[k].shape[1:])),
                                          _bits(jef[k][rank]), err_msg=k)


def _pod_grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(size=(N_PODS,) + s) * (3 if k == "w" else 0.01)).astype(np.float32)
            for k, s in LEAVES.items()}


@pytest.mark.parametrize("form", ["pod_mean", "stacked"])
def test_uncompressed_hop_is_the_plain_mean(runs, form):
    """``enabled=False`` is the plain mean, bitwise the reference's and
    ``(g0 + g1) / 2`` in float32."""
    ref, ranks = runs
    jm, _ = ref[(form, "off", 0)]
    g = _pod_grads(0)
    for res in ranks:
        tm = res[(form, "off", 0)][0]
        for k in LEAVES:
            np.testing.assert_array_equal(_bits(tm[k]), _bits(jm[k]))
            np.testing.assert_array_equal(_bits(tm[k]), _bits((g[k][0] + g[k][1]) / np.float32(2)))


@pytest.mark.parametrize("key", [k for k in KEYS if k[2] == 0], ids=lambda k: f"{k[0]}-{k[1]}")
def test_the_wire_is_codes_and_scales(runs, key):
    """Each rank gathers int8 codes (bits 8) or packed uint8 codes (bits 4)
    and float32 scales, nothing else, and sends exactly ``n·bits/8 +
    4·ceil(n/block)`` bytes per leaf, n padded to a block multiple."""
    _, ranks = runs
    kw = CONFIGS[key[1]]
    want_wires = []
    for name in sorted(LEAVES):  # the tree's leaf order
        n = int(np.prod(LEAVES[name]))
        nb = -(-n // kw["block"])
        want_wires += [("torch.int8" if kw["bits"] == 8 else "torch.uint8",
                        nb * kw["block"] * kw["bits"] // 8), ("torch.float32", 4 * nb)]
    for res in ranks:
        _m, _e, sent, wires = res[key]
        assert wires == want_wires
        assert sent == {"ppermute": 0, "all_reduce": 0, "gather": 0,
                        "all_gather": sum(b for _, b in want_wires)}
        raw = sum(4 * int(np.prod(s)) for s in LEAVES.values())
        assert sent["all_gather"] < raw / 3  # never the f32 gradients


def test_quantization_bound_and_error_feedback_hold(runs):
    """The reference tests' properties on the port's two-rank run: the mean
    is within the block-wise quantization bound, and each pod's residual
    plus its dequantized codes is its carry (up to bf16 rounding)."""
    _, ranks = runs
    g = _pod_grads(0)
    tm, tef, _, _ = ranks[0][("pod_mean", "b8", 0)]
    block = CONFIGS["b8"]["block"]
    for k, s in LEAVES.items():
        flat = g[k].reshape(N_PODS, -1)
        n = flat.shape[1]
        gp = np.pad(flat, ((0, 0), (0, (-n) % block))).reshape(N_PODS, -1, block)
        bound = (np.abs(gp).max(axis=2) / 127.0 * 0.5 + 1e-8).mean(axis=0)
        err = np.abs(tm[k].reshape(-1) - flat.mean(axis=0))
        assert (err <= np.repeat(bound, block)[:n] * (1 + 1e-4)).all(), k
        own = np.stack([flat[r] - ranks[r][("pod_mean", "b8", 0)][1][k].reshape(-1)
                        for r in range(N_PODS)])
        assert np.abs(own.mean(axis=0) - tm[k].reshape(-1)).max() < 5e-4 * max(1, np.abs(flat).max())
