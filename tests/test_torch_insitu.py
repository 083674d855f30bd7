"""Twin tests of the port's in-situ sharded compression
(``repro_torch.dist.insitu``, ``repro_torch.dist.sharding``) against the JAX
package's (``repro.dist.insitu``).

* The halo machinery on a *mocked* mesh: a port twin of the reference
  tests' ``StackedOps`` (the two collectives over explicit leading shard
  dims) runs ``halo_exchange`` / ``carry_exchange`` in one process, held
  bitwise to the reference's, permute logs included.
* Partition layouts, field specs and their rejections, on mesh stand-ins
  (axis names and sizes are all the spec math reads).
* Host payloads: round trip and the sparse-manifest rejection.
* Real ``torch.distributed`` runs on the CPU (``gloo``): a 4-rank mesh
  1x2x2 over Nyx 3-D fields and a 2-rank HACC 1-D run, each rank a
  subprocess, beside a JAX subprocess with 4 forced host devices running
  the reference on the same inputs.  Every shard's payload is bitwise the
  reference's, each rank's decoded shard and the mesh-free ``host_decode``
  are bitwise the single-device decode, the zero-border stream breaks the
  bound at the seams, the bytes each rank sends are faces, scalars and
  compressed payloads only, and an ``insitu-*`` leaf crosses between the
  two checkpoint managers both ways.
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
from jax.sharding import PartitionSpec as PS

from repro.checkpoint import manager as jman
from repro.core import sz as jsz
from repro.dist import insitu as jins
from repro.dist import sharding as jshard
from repro_torch.checkpoint import manager as tman
from repro_torch.core import sz as tsz
from repro_torch.dist import insitu, sharding

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


# ------------------------------------------------------- mocked-mesh halo --


class StackedOps:
    """The port twin of the reference tests' mocked mesh: the collectives
    over explicit leading shard dims of a stacked ``(g0, g1, ..., *local)``
    tensor (``axis_pos`` maps mesh axis name -> leading dim)."""

    def __init__(self, axis_pos):
        self.axis_pos = dict(axis_pos)
        self.permuted = []  # (axis_name, perm) log

    def ppermute(self, x, name, perm):
        self.permuted.append((name, tuple(perm)))
        pos = self.axis_pos[name]
        sl = (slice(None),) * pos
        out = torch.zeros_like(x)  # unpaired destinations stay zero
        for s, d in perm:
            out[sl + (d,)] = x[sl + (s,)]
        return out

    def pmax(self, x, names):
        for n in names:
            x = x.amax(dim=self.axis_pos[n], keepdim=True)
        return x


class JaxStackedOps(StackedOps):
    """The reference tests' ``StackedOps`` (``tests/test_insitu.py``), its
    copies made in numpy (the same values as its ``.at[].set``)."""

    def ppermute(self, x, name, perm):
        self.permuted.append((name, tuple(perm)))
        pos = self.axis_pos[name]
        sl = (slice(None),) * pos
        a = np.asarray(x)
        out = np.zeros_like(a)  # unpaired destinations stay zero, like lax
        for s, d in perm:
            out[sl + (d,)] = a[sl + (s,)]
        return jnp.asarray(out)


def _stack_shards(x: np.ndarray, grid) -> np.ndarray:
    nd = x.ndim
    shp = []
    for s, g in zip(x.shape, grid):
        shp += [g, s // g]
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    return np.ascontiguousarray(x.reshape(shp).transpose(perm))


def _unstack_shards(xs, shape) -> np.ndarray:
    nd = len(shape)
    perm = []
    for i in range(nd):
        perm += [i, nd + i]
    return np.asarray(xs).transpose(perm).reshape(shape)


def _ints(shape, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


HALO_CASES = {
    # name: (q, grid, layout, sizes, {axis: leading dim})
    "1axis": (_ints((8, 6), -50, 50, 0), (4, 1), ("a", None), {"a": 4}, {"a": 0}),
    "2axes": (_ints((8, 5, 6), -9, 9, 1), (2, 1, 3), ("a", None, "b"), {"a": 2, "b": 3},
              {"a": 0, "b": 2}),
    "3axes": (_ints((8, 6, 4), -40, 40, 3), (4, 2, 1), ("a", "b", None), {"a": 4, "b": 2},
              {"a": 0, "b": 1}),
    # values across the int32 range: every difference and carry wraps
    "wrap": (_ints((16, 4, 6), -2**31, 2**31 - 1, 4), (8, 2, 3), ("a", "b", "c"),
             {"a": 8, "b": 2, "c": 3}, {"a": 0, "b": 1, "c": 2}),
}


def test_ring_and_scan_schedules_equal_reference():
    for n in (1, 2, 3, 4, 8, 13):
        assert insitu._ring_perm(n) == jins._ring_perm(n)
        assert insitu._scan_perms(n) == jins._scan_perms(n)
    vals = np.arange(8.0)
    inc = vals.copy()
    for _off, perm in insitu._scan_perms(8):
        shifted = np.zeros_like(inc)
        for s, d in perm:
            shifted[d] = inc[s]
        inc = inc + shifted
    np.testing.assert_array_equal(inc, np.cumsum(vals))


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_and_carry_exchange_equal_reference(case):
    """Residual with halo faces and reconstruction with carries, on stacked
    shards: bitwise the reference's, with the same permute log, and the
    round trip exact."""
    q, grid, layout, sizes, pos = HALO_CASES[case]
    nd = q.ndim
    stacked = _stack_shards(q, grid)
    tops, jops = StackedOps(pos), JaxStackedOps(pos)
    td = tsz.lorenzo_residual(torch.from_numpy(stacked),
                              exchange=insitu.halo_exchange(layout, sizes, tops), ndim=nd)
    jd = jsz.lorenzo_residual(jnp.asarray(stacked),
                              exchange=jins.halo_exchange(layout, sizes, ops=jops), ndim=nd)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(_unstack_shards(td, q.shape),
                                  np.asarray(jsz.lorenzo_residual(jnp.asarray(q))))
    assert tops.permuted == jops.permuted
    assert [n for n, _ in tops.permuted] == [a for a in layout if a is not None]
    tops.permuted.clear(), jops.permuted.clear()
    tb = tsz.lorenzo_reconstruct(td, exchange=insitu.carry_exchange(layout, sizes, tops), ndim=nd)
    jb = jsz.lorenzo_reconstruct(jd, exchange=jins.carry_exchange(layout, sizes, ops=jops), ndim=nd)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(_unstack_shards(tb, q.shape), q)
    assert tops.permuted == jops.permuted


def test_edge_shard_keeps_zero_plane():
    q = _ints((8,), -50, 50, 2)
    ops = StackedOps({"a": 0})
    d = tsz.lorenzo_residual(torch.from_numpy(_stack_shards(q, (2,))),
                             exchange=insitu.halo_exchange(("a",), {"a": 2}, ops), ndim=1)
    ref = np.asarray(jsz.lorenzo_residual(jnp.asarray(q)))
    np.testing.assert_array_equal(d[0].numpy(), ref[:4])
    local = tsz.lorenzo_residual(torch.from_numpy(q[4:].copy()))
    assert (d[1] != local).any()  # the interior shard saw its neighbour


def test_nonpartitioned_axes_skip_exchange():
    ops = StackedOps({"a": 0})
    ex = insitu.halo_exchange((None, "a", None), {"a": 1}, ops)
    cx = insitu.carry_exchange((None, "a", None), {"a": 1}, ops)
    for axis in range(3):
        assert ex(axis, torch.zeros((1, 1, 1), dtype=torch.int32)) is None
        assert cx(axis, torch.zeros((1, 1, 1), dtype=torch.int32)) is None
    assert ops.permuted == []


# --------------------------------------------------------- layout / specs --


def _mesh(shape, axes, device_type="cpu"):
    """A mesh stand-in: what the spec math reads (the reference's tests use
    ``jax.sharding.AbstractMesh`` the same way)."""
    return types.SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(axes),
                                 device_type=device_type)


def _ps(spec):
    return tuple(spec)


LAYOUT_CASES = [
    ((2, 4), ("pod", "data"), (8, 16, 3), ("pod", "data")),
    ((1, 4), ("pod", "data"), (8, 16), ("pod", "data")),
    ((1, 4), ("pod", "data"), (8, 16), ("nope", None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 8, 8), (("model",), None, "pod")),
]


@pytest.mark.parametrize("mesh_shape,axes,shape,spec", LAYOUT_CASES)
def test_partition_layout_equals_reference(mesh_shape, axes, shape, spec):
    got = insitu.partition_layout(shape, spec, _mesh(mesh_shape, axes))
    assert got == jins.partition_layout(shape, PS(*spec), jax.sharding.AbstractMesh(mesh_shape,
                                                                                    axes))


@pytest.mark.parametrize("mesh_shape,axes,shape,spec,err", [
    ((2, 4), ("pod", "data"), (8, 16), (("pod", "data"),), NotImplementedError),
    ((3,), ("data",), (8,), ("data",), ValueError),
    ((2,), ("data",), (8,), ("data", None, None), ValueError),
])
def test_partition_layout_rejections(mesh_shape, axes, shape, spec, err):
    with pytest.raises(err):
        insitu.partition_layout(shape, spec, _mesh(mesh_shape, axes))
    with pytest.raises(err):
        jins.partition_layout(shape, PS(*spec), jax.sharding.AbstractMesh(mesh_shape, axes))


@pytest.mark.parametrize("mesh_shape,axes,shape", [
    ((2, 2, 2), ("pod", "data", "model"), (16, 8, 8)),
    ((8,), ("data",), (4096,)),
    ((2, 2, 2), ("pod", "data", "model"), (7, 8, 8)),
    ((1, 2, 2), ("pod", "data", "model"), (32, 32, 32)),
    ((2, 4), ("data", "model"), (6, 12)),
    ((4,), ("model",), (64, 8, 8)),
])
def test_field_spec_equals_reference(mesh_shape, axes, shape):
    got = sharding.field_spec(shape, _mesh(mesh_shape, axes))
    want = jshard.field_spec(shape, jax.sharding.AbstractMesh(mesh_shape, axes))
    assert got == tuple(want)


def test_spec_for_and_field_spec_rejection_equal_reference():
    m = _mesh((2, 4), ("data", "model"))
    jm = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    for shape, axes in (((8, 24), ("embed", "heads")), ((6, 16), ("batch", "mlp")),
                        ((8, 8), ("experts", "mlp")), ((4, 3), ("vocab", None))):
        assert sharding.spec_for(shape, axes, m) == tuple(jshard.spec_for(shape, axes, jm))
    with pytest.raises(ValueError):
        sharding.field_spec((2, 2, 2, 2), m)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    m = _mesh((1, 2, 2), ("pod", "data", "model"))
    assert sharding.placements((None, "data", "model"), m) == (Replicate(), Shard(1), Shard(2))
    assert sharding.placements(("model",), m) == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError):
        sharding.placements(("rows",), m)


class TestRejections:
    def test_misaligned_zfp_seam(self):
        m = _mesh((2,), ("data",))
        with pytest.raises(ValueError, match="4"):  # 12 / 2 = 6, not 4-aligned
            insitu.sharded_compress(torch.zeros(6, 8, 8), "zfp", m, ("data",), rate=8)

    def test_sz_kernel_tile_misalignment(self):
        m = _mesh((2,), ("data",))
        with pytest.raises(ValueError, match="tile"):  # 8 / 2 = 4, not a tile of 8
            insitu.sharded_compress(torch.zeros(4, 64, 128), "sz", m, ("data",), eb=1e-3,
                                    backend="kernel")
        with pytest.raises(ValueError, match="tile"):  # last axis 64 % 128
            insitu.sharded_compress(torch.zeros(8, 64, 64), "sz", m, (), eb=1e-3,
                                    backend="kernel")

    def test_mesh_device_differs_from_the_field(self):
        with pytest.raises(ValueError, match="mesh on 'cuda'"):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "sz", _mesh((2,), ("data",), "cuda"),
                                    ("data",), eb=1e-3)

    def test_local_shard_needs_a_spec_and_codec_args(self):
        m = _mesh((2,), ("data",))
        with pytest.raises(ValueError, match="spec"):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "sz", m, eb=1e-3)
        with pytest.raises(ValueError, match="eb"):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "sz", m, ("data",))
        with pytest.raises(ValueError, match="rate"):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "zfp", m, ("data",))
        with pytest.raises(ValueError, match="codec"):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "lz4", m, ("data",))
        with pytest.raises(NotImplementedError):
            insitu.sharded_compress(torch.zeros(8, 8, 8), "sz", m, (("data", "model"),), eb=1.0)


# ------------------------------------------------- host payloads / streams --


def test_shard_payload_roundtrip_equals_reference():
    rng = np.random.default_rng(0)
    blobs = {"words": rng.integers(0, 2**32, size=37, dtype=np.uint32),
             "widths": rng.integers(0, 32, size=5, dtype=np.uint8),
             "total_bits": np.int32(1234)}
    payload = insitu.shard_payload_encode(blobs)
    assert payload == jins.shard_payload_encode(blobs)
    back = insitu.shard_payload_decode(payload)
    assert sorted(back) == sorted(blobs)
    np.testing.assert_array_equal(back["words"], blobs["words"])
    np.testing.assert_array_equal(back["widths"], blobs["widths"])
    assert int(back["total_bits"]) == 1234


def _one_shard_hss(x: np.ndarray, eb: float) -> insitu.HostShardedStream:
    """A one-shard in-situ stream built from the single-device coder."""
    c = tsz.compress(torch.from_numpy(x), eb)
    bits = int(c.packed.total_bits)
    n_words = (bits - c.packed.widths.shape[0] * 8 + 31) // 32
    words = c.packed.words[:n_words].view(torch.int32).numpy().view(np.uint32)
    blobs = {"words": words.copy(), "widths": c.packed.widths.numpy().copy(),
             "total_bits": np.int32(bits)}
    idx = tuple((0, s) for s in x.shape)
    return insitu.HostShardedStream("insitu-sz", x.shape, x.shape, (1,) * x.ndim, True, "core",
                                    {"eb_i": float(c.eb)}, [(idx, blobs)])


def test_host_restore_rejects_sparse_manifest():
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    hss = _one_shard_hss(x, 1e-3)
    meta = insitu.host_stream_meta(hss)
    payloads = [insitu.shard_payload_encode(b) for _, b in hss.shards]
    got = insitu.host_restore(meta, payloads, device="cpu")
    assert torch.equal(got, insitu.host_decode(hss, device="cpu"))
    assert torch.equal(got, tsz.decompress(tsz.compress(torch.from_numpy(x), 1e-3)))
    meta["insitu"]["grid"] = [2, 1]  # the grid claims 2 shards, 1 payload present
    with pytest.raises(IOError, match="payload"):
        insitu.host_restore(meta, payloads, device="cpu")


def test_host_stream_meta_and_accounting_equal_reference():
    x = np.random.default_rng(1).normal(size=(8, 8, 8)).astype(np.float32)
    hss = _one_shard_hss(x, 1e-2)
    jhss = jins.HostShardedStream(*[getattr(hss, f) for f in (
        "codec", "shape", "local_shape", "grid", "halo", "backend", "params", "shards")])
    assert insitu.host_stream_meta(hss) == jins.host_stream_meta(jhss)
    assert hss.accounting() == jhss.accounting() and hss.nbytes_raw == jhss.nbytes_raw


# ------------------------------------------- torch.distributed on the CPU --

# The cases both packages run; fields are made from seeds in each process.
CASES = """
import numpy as np

def nyx_cases(cosmo):
    f = cosmo.nyx_fields(n=32)
    rng = np.random.default_rng(7)
    k = (rng.normal(size=(8, 128, 256)) * 10).astype(np.float32)  # one tile per shard
    x = f["baryon_density"]
    eb = 1e-3 * float(x.max() - x.min())
    return {"sz-baryon_density": (x, "sz", dict(eb=eb)),
            "zfp-vx": (f["vx"], "zfp", dict(rate=8)),
            "sz-nohalo": (x, "sz", dict(eb=eb, halo=False)),
            "sz-kernel": (k, "sz", dict(eb=1e-2, backend="kernel"))}

def hacc_cases(cosmo):
    x = cosmo.hacc_particles(grid=32).fields["x"]
    return {"sz-hacc": (x, "sz", dict(eb=1e-3)),
            "zfp-hacc": (x.reshape(-1, 8, 8), "zfp", dict(rate=6))}
"""

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import PartitionSpec as PS
from repro.data import cosmo
from repro.dist import insitu, sharding
from cases import nyx_cases, hacc_cases

devs = jax.devices()
mesh3 = jax.sharding.Mesh(np.array(devs[:4]).reshape(1, 2, 2), ("pod", "data", "model"))
mesh1 = jax.sharding.Mesh(np.array(devs[:2]), ("data",))
out = {}
for cases, mesh in ((nyx_cases(cosmo), mesh3), (hacc_cases(cosmo), mesh1)):
    for name, (x, codec, kw) in cases.items():
        spec = PS("data") if mesh is mesh1 else sharding.field_spec(x.shape, mesh)
        out[name] = insitu.to_host(insitu.sharded_compress(x, codec, mesh, spec, **kw))
pickle.dump(out, open(sys.argv[1], "wb"))
"""

RANK = """
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out_dir, which = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import kernels
from repro_torch.core import sz, zfp
from repro_torch.data import cosmo
from repro_torch.dist import insitu, sharding
from cases import nyx_cases, hacc_cases

if which == "nyx":
    mesh, cases = init_device_mesh("cpu", (1, 2, 2), mesh_dim_names=("pod", "data", "model")), nyx_cases(cosmo)
else:
    mesh, cases = init_device_mesh("cpu", (2,), mesh_dim_names=("data",)), hacc_cases(cosmo)
sizes = sharding.mesh_sizes(mesh)
res = {"hss": {}, "local_equal": {}, "sent": {}, "ratio": {}, "launches": {}, "position": {},
       "layout": {}}
for i, (name, (x, codec, kw)) in enumerate(cases.items()):
    spec = ("data",) if which == "hacc" else sharding.field_spec(x.shape, mesh)
    layout = insitu.partition_layout(x.shape, spec, mesh)
    sl = tuple(slice(mesh.get_local_rank(a) * (s // sizes[a]), (mesh.get_local_rank(a) + 1) * (s // sizes[a]))
               if a else slice(None) for s, a in zip(x.shape, layout))
    local = torch.from_numpy(np.ascontiguousarray(x[sl]))
    if i % 2:  # both input forms: a DTensor, or the local shard and its spec
        field, spec_arg = DTensor.from_local(local, mesh, sharding.placements(spec, mesh),
                                             run_check=False, shape=x.shape,
                                             stride=torch.from_numpy(x).stride()), None
    else:
        field, spec_arg = local, spec
    insitu.reset_sent_bytes()
    kernels.reset_launch_counts()
    st = insitu.sharded_compress(field, codec, mesh, spec_arg, **kw)
    y = insitu.sharded_decompress(st, mesh)
    res["ratio"][name] = insitu.compression_ratio(st)
    res["launches"][name] = sum(kernels.launch_counts().values())
    res["position"][name], res["layout"][name] = st.position, st.layout
    xt = torch.from_numpy(x)
    if codec == "zfp":
        ref = zfp.decompress(zfp.compress(xt, kw["rate"]))
    elif kw.get("backend") == "kernel":
        from repro_torch.kernels import ops
        p, ps, e = ops.sz_compress_kernel(xt, kw["eb"])
        ref = ops.sz_decompress_kernel(p, ps, x.shape, e)
    else:
        ref = sz.decompress(sz.compress(xt, kw["eb"]))
    res["local_equal"][name] = bool(torch.equal(y.to_local(), ref[sl])) and tuple(y.shape) == x.shape
    h = insitu.to_host(st)
    res["sent"][name] = dict(insitu.sent_bytes, raw_local=local.numel() * 4)
    if rank == 0:
        res["hss"][name] = h
        res["host_decode_equal"] = res.get("host_decode_equal", {})
        res["host_decode_equal"][name] = bool(torch.equal(insitu.host_decode(h, device="cpu"), ref))
    else:
        assert h is None
pickle.dump(res, open(os.path.join(out_dir, f"{which}_{rank}.pkl"), "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference in a 4-device JAX subprocess, and the port's 4-rank
    (Nyx) and 2-rank (HACC) gloo groups, all started together."""
    d = tmp_path_factory.mktemp("insitu")
    (d / "cases.py").write_text(CASES)
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{d}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), str(d / "ref.pkl")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for which, world in (("nyx", 4), ("hacc", 2)):
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), str(r), str(world),
                                    str(port), str(d), which], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                  for r in range(world)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, out.decode(errors="replace")))
    for rc, log in logs:
        assert rc == 0, log[-4000:]
    ranks = {(w, r): pickle.load(open(d / f"{w}_{r}.pkl", "rb"))
             for w, n in (("nyx", 4), ("hacc", 2)) for r in range(n)}
    return pickle.load(open(d / "ref.pkl", "rb")), ranks


NAMES = ["sz-baryon_density", "zfp-vx", "sz-nohalo", "sz-kernel", "sz-hacc", "zfp-hacc"]


def _rank0(runs, name):
    return runs[1][("hacc" if "hacc" in name else "nyx", 0)]


@pytest.mark.parametrize("name", NAMES)
def test_shard_payloads_equal_reference(runs, name):
    ref = runs[0][name]
    got = _rank0(runs, name)["hss"][name]
    assert (got.codec, tuple(got.shape), tuple(got.local_shape), tuple(got.grid), got.halo,
            got.backend) == (ref.codec, tuple(ref.shape), tuple(ref.local_shape),
                             tuple(ref.grid), ref.halo, ref.backend)
    assert got.params == ref.params
    assert len(got.shards) == len(ref.shards) == int(np.prod(ref.grid)) > 1
    for (gi, gb), (ri, rb) in zip(got.shards, ref.shards):
        assert gi == ri and sorted(gb) == sorted(rb)
        for k in rb:
            assert np.asarray(gb[k]).dtype == np.asarray(rb[k]).dtype, k
            np.testing.assert_array_equal(gb[k], rb[k], err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_decodes_equal_single_device(runs, name):
    """Each rank's shard of ``sharded_decompress`` and (halo and kernel
    streams) the mesh-free ``host_decode`` are bitwise the single-device
    decode; the ZFP ratio is exactly 32/rate."""
    which = "hacc" if "hacc" in name else "nyx"
    for (w, _r), res in runs[1].items():
        if w == which:
            assert res["local_equal"][name]
    if name != "sz-nohalo":
        assert _rank0(runs, name)["host_decode_equal"][name]
    if name.startswith("zfp"):
        rate = _rank0(runs, name)["hss"][name].params["rate"]
        assert all(res["ratio"][name] == 32 / rate for (w, _), res in runs[1].items() if w == which)


def test_zero_border_stream_breaks_the_bound_at_the_seams(runs):
    h0 = _rank0(runs, "sz-nohalo")["hss"]["sz-nohalo"]
    from repro_torch.data import cosmo

    x = torch.from_numpy(cosmo.nyx_fields(n=32)["baryon_density"])
    eb = 1e-3 * float(x.max() - x.min())
    assert float((insitu.host_decode(h0, device="cpu") - x).abs().max()) <= eb * (1 + 1e-5)
    as_global = insitu.HostShardedStream(h0.codec, h0.shape, h0.local_shape, h0.grid, True,
                                         h0.backend, h0.params, h0.shards)
    seam_err = float((insitu.host_decode(as_global, device="cpu") - x).abs().max())
    assert seam_err > 10 * eb


def _expected_sent(name, res, hss) -> dict:
    """What a rank sends: per partitioned axis of n shards, a shard at
    position p ships its int32 face in the halo ring (p < n - 1) and in
    each carry-scan step (p + offset < n); one float32 |x|max and one int64
    byte count per partitioned axis; and, off the first rank, its
    compressed payload."""
    layout, pos, local = res["layout"][name], res["position"][name], hss.local_shape
    sizes = dict(zip(layout, hss.grid))
    faces = scalars = 0
    if name.startswith("sz"):
        for d, a in enumerate(layout):
            if a is None:
                continue
            n, p = sizes[a], pos[d]
            scalars += 4 + 8
            if "kernel" in name or "nohalo" in name:
                continue
            sends = int(p < n - 1) + sum(p + off < n for off, _ in insitu._scan_perms(n))
            faces += sends * 4 * int(np.prod(local)) // local[d]
    shard = int(np.ravel_multi_index(pos, hss.grid))
    payload = sum(np.asarray(a).nbytes for a in hss.shards[shard][1].values())
    return {"ppermute": faces, "all_reduce": scalars, "gather": payload if shard else 0}


@pytest.mark.parametrize("name", NAMES)
def test_ranks_send_faces_scalars_and_payloads_only(runs, name):
    """No rank sends its raw shard: exactly the halo and carry faces, the
    scalar reductions and (to the first rank) its compressed payload."""
    which = "hacc" if "hacc" in name else "nyx"
    hss = _rank0(runs, name)["hss"][name]
    total_faces = 0
    for (w, _r), res in runs[1].items():
        if w != which:
            continue
        sent = res["sent"][name]
        assert res["launches"][name] == 0  # the CPU runs the plain versions
        assert {k: sent[k] for k in ("ppermute", "all_reduce", "gather")} == \
            _expected_sent(name, res, hss)
        assert sent["ppermute"] + sent["all_reduce"] + sent["gather"] < sent["raw_local"]
        total_faces += sent["ppermute"]
    halo = name.startswith("sz") and "kernel" not in name and "nohalo" not in name
    assert (total_faces > 0) == halo


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("name", ["sz-baryon_density", "sz-kernel", "zfp-vx"])
def test_insitu_leaf_crosses_between_managers(runs, tmp_path, direction, name):
    """An ``insitu-*`` leaf saved by one package's manager restores in the
    other's, bitwise equal to the reference's host decode, and both write
    the same shard files and manifest."""
    ref = runs[0][name]
    got = _rank0(runs, name)["hss"][name]
    want = jins.host_decode(ref)
    pol_t, pol_j = tman.CodecPolicy(zstd_level=0), jman.CodecPolicy(zstd_level=0)
    tstate = {"field": got, "step": torch.tensor(3, dtype=torch.int32)}
    jstate = {"field": ref, "step": jnp.int32(3)}
    tman.CheckpointManager(tmp_path / "t", policy=pol_t, async_save=False,
                           device="cpu").save(1, tstate)
    jman.CheckpointManager(tmp_path / "j", policy=pol_j, async_save=False).save(1, jstate)
    dt, dj = tmp_path / "t/step_000000001", tmp_path / "j/step_000000001"
    names = sorted(p.name for p in dj.iterdir() if not p.name.startswith("obs_"))
    assert names == sorted(p.name for p in dt.iterdir() if not p.name.startswith("obs_"))
    assert len([n for n in names if n.startswith("leaf_00000_s")]) == len(ref.shards)
    for n in names:
        assert (dj / n).read_bytes() == (dt / n).read_bytes(), n
    if direction == "port_to_jax":
        out, _ = jman.CheckpointManager(tmp_path / "t", policy=pol_j,
                                        async_save=False).restore(state_like=jstate)
        np.testing.assert_array_equal(np.asarray(out["field"]), want)
    else:
        out, _ = tman.CheckpointManager(tmp_path / "j", policy=pol_t, async_save=False,
                                        device="cpu").restore(state_like=tstate)
        assert out["field"].dtype == torch.float32
        np.testing.assert_array_equal(out["field"].numpy(), want)
    assert int(out["step"]) == 3
