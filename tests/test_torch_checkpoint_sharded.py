"""Twin tests of the port's per-shard checkpoint leaves
(``repro_torch.checkpoint.manager``: ``_ShardedLeaf``, ``restore(...,
shardings=...)``) against the JAX package's, at two ranks and one in place
of the reference tests' eight and four devices:

* ``test_checkpoint.py::test_per_shard_save_restore_8dev`` — ``DTensor``
  leaves split over a ``("data", "model")`` mesh of (2, 1) and (1, 2) (a
  leaf replicated over ``model`` is saved once), lossy ``sz_abs`` shards;
* ``test_compressed_restore_different_mesh_8dev`` — an in-situ stream and a
  lossy split leaf saved on a ``("pod", "data", "model")`` mesh;
* ``test_arena_snapshot_restore_different_mesh_8dev`` — a sharded arena
  bucket gathered by ``arena_to_host``.

Each case is saved by the reference on two forced host devices (and one),
by a two-rank and by a one-rank ``gloo`` group of the port (each rank a
subprocess), all at ``zstd_level=0``: the files and the manifest are byte
for byte the reference's.  Then every directory is restored by the other
side: the port's ranks restore with ``shardings`` onto their own mesh and
onto the other group's (2 ranks -> 1 and 1 -> 2), the reference restores
the port's; every leaf is bitwise the reference's restore, compressed ones
within their bound.
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
CASE_NAMES = ("per_shard_2x1", "per_shard_1x2", "reshard", "arena")

CASES = """
import numpy as np
EB_W, EB_FIELD, EB_ARENA = 1e-3, 1e-2, 1e-3
MESHES = {  # case: (axis names, mesh shape at two ranks)
    "per_shard_2x1": (("data", "model"), (2, 1)),
    "per_shard_1x2": (("data", "model"), (1, 2)),
    "reshard": (("pod", "data", "model"), (2, 1, 1)),
    "arena": (("data",), (2,)),
}

def values():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(512, 1024)).astype(np.float32),
            "b": np.ones((512,), np.float32),
            "field": (rng.normal(size=(16, 8, 8)) * 10).astype(np.float32),
            "arena": {f"w{i}": (rng.normal(size=(64, 32)) * (i + 1)).astype(np.float32)
                      for i in range(4)}}

def mesh_shape(case, world):
    return MESHES[case][1] if world == 2 else (1,) * len(MESHES[case][0])
"""

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from pathlib import Path
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.checkpoint.manager import CheckpointManager, CodecPolicy
from repro.dist import insitu
from cases import CASE_NAMES, EB_W, EB_FIELD, EB_ARENA, MESHES, values, mesh_shape

mode, root = sys.argv[1], Path(sys.argv[2])
v = values()
POL = CodecPolicy(mode="sz_abs", eb=1e-3, min_bytes=1 << 16, zstd_level=0)

def mesh_of(case, world):
    shape = mesh_shape(case, world)
    return jax.sharding.Mesh(np.array(jax.devices()[:world]).reshape(shape), MESHES[case][0])

def state_of(case, world):
    m = mesh_of(case, world)
    put = lambda x, spec: jax.device_put(jnp.asarray(x), NamedSharding(m, PS(*spec)))
    if case.startswith("per_shard"):
        return {"w": put(v["w"], ("data", "model")), "b": put(v["b"], ("data",)),
                "step": jnp.int32(3)}, POL
    if case == "reshard":
        spec = PS("pod", "data", "model")
        hss = insitu.to_host(insitu.sharded_compress(put(v["field"], spec), "sz", m, spec,
                                                     eb=EB_FIELD))
        return {"rho": hss, "w": put(v["w"], ("pod",)), "step": jnp.int32(3)}, POL
    leaves = {k: put(x, ("data",)) for k, x in v["arena"].items()}
    buckets, skipped = insitu.plan_arena([(k, x.shape, x.dtype, PS("data"))
                                          for k, x in leaves.items()], m)
    assert len(buckets) == 1 and not skipped
    b = buckets[0]
    comp = jax.jit(lambda ls, e: insitu.sharded_compress_arena(list(ls), b, m, e))
    h = insitu.arena_to_host(comp([leaves[nm] for nm in b.names], jnp.float32(EB_ARENA)))
    return {"arena000": h, "step": jnp.int32(7)}, CodecPolicy(zstd_level=0)

def host(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)

out = {}
for case in CASE_NAMES:
    for world in (2, 1):
        state, pol = state_of(case, world)
        d = root / f"ref{world}" / case
        mgr = CheckpointManager(d, async_save=False, policy=pol)
        if mode == "save":
            mgr.save(1, state)
            out[(case, world)] = host(mgr.restore(state_like=state)[0])
        else:  # restore the port's directories onto this world's mesh
            m = mesh_of(case, world)
            sh = jax.tree.map(lambda _: NamedSharding(m, PS()), state)
            for src in (1, 2):
                got = CheckpointManager(root / f"port{src}" / case, async_save=False,
                                        policy=pol).restore(state_like=state, shardings=sh)[0]
                out[(case, src, world)] = host(got)
pickle.dump(out, open(root / f"ref_{mode}.pkl", "wb"))
"""

RANK = """
import os, pickle, sys
from pathlib import Path
import numpy as np, torch, torch.distributed as dist
mode, rank, world, port, root = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                                 Path(sys.argv[5]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import manager as ckpt
from repro_torch.dist import insitu
from repro_torch.dist.sharding import NamedSharding, place
from cases import CASE_NAMES, EB_W, EB_FIELD, EB_ARENA, MESHES, values, mesh_shape

v = values()
POL = ckpt.CodecPolicy(mode="sz_abs", eb=1e-3, min_bytes=1 << 16, zstd_level=0)
flat = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))  # the restore mesh
meshes = {c: init_device_mesh("cpu", mesh_shape(c, world), mesh_dim_names=MESHES[c][0])
          for c in CASE_NAMES}

def put(x, spec, m):
    return place(torch.from_numpy(np.ascontiguousarray(x)), NamedSharding(m, spec))

def state_of(case):
    m = meshes[case]
    step = torch.tensor(3 if case != "arena" else 7, dtype=torch.int32)
    if case.startswith("per_shard"):
        return {"w": put(v["w"], ("data", "model"), m), "b": put(v["b"], ("data",), m),
                "step": step}, POL
    if case == "reshard":
        st = insitu.sharded_compress(put(v["field"], ("pod", "data", "model"), m), "sz", m,
                                     eb=EB_FIELD)
        hss = insitu.to_host(st)
        return {"rho": hss, "w": put(v["w"], ("pod",), m), "step": step}, POL
    leaves = {k: put(x, ("data",), m) for k, x in v["arena"].items()}
    buckets, skipped = insitu.plan_arena([(k, tuple(x.shape), x.dtype, ("data",))
                                          for k, x in leaves.items()], m)
    assert len(buckets) == 1 and not skipped
    b = buckets[0]
    h = insitu.arena_to_host(insitu.sharded_compress_arena([leaves[nm] for nm in b.names], b, m,
                                                           EB_ARENA))
    return {"arena000": h, "step": step}, ckpt.CodecPolicy(zstd_level=0)

def shardings(case):
    ns = NamedSharding(flat, ("data",))
    if case.startswith("per_shard"):
        return {"w": ns, "b": ns, "step": None}
    if case == "reshard":
        return {"rho": ns, "w": ns, "step": None}
    return {"arena000": ns, "step": None}

def record(tree):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = record(x)
        elif isinstance(x, DTensor):
            out[k] = ("dtensor", str(x.placements), x.to_local().numpy().copy(), tuple(x.shape))
        else:
            out[k] = ("host", None, x.numpy().copy(), tuple(x.shape))
    return out

res = {}
for case in CASE_NAMES:
    like = {"per_shard_2x1": ["b", "step", "w"], "per_shard_1x2": ["b", "step", "w"],
            "reshard": ["rho", "step", "w"], "arena": ["arena000", "step"]}[case]
    like = {k: 0 for k in like}
    if mode == "save":
        state, pol = state_of(case)
        if rank == 0 or any(isinstance(x, DTensor) for x in state.values()):
            # the DTensor save is a collective; a gathered leaf is the first rank's alone
            mgr = ckpt.CheckpointManager(root / f"port{world}" / case, device="cpu", policy=pol,
                                         async_save=case.startswith("per_shard"))
            insitu.reset_sent_bytes()
            mgr.save(1, state)
            mgr.wait()
            res[("sent", case)] = dict(insitu.sent_bytes)
        dist.barrier()
        sources = [world]
    else:
        sources = [1, 2, "ref2"]
    for src in sources:
        d = root / (f"port{src}" if isinstance(src, int) else src) / case
        mgr = ckpt.CheckpointManager(d, device="cpu", policy=ckpt.CodecPolicy(zstd_level=0),
                                     async_save=False)
        res[(case, src)] = record(mgr.restore(state_like=like, shardings=shardings(case))[0])
pickle.dump(res, open(root / f"{mode}_w{world}_r{rank}.pkl", "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wave(d, env, mode):
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), mode, str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in (2, 1):
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), mode, str(r), str(world),
                                    str(port), str(d)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, out.decode(errors="replace")))
    for rc, log in logs:
        assert rc == 0, log[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Wave 1: the reference (two forced host devices, and one) and the
    port's two-rank and one-rank groups each save every case and restore
    their own.  Wave 2: every side restores the others' directories."""
    d = tmp_path_factory.mktemp("ckpt_sharded")
    (d / "cases.py").write_text(CASES + f"\nCASE_NAMES = {CASE_NAMES!r}\n")
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{d}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    _wave(d, env, "save")
    _wave(d, env, "restore")
    load = lambda name: pickle.load(open(d / name, "rb"))  # noqa: E731
    ranks = {(mode, w, r): load(f"{mode}_w{w}_r{r}.pkl")
             for mode in ("save", "restore") for w in (2, 1) for r in range(w)}
    return d, load("ref_save.pkl"), load("ref_restore.pkl"), ranks


def _files(step_dir: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())
            if not p.name.startswith("obs_")}  # the observatory holds timings


@pytest.mark.parametrize("world", [2, 1])
@pytest.mark.parametrize("case", CASE_NAMES)
def test_files_and_manifest_equal_reference(runs, case, world):
    """The port's group writes the reference's files and manifest, byte
    for byte; split leaves as one ``leaf_i_sNNN.bin`` per unique shard."""
    d = runs[0]
    ref, got = _files(d / f"ref{world}" / case / "step_000000001"), \
        _files(d / f"port{world}" / case / "step_000000001")
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name
    shards = [n for n in ref if "_s" in n]
    want = {("per_shard_2x1", 2): 4, ("per_shard_1x2", 2): 2, ("reshard", 2): 4,
            ("arena", 2): 2, ("arena", 1): 1, ("reshard", 1): 1}
    assert len(shards) == want.get((case, world), 0), shards


def _bytes(a) -> np.ndarray:
    return np.frombuffer(np.asarray(a).tobytes(), np.uint8)


def _expect(ref_save, case, world):
    return ref_save[(case, world)]


def _check(rec, want, world, rank, case, bound=None):
    """One restored tree (the port's record) against the reference's
    restore: each split leaf's local block bitwise the matching slice."""
    for k, w in want.items():
        if isinstance(w, dict) and not isinstance(rec[k], tuple):
            _check(rec[k], w, world, rank, case)
            continue
        kind, places, local, shape = rec[k]
        w = np.asarray(w)
        assert shape == w.shape, k
        if kind == "dtensor":
            assert places == "(Shard(dim=0),)", places
            n = w.shape[0] // world
            w = w[rank * n:(rank + 1) * n]
        np.testing.assert_array_equal(_bytes(local), _bytes(w), err_msg=f"{case} {k}")


@pytest.mark.parametrize("src,world", [(2, 2), (1, 1), (2, 1), (1, 2), ("ref2", 2), ("ref2", 1)],
                         ids=["2to2", "1to1", "2to1", "1to2", "ref2to2", "ref2to1"])
@pytest.mark.parametrize("case", CASE_NAMES)
def test_restore_onto_a_mesh_equals_reference(runs, case, src, world):
    """Every rank restores with ``shardings`` onto its ``("data",)`` mesh
    (the saving mesh's size or the other): each leaf is a ``DTensor`` split
    on dim 0 whose local block is bitwise the reference's restore."""
    _, ref_save, _, ranks = runs
    mode = "save" if src == world else "restore"
    key = (case, src)
    want = _expect(ref_save, case, 2 if src == "ref2" else src)
    for r in range(world):
        _check(ranks[(mode, world, r)][key], want, world, r, case)


@pytest.mark.parametrize("src,world", [(2, 2), (2, 1), (1, 2), (1, 1)],
                         ids=["port2to2", "port2to1", "port1to2", "port1to1"])
@pytest.mark.parametrize("case", CASE_NAMES)
def test_reference_restores_the_port(runs, case, src, world):
    """The reference restores the port's directories (onto its two-device
    or one-device mesh) to the values of its own."""
    _, ref_save, ref_restore, _ = runs
    got, want = ref_restore[(case, src, world)], ref_save[(case, src)]

    def walk(g, w):
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k])
            else:
                np.testing.assert_array_equal(_bytes(g[k]), _bytes(w[k]), err_msg=k)
    walk(got, want)


def test_lossy_leaves_within_their_bound(runs):
    """The restored leaves hold the reference tests' bounds: ``w`` within
    1e-3 (``sz_abs`` shards), ``rho`` within 1e-2 and bitwise the
    single-device round trip, the arena leaves within 1e-3, ``b`` exact."""
    import torch

    from repro_torch.core import sz

    _, ref_save, _, ranks = runs
    ns = {}
    exec(CASES, ns)
    v = ns["values"]()
    for world in (2, 1):
        got = ranks[("save", world, 0)]
        for case in ("per_shard_2x1", "reshard"):
            w = got[(case, world)]["w"][2]
            n = v["w"].shape[0] // world
            assert np.abs(w - v["w"][:n]).max() <= 1e-3 * (1 + 1e-5)
        b = got[("per_shard_2x1", world)]["b"][2]
        np.testing.assert_array_equal(b, v["b"][:b.shape[0]])
        rho = got[("reshard", world)]["rho"][2]
        single = sz.decompress(sz.compress(torch.from_numpy(v["field"]), 1e-2)).numpy()
        n = v["field"].shape[0] // world
        np.testing.assert_array_equal(rho.view(np.int32), single[:n].view(np.int32))
        assert np.abs(rho - v["field"][:n]).max() <= 1e-2 * (1 + 1e-5)
        for k, x in got[("arena", world)]["arena000"].items():
            n = v["arena"][k].shape[0] // world
            assert np.abs(x[2] - v["arena"][k][:n]).max() <= 1e-3 * (1 + 1e-5)


def test_split_saves_send_their_shard_payloads(runs):
    """A split leaf's save sends, off the first rank, exactly its shards'
    encoded payloads (a raw shard for a lossless leaf), and the first rank
    sends nothing."""
    d, _, _, ranks = runs
    import json

    for case in ("per_shard_2x1", "per_shard_1x2"):
        m = json.loads((d / "port2" / case / "step_000000001" / "MANIFEST.json").read_text())
        mine = sum(s["stored_bytes"] for leaf in m["leaves"] for s in leaf.get("shards", [])
                   if s["index"][0][0] > 0 or s["index"][-1][0] > 0)
        assert ranks[("save", 2, 1)][("sent", case)]["gather"] == mine
        assert ranks[("save", 2, 0)][("sent", case)]["gather"] == 0
