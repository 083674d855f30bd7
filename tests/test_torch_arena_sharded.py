"""Twin tests of the port's sharded stream arena
(``repro_torch.dist.insitu``: ``plan_arena``, ``plan_kernel_buckets``,
``sharded_compress_arena``, ``sharded_decompress_arena``,
``arena_to_host``) and of the row codec's distribution hooks
(``repro_torch.core.arena.sz_encode_rows`` / ``sz_decode_rows``) against
the JAX package's.

* Planning on mesh stand-ins (axis names and sizes are all it reads): the
  reference tests' entries (``tests/test_arena.py::TestShardedArena::
  test_plan_rejects_non_leading_partitions``, ``TestKernelBuckets::
  test_plan_kernel_buckets_eligibility``) give the same buckets, skips and
  reasons.
* The hooks in one process: an ``exchange`` and a ``carry`` that return
  given faces, bitwise the reference's rows.
* Real ``torch.distributed`` runs on the CPU: a two-rank and a one-rank
  ``gloo`` group (each rank a subprocess) beside a JAX subprocess with two
  forced host devices running the reference on the same leaves (the
  reference test's three, a zero leaf and one whose codes leave the int32
  range).  The gathered ``HostArena`` and its payload bytes, every decoded
  leaf and the mesh-free restore are bitwise the reference's, each arena
  row is the per-leaf sharded stream, and every rank sends exactly one
  ``[B, 1]`` int32 face and one ``[B]`` float32 reduction per bucket on
  compress, one carry face per scan round on decompress and, off the
  first rank, its compressed slab and sidecars.
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

from repro.core import arena as ja
from repro.dist import insitu as jins
from repro_torch.core import arena as ta
from repro_torch.dist import insitu as tins

SRC = Path(__file__).resolve().parents[1] / "src"


def _mesh(shape, axes):
    return types.SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(axes))


def _bucket_fields(b):
    return (b.names, tuple(tuple(s) for s in b.shapes), b.dtypes, b.ns, b.padded_loc, b.axis,
            b.grid)


PLAN_CASES = {
    # the reference test's entries, then more: a replicated leaf, a bf16
    # leaf, a composed partition and a row too long for int32 bit offsets
    "reference": [("ok", (8, 4), "float32", ("data",)), ("bad", (8, 4), "float32", (None, "data")),
                  ("odd", (7,), "float32", ("data",))],
    "mixed": [("rep", (100, 3), "float32", ()), ("half", (64, 8), "bfloat16", ("data",)),
              ("w", (4096,), "float32", ("data",)), ("v", (4000,), "float32", ("data",)),
              ("composed", (8, 8), "float32", (("data", "model"),)),
              ("huge", (2**27,), "float32", ())],
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_arena_equals_reference(case):
    entries = PLAN_CASES[case]
    tb, tskip = tins.plan_arena(entries, _mesh((2, 2), ("data", "model")))
    jb, jskip = jins.plan_arena([(n, s, d if d != "bfloat16" else jnp.bfloat16, PS(*sp))
                                 for n, s, d, sp in entries],
                                jax.sharding.AbstractMesh((2, 2), ("data", "model")))
    assert [_bucket_fields(b) for b in tb] == [_bucket_fields(b) for b in jb]
    assert tskip == jskip
    if case == "reference":
        assert [b.names for b in tb] == [("ok",)]
        assert sorted(k for k, _ in tskip) == ["bad", "odd"]


def test_plan_kernel_buckets_eligibility_equals_reference():
    entries = [
        ("tile_a", (8, 64, 128), "float32", ()),       # kernel route
        ("tile_b", (8, 64, 128), "float32", ()),       # same bucket
        ("misaligned", (8, 64, 127), "float32", ()),   # flat route
        ("flat2d", (64, 64), "float32", ()),           # flat route
        ("sharded", (8, 64, 128), "float32", ("data",)),  # flat route
    ]
    kb, rest = tins.plan_kernel_buckets(entries, _mesh((2,), ("data",)))
    jkb, jrest = jins.plan_kernel_buckets([e[:3] + (PS(*e[3]),) for e in entries],
                                          jax.sharding.AbstractMesh((2,), ("data",)))
    assert len(kb) == 1 and kb[0].names == ("tile_a", "tile_b")
    assert kb[0].padded == 8 * 64 * 128  # tile rows carry no pad
    assert [(b.padded, b.names, b.shapes, b.dtypes, b.ns) for b in kb] == \
        [(b.padded, b.names, b.shapes, b.dtypes, b.ns) for b in jkb]
    assert [e[0] for e in rest] == [e[0] for e in jrest] == ["misaligned", "flat2d", "sharded"]


# ------------------------------------------------- the row codec's hooks --

HOOK_CASES = {
    # (rows, n per row, eb, left faces, carries)
    "faces": ((3, 256), (256, 200, 17), 1e-2, (5, -7, 0), (11, -3, 2**31 - 1)),
    "wrap": ((2, 128), (128, 128), 1e-2, (2**31 - 1, -2**31), (-2**31, 7)),
}


@pytest.mark.parametrize("case", list(HOOK_CASES))
def test_row_hooks_equal_reference(case):
    """``absmax``/``exchange`` on encode and ``carry`` on decode give the
    reference's arena, sidecars and rows bit for bit (faces and carries
    across the int32 range included); the defaults give the hook-free
    arena."""
    shape, ns, eb, faces, carries = HOOK_CASES[case]
    rng = np.random.default_rng(len(case))
    scale = 1e9 if case == "wrap" else 4.0
    rows = (rng.normal(size=shape) * scale).astype(np.float32)
    n = np.asarray(ns, np.int32)
    am = np.abs(np.where(np.arange(shape[1])[None] < n[:, None], rows, 0)).max(axis=1) * 1.5
    face = np.asarray(faces, np.int32)[:, None]
    got_t, got_j = [], []
    tout = ta.sz_encode_rows(torch.from_numpy(rows), torch.from_numpy(n).long(), eb, 4096,
                             absmax=torch.from_numpy(am),
                             exchange=lambda last: (got_t.append(last.numpy().copy()),
                                                    torch.from_numpy(face))[1])
    jout = ja.sz_encode_rows(jnp.asarray(rows), jnp.asarray(n), eb, 4096, absmax=jnp.asarray(am),
                             exchange=lambda last: (got_j.append(np.asarray(last)),
                                                    jnp.asarray(face))[1])
    np.testing.assert_array_equal(got_t[0], got_j[0])
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(np.asarray(a.numpy() if hasattr(a, "numpy") else a),
                                      np.asarray(b), err_msg=case)
    carry = np.asarray(carries, np.int32)[:, None]
    arena_, widths, offsets, counts, _tb, eb_i, _used = tout
    trows = ta.sz_decode_rows(arena_, widths, offsets, counts, eb_i,
                              carry=lambda tot: torch.from_numpy(carry), n=torch.from_numpy(n))
    jrows = ja.sz_decode_rows(*[jnp.asarray(np.asarray(x)) for x in jout[:4]],
                              jnp.asarray(np.asarray(jout[5])),
                              carry=lambda tot: jnp.asarray(carry), n=jnp.asarray(n))
    np.testing.assert_array_equal(trows.numpy().view(np.int32), np.asarray(jrows).view(np.int32))
    plain = ta.sz_encode_rows(torch.from_numpy(rows), torch.from_numpy(n).long(), eb, 4096)
    hookless = ja.sz_encode_rows(jnp.asarray(rows), jnp.asarray(n), eb, 4096)
    for a, b in zip(plain, hookless):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------- torch.distributed on the CPU --

CASES = """
import numpy as np
EB = 1e-2

def leaves():
    rng = np.random.default_rng(2)
    return {"w1": rng.normal(size=(16, 24)).astype(np.float32) * 4,
            "w2": rng.normal(size=(16, 24)).astype(np.float32),
            "b": rng.normal(size=(64,)).astype(np.float32),
            "zero": np.zeros((32,), np.float32),
            # |x| / (2 eb) past 2**31: the quanta saturate, the deltas wrap
            "wrap": (rng.normal(size=(64,)) * 1e9).astype(np.float32)}
"""

REFERENCE = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as PS
from repro.core import arena
from repro.dist import insitu
from cases import EB, leaves

vals = leaves()
out = {}
for n_dev in (1, 2):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    spec = PS("data")
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, spec)) for k, v in vals.items()}
    buckets, skipped = insitu.plan_arena([(k, v.shape, v.dtype, spec) for k, v in vals.items()],
                                         mesh)
    assert not skipped
    for b in buckets:
        # eb traced, so XLA divides by it as the program reads
        comp = jax.jit(lambda ls, e, _b=b: insitu.sharded_compress_arena(list(ls), _b, mesh, e))
        st = comp([sharded[nm] for nm in b.names], jnp.float32(EB))
        h = insitu.arena_to_host(st)
        dec = jax.jit(lambda s: insitu.sharded_decompress_arena(s, mesh))(st)
        back = arena.host_restore(arena.host_meta(h), [arena.payload_encode(s) for s in h.shards])
        out[(n_dev, b.names)] = {"host": h, "dec": [np.asarray(d) for d in dec], "back": back}
pickle.dump(out, open(sys.argv[1], "wb"))
"""

RANK = """
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import kernels
from repro_torch.core import arena, sz
from repro_torch.dist import insitu, sharding
from cases import EB, leaves

vals = leaves()
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
spec = ("data",)

def place(x, i):
    t = torch.from_numpy(x)
    n = x.shape[0] // world
    local = t[rank * n:(rank + 1) * n].contiguous()
    if i % 2:  # both input forms: a DTensor, or the rank's local part
        return DTensor.from_local(local, mesh, sharding.placements(spec, mesh), run_check=False,
                                  shape=t.shape, stride=t.stride())
    return local

buckets, skipped = insitu.plan_arena([(k, v.shape, v.dtype, spec) for k, v in vals.items()], mesh)
assert not skipped
res = {"buckets": buckets}
for b in buckets:
    r = {}
    kernels.reset_launch_counts()
    insitu.reset_sent_bytes()
    st = insitu.sharded_compress_arena([place(vals[nm], i) for i, nm in enumerate(b.names)], b,
                                       mesh, EB)
    r["sent_compress"] = dict(insitu.sent_bytes)
    insitu.reset_sent_bytes()
    dec = insitu.sharded_decompress_arena(st, mesh)
    r["sent_decompress"] = dict(insitu.sent_bytes)
    r["dec"] = [(tuple(d.shape), str(d.dtype), d.to_local().numpy()) for d in dec]
    insitu.reset_sent_bytes()
    h = insitu.arena_to_host(st)
    r["sent_host"] = dict(insitu.sent_bytes)
    r["launches"] = sum(kernels.launch_counts().values())
    r["position"], r["rows"] = st.position, len(b.names)
    r["local_shard"] = {"arena": st.arena[:int(st.used)].numpy().view(np.uint32).copy(),
                        "counts": st.counts.numpy().copy()}
    if rank == 0:
        r["host"] = h
        r["back"] = arena.host_restore(arena.host_meta(h), [arena.payload_encode(s) for s in h.shards],
                                       device="cpu")
        # the per-leaf sharded stream of each flat leaf, for the row identity
        r["per_leaf"] = {}
    else:
        assert h is None
    for i, nm in enumerate(b.names):
        flat = torch.from_numpy(vals[nm].reshape(-1))
        n = flat.numel() // world
        sp = spec if b.axis else ()
        st1 = insitu.sharded_compress(flat[rank * n:(rank + 1) * n] if b.axis else flat, "sz",
                                      mesh, sp, eb=EB)
        h1 = insitu.to_host(st1)
        if rank == 0:
            r["per_leaf"][nm] = h1
    res[b.names] = r
pickle.dump(res, open(os.path.join(out_dir, f"w{world}_r{rank}.pkl"), "wb"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference on two forced host devices, and the port's two-rank
    and one-rank gloo groups, all started together."""
    d = tmp_path_factory.mktemp("arena_sharded")
    (d / "cases.py").write_text(CASES)
    (d / "reference.py").write_text(textwrap.dedent(REFERENCE))
    (d / "rank.py").write_text(textwrap.dedent(RANK))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{d}", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(d / "reference.py"), str(d / "ref.pkl")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in (2, 1):
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, str(d / "rank.py"), str(r), str(world),
                                    str(port), str(d)], env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT) for r in range(world)]
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
    ranks = {(w, r): pickle.load(open(d / f"w{w}_r{r}.pkl", "rb")) for w in (2, 1) for r in range(w)}
    return pickle.load(open(d / "ref.pkl", "rb")), ranks


def _cases():
    """(ranks, bucket names): the leaves' buckets by row length."""
    return [(2, ("b", "zero", "wrap")), (2, ("w1", "w2")), (1, ("b", "zero", "wrap")),
            (1, ("w1", "w2"))]


CASE_IDS = [f"{w}rank-{'+'.join(names)}" for w, names in _cases()]


def _host_fields(h):
    return (h.codec, tuple(h.names), tuple(tuple(s) for s in h.shapes), tuple(h.dtypes),
            tuple(h.ns), h.padded, h.grid, h.halo, list(h.eb_i))


@pytest.mark.parametrize("world,names", _cases(), ids=CASE_IDS)
def test_host_arena_and_payloads_equal_reference(runs, world, names):
    """The gathered ``HostArena`` equals the reference's field for field,
    every shard's arrays in their dtypes, and its payloads byte for byte."""
    ref, ranks = runs
    want = ref[(world, names)]["host"]
    got = ranks[(world, 0)][names]["host"]
    assert _host_fields(got) == _host_fields(want)
    assert len(got.shards) == len(want.shards) == world
    for gs, ws in zip(got.shards, want.shards):
        assert sorted(gs) == sorted(ws)
        for k in ws:
            assert np.asarray(gs[k]).dtype == np.asarray(ws[k]).dtype, k
            np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
        assert ta.payload_encode(gs) == ja.payload_encode(ws)
    assert ta.host_meta(got) == ja.host_meta(want)


@pytest.mark.parametrize("world,names", _cases(), ids=CASE_IDS)
def test_decodes_equal_reference_and_single_device(runs, world, names):
    """Each rank's ``sharded_decompress_arena`` leaf (a ``DTensor`` in the
    leaf's shape and dtype) and the mesh-free ``host_restore`` are bitwise
    the reference's decode, and (halo arenas) the single-device flat round
    trip ``sz.decompress(sz.compress(leaf))``."""
    from repro_torch.core import sz as tsz

    ref, ranks = runs
    jdec = ref[(world, names)]["dec"]
    vals = _leaves()
    for r in range(world):
        dec = ranks[(world, r)][names]["dec"]
        for i, nm in enumerate(names):
            shape, dtype, local = dec[i]
            assert shape == vals[nm].shape and dtype == "torch.float32"
            n = shape[0] // world
            np.testing.assert_array_equal(local.view(np.int32),
                                          jdec[i][r * n:(r + 1) * n].view(np.int32), err_msg=nm)
    back = ranks[(world, 0)][names]["back"]
    for i, nm in enumerate(names):
        np.testing.assert_array_equal(back[nm].numpy().view(np.int32),
                                      np.asarray(ref[(world, names)]["back"][nm]).view(np.int32))
        flat = torch.from_numpy(vals[nm].reshape(-1))
        single = tsz.decompress(tsz.compress(flat, 1e-2)).reshape(vals[nm].shape)
        np.testing.assert_array_equal(back[nm].numpy().view(np.int32), single.numpy().view(np.int32))


def _leaves():
    ns = {}
    exec(CASES, ns)
    return ns["leaves"]()


@pytest.mark.parametrize("world,names", _cases(), ids=CASE_IDS)
def test_arena_rows_are_the_per_leaf_streams(runs, world, names):
    """Row ``b`` of shard ``s`` is the per-leaf ``sharded_compress`` stream
    of the same flat leaf, and the zero leaf stores no words."""
    _, ranks = runs
    h = ranks[(world, 0)][names]["host"]
    per_leaf = ranks[(world, 0)][names]["per_leaf"]
    for i, nm in enumerate(names):
        for s in range(h.grid):
            ls = ta.leaf_stream(h, i, s)
            blobs = per_leaf[nm].shards[s][1]
            np.testing.assert_array_equal(ls["words"], blobs["words"])
            np.testing.assert_array_equal(ls["widths"], blobs["widths"])
            assert ls["total_bits"] == int(blobs["total_bits"])
            if nm == "zero":
                assert ls["words"].size == 0


@pytest.mark.parametrize("world,names", _cases(), ids=CASE_IDS)
def test_ranks_send_one_face_one_reduction_and_the_slab(runs, world, names):
    """Per bucket of B rows a rank sends: on compress one ``[B, 1]`` int32
    face (all but the last shard) and one ``[B]`` float32 ``all_reduce``; on
    decompress one ``[B, 1]`` carry face per scan round it is a source of;
    on ``arena_to_host`` (off the first rank) its live slab and sidecars —
    never a raw leaf.  The CPU launches no kernel."""
    _, ranks = runs
    for r in range(world):
        res = ranks[(world, r)][names]
        b = res["rows"]
        split = world > 1
        assert res["sent_compress"] == {"ppermute": 4 * b if split and r < world - 1 else 0,
                                        "all_reduce": 4 * b if split else 0, "gather": 0,
                                        "all_gather": 0}
        rounds = sum(r + off < world for off, _ in tins._scan_perms(world))
        assert res["sent_decompress"] == {"ppermute": 4 * b * rounds, "all_reduce": 0,
                                          "gather": 0, "all_gather": 0}
        shard = ranks[(world, 0)][names]["host"].shards[r]
        slab = sum(np.asarray(a).nbytes for a in shard.values())
        assert res["sent_host"] == {"ppermute": 0, "all_reduce": 0,
                                    "gather": slab if r else 0, "all_gather": 0}
        np.testing.assert_array_equal(res["local_shard"]["arena"], shard["arena"])
        assert res["launches"] == 0
