"""Twin tests of the snapshot arena (``repro_torch.core.arena``, the row
packer, K8/K9's plain versions, the single-device kernel-bucket planner and
the port's tree flattening) against the JAX package on the same seeded
inputs.  Streams, sidecars, payload bytes and reconstructions are equal bit
for bit; the reference's Pallas kernels run in interpret mode, as its own
tests run them off-TPU.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py`` holds
K8 and K9 against their plain versions there.
"""

import collections
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from repro.core import arena as ja
from repro.core import bitpack as jbp
from repro.core import zfp as jzfp
from repro.dist import insitu as jinsitu
from repro.kernels import sz_fused as jszf
from repro_torch import tree as ttree
from repro_torch.core import arena as ta
from repro_torch.core import bitpack as tbp
from repro_torch.dist import insitu as tinsitu
from repro_torch.kernels import sz_fused as tszf

TILE = (8, 64, 128)


def _np(a) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as numpy, bf16 and f32 as bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        a = tbp.to_numpy(a)
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))
    assert _np(a).dtype == _np(b).dtype


def _pair(x: np.ndarray, dtype: str):
    """The same leaf for both packages: f32 values, cast to ``dtype`` (both
    round to nearest even)."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(ta.torch_dtype(dtype))
    _same(j, t)
    return j, t


# --------------------------------------------------------- row packer -----


def _codes(ns, seed, lo=-(2**20), hi=2**20):
    rng = np.random.default_rng(seed)
    padded = max(ja.row_length(n) for n in ns)
    codes = np.zeros((len(ns), padded), np.int32)
    for b, n in enumerate(ns):
        codes[b, :n] = rng.integers(lo, hi, size=n)
    return codes


def _rows_case(name):
    if name == "all_zero":
        return np.zeros((2, 128), np.int32), (128, 70)
    if name == "extreme":
        codes = np.zeros((2, 64), np.int32)
        codes[0, :7] = [0, 1, -1, 2**30, -(2**30), 2**31 - 1, -(2**31)]
        return codes, (7, 64)
    if name == "full_32bit":  # every code 32 bits wide: the n + 2 word cap binds
        rng = np.random.default_rng(5)
        codes = rng.integers(-(2**31), 2**31, size=(2, 192), dtype=np.int64).astype(np.int32)
        codes[:, 0] = -(2**31)
        codes[1, 130:] = 0
        return codes, (192, 130)
    ns = {"mixed": (100, 64, 1, 200, 3), "single": (256,), "equal": (64, 64)}[name]
    return _codes(ns, sum(ns)), ns


@pytest.mark.parametrize("case", ["mixed", "single", "equal", "all_zero", "extreme", "full_32bit"])
def test_row_packer_matches_reference(case):
    codes, ns = _rows_case(case)
    jr = jbp.pack_codes_rows(jnp.asarray(codes), jnp.asarray(ns))
    tr = tbp.pack_codes_rows(torch.from_numpy(codes), torch.tensor(ns))
    for a, b in zip(jr, tr):  # rows, counts, widths, total_bits: word for word
        _same(a, b)
    back = tbp.unpack_codes_rows(tr[0], tr[2])
    _same(jbp.unpack_codes_rows(jr[0], jr[2]), back)
    np.testing.assert_array_equal(back.numpy(), codes)


# ------------------------------------------------------ K8 / K9 plain -----


@pytest.mark.parametrize("shape,ebs", [((2, 8, 64, 128), (0.5, 0.05)),
                                       ((3, 16, 64, 128), (1e-3, 0.2, 7.0))])
def test_k8_k9_plain_match_reference(shape, ebs):
    """K8's and K9's plain versions (what the wrappers run on a CPU tensor)
    against the reference's batched Pallas kernels in interpret mode: the
    arena, every sidecar and the decoded rows are equal bit for bit."""
    rng = np.random.default_rng(len(ebs))
    x = (rng.normal(size=shape) * 20).astype(np.float32)
    x[0] = np.cumsum(x[0], axis=2)  # a smooth row beside rough ones
    eb = np.asarray(ebs, np.float32)
    jo = jszf.fused_compress_batched(jnp.asarray(x), jnp.asarray(eb))
    to = tszf.fused_compress_batched(torch.from_numpy(x), torch.from_numpy(eb))
    for a, b in zip(jo, to):
        _same(a, b)
    jy = jszf.fused_decompress_batched(jo[0], jo[1], shape[1:], jnp.asarray(eb))
    ty = tszf.fused_decompress_batched(to[0], to[1], shape[1:], torch.from_numpy(eb))
    _same(jy, ty)
    # each row is the one-field coder's stream (K3's plain version)
    off = 0
    for b in range(shape[0]):
        ref = tbp.to_storage(tszf.fused_compress(torch.from_numpy(x[b]), torch.tensor(eb[b])))
        cnt = int(to[3][b])
        assert int(to[2][b]) == off and cnt == len(ref["words"])
        np.testing.assert_array_equal(tbp.to_numpy(to[0][off:off + cnt]), ref["words"])
        off += cnt
    assert int(to[5]) == off


def test_k8_rejects_oversized_rows_and_bad_bounds():
    with pytest.raises(ValueError, match="too large"):
        tszf.fused_compress_batched(torch.zeros(1, 1024, 1024, 64), torch.ones(1))
    with pytest.raises(ValueError, match="one bound per row"):
        tszf.fused_encode_batched_plain(torch.zeros(2, 8, 64, 128), torch.ones(3))


# ------------------------------------------------------------ planning ----


def _bucket_key(b):
    return (b.padded, b.names, b.shapes, b.dtypes, b.ns, b.rows, b.nbytes_raw)


def test_plan_buckets_and_row_length_match_reference():
    entries = [(f"l{i}", (37 + (i * 97) % 6000,), "float32") for i in range(60)]
    entries += [("b", (100,), "float32"), ("a", (90,), "bfloat16"), ("s", (), "float32")]
    for budget in (ja.ROW_ELEM_BUDGET, 3 * 1024):
        jp, tp = ja.plan_buckets(entries, budget), ta.plan_buckets(entries, budget)
        assert [_bucket_key(b) for b in jp] == [_bucket_key(b) for b in tp]
    for n in (1, 64, 65, 129, 4096, 4097):
        assert ta.row_length(n) == ja.row_length(n)


def test_plan_for_tree_names_leaves_as_keystr():
    """Leaf names are ``jax.tree_util.keystr`` paths and dicts flatten in
    sorted key order, whatever their insertion order."""
    NT = collections.namedtuple("NT", "p q")
    x = np.ones((4, 5), np.float32)
    jt = {"z": [jnp.asarray(x), (None, jnp.asarray(x[0]))], "a": {"y": jnp.asarray(x),
          "b": NT(jnp.asarray(x[:2]), jnp.arange(3))}, "m": jnp.asarray(x).astype(jnp.bfloat16)}
    tt = {"z": [torch.from_numpy(x), (None, torch.from_numpy(x[0]))], "a": {"y": torch.from_numpy(x),
          "b": NT(torch.from_numpy(x[:2]), torch.arange(3))},
          "m": torch.from_numpy(x).to(torch.bfloat16)}
    assert [_bucket_key(b) for b in ja.plan_for_tree(jt)] == \
        [_bucket_key(b) for b in ta.plan_for_tree(tt)]
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0]]
    tpaths = [p for p, _ in ttree.tree_flatten_with_path(tt)[0]]
    assert tpaths == jpaths and tpaths[0] == "['a']['b'].p"
    assert str(ttree.tree_structure(tt)) == str(jax.tree_util.tree_structure(jt))
    leaves, treedef = ttree.tree_flatten(tt)
    back = ttree.tree_unflatten(treedef, leaves)
    assert list(back) == sorted(tt) and back["a"]["b"].p is tt["a"]["b"].p
    assert back["z"][1][0] is None and isinstance(back["z"][1], tuple)
    with pytest.raises(ValueError, match="leaves"):
        ttree.tree_unflatten(treedef, leaves[:-1])


def test_plan_kernel_buckets_matches_reference():
    """Eligibility (3-D, TILE-aligned, small enough for int32 bit offsets;
    every leaf replicated on one device) and chunking equal the reference's
    on a one-device mesh, and the six Nyx 256^3 fields make two buckets
    (4 + 2 rows) under the 2^26 budget."""
    entries = [("tile_a", (8, 64, 128), "float32"), ("tile_b", (8, 64, 128), "float32"),
               ("misaligned", (8, 64, 127), "float32"), ("flat2d", (64, 64), "float32"),
               ("big", (16, 64, 128), "bfloat16"), ("huge", (512, 512, 256), "float32")]
    entries += [(f"nyx{i}", (256, 256, 256), "float32") for i in range(6)]
    mesh = jax.sharding.AbstractMesh((1,), ("data",))
    jb, jrest = jinsitu.plan_kernel_buckets([e + (PS(),) for e in entries], mesh)
    tmesh = types.SimpleNamespace(shape=(1,), mesh_dim_names=("data",))
    tb, trest = tinsitu.plan_kernel_buckets([e + ((),) for e in entries], tmesh)
    assert [_bucket_key(b) for b in jb] == [_bucket_key(b) for b in tb]
    assert [e[0] for e in jrest] == [e[0] for e in trest] == ["misaligned", "flat2d", "huge"]
    assert [b.rows for b in tb if b.shapes[0] == (256, 256, 256)] == [4, 2]
    assert all(b.padded == b.ns[0] for b in tb)


# ------------------------------------------------------ flat buckets ------


def _random_tree(seed):
    """The reference's ``tests/test_arena.py::_random_tree`` shapes, as
    numpy f32 values plus a dtype per leaf."""
    rng = np.random.default_rng(seed)
    named = []
    for i in range(int(rng.integers(1, 7))):
        rank = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(1, 14)) for _ in range(rank))
        dtype = ["float32", "bfloat16"][int(rng.integers(0, 2))]
        x = (rng.normal(size=shape) * 10.0 ** int(rng.integers(-1, 3))).astype(np.float32)
        named.append((f"leaf{i}", x, dtype))
    return named, float(10.0 ** rng.integers(-4, 0))


def _flat_cases():
    cases = [_random_tree(seed) for seed in range(6)]
    rng = np.random.default_rng(11)
    cases.append(([("z", np.zeros(64, np.float32), "float32"),
                   ("c", np.full(100, 3.25, np.float32), "float32")], 1e-2))
    cases.append(([("w", rng.normal(size=(48, 32)).astype(np.float32) * 50, "float32"),
                   ("v", rng.normal(size=(3000,)).astype(np.float32), "bfloat16"),
                   ("u", rng.normal(size=(7, 9, 11)).astype(np.float32), "float32")], 1e-3))
    return cases


@pytest.mark.parametrize("case", range(8))
def test_flat_bucket_matches_reference(case):
    """Every flat bucket: the device arena and sidecars, the batched
    decode, the host arena's payload bytes and ``host_restore`` are the
    reference's bit for bit, and each leaf's stream equals the per-leaf
    coder's (``sz.compress`` on the flat leaf)."""
    from repro_torch.core import sz as tsz

    named, eb = _flat_cases()[case]
    pairs = {nm: _pair(x, dt) for nm, x, dt in named}
    entries = [(nm, x.shape, dt) for nm, x, dt in named]
    jplan, tplan = ja.plan_buckets(entries), ta.plan_buckets(entries)
    assert [_bucket_key(b) for b in jplan] == [_bucket_key(b) for b in tplan]
    for jb, tb in zip(jplan, tplan):
        jarena = ja.sz_compress_bucket([pairs[nm][0] for nm in jb.names], jb, eb)
        tarena = ta.sz_compress_bucket([pairs[nm][1] for nm in tb.names], tb, eb, device="cpu")
        staged = ta.sz_compress_bucket([pairs[nm][1] for nm in tb.names], tb, eb, staged=True,
                                       device="cpu")
        for f in ("arena", "widths", "offsets", "counts", "total_bits", "eb_i", "used"):
            _same(getattr(jarena, f), getattr(tarena, f))
            _same(getattr(staged, f), getattr(tarena, f))
        assert ta.arena_nbytes(tarena) == ja.arena_nbytes(jarena)
        assert ta.compression_ratio(tarena, tb) == ja.compression_ratio(jarena, jb)
        for a, b in zip(ja.sz_decompress_bucket(jarena, jb), ta.sz_decompress_bucket(tarena, tb)):
            _same(a, b)
        jh, th = ja.to_host(jarena, jb), ta.to_host(tarena, tb)
        assert ja.host_meta(jh) == ta.host_meta(th)
        assert th.nbytes_stored() == jh.nbytes_stored() and th.accounting() == jh.accounting()
        payloads = [ta.payload_encode(s) for s in th.shards]
        assert payloads == [ja.payload_encode(s) for s in jh.shards]
        jback = ja.host_restore(ja.host_meta(jh), payloads)
        tback = ta.host_restore(ta.host_meta(th), payloads, device="cpu")
        for i, nm in enumerate(tb.names):
            _same(jback[nm], tback[nm])
            assert tback[nm].dtype == ta.torch_dtype(tb.dtypes[i])
            ref = tsz.compress(pairs[nm][1].to(torch.float32).reshape(-1), eb)
            st = tbp.to_storage(ref.packed)
            ls = ta.leaf_stream(th, i)
            np.testing.assert_array_equal(ls["words"], st["words"])
            np.testing.assert_array_equal(ls["widths"], st["widths"])
            assert ls["total_bits"] == int(ref.packed.total_bits)


def test_payload_roundtrip_and_truncation():
    blobs = {"arena": np.arange(5, dtype=np.uint32), "widths": np.ones((2, 3), np.uint8),
             "offsets": np.asarray([0, 3], np.int32), "counts": np.asarray([3, 2], np.int32),
             "total_bits": np.asarray([40, 30], np.int32)}
    p = ta.payload_encode(blobs)
    assert p == ja.payload_encode(blobs)
    back = ta.payload_decode(p)
    for k, v in blobs.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    for cut in (2, 10, len(p) - 1):
        with pytest.raises(ValueError, match="truncated"):
            ta.payload_decode(p[:cut])


def test_host_restore_rejects_sparse_payloads():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32))
    b = ta.plan_buckets([("w", x.shape, x.dtype)])[0]
    h = ta.to_host(ta.sz_compress_bucket([x], b, 1e-3, device="cpu"), b)
    meta = ta.host_meta(h)
    meta["arena"]["grid"] = 2  # claims 2 shards, 1 payload present
    # a ValueError (the reference raises IOError): a descriptor that
    # disagrees with its payloads, which the manager reports as corruption
    with pytest.raises(ValueError, match="payload"):
        ta.host_restore(meta, [ta.payload_encode(h.shards[0])], device="cpu")


def test_host_restore_reads_reference_sharded_arena():
    """A two-shard flat arena of the reference's layout (rows split over the
    flat axis, with and without halo borders) restores to the reference's
    values: the stitching rule of the sharded path."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 256)) * 5).astype(np.float32)
    for halo in (False, True):
        shards = []
        eb_i = None
        for s in range(2):
            seg = x[:, 128 * s:128 * (s + 1)]
            b = ja.plan_buckets([(f"r{k}", (128,), "float32") for k in range(2)])[0]
            a = ja.sz_compress_bucket([jnp.asarray(r) for r in seg], b, 1e-2)
            shards.append(ja.to_host(a, b).shards[0])
            eb_i = list(np.asarray(a.eb_i)) if eb_i is None else eb_i
        meta = {"codec": ja.CODEC_SZ, "arena": {
            "names": ["r0", "r1"], "shapes": [[256], [256]], "dtypes": ["float32"] * 2,
            "ns": [256, 256], "padded": 128, "grid": 2, "halo": halo,
            "eb_i": [float(e) for e in eb_i]}}
        payloads = [ja.payload_encode(s) for s in shards]
        jback = ja.host_restore(meta, payloads)
        tback = ta.host_restore(meta, payloads, device="cpu")
        for nm in ("r0", "r1"):
            _same(jback[nm], tback[nm])


# ----------------------------------------------------- kernel buckets -----


def test_kernel_bucket_matches_reference_and_tile_coder():
    """``szk_compress_bucket`` (K8's plain version on the CPU) against the
    reference's (interpret mode): arena and sidecars bit for bit, each
    row's slice equal to ``ops.sz_compress_kernel``'s stream, the batched
    decode (K9) equal to the per-field decode, and ``host_restore`` of the
    ``arena-szk`` payload equal to the reference's."""
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(7)
    eb = 1e-3
    xs = [(rng.normal(size=TILE) * (i + 1)).astype(np.float32) for i in range(3)]
    n = int(np.prod(TILE))
    jb = ja.Bucket(n, ("x0", "x1", "x2"), (TILE,) * 3, ("float32",) * 3, (n,) * 3)
    tb = ta.Bucket(n, ("x0", "x1", "x2"), (TILE,) * 3, ("float32",) * 3, (n,) * 3)
    jarena = ja.szk_compress_bucket([jnp.asarray(x) for x in xs], jb, eb)
    tarena = ta.szk_compress_bucket([torch.from_numpy(x) for x in xs], tb, eb, device="cpu")
    for f in ("arena", "widths", "offsets", "counts", "total_bits", "eb_i", "used"):
        _same(getattr(jarena, f), getattr(tarena, f))
    jh = ja.to_host(jarena, jb, codec=ja.CODEC_SZK)
    th = ta.to_host(tarena, tb, codec=ta.CODEC_SZK)
    assert ja.host_meta(jh) == ta.host_meta(th) and th.codec == ta.CODEC_SZK
    payloads = [ta.payload_encode(th.shards[0])]
    assert payloads == [ja.payload_encode(jh.shards[0])]
    dec = ta.szk_decompress_bucket(tarena, tb)
    for a, b in zip(ja.szk_decompress_bucket(jarena, jb), dec):
        _same(a, b)
    jback = ja.host_restore(ja.host_meta(jh), payloads)
    tback = ta.host_restore(ta.host_meta(th), payloads, device="cpu")
    sh = th.shards[0]
    for i, x in enumerate(xs):
        packed, pshape, eb_i = tops.sz_compress_kernel(torch.from_numpy(x), eb)
        ref = tbp.to_storage(packed)
        off, cnt = int(sh["offsets"][i]), int(sh["counts"][i])
        np.testing.assert_array_equal(sh["arena"][off:off + cnt], ref["words"])
        np.testing.assert_array_equal(sh["widths"][i], ref["widths"])
        assert int(sh["total_bits"][i]) == int(packed.total_bits)
        _same(eb_i, tarena.eb_i[i])
        _same(dec[i], tops.sz_decompress_kernel(packed, pshape, TILE, eb_i))
        _same(jback[f"x{i}"], tback[f"x{i}"])
        _same(tback[f"x{i}"], dec[i])
    with pytest.raises(ValueError, match="shape-uniform"):
        ta.szk_compress_bucket(xs[:2], ta.Bucket(n, ("a", "b"), (TILE, (16, 64, 64)),
                                                 ("float32",) * 2, (n, n)), eb, device="cpu")


@pytest.mark.parametrize("route", ["flat", "kernel"])
def test_per_row_bounds_match_reference(route):
    """A bucket's bound may be a float32 tensor with one bound per row (each
    leaf at 1e-4 of its own range, however far apart the ranges lie): the
    arena, sidecars and payload bytes are the reference's given the same
    array, every row holds codes, each row is its leaf's one-field stream at
    its own bound, and ``host_restore`` keeps every leaf within it."""
    from repro_torch.core import sz as tsz
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(11)
    shape = TILE if route == "kernel" else (37, 41)
    xs = [(rng.normal(size=shape) * s).astype(np.float32) for s in (1e-3, 1.0, 1e4)]
    ebs = np.asarray([1e-4 * float(x.max() - x.min()) for x in xs], np.float32)
    n = int(np.prod(shape))
    kw = dict(names=("x0", "x1", "x2"), shapes=(shape,) * 3, dtypes=("float32",) * 3,
              ns=(n,) * 3)
    jb = ja.Bucket(padded=ta.row_length(n) if route == "flat" else n, **kw)
    tb = ta.Bucket(padded=jb.padded, **kw)
    if route == "kernel":
        jarena = ja.szk_compress_bucket([jnp.asarray(x) for x in xs], jb, jnp.asarray(ebs))
        tarena = ta.szk_compress_bucket([torch.from_numpy(x) for x in xs], tb,
                                        torch.from_numpy(ebs), device="cpu")
    else:
        jarena = ja.sz_compress_bucket([jnp.asarray(x) for x in xs], jb, jnp.asarray(ebs))
        tarena = ta.sz_compress_bucket([torch.from_numpy(x) for x in xs], tb,
                                       torch.from_numpy(ebs), device="cpu")
    for f in ("arena", "widths", "offsets", "counts", "total_bits", "eb_i", "used"):
        _same(getattr(jarena, f), getattr(tarena, f))
    codec = ta.CODEC_SZK if route == "kernel" else ta.CODEC_SZ
    th = ta.to_host(tarena, tb, codec=codec)
    jh = ja.to_host(jarena, jb, codec=codec)
    assert ja.host_meta(jh) == ta.host_meta(th)
    payloads = [ta.payload_encode(s) for s in th.shards]
    assert payloads == [ja.payload_encode(s) for s in jh.shards]
    back = ta.host_restore(ta.host_meta(th), payloads, device="cpu")
    sh = th.shards[0]
    for i, x in enumerate(xs):
        xt = torch.from_numpy(x)
        assert tarena.widths[i].any()
        if route == "kernel":
            packed = tops.sz_compress_kernel(xt, float(ebs[i]))[0]
        else:
            packed = tsz.compress(xt.reshape(-1), float(ebs[i])).packed
        ref = tbp.to_storage(packed)
        off, cnt = int(sh["offsets"][i]), int(sh["counts"][i])
        np.testing.assert_array_equal(sh["arena"][off:off + cnt], ref["words"])
        assert int(sh["total_bits"][i]) == int(packed.total_bits)
        assert float((back[f"x{i}"] - xt).abs().max()) <= float(ebs[i]) * (1 + 1e-5)


# --------------------------------------------------------- ZFP arena ------


def test_zfp_arena_matches_reference():
    rng = np.random.default_rng(3)
    shapes = [(8, 8, 8), (12, 8, 4), (6, 5, 9)]
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ja_ = ja.zfp_compress_bucket([jnp.asarray(x) for x in xs], 8)
    ta_ = ta.zfp_compress_bucket([torch.from_numpy(x) for x in xs], 8, device="cpu")
    assert ta_.ranges == ja_.ranges and ta_.ranges == ta.zfp_ranges(shapes)
    for f in ("words", "emax", "gtops"):
        _same(getattr(ja_, f), getattr(ta_, f))
    from repro_torch.core import zfp as tzfp

    for i, x in enumerate(xs):
        v = ta.zfp_leaf_view(ta_, i, x.shape)
        ref = tzfp.compress(torch.from_numpy(x), 8)
        jv = ja.zfp_leaf_view(ja_, i, x.shape)
        for f in ("words", "emax", "gtops"):
            _same(getattr(v, f), getattr(ref, f))
            _same(getattr(jv, f), getattr(v, f))
    for a, b in zip(ja.zfp_decompress_bucket(ja_, shapes), ta.zfp_decompress_bucket(ta_, shapes)):
        _same(a, b)
    assert jzfp.n_blocks_for(shapes[2]) == ta_.ranges[3] - ta_.ranges[2]


# ------------------------------------------------- handles and slots -----


def test_to_host_async_on_the_cpu_equals_to_host():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(40, 30)).astype(np.float32))
    b = ta.plan_buckets([("w", x.shape, x.dtype)])[0]
    a = ta.sz_compress_bucket([x], b, 1e-3, device="cpu")
    p = ta.to_host_async(a, b, codec=ta.CODEC_SZ)
    assert p.names == ("w",)
    h, ref = p.result(), ta.to_host(a, b)
    assert ta.host_meta(h) == ta.host_meta(ref)
    assert [ta.payload_encode(s) for s in h.shards] == [ta.payload_encode(s) for s in ref.shards]


def test_pending_host_arena_fetches_once_and_caches_errors():
    calls = []

    def fetch():
        calls.append(1)
        return "host-arena"

    p = ta.PendingHostArena(fetch, names=("a", "b"))
    assert p.names == ("a", "b")
    results = []
    threads = [threading.Thread(target=lambda: results.append(p.result())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert results == ["host-arena"] * 8 and len(calls) == 1  # the D2H never repeats

    def broken():
        raise RuntimeError("device gone")

    q = ta.PendingHostArena(broken)
    for _ in range(2):  # every caller sees the same failure
        with pytest.raises(RuntimeError, match="device gone"):
            q.result()


def test_snapshot_slots_block_and_release():
    pool = ta.SnapshotSlots(2)
    pool.acquire()
    pool.acquire()
    assert pool.in_flight == 2
    got = threading.Event()

    def third():
        pool.acquire()
        got.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not got.wait(timeout=0.2)  # both slots busy: the hook stalls here
    pool.release("ignored", "positional", "args")  # usable as on_complete
    assert got.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive() and pool.in_flight == 2
    pool.release()
    pool.release()
    assert pool.in_flight == 0
    with pytest.raises(ValueError):
        pool.release()  # over-release is a bug, not a no-op
