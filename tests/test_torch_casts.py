"""Twin tests of the port's float -> int32 conversions on inputs outside the
int32 range, +-inf and NaN: every SZ route (``core``, ``xla``, ``fused`` and
the flat arena) and every ZFP route (``core``, ``xla``, ``fused``) gives the
JAX package's stream on them, and decodes it to the same values.

The reference converts with ``jnp.round(v).astype(jnp.int32)``, which XLA
rounds half to even, saturates and maps NaN to 0, as the card's
``__float2int_rn`` does (``test_torch_cuda.py`` holds the card to the CPU on
these inputs); ``repro_torch.core.bitpack.round_i32`` is the port's one
conversion.  The reference's own routes differ on a ZFP block holding +-inf
(its ``core`` exponent comes from ``frexp``, its kernels' from the exponent
bits), so the port is held route for route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arena as ja
from repro.core import sz as jsz
from repro.core import zfp as jz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import zfp3d as jk5
from repro.kernels import zfp_fused as jk6
from repro_torch.core import arena as ta
from repro_torch.core import bitpack as tbp
from repro_torch.core import sz as tsz
from repro_torch.core import zfp as tz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import zfp3d as tk5
from repro_torch.kernels import zfp_fused as tk6

SZ_CASES = {"big": 5e6, "nan": np.nan, "huge": 3e38, "inf": np.inf}
SZ_EB = 1e-3


def _np(a) -> np.ndarray:
    return tbp.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b):
    """Equal integers, or floats equal bit for bit where neither is NaN and
    NaN at the same places (a NaN's payload is the platform's)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        a, b = a.view(np.uint32)[~np.isnan(a)], b.view(np.uint32)[~np.isnan(b)]
    np.testing.assert_array_equal(a, b)


def _same_packed(pj, pt):
    _same(pj.words, pt.words)
    _same(pj.widths, pt.widths)
    assert int(pj.total_bits) == int(pt.total_bits)


def _sz_field(case: str) -> np.ndarray:
    """An (8, 64, 128) smooth field with one value the case names at
    [1, 2, 3] (at eb 1e-3, 5e6 quantizes to 2.5e9 > 2**31)."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(8, 64, 128)).astype(np.float32)
    for ax in range(3):
        f = np.cumsum(f, axis=ax)
    f = (f * 100.0 / np.abs(f).max()).astype(np.float32)
    f[1, 2, 3] = SZ_CASES[case]
    return f


def test_round_i32_is_xla_convert():
    x = np.array([np.inf, -np.inf, np.nan, -np.nan, 3e38, -3e38, 2.5e9, -2.5e9, 2.0**31 - 128,
                  2.0**31, -(2.0**31), -(2.0**31) - 256, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                  1e-40, -0.0, 123456.5, -7.49], np.float32)
    got = tbp.round_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.round(jnp.asarray(x)).astype(
        jnp.int32)))


@pytest.mark.parametrize("case", list(SZ_CASES))
def test_sz_core_route_matches_reference(case):
    x = _sz_field(case)
    cj, ct = jsz.compress(jnp.asarray(x), SZ_EB), tsz.compress(torch.from_numpy(x), SZ_EB)
    _same_packed(cj.packed, ct.packed)
    _same(cj.eb, ct.eb)
    _same(jsz.decompress(cj), tsz.decompress(ct))


@pytest.mark.parametrize("case", list(SZ_CASES))
def test_sz_kernel_routes_match_reference(case):
    """``xla`` (K1's plain version and the packer) and ``fused`` (K3's)
    against the reference's ``xla`` and its interpret-mode ``fused``; both
    decoders of each package read the stream to the same values."""
    x = _sz_field(case)
    pj, pad_j, ebj = jops.sz_compress_kernel(jnp.asarray(x), SZ_EB, path="xla")
    pf, _, _ = jops.sz_compress_kernel(jnp.asarray(x), SZ_EB, path="fused")
    _same_packed(pj, pf)
    rj = jops.sz_decompress_kernel(pj, pad_j, x.shape, ebj, path="xla")
    for path in ("xla", "fused"):
        pt, pad_t, ebt = tops.sz_compress_kernel(torch.from_numpy(x), SZ_EB, path=path)
        assert pad_t == tuple(pad_j)
        _same(ebj, ebt)
        _same_packed(pj, pt)
        for dpath in ("xla", "fused"):
            _same(rj, tops.sz_decompress_kernel(pt, pad_t, x.shape, ebt, path=dpath))
    _same(jref.lorenzo3d_quantize_ref(jnp.asarray(x), SZ_EB),
          tref.lorenzo3d_quantize_ref(torch.from_numpy(x), SZ_EB))


def test_sz_flat_arena_matches_reference():
    """The flat bucket coder (``arena.sz_encode_rows``) on leaves holding
    5e6 at eb 1e-3, NaN, 3e38 and +inf."""
    leaves = []
    for case, value in SZ_CASES.items():
        v = _sz_field(case).reshape(-1)[:3000].copy()
        v[11] = value
        leaves.append((case, v))
    entries = [(nm, v.shape, "float32") for nm, v in leaves]
    jplan, tplan = ja.plan_buckets(entries), ta.plan_buckets(entries)
    assert [b.names for b in jplan] == [b.names for b in tplan]
    vals = dict(leaves)
    for jb, tb in zip(jplan, tplan):
        jarena = ja.sz_compress_bucket([jnp.asarray(vals[nm]) for nm in jb.names], jb, SZ_EB)
        tarena = ta.sz_compress_bucket([torch.from_numpy(vals[nm]) for nm in tb.names], tb,
                                       SZ_EB, device="cpu")
        for f in ("arena", "widths", "offsets", "counts", "total_bits", "eb_i", "used"):
            _same(getattr(jarena, f), getattr(tarena, f))
        for a, b in zip(ja.sz_decompress_bucket(jarena, jb), ta.sz_decompress_bucket(tarena, tb)):
            _same(a, b)


# ------------------------------------------------------------------ ZFP ---


def _zfp_blocks() -> np.ndarray:
    """256 blocks of N(0, 1) (seed 0) with +inf in block 1, -inf in 2, NaN
    in 3, 3e38 in 4, -3e38 and +inf in 5 and every value 3e38 in 6."""
    b = np.random.default_rng(0).normal(size=(256, 4, 4, 4)).astype(np.float32)
    b[1, 0, 1, 2] = np.inf
    b[2, 3, 0, 1] = -np.inf
    b[3, 1, 1, 1] = np.nan
    b[4, 2, 2, 2] = 3e38
    b[5, 0, 0, 0], b[5, 3, 3, 3] = -3e38, np.inf
    b[6] = 3e38
    return b


def _zfp_field() -> np.ndarray:
    """The same 256 blocks as a (16, 16, 64) field."""
    return tz._uncarve_blocks(torch.from_numpy(_zfp_blocks()), (16, 16, 64)).numpy().copy()


def test_zfp_core_route_matches_reference():
    b = _zfp_blocks()
    uj, ej, gj = jz.blocks_transform(jnp.asarray(b))
    ut, et, gt = tz.blocks_transform(torch.from_numpy(b))
    for a, c in ((uj, ut), (ej, et), (gj, gt)):
        _same(a, c)
    for rate in (4, 8, 32):
        wj, wt = jz.encode_words(uj, gj, rate), tz.encode_words(ut, gt, rate)
        _same(wj, wt)
        _same(jz.blocks_from_stream(wj, ej, gj, rate), tz.blocks_from_stream(wt, et, gt, rate))
    x = _zfp_field()
    cj, ct = jz.compress(jnp.asarray(x), 8), tz.compress(torch.from_numpy(x), 8)
    for f in ("words", "emax", "gtops"):
        _same(getattr(cj, f), getattr(ct, f))
    _same(jz.decompress(cj), tz.decompress(ct))


def test_zfp_xla_route_matches_reference():
    """K5's plain version and the ``ref`` oracle against the reference's
    interpret-mode K5 and its oracle, then the ``xla`` path end to end."""
    b = _zfp_blocks()
    for a, c in zip(jk5.zfp3d_transform(jnp.asarray(b)), tk5.zfp3d_transform(torch.from_numpy(b))):
        _same(np.asarray(a).astype(_np(c).dtype), c)
    for a, c in zip(jref.zfp3d_transform_ref(jnp.asarray(b)),
                    tref.zfp3d_transform_ref(torch.from_numpy(b))):
        _same(np.asarray(a).astype(_np(c).dtype), c)
    x = _zfp_field()
    cj = jops.zfp_compress_kernel(jnp.asarray(x), 8, path="xla")
    ct = tops.zfp_compress_kernel(torch.from_numpy(x), 8, path="xla")
    for f in ("words", "emax", "gtops"):
        _same(getattr(cj, f), getattr(ct, f))
    _same(jops.zfp_decompress_kernel(cj, path="xla"), tops.zfp_decompress_kernel(ct, path="xla"))


@pytest.mark.parametrize("rate", [4, 8])
def test_zfp_fused_route_matches_reference(rate):
    """K6/K7's plain versions against the reference's interpret-mode K6/K7
    on the same blocks; the exponent of an inf block is the kernels' 127
    (exponent bits) where the ``core`` route's ``frexp`` gives 0, in both
    packages."""
    b = _zfp_blocks()
    wj, ej, gj = jk6.fused_compress_blocks(jnp.asarray(b), rate)
    wt, et, gt = tk6.fused_compress_blocks(torch.from_numpy(b), rate)
    for a, c in ((wj, wt), (ej, et), (gj, gt)):
        _same(np.asarray(a).astype(_np(c).dtype), c)
    _same(jk6.fused_decompress_blocks(wj, ej, gj, rate),
          tk6.fused_decompress_blocks(wt, et, gt, rate))
    _, e_core, _ = tz.blocks_transform(torch.from_numpy(b))
    assert [int(v) for v in et[[1, 2, 5]]] == [127 + 128] * 3
    assert [int(v) for v in e_core[[1, 2, 5]]] == [0 + 128] * 3
    x = _zfp_field()
    ct = tops.zfp_compress_kernel(torch.from_numpy(x), rate, path="fused")
    cj = jops.zfp_compress_kernel(jnp.asarray(x), rate, path="fused")
    for f in ("words", "emax", "gtops"):
        _same(getattr(cj, f), getattr(ct, f))
    _same(jops.zfp_decompress_kernel(cj, path="fused"),
          tops.zfp_decompress_kernel(ct, path="fused"))
