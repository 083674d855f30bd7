"""Twin tests of ``repro_torch.core.zfp`` against ``repro.core.zfp``: the
same numpy inputs through both, with tolerance 0 everywhere.  Streams
(``words``/``emax``/``gtops``) and every integer stage are equal bit for
bit, and so are decoded floats (decode is an int -> f32 conversion times a
power of two).  The seed-reference streams of the JAX package's coder tests
are embedded here too, so the port reproduces the captured wire format.
"""

import base64
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zfp as jz
from repro_torch.core import bitpack as tbp
from repro_torch.core import zfp as tz

RATES = [1, 2, 4, 8, 16, 32]
SHAPES = [(10, 9, 7), (13, 17, 5)]

# Streams captured from the pre-rewrite (32-pass) coder of the JAX package
# on the deterministic field below: zlib + base64 of the little-endian bytes.
_WORDS4 = 'eJxjYMANBC5JJGVl+yo2pOjIFXsomjL/q+gt/TeZkRko58KgwMA420Oq4YGJ2qNeFvO8m31FwYn8F2WBchwCAgxMLkKCTJOvNGS+4ikJ1Fkuxu1fkQaSUxBgUWBQaHCZEBDA1cBSYZB9Q/2YzeHIfZxAOYcXQoyOAhwaHLFKKzyYOAMPN7RI52gcjrIDyjUzMLEIKJxwa+6z5HTYcDul4OMnZcFtEm0qILcIMDZwHC1w5pNwW/7xrk/ozv6VLdw8dTsNgHIAM8E66A=='
_WORDS8 = 'eJxjYCAfCFySSMrK9lVsSNGRK/ZQNGX+V9Fb+m8yo/MClfozC+IV9v29+b2c8azQdvMMK9tvybalf759WJJVbMcH1OvCoMDAONtDquGBidqjXhbzvJt9RcGJ/BfvHtmtvyJlx5Qa9TMGqml+eienhLovMFH9L6NtnTUhqt5CG6iXQ0CAgclFSJBp8pWGzFc8JYE6y8W4/SvS5q69a/mGYRLT9ZWcT9fnLOr0nLva9njYpl1Ggas49t/1ZFUE6lUQYFFgUGhwmRAQwNXAUmGQfUP9mM3hyH2dP7ef19yTIbLX9P6jLHaGBXPjHv1l6O7/vZLvgvacPQnzDYB6HV4IMToKcGhwxCqt8GDiDDzc0CKdo3E4qs7r06mHlv8Er6+5/IBXdPJlxYlLt90oVVyr6WT9/EVMKaMAUG8zAxOLgMIJt+Y+S06HDbdTCj5+UhbcJtGm8qNj4fwFW+/fOBwRwi5nU62qcr3/9p829vorx6Q/5ecfZQeFlQBjA8fRAmc+CbflH+/6hO7sX9nCzVO3c4PU7IKXeZETJj58anMg3eDddiZmLjaRlwrJhtoaf1kTfjAC9QIAg7qqvA=='
_EMAX = 'eJxjmDhpYv/EiRMBD+ID9w=='
_GTOPS = 'eJw1i8ENADAIAl2hKrj/pqKmxMflBLOfBEkoz0V3sVKUAVGxRo4SFn2/O8LV0M5TBdc='


def _unb64(s: str, dtype, shape):
    return np.frombuffer(zlib.decompress(base64.b64decode(s)), dtype).reshape(shape)


def _seed_field():
    """The deterministic capture field: wide dynamic range + one zero block."""
    rng = np.random.default_rng(1234)
    f = (rng.normal(size=(8, 8, 8)) * 10 ** rng.uniform(-3, 5, size=(8, 8, 8))).astype(np.float32)
    f[0:4, 0:4, 0:4] = 0.0
    return f


def _rand_field(seed, shape=(8, 8, 8), lo=-5.0, hi=5.0):
    """Values at scales 10^lo .. 10^hi, with an all-zero first block."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape) * 10 ** rng.uniform(lo, hi, size=shape)
    f = f.astype(np.float32)
    f[:4, :4, :4] = 0.0
    return f


def _u32(t: torch.Tensor) -> np.ndarray:
    """A port tensor of 32-bit values (uint32 storage or int64) as uint32."""
    if t.dtype == torch.int64:
        t = tbp.i64_to_u32(t)
    return tbp.to_numpy(t)


def _assert_same_compressed(cj, ct):
    np.testing.assert_array_equal(np.asarray(cj.words), tbp.to_numpy(ct.words))
    np.testing.assert_array_equal(np.asarray(cj.emax), ct.emax.numpy())
    np.testing.assert_array_equal(np.asarray(cj.gtops), ct.gtops.numpy())
    assert (ct.words.dtype, ct.emax.dtype, ct.gtops.dtype) == (torch.uint32, torch.uint8,
                                                               torch.uint8)
    assert tuple(cj.shape) == ct.shape and cj.rate == ct.rate


def _assert_same_floats(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


# ------------------------------------------------------------ constants ---


def test_constants_match_reference():
    for name in ("PERM", "IPERM", "GROUP_SIZES", "GROUP_OF_COEF", "RANK_IN_GROUP", "_gstart"):
        np.testing.assert_array_equal(getattr(tz, name), getattr(jz, name), err_msg=name)
    for name in ("Q", "N_GROUPS", "_HEADER_BITS", "BLOCK_SIDE", "_EMAX_BIAS", "_NBMASK_VAL",
                 "_FIXED_START"):
        assert getattr(tz, name) == getattr(jz, name), name
    for extent, shards in [(8, 2), (10, 2), (10, 1), (12, 4)]:
        assert tz.shard_extent_aligned(extent, shards) == jz.shard_extent_aligned(extent, shards)


# ------------------------------------------------------ compress/decode ---


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", RATES)
def test_compress_and_decompress_match_reference(rate, shape):
    f = _rand_field(rate * 100 + sum(shape), shape)
    cj = jz.compress(jnp.asarray(f), rate)
    ct = tz.compress(torch.from_numpy(f), rate)
    _assert_same_compressed(cj, ct)
    _assert_same_floats(jz.decompress(cj), tz.decompress(ct).numpy())
    assert tz.compressed_nbytes(ct) == jz.compressed_nbytes(cj)
    assert tz.compression_ratio(ct) == jz.compression_ratio(cj)
    assert tz.compression_ratio(ct, n_values=100) == jz.compression_ratio(cj, n_values=100)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("scale", [1e-5, 1e5, 1e-39, 1e-37])
def test_scales_and_subnormals_match_reference(rate, scale):
    """Uniform magnitudes from 1e-5 to 1e5, and blocks near the subnormal
    range: a block whose |x|max is subnormal is a zero block in both (the
    reference flushes subnormals), and subnormal values beside normal ones
    quantize to 0."""
    rng = np.random.default_rng(7)
    f = (rng.normal(size=(12, 8, 8)) * scale).astype(np.float32)
    f[4:8] = (rng.normal(size=(4, 8, 8)) * 1e-39).astype(np.float32)  # all-subnormal blocks
    cj = jz.compress(jnp.asarray(f), rate)
    ct = tz.compress(torch.from_numpy(f), rate)
    _assert_same_compressed(cj, ct)
    _assert_same_floats(jz.decompress(cj), tz.decompress(ct).numpy())
    assert (ct.emax.numpy().reshape(3, 2, 2)[1] == 0).all()


def test_block_transform_matches_reference():
    f = _rand_field(3, (9, 6, 13))
    uj, ej, gj = jz.block_transform(jnp.asarray(f))
    ut, et, gt = tz.block_transform(torch.from_numpy(f))
    np.testing.assert_array_equal(np.asarray(uj), _u32(ut))
    np.testing.assert_array_equal(np.asarray(ej), et.numpy())
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    np.testing.assert_array_equal(np.asarray(jz._carve_blocks(jnp.asarray(f))),
                                  tz._carve_blocks(torch.from_numpy(f)).numpy())
    blocks = tz._carve_blocks(torch.from_numpy(f))
    np.testing.assert_array_equal(tz._uncarve_blocks(blocks, f.shape).numpy(), f)
    assert tz.n_blocks_for(f.shape) == jz.n_blocks_for(f.shape) == blocks.shape[0]


@pytest.mark.parametrize("shape", [(4, 8, 4), (8, 4, 12), (5, 9, 3), (64, 8, 8)])
def test_carve_matches_reference_and_is_contiguous(shape):
    """Block carving equals the reference's on shapes where a reshape of
    the permuted field could be a strided view; the kernels need it dense."""
    f = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    bt = tz._carve_blocks(torch.from_numpy(f))
    assert bt.is_contiguous()
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jz._carve_blocks(jnp.asarray(f))))
    np.testing.assert_array_equal(tz._uncarve_blocks(bt, shape).numpy(), f)


def test_garbage_streams_decode_like_reference():
    """Arbitrary words and headers (any emax, tops up to 32) decode to the
    same floats: the inverse lift wraps exactly as the reference's int32."""
    rng = np.random.default_rng(17)
    nb, rate = 96, 8
    words = rng.integers(0, 2**32, size=(nb, jz.payload_words(rate)), dtype=np.uint64)
    words = words.astype(np.uint32)
    emax = rng.integers(0, 256, size=nb, dtype=np.uint8)
    gtops = rng.integers(0, 33, size=(nb, 10), dtype=np.uint8)
    shape = (16, 16, 24)  # 96 blocks
    cj = jz.from_words(words, emax, gtops, shape, rate)
    ct = tz.from_words(words, emax, gtops, shape, rate, device="cpu")
    _assert_same_compressed(cj, ct)
    _assert_same_floats(jz.decompress(cj), tz.decompress(ct).numpy())


def test_payload_words_validates_rate_like_reference():
    for rate in (1, 2, 31, 32, 100):
        assert tz.payload_words(rate) == jz.payload_words(rate) == 2 * rate - 1
    for rate in (0, -3):
        with pytest.raises(ValueError) as ej:
            jz.payload_words(rate)
        with pytest.raises(ValueError) as et:
            tz.payload_words(rate)
        assert str(et.value) == str(ej.value)
        with pytest.raises(ValueError):
            tz.compress(torch.zeros(4, 4, 4), rate)


# -------------------------------------------------------------- stages ---


def test_lifts_negabinary_and_exp2_match_reference():
    rng = np.random.default_rng(11)
    v = rng.integers(-(2**31), 2**31, size=(4096, 4), dtype=np.int64).astype(np.int32)
    vj, vt = jnp.asarray(v), torch.from_numpy(v)
    np.testing.assert_array_equal(np.asarray(jz.fwd_lift(vj)), tz.fwd_lift(vt).numpy())
    np.testing.assert_array_equal(np.asarray(jz.inv_lift(vj)), tz.inv_lift(vt).numpy())
    small = rng.integers(-(2**27), 2**27, size=(64, 4, 4, 4), dtype=np.int64).astype(np.int32)
    st = torch.from_numpy(small)
    np.testing.assert_array_equal(np.asarray(jz._lift3d(jnp.asarray(small))),
                                  tz._lift3d(st).numpy())
    np.testing.assert_array_equal(np.asarray(jz._inv_lift3d(jnp.asarray(small))),
                                  tz._inv_lift3d(st).numpy())
    flat = v.reshape(-1)
    nb_j = np.asarray(jz.negabinary(jnp.asarray(flat)))
    nb_t = torch.from_numpy(nb_j.view(np.int32).copy())
    np.testing.assert_array_equal(nb_j, _u32(tz.negabinary(torch.from_numpy(flat))))
    np.testing.assert_array_equal(
        tz.inv_negabinary(tz.negabinary(torch.from_numpy(flat))).numpy(), flat)
    np.testing.assert_array_equal(
        np.asarray(jz.inv_negabinary(jnp.asarray(nb_j))),
        tz.inv_negabinary(nb_t.view(torch.uint32)).numpy())
    np.testing.assert_array_equal(np.asarray(jz._bitlength32(jnp.asarray(nb_j))),
                                  tz._bitlength32(nb_t).numpy())
    k = np.arange(-140, 140, dtype=np.int32)
    _assert_same_floats(jz.exact_exp2(jnp.asarray(k)), tz.exact_exp2(torch.from_numpy(k)).numpy())


def test_exponent_bit_trick_vs_frexp():
    """The kernels' exponent bits and the core's frexp agree after the
    clip to [-100, 127], subnormal |x|max included (-126 and below both
    clip to -100)."""
    from repro_torch.kernels import zfp3d as tk5

    rng = np.random.default_rng(19)
    mags = np.concatenate([10.0 ** rng.uniform(-44, 38, size=480), [1e-39, 2**-149, 2**-126,
                                                                    2**-127, 1.0, 0.5]])
    blocks = np.zeros((len(mags), 4, 4, 4), np.float32)
    blocks[:, 1, 2, 3] = mags.astype(np.float32)
    _, e_bits, nz_bits = tk5.block_float_negabinary(torch.from_numpy(blocks))
    maxabs = torch.from_numpy(np.abs(blocks).max(axis=(1, 2, 3)))
    _, e_frexp = torch.frexp(maxabs)
    np.testing.assert_array_equal(e_bits.numpy(), torch.clamp(e_frexp, -100, 127).numpy())
    _, ej = jnp.frexp(jnp.asarray(maxabs.numpy()))
    normal = maxabs.numpy() >= 2.0**-126
    np.testing.assert_array_equal(np.clip(np.asarray(ej), -100, 127)[normal],
                                  e_bits.numpy()[normal])
    np.testing.assert_array_equal(nz_bits.numpy(), normal)


# ---------------------------------------------------------------- coder ---


@pytest.mark.parametrize("rate,words_b64", [(4, _WORDS4), (8, _WORDS8)])
def test_seed_reference_stream(rate, words_b64):
    """The port's coder reproduces the captured seed streams bit for bit."""
    c = tz.compress(torch.from_numpy(_seed_field()), rate)
    wpb = tz.payload_words(rate)
    np.testing.assert_array_equal(tbp.to_numpy(c.words), _unb64(words_b64, np.uint32, (8, wpb)))
    np.testing.assert_array_equal(c.emax.numpy(), _unb64(_EMAX, np.uint8, (8,)))
    np.testing.assert_array_equal(c.gtops.numpy(), _unb64(_GTOPS, np.uint8, (8, 10)))


def test_bit_transpose_involution():
    """The 32x32 bit transpose equals the reference's and inverts exactly."""
    rng = np.random.default_rng(9)
    u = rng.integers(0, 2**32, size=(257, 64), dtype=np.uint64).astype(np.uint32)
    ut = torch.from_numpy(u.view(np.int32)).view(torch.uint32)
    w0, w1 = tz._plane_words(ut)
    j0, j1 = jz._plane_words(jnp.asarray(u))
    np.testing.assert_array_equal(_u32(w0), np.asarray(j0))
    np.testing.assert_array_equal(_u32(w1), np.asarray(j1))
    np.testing.assert_array_equal(_u32(tz._coef_words(w0, w1)), u)
    a = tbp.u32_to_i64(ut[:, :32])
    np.testing.assert_array_equal(_u32(tz._bit_transpose32(a)),
                                  np.asarray(jz._bit_transpose32(jnp.asarray(u[:, :32]))))


def test_plane_words_orientation():
    """W0[:, j] bit c must be bit plane (31 - j) of coefficient c."""
    u = np.zeros((1, 64), np.uint32)
    u[0, 3] = 1 << 30  # coefficient 3, plane 30 -> stream-major j = 1
    w0, w1 = tz._plane_words(torch.from_numpy(u.view(np.int32)))
    assert int(w0[0, 1]) == (1 << 3)
    assert int(w0.sum()) == 1 << 3 and int(w1.sum()) == 0


def test_plane_offsets_match_flat_schedule():
    """Closed-form OFF/keep == the flat 320-item prefix sums, in both."""
    f = _rand_field(21, lo=-3.0, hi=6.0)
    _, _, gtops = tz.block_transform(torch.from_numpy(f))
    g = gtops.numpy()
    flat = tz._schedule_offsets(gtops).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jz._schedule_offsets(jnp.asarray(g))))
    flat = flat.reshape(-1, 32, 10)
    OFF, keep = tz._plane_offsets(gtops, 454)
    np.testing.assert_array_equal(OFF.numpy(), flat[:, :, 0])
    pw = flat[:, :, -1] + np.where(31 - np.arange(32)[None, :] < g[:, -1:], 1, 0) - flat[:, :, 0]
    np.testing.assert_array_equal(keep.numpy(), np.clip(454 - flat[:, :, 0], 0, pw))
    oj, kj = jz._plane_offsets(jnp.asarray(g), 454)
    np.testing.assert_array_equal(OFF.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(kj))


@pytest.mark.parametrize("rate", [4, 8, 32])
def test_encode_and_decode_words_match_reference(rate):
    """The coder halves on the same coefficients and headers: equal words,
    equal admitted coefficients, and equal payloads and masks on the way."""
    f = _rand_field(rate, (12, 8, 8), lo=-3.0, hi=6.0)
    uj, _, gj = jz.block_transform(jnp.asarray(f))
    ut, _, gt = tz.block_transform(torch.from_numpy(f))
    wj = np.asarray(jz.encode_words(uj, gj, rate))
    wt = tz.encode_words(ut, gt, rate)
    np.testing.assert_array_equal(tbp.to_numpy(wt), wj)
    np.testing.assert_array_equal(_u32(tz.decode_words(wt, gt, rate)),
                                  np.asarray(jz.decode_words(jnp.asarray(wj), gj, rate)))
    for a, b in zip(tz._plane_payloads(ut, gt), jz._plane_payloads(uj, gj)):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    keep = torch.arange(0, 65)
    for a, b in zip(tz._mask64(keep), jz._mask64(jnp.asarray(keep.numpy()))):
        np.testing.assert_array_equal(_u32(a), np.asarray(b))
    for g in range(tz.N_GROUPS):
        np.testing.assert_array_equal(tz._group_widths(gt, g).numpy(),
                                      np.asarray(jz._group_widths(gj, g)))


def test_full_admission_roundtrip_exact():
    """When every plane fits the budget, decode(encode(u)) == u exactly."""
    rng = np.random.default_rng(13)
    u = rng.integers(0, 2**10, size=(64, 64), dtype=np.uint64).astype(np.uint32)
    ut = torch.from_numpy(u.view(np.int32))
    lens = tz._bitlength32(ut)
    gt = torch.zeros(64, 10, dtype=torch.int64).scatter_reduce(
        1, torch.as_tensor(tz.GROUP_OF_COEF, dtype=torch.int64).expand(64, 64), lens, "amax")
    back = tz.decode_words(tz.encode_words(ut, gt, 32), gt, 32)
    np.testing.assert_array_equal(_u32(back), u)


def test_from_words_defaults_to_cuda(monkeypatch):
    """Rebuilding a stream without a device means CUDA: with none, it raises."""
    c = tz.compress(torch.from_numpy(_seed_field()), 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tz.from_words(tbp.to_numpy(c.words).reshape(-1), c.emax.numpy(), c.gtops.numpy(),
                      c.shape, c.rate)
    back = tz.from_words(tbp.to_numpy(c.words).reshape(-1), c.emax.numpy(), c.gtops.numpy(),
                         c.shape, c.rate, device="cpu")
    _assert_same_compressed(jz.compress(jnp.asarray(_seed_field()), 8), back)
