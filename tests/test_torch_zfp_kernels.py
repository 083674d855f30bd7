"""Twin tests of the ZFP kernels (K5-K7) and the ZFP half of ``ops``: the
port's plain versions (what its wrappers run on a CPU tensor) against the
JAX package's Pallas kernels, run in interpret mode as
``repro.kernels.default_interpret`` chooses off-TPU, and against the
oracle in ``ref``.  Every stream, header and decoded float is equal bit for
bit.

The hand-written CUDA kernels run only on a card: ``test_torch_cuda.py``
holds each against its plain version there.  Their one table, the sequency
permutation in ``csrc/zfp_block.cuh``, is held to ``core.zfp.PERM`` here.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zfp as jz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import zfp3d as jk5
from repro.kernels import zfp_fused as jk6
from repro_torch.core import bitpack as tbp
from repro_torch.core import zfp as tz
from repro_torch.data import cosmo, zfp_cases
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import zfp3d as tk5
from repro_torch.kernels import zfp_fused as tk6


def _nyx_blocks() -> np.ndarray:
    """512 blocks of the Nyx baryon density at 32^3."""
    return np.array(jz._carve_blocks(jnp.asarray(cosmo.nyx_fields(n=32)["baryon_density"])))


def _wide_blocks() -> np.ndarray:
    """256 blocks over 12 decades, with a zero and two subnormal blocks."""
    rng = np.random.default_rng(3)
    b = rng.normal(size=(256, 4, 4, 4)) * 10 ** rng.uniform(-6, 6, size=(256, 1, 1, 1))
    b = b.astype(np.float32)
    b[0] = 0.0
    b[1] = 1e-39
    b[2, 0, 0, 0] = 2.0**-130
    return b


def _hard_blocks() -> np.ndarray:
    """256 blocks led by the card checks' hard cases (+-inf, NaN, 3e38,
    saturated blocks, zero, subnormal).  Only the kernel routes take them:
    the reference's ``ref`` route gives an inf block another emax."""
    return zfp_cases.hard_blocks(256, seed=7).numpy()


BLOCKS = {"nyx": _nyx_blocks, "wide": _wide_blocks}
FUSED_BLOCKS = {**BLOCKS, "hard": _hard_blocks}


def _rand_field(seed, shape, spread=6.0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=shape) * 10 ** rng.uniform(-3, spread, size=shape),
                      np.float32)


def _np(a) -> np.ndarray:
    return tbp.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ K5 ----


@pytest.mark.parametrize("blocks", list(BLOCKS))
def test_k5_plain_matches_zfp3d_and_ref(blocks):
    b = BLOCKS[blocks]()
    uj, ej, gj = jk5.zfp3d_transform(jnp.asarray(b))
    ut, et, gt = tk5.zfp3d_transform(torch.from_numpy(b))
    assert (ut.dtype, et.dtype, gt.dtype) == (torch.uint32, torch.uint8, torch.uint8)
    for got, want in ((ut, uj), (et, ej), (gt, gj)):
        np.testing.assert_array_equal(_np(got), np.asarray(want).astype(_np(got).dtype))
    for got, want in zip(tref.zfp3d_transform_ref(torch.from_numpy(b)),
                         jref.zfp3d_transform_ref(jnp.asarray(b))):
        _assert_same(got, want)
    ur, er, gr = tref.zfp3d_transform_ref(torch.from_numpy(b))
    _assert_same(ur, ut)
    np.testing.assert_array_equal(er.numpy(), et.numpy())
    np.testing.assert_array_equal(gr.numpy(), gt.numpy())


def test_k5_takes_any_block_count():
    """The kernels mask a ragged tail, so the port never pads the block count."""
    b = _wide_blocks()[:37]
    ut, et, gt = tk5.zfp3d_transform(torch.from_numpy(b))
    uj, ej, gj = jk5.zfp3d_transform(jnp.asarray(np.pad(b, ((0, 256 - 37),) + ((0, 0),) * 3)))
    _assert_same(ut, np.asarray(uj)[:37])
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej)[:37])
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj)[:37])


# ------------------------------------------------------------- K6 / K7 ----


@pytest.mark.parametrize("blocks", list(FUSED_BLOCKS))
@pytest.mark.parametrize("rate", [4, 8])
def test_k6_k7_plain_match_zfp_fused(rate, blocks):
    b = FUSED_BLOCKS[blocks]()
    wj, ej, gj = jk6.fused_compress_blocks(jnp.asarray(b), rate)
    wt, et, gt = tk6.fused_compress_blocks(torch.from_numpy(b), rate)
    _assert_same(wt, wj)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    _assert_same(tk6.fused_decompress_blocks(wt, et, gt, rate),
                 jk6.fused_decompress_blocks(wj, ej, gj, rate))
    # the transform tile under both
    for got, want in zip(tk6._transform_tile(torch.from_numpy(b)),
                         jk6._transform_tile(jnp.asarray(b))):
        np.testing.assert_array_equal(_np(got), np.asarray(want).astype(_np(got).dtype))
    # the arena wrappers are reshapes of the same launches
    arena, ea, ga = tk6.fused_compress_arena(torch.from_numpy(b), rate)
    _assert_same(arena, np.asarray(jk6.fused_compress_arena(jnp.asarray(b), rate)[0]))
    _assert_same(tk6.fused_decompress_arena(arena, ea, ga, rate),
                 tk6.fused_decompress_blocks(wt, et, gt, rate))


@pytest.mark.parametrize("rate", [1, 2, 16, 32])
def test_k6_k7_plain_match_core_at_every_rate(rate):
    """The fused plain versions against the core coder (the JAX package's
    core and fused paths agree, so this closes the square at the rates the
    interpret-mode kernels are too slow to sweep)."""
    b = torch.from_numpy(_wide_blocks())
    words, emax, gtops = tk6.fused_compress_blocks(b, rate)
    u, emax_c, gtops_c = tz.blocks_transform(b)
    _assert_same(words, tz.encode_words(u, gtops_c, rate))
    np.testing.assert_array_equal(emax.numpy(), emax_c.numpy())
    np.testing.assert_array_equal(gtops.numpy(), gtops_c.numpy())
    _assert_same(tk6.fused_decompress_blocks(words, emax, gtops, rate),
                 tz.blocks_from_stream(words, emax, gtops, rate))


# The field layout's shapes, scaled down from the card tests': HACC's last
# partition (X % 4 == 3, Y = Z = 8), a Nyx box's 1 : 1 : 2, a field ragged
# on every axis, a block count that is no multiple of a CTA's 64, and a 2-D
# field's trailing unit axis.
FIELD_SHAPES = {"hacc_last": (63, 8, 8), "nyx_box": (32, 32, 64), "ragged": (21, 22, 23),
                "nb_not_64": (259, 8, 8), "2d": (9, 13, 1)}


@pytest.mark.parametrize("shape", list(FIELD_SHAPES))
@pytest.mark.parametrize("rate", [1, 8, 16, 33])
def test_k6_k7_field_entries_match_core(rate, shape):
    """The field entries' plain route (what K6 and K7 read and write in place
    on the card) gives the JAX package's ``zfp.compress`` stream and
    ``zfp.decompress`` floats, and so does the ``fused`` path of ``ops`` on
    a view of the same values that is not contiguous."""
    x = _rand_field(rate, FIELD_SHAPES[shape])
    cj = jz.compress(jnp.asarray(x), rate)
    want = np.asarray(jz.decompress(cj))
    words, emax, gtops = tk6.fused_compress_field(torch.from_numpy(x), rate)
    _assert_same(words, cj.words)
    np.testing.assert_array_equal(emax.numpy(), np.asarray(cj.emax))
    np.testing.assert_array_equal(gtops.numpy(), np.asarray(cj.gtops))
    got = tk6.fused_decompress_field(words, emax, gtops, rate, x.shape)
    assert tuple(got.shape) == x.shape
    _assert_same(got, want)
    view = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 1, 0))).permute(2, 1, 0)
    assert not view.is_contiguous()
    c = tops.zfp_compress_kernel(view, rate, path="fused")
    _assert_same(c.words, cj.words)
    _assert_same(tops.zfp_decompress_kernel(c, path="fused"), want)


def test_cuda_tables_match_core():
    """The kernels' sequency permutation is ``core.zfp.PERM``."""
    src = (_build.CSRC / "zfp_block.cuh").read_text()
    table = re.search(r"uint8_t PERM\[64\] = \{([^}]*)\}", src).group(1)
    np.testing.assert_array_equal([int(v) for v in table.replace("\n", " ").split(",")], tz.PERM)


# ------------------------------------------------------------------ ops ---


@pytest.mark.parametrize("rate", [4, 8])
def test_ops_paths_match_reference_stream(rate):
    """``fused`` and ``xla`` emit the JAX package's ``zfp.compress`` stream."""
    x = _rand_field(1234, (8, 8, 8))
    x[0:4, 0:4, 0:4] = 0.0
    cj = jz.compress(jnp.asarray(x), rate)
    for path in ("fused", "xla"):
        ct = tops.zfp_compress_kernel(torch.from_numpy(x), rate, path=path)
        _assert_same(ct.words, cj.words)
        np.testing.assert_array_equal(ct.emax.numpy(), np.asarray(cj.emax))
        np.testing.assert_array_equal(ct.gtops.numpy(), np.asarray(cj.gtops))
        assert ct.shape == tuple(cj.shape) and ct.rate == rate
    ck = jops.zfp_compress_kernel(jnp.asarray(x), rate, path="fused")
    _assert_same(ck.words, cj.words)


@pytest.mark.parametrize("rate", [4, 8])
def test_ops_decoders_agree(rate):
    """Every decoder of either package reads every stream to the same floats."""
    x = _rand_field(5, (10, 9, 7))
    want = np.asarray(jz.decompress(jops.zfp_compress_kernel(jnp.asarray(x), rate, path="fused")))
    for path in ("fused", "xla"):
        ct = tops.zfp_compress_kernel(torch.from_numpy(x), rate, path=path)
        for dpath in ("fused", "xla"):
            got = tops.zfp_decompress_kernel(ct, path=dpath)
            assert tuple(got.shape) == x.shape
            _assert_same(got, want)
        _assert_same(tz.decompress(ct), want)
    cj = jz.compress(jnp.asarray(x), rate)
    for dpath in ("fused", "xla"):
        _assert_same(jops.zfp_decompress_kernel(cj, path=dpath), want)


def test_ops_transform_kernel_matches_reference():
    x = _rand_field(8, (12, 9, 6))
    uj, ej, gj = jops.zfp_transform_kernel(jnp.asarray(x))
    ut, et, gt = tops.zfp_transform_kernel(torch.from_numpy(x))
    _assert_same(ut, uj)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    ub, eb, gb = tz.block_transform(torch.from_numpy(x))
    _assert_same(ut, ub)


def test_ops_zfp_path_validation_and_rate():
    x = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError) as ej:
        jops._resolve_zfp_path("gpu")
    with pytest.raises(ValueError) as et:
        tops.zfp_compress_kernel(x, 8, path="gpu")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="leaves no payload"):
        tops.zfp_compress_kernel(x, 0)


def test_zfp_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes a plain version: any other device goes to the
    kernel route, which refuses what is not a CUDA tensor."""
    blocks = torch.empty(8, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk5.zfp3d_transform(blocks)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk6.fused_compress_blocks(blocks, 8)
    words = torch.empty(8, 15, dtype=torch.uint32, device="meta")
    emax = torch.empty(8, dtype=torch.uint8, device="meta")
    gtops = torch.empty(8, 10, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk6.fused_decompress_blocks(words, emax, gtops, 8)
    with pytest.raises(ValueError, match="rate 4 needs 7 words"):
        tk6.fused_decompress_blocks(words, emax, gtops, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk6.fused_compress_field(torch.empty(8, 4, 4, device="meta"), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk6.fused_decompress_field(words, emax, gtops, 8, (16, 8, 4))
    with pytest.raises(ValueError, match="the field needs 2"):
        tk6.fused_decompress_field(words, emax, gtops, 8, (8, 4, 2))
    with pytest.raises(ValueError, match="want a 3-D field"):
        tk6.fused_compress_field(torch.zeros(8, 4), 8)
