"""Twin tests of the SZ kernels (K1-K4) and ``ops``: the port's plain
versions (what its wrappers run on a CPU tensor) against the JAX package's
Pallas kernels, run in interpret mode as ``repro.kernels.default_interpret``
chooses off-TPU.  Every integer output, stream and reconstruction is equal
bit for bit.

The hand-written CUDA kernels themselves run only on a card:
``test_torch_cuda.py`` holds each against its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lorenzo3d as jlor
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sz_fused as jszf
from repro_torch.core import bitpack as tbp
from repro_torch.data import cosmo
from repro_torch.kernels import lorenzo3d as tlor
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sz_fused as tszf

SHAPES = [(8, 64, 128), (16, 64, 128), (8, 128, 256), (24, 192, 128)]  # TestLorenzo3D's


def _field(shape, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    for ax in range(len(shape)):
        f = np.cumsum(f, axis=ax)
    return (f * scale / max(np.abs(f).max(), 1e-9)).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same_stream(pj, pt):
    np.testing.assert_array_equal(np.asarray(pj.words), tbp.to_numpy(pt.words))
    np.testing.assert_array_equal(np.asarray(pj.widths), tbp.to_numpy(pt.widths))
    assert int(pj.total_bits) == int(pt.total_bits) and pj.n == pt.n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eb", [1e-1, 1e-3])
def test_k1_k2_plain_match_lorenzo3d(shape, eb):
    x = _field(shape, seed=sum(shape))
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ebj, ebt = jlor.guarded_eb(xj, eb), tlor.guarded_eb(xt, eb)
    np.testing.assert_array_equal(_bits(ebj), _bits(ebt.numpy()))
    dj = jlor.lorenzo3d_quantize(xj, ebj)
    dt = tlor.lorenzo3d_quantize(xt, ebt)
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(tref.lorenzo3d_quantize_ref(xt, eb).numpy(),
                                  np.asarray(jref.lorenzo3d_quantize_ref(xj, eb)))
    rj = jlor.lorenzo3d_reconstruct(dj, ebj)
    rt = tlor.lorenzo3d_reconstruct(dt, ebt)
    np.testing.assert_array_equal(_bits(rj), _bits(rt.numpy()))
    np.testing.assert_array_equal(_bits(tref.lorenzo3d_reconstruct_ref(dt, ebt).numpy()),
                                  _bits(rt.numpy()))
    assert np.abs(rt.numpy() - x).max() <= eb * (1 + 1e-5)


def test_k2_wraps_like_int32():
    """Residuals whose prefix sums overflow int32 reconstruct as the
    reference's wrapping cumsum does."""
    rng = np.random.default_rng(2)
    d = rng.integers(-(2**31), 2**31, size=(8, 64, 128), dtype=np.int64).astype(np.int32)
    ebj = jnp.float32(0.25)
    rj = jlor.lorenzo3d_reconstruct(jnp.asarray(d), ebj)
    rt = tlor.lorenzo3d_reconstruct(torch.from_numpy(d), torch.tensor(0.25))
    np.testing.assert_array_equal(_bits(rj), _bits(rt.numpy()))


def _pad_tile(a: np.ndarray) -> np.ndarray:
    return np.pad(a, [(0, (-s) % t) for s, t in zip(a.shape, tlor.TILE)])


def _k3_k4_inputs():
    """TILE-padded inputs, as ``ops`` hands them to the kernels."""
    nyx = cosmo.nyx_fields(n=64)
    return {"nyx baryon_density": (_pad_tile(nyx["baryon_density"]), 20.0),
            "nyx vx": (_pad_tile(nyx["vx"]), 1e4),
            "ragged (10,70,130)": (_pad_tile(_field((10, 70, 130), seed=11)), 1e-2)}


@pytest.mark.parametrize("case", list(_k3_k4_inputs()))
def test_k3_k4_plain_match_sz_fused(case):
    x, eb = _k3_k4_inputs()[case]
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ebj, ebt = jlor.guarded_eb(xj, eb), tlor.guarded_eb(xt, eb)
    # the Pallas K3's rows and widths (what the plain version builds the stream from)
    wj, widj = jszf._fused_encode(xj, ebj)
    wt, widt = tszf.fused_encode_plain(xt, ebt)
    np.testing.assert_array_equal(np.asarray(wj), tbp.to_numpy(wt))
    np.testing.assert_array_equal(np.asarray(widj), widt.numpy())
    # K3 + stream assembly, then disassembly + K4
    pj = jszf.fused_compress(xj, ebj)
    pt = tszf.fused_compress(xt, ebt)
    _assert_same_stream(pj, pt)
    bj, bwj = jszf._disassemble_stream(pj)
    bt, bwt = tszf._disassemble(pt.words, pt.widths)
    np.testing.assert_array_equal(np.asarray(bj), tbp.to_numpy(bt))
    np.testing.assert_array_equal(np.asarray(bwj), bwt.numpy())
    rj = jszf.fused_decompress(pj, x.shape, ebj)
    rt = tszf.fused_decompress(pt, x.shape, ebt)
    np.testing.assert_array_equal(_bits(rj), _bits(rt.numpy()))


def test_pack_unpack_blocks_adversarial():
    """The block packer across widths 0..32 agrees with the reference's and
    round-trips; payload words beyond 2*w are zero."""
    rng = np.random.default_rng(5)
    nb = 40
    codes = np.zeros((nb, tbp.BLOCK), np.uint32)
    for b in range(nb):
        w = b % 33
        if w:
            codes[b] = rng.integers(0, 2**w, size=tbp.BLOCK, dtype=np.uint64)
            codes[b, 0] = 2**w - 1
    uj = jnp.asarray(codes)
    width_j = jnp.max(jszf.bitpack.bitlength(uj), axis=1)
    ut = tbp.u32_to_i64(torch.from_numpy(codes.view(np.int32)))
    width_t = tbp.bitlength(ut).amax(dim=1)
    np.testing.assert_array_equal(np.asarray(width_j), width_t.numpy())
    words_t = tszf._pack_blocks(ut, width_t)
    np.testing.assert_array_equal(np.asarray(jszf._pack_blocks(uj, width_j)), tbp.to_numpy(words_t))
    np.testing.assert_array_equal(tszf._unpack_blocks(words_t, width_t).numpy(), codes)
    j = np.arange(tszf.WORDS_PER_BLOCK)[None, :]
    np.testing.assert_array_equal(tbp.to_numpy(words_t) * (j >= 2 * width_t.numpy()[:, None]), 0)


def test_tile_major_flatten_matches_reference():
    a = np.arange(16 * 128 * 256, dtype=np.int32).reshape(16, 128, 256)
    ft = tszf.tile_major_flatten(torch.from_numpy(a))
    np.testing.assert_array_equal(np.asarray(jszf.tile_major_flatten(jnp.asarray(a))), ft.numpy())
    np.testing.assert_array_equal(tszf.tile_major_unflatten(ft, a.shape).numpy(), a)


@pytest.mark.parametrize("shape", [(10, 70, 130), (16, 64, 128)])
def test_ops_paths_agree_with_each_other_and_reference(shape):
    """``fused`` and ``xla`` give the same stream as the reference's ``ops``,
    and either decoder reads it; padding is cropped."""
    x = _field(shape, seed=5)
    eb = 1e-2
    pj, pad_j, ebj = jops.sz_compress_kernel(jnp.asarray(x), eb, path="xla")
    rj = jops.sz_decompress_kernel(pj, pad_j, x.shape, ebj, path="xla")
    for path in ("fused", "xla"):
        pt, pad_t, ebt = tops.sz_compress_kernel(torch.from_numpy(x), eb, path=path)
        assert pad_t == tuple(pad_j)
        np.testing.assert_array_equal(_bits(ebj), _bits(ebt.numpy()))
        _assert_same_stream(pj, pt)
        for dpath in ("fused", "xla"):
            rt = tops.sz_decompress_kernel(pt, pad_t, x.shape, ebt, path=dpath)
            assert tuple(rt.shape) == x.shape
            np.testing.assert_array_equal(_bits(rj), _bits(rt.numpy()))
    assert np.abs(np.asarray(rj) - x).max() <= eb * (1 + 1e-5)


def test_ops_eb_i_override_and_path_validation():
    x = torch.from_numpy(_field((8, 64, 128), seed=7))
    eb_i = torch.tensor(0.01, dtype=torch.float32)
    packed, _, used = tops.sz_compress_kernel(x, 123.0, eb_i=eb_i)
    assert used.item() == eb_i.item()
    np.testing.assert_array_equal(
        tbp.to_numpy(packed.words),
        tbp.to_numpy(tbp.pack_codes(tszf.tile_major_flatten(tlor.lorenzo3d_quantize(x, eb_i))).words))
    with pytest.raises(ValueError, match="unknown SZ kernel path"):
        tops.sz_compress_kernel(x, 1.0, path="gpu")


def test_fused_compress_refuses_oversized_field_like_reference():
    shape = (512, 512, 512)
    with pytest.raises(ValueError) as ej:  # traced on a shape: nothing is allocated
        jax.eval_shape(lambda a: jszf.fused_compress(a, jnp.float32(1.0)),
                       jax.ShapeDtypeStruct(shape, jnp.float32))
    with pytest.raises(ValueError) as et:
        tops.sz_compress_kernel(torch.zeros(1).expand(*shape), 1.0, path="fused")
    assert str(et.value) == str(ej.value)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel route, which refuses what is not a CUDA tensor."""
    x = torch.empty(8, 64, 128, device="meta")
    eb = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tlor.lorenzo3d_quantize(x, eb)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tszf.fused_compress(x, eb)


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.core.api import get_compressor
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_compressor("tpu-sz")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
