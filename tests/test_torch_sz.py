"""Twin tests: the port's TPU-SZ core (``repro_torch.core.sz`` and
``transforms``) against ``repro.core.sz`` on the CPU.

ABS mode: streams, ``eb_i`` bits, ``nbytes`` and reconstructions are equal
bit for bit (the dequantize is one f32 multiply).  PW_REL: ``torch.log`` and
``torch.exp`` may differ from XLA's by an ulp, so the port is held to the
reference's own bound (``|x̂/x - 1| <= pw * 1.05`` on non-zeros, exact zeros
kept) and its size to within 0.5% of the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sz as jsz
from repro.core.api import get_compressor as jax_compressor
from repro_torch.core import sz as tsz
from repro_torch.core import transforms as ttr
from repro_torch.core.api import get_compressor as torch_compressor
from repro_torch.data import cosmo


def _smooth_field(shape, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    for ax in range(len(shape)):
        f = np.cumsum(f, axis=ax)
    return (f * scale / max(np.abs(f).max(), 1e-9)).astype(np.float32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _assert_same_compressed(cj, ct):
    np.testing.assert_array_equal(np.asarray(cj.packed.words), _u32(ct.packed.words))
    np.testing.assert_array_equal(np.asarray(cj.packed.widths), ct.packed.widths.numpy())
    assert int(cj.packed.total_bits) == int(ct.packed.total_bits)
    np.testing.assert_array_equal(np.asarray(cj.eb).view(np.uint32), ct.eb.numpy().view(np.uint32))
    assert tuple(cj.shape) == ct.shape and cj.block_size == ct.block_size


@pytest.mark.parametrize("shape", [(1000,), (48, 40), (24, 20, 28)])
@pytest.mark.parametrize("block_size", [None, 8])
@pytest.mark.parametrize("eb", [1e-1, 1e-3])
def test_compress_decompress_match_reference(shape, block_size, eb):
    x = _smooth_field(shape, seed=sum(shape))
    cj = jsz.compress(jnp.asarray(x), eb, block_size=block_size)
    ct = tsz.compress(torch.from_numpy(x), eb, block_size=block_size)
    _assert_same_compressed(cj, ct)
    assert int(jsz.compressed_nbytes(cj)) == int(tsz.compressed_nbytes(ct))
    xr = tsz.decompress(ct).numpy()
    np.testing.assert_array_equal(np.asarray(jsz.decompress(cj)).view(np.uint32), xr.view(np.uint32))
    assert np.abs(xr - x).max() <= eb * (1 + 1e-5)


def test_lorenzo_residual_reconstruct_wrap_like_int32():
    """Residuals of int32 extremes overflow: both sides wrap mod 2**32 and
    the prefix sums undo it exactly."""
    rng = np.random.default_rng(0)
    q = rng.integers(-(2**31), 2**31, size=(9, 7, 11), dtype=np.int64).astype(np.int32)
    dj = np.asarray(jsz.lorenzo_residual(jnp.asarray(q)))
    dt = tsz.lorenzo_residual(torch.from_numpy(q))
    np.testing.assert_array_equal(dj, dt.numpy())
    np.testing.assert_array_equal(tsz.lorenzo_reconstruct(dt).numpy(), q)
    np.testing.assert_array_equal(np.asarray(jsz.lorenzo_reconstruct(jnp.asarray(dj))),
                                  tsz.lorenzo_reconstruct(dt).numpy())


@pytest.mark.parametrize("eb", [1e-6, 1e-3, 0.5, 10.0, 3e4])
def test_internal_bound_bit_exact(eb):
    absmax = np.asarray([0.0, 1.0, 123.456, 1e5, 1e8, 3.3e38], np.float32)
    for a in absmax:
        bj = np.asarray(jsz.internal_bound(jnp.float32(a), eb))
        bt = tsz.internal_bound(torch.tensor(a, dtype=torch.float32), eb).numpy()
        assert bj.view(np.uint32) == bt.view(np.uint32), (a, eb)


def test_from_stream_rebuilds_the_reference_stream():
    x = _smooth_field((16, 16, 16), seed=4)
    cj = jsz.compress(jnp.asarray(x), 1e-2)
    bits = int(cj.packed.total_bits)
    n_words = (bits - cj.packed.widths.shape[0] * 8 + 31) // 32
    ct = tsz.from_stream(np.asarray(cj.packed.words)[:n_words], np.asarray(cj.packed.widths),
                         cj.packed.n, np.asarray(cj.eb), cj.shape, total_bits=bits,
                         device="cpu")
    _assert_same_compressed(cj, ct)
    np.testing.assert_array_equal(np.asarray(jsz.decompress(cj)), tsz.decompress(ct).numpy())


def test_hacc_1d_route_matches_reference():
    """Paper §IV-B4 dimension conversion on HACC particles: 1-D -> 3-D
    partition -> compress -> back, through both registries."""
    x = cosmo.hacc_particles(grid=16).fields["x"]
    eb = 0.005
    rj = jax_compressor("tpu-sz").compress(jnp.asarray(x), eb=eb)
    comp = torch_compressor("tpu-sz", device="cpu")
    rt = comp.compress(x, eb=eb)
    assert rt.meta == rj.meta and rt.nbytes == rj.nbytes and rt.ratio == rj.ratio
    assert len(rt.payload["parts"]) == len(rj.payload["parts"]) == 1
    _assert_same_compressed(rj.payload["parts"][0], rt.payload["parts"][0])
    xr = comp.decompress(rt).numpy()
    assert xr.shape == x.shape
    np.testing.assert_array_equal(np.asarray(jax_compressor("tpu-sz").decompress(rj)), xr)
    assert np.abs(xr - x).max() <= eb * (1 + 1e-5)


@pytest.mark.parametrize("shape", [(4096,), (16, 64, 128)])
@pytest.mark.parametrize("backend", ["core", "kernel"])
def test_pw_rel_within_bound_and_size(shape, backend):
    rng = np.random.default_rng(3)
    n = int(np.prod(shape))
    x = np.asarray(rng.normal(size=n) * np.exp(rng.uniform(0, 8, n)), np.float32).reshape(shape)
    x.reshape(-1)[::97] = 0.0  # exact zeros must survive the sign channel
    for pw in (0.1, 0.01):
        rj = jax_compressor("tpu-sz", backend=backend).compress(jnp.asarray(x), pw_rel=pw)
        comp = torch_compressor("tpu-sz", backend=backend, device="cpu")
        rt = comp.compress(x, pw_rel=pw)
        xr = comp.decompress(rt).numpy()
        nz = x != 0
        assert np.abs(xr[nz] / x[nz] - 1.0).max() <= pw * (1 + 0.05)
        assert (xr[~nz] == 0).all()
        assert abs(rt.nbytes - rj.nbytes) <= 0.005 * rj.nbytes
        assert rt.meta == rj.meta


def test_transforms_match_reference():
    from repro.core import transforms as jtr

    x = np.asarray(np.random.default_rng(8).normal(size=1000), np.float32)
    x[::7] = 0.0
    tj, tt = jtr.log_forward(jnp.asarray(x)), ttr.log_forward(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(tj.signs), tt.signs.numpy())
    # torch.log and XLA's log may differ by one ulp
    np.testing.assert_array_max_ulp(np.asarray(tj.logs), tt.logs.numpy(), maxulp=1)
    assert ttr.pwrel_to_abs(0.01) == jtr.pwrel_to_abs(0.01)
    np.testing.assert_array_equal(np.asarray(jtr.to_3d(jnp.asarray(x), (4, 16, 16))),
                                  ttr.to_3d(torch.from_numpy(x), (4, 16, 16)).numpy())
    parts_j = jtr.partition_1d(jnp.asarray(x), 300)
    parts_t = ttr.partition_1d(torch.from_numpy(x), 300)
    assert [p.shape[0] for p in parts_j] == [p.shape[0] for p in parts_t] == [300, 300, 300, 100]
    with pytest.raises(ValueError, match="exceeds partition"):
        ttr.to_3d(torch.from_numpy(x), (2, 2, 2))
