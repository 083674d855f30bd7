"""Twin tests of the SZ stream-level functions, whose CUDA kernels (K3, K4,
K8, K9) take and return the dense stream: their plain versions (what the
wrappers run on a CPU tensor) against the JAX package's ``fused_compress``,
``fused_decompress``, ``fused_compress_batched`` and
``fused_decompress_batched``, run in interpret mode as
``repro.kernels.default_interpret`` chooses off-TPU.

Equal bit for bit: the words with their zero tail, the widths,
``total_bits``, the batched offsets, counts and used, and every
reconstruction, on the hard cases of ``repro_torch.data.sz_cases`` (every
block at width 0; every block at width 32 from +-3e38, NaN and +inf through
the saturating conversion; a ragged padded field; values whose quantized
value leaves the int32 range) and on batches whose rows differ in ratio by
more than 4x.  ``test_torch_cuda.py`` holds the card's kernels to these
plain versions on the same cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sz_fused as jszf
from repro_torch.core import bitpack as tbp
from repro_torch.data import sz_cases
from repro_torch.kernels import sz_fused as tszf

CASES = sz_cases.cases()


def _np(a) -> np.ndarray:
    return tbp.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b) -> None:
    """Equal integers, or float32 equal bit for bit."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b.astype(a.dtype))


def _ref_compress(x: torch.Tensor, eb_i: torch.Tensor):
    return jszf.fused_compress(jnp.asarray(x.numpy()), jnp.float32(eb_i.item()))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_plain_matches_reference(case):
    """``fused_compress_plain`` is the reference's stream word for word, the
    zero tail past the payload included, and ``fused_compress`` on a CPU
    tensor is that plain version."""
    x, eb_i = CASES[case]
    pj = _ref_compress(x, eb_i)
    pt = tszf.fused_compress_plain(x, eb_i)
    assert pt.words.dtype == torch.uint32 and pt.words.shape == (x.numel() + 2,)
    assert pt.widths.dtype == torch.uint8 and pt.total_bits.dtype == torch.int64
    _same(pj.words, pt.words)
    _same(pj.widths, pt.widths)
    assert int(pj.total_bits) == int(pt.total_bits) and pj.n == pt.n
    used = 2 * int(pt.widths.to(torch.int64).sum())
    assert not _np(pt.words)[used:].any()
    pw = tszf.fused_compress(x, eb_i)
    _same(pw.words, pt.words)
    _same(pw.widths, pt.widths)
    assert int(pw.total_bits) == int(pt.total_bits)


@pytest.mark.parametrize("case", list(CASES))
def test_stream_decode_plain_matches_reference(case):
    """``fused_decompress_plain`` reconstructs the reference's field bit for
    bit from the same stream."""
    x, eb_i = CASES[case]
    pj = _ref_compress(x, eb_i)
    pt = tszf.fused_compress_plain(x, eb_i)
    rj = jszf.fused_decompress(pj, tuple(x.shape), jnp.float32(eb_i.item()))
    rt = tszf.fused_decompress_plain(pt, tuple(x.shape), eb_i)
    _same(rj, rt)
    _same(rt, tszf.fused_decompress(pt, tuple(x.shape), eb_i))


def test_hard_cases_reach_their_widths():
    """The cases are what they claim: every block at width 0, every block
    at width 32, and a padded ragged field with its padding."""
    assert not tszf.fused_compress_plain(*CASES["zero"]).widths.any()
    assert bool((tszf.fused_compress_plain(*CASES["full_width"]).widths == 32).all())
    assert tuple(CASES["ragged"][0].shape) == (16, 128, 256)
    assert not CASES["ragged"][0][10:].any() and not CASES["ragged"][0][:, 70:].any()


def _batches():
    x, eb = sz_cases.rows()
    edge = torch.stack([torch.zeros(16, 64, 128), CASES["full_width"][0].repeat(2, 1, 1), x[0]])
    return {"rows": (x, eb), "width 0, 32 and mixed": (edge, torch.tensor([1e-2, 1.0, 0.5]))}


@pytest.mark.parametrize("case", list(_batches()))
def test_batched_stream_plain_matches_reference(case):
    """``fused_compress_batched_plain`` gives the reference's arena (zero
    tail included), widths, offsets, counts, total_bits and used, and
    ``fused_decompress_batched_plain`` its rows, bit for bit."""
    x, eb = _batches()[case]
    jo = jszf.fused_compress_batched(jnp.asarray(x.numpy()), jnp.asarray(eb.numpy()))
    to = tszf.fused_compress_batched_plain(x, eb)
    for a, b in zip(jo, to):
        _same(a, b)
    assert not _np(to[0])[int(to[5]):].any()
    for a, b in zip(to, tszf.fused_compress_batched(x, eb)):
        _same(a, b)
    shape = tuple(x.shape[1:])
    jy = jszf.fused_decompress_batched(jo[0], jo[1], shape, jnp.asarray(eb.numpy()))
    ty = tszf.fused_decompress_batched_plain(to[0], to[1], shape, eb)
    _same(jy, ty)
    _same(ty, tszf.fused_decompress_batched(to[0], to[1], shape, eb))


def test_batch_rows_differ_in_ratio_by_more_than_4x():
    """The row offsets of ``sz_cases.rows()`` are arbitrary: the rows'
    compression ratios are more than 4x apart, and each row's arena slice is
    its one-field stream."""
    x, eb = sz_cases.rows()
    arena, widths, offsets, counts, total_bits, used = tszf.fused_compress_batched_plain(x, eb)
    ratios = 32 * x[0].numel() / total_bits.double()
    assert float(ratios.max() / ratios.min()) > 4
    pos = 0
    for b in range(x.shape[0]):
        ref = tbp.to_storage(tszf.fused_compress_plain(x[b], eb[b]))
        assert int(offsets[b]) == pos and int(counts[b]) == len(ref["words"])
        np.testing.assert_array_equal(_np(arena[pos:pos + len(ref["words"])]), ref["words"])
        pos += len(ref["words"])
    assert int(used) == pos
