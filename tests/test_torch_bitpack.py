"""Twin tests: the port's bit packer against ``repro.core.bitpack``.

The same numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU; every integer output and stream must be equal bit
for bit (uint32 words compared after ``.view(np.uint32)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbp
from repro_torch.core import bitpack as tbp


def _assert_same_stream(pj, pt):
    np.testing.assert_array_equal(np.asarray(pj.words).view(np.uint32), tbp.to_numpy(pt.words))
    np.testing.assert_array_equal(np.asarray(pj.widths), tbp.to_numpy(pt.widths))
    assert int(pj.total_bits) == int(pt.total_bits)
    assert pj.n == pt.n
    assert int(jbp.packed_nbytes(pj)) == int(tbp.packed_nbytes(pt))


def _adversarial_codes() -> np.ndarray:
    """Blocks of every width 0..32 (pinned by one full-width code each) and
    int32 extremes, so block payloads start at every word phase."""
    rng = np.random.default_rng(13)
    blocks = []
    for w in range(33):
        if w == 0:
            blocks.append(np.zeros(tbp.BLOCK, np.int64))
            continue
        u = rng.integers(0, 2**w, size=tbp.BLOCK, dtype=np.uint64)
        u[0] = 2**w - 1
        # un-zigzag so the zigzagged codes have exactly these bit lengths
        blocks.append((u >> 1).astype(np.int64) ^ -(u & 1).astype(np.int64))
    codes = np.concatenate(blocks)
    extremes = np.asarray([0, 1, -1, 2**30, -(2**30), 2**31 - 1, -(2**31)], np.int64)
    return np.concatenate([codes, extremes]).astype(np.int32)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096])
def test_pack_random_codes_matches_reference(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(-(2**20), 2**20, size=n).astype(np.int32)
    pj = jbp.pack_codes(jnp.asarray(codes))
    pt = tbp.pack_codes(torch.from_numpy(codes))
    _assert_same_stream(pj, pt)
    np.testing.assert_array_equal(tbp.unpack_codes(pt).numpy(), codes)


def test_pack_adversarial_widths_and_extremes():
    codes = _adversarial_codes()
    pj = jbp.pack_codes(jnp.asarray(codes))
    pt = tbp.pack_codes(torch.from_numpy(codes))
    np.testing.assert_array_equal(np.asarray(pj.widths)[:33], np.arange(33))
    _assert_same_stream(pj, pt)
    np.testing.assert_array_equal(tbp.unpack_codes(pt).numpy(), codes)


def test_unpack_reads_the_reference_stream():
    codes = _adversarial_codes()
    pj = jbp.pack_codes(jnp.asarray(codes))
    pt = tbp.from_storage(np.asarray(pj.words), np.asarray(pj.widths), pj.n, int(pj.total_bits),
                          device="cpu")
    np.testing.assert_array_equal(tbp.unpack_codes(pt).numpy(), codes)


def test_zigzag_bitlength_code_mask_match_reference():
    v = _adversarial_codes()
    uj = np.asarray(jbp.zigzag(jnp.asarray(v)))
    ut = tbp.zigzag(torch.from_numpy(v))
    np.testing.assert_array_equal(uj.astype(np.int64), ut.numpy())
    np.testing.assert_array_equal(np.asarray(jbp.unzigzag(jnp.asarray(uj))), tbp.unzigzag(ut).numpy())
    np.testing.assert_array_equal(np.asarray(jbp.bitlength(jnp.asarray(uj))), tbp.bitlength(ut).numpy())
    w = np.arange(33, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(jbp.code_mask(jnp.asarray(w))).astype(np.int64),
                                  tbp.code_mask(torch.from_numpy(w)).numpy())


def test_exclusive_cumsum_matches_reference():
    x = np.random.default_rng(3).integers(0, 1000, size=(4, 37)).astype(np.int32)
    for axis in (0, 1):
        np.testing.assert_array_equal(np.asarray(jbp.exclusive_cumsum(jnp.asarray(x), axis=axis)),
                                      tbp.exclusive_cumsum(torch.from_numpy(x), dim=axis).numpy())


def test_compact_streams_with_zero_count_rows():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, size=(9, 16), dtype=np.uint64).astype(np.uint32)
    counts = np.asarray([3, 0, 16, 0, 0, 7, 1, 0, 5], np.int32)
    capacity = int(counts.sum()) + 11
    wj, oj, uj = jbp.compact_streams(jnp.asarray(rows), jnp.asarray(counts), capacity)
    wt, ot, ut = tbp.compact_streams(torch.from_numpy(rows.view(np.int32)).view(torch.uint32),
                                     torch.from_numpy(counts), capacity)
    np.testing.assert_array_equal(np.asarray(wj), tbp.to_numpy(wt))
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    assert int(uj) == int(ut)


def test_storage_round_trip_matches_reference():
    rng = np.random.default_rng(7)
    codes = rng.integers(-100, 100, size=5000).astype(np.int32)
    pj = jbp.pack_codes(jnp.asarray(codes))
    pt = tbp.pack_codes(torch.from_numpy(codes))
    sj, st = jbp.to_storage(pj), tbp.to_storage(pt)
    for key in ("words", "widths", "n"):
        np.testing.assert_array_equal(sj[key], st[key])
    back = tbp.from_storage(st["words"], st["widths"], int(st["n"]), device="cpu")
    _assert_same_stream(pj, back)
    np.testing.assert_array_equal(tbp.unpack_codes(back).numpy(), codes)


def test_pack_refuses_oversized_input_like_reference():
    n = 1 << 26
    with pytest.raises(ValueError) as ej:  # traced on a shape: nothing is allocated
        jax.eval_shape(jbp.pack_codes, jax.ShapeDtypeStruct((n,), jnp.int32))
    with pytest.raises(ValueError) as et:
        tbp.pack_codes(torch.zeros(1, dtype=torch.int32).expand(n))
    assert str(et.value) == str(ej.value)
