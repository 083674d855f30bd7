"""K10's plain version in the port against the JAX package on the CPU.

The same numpy inputs go through ``repro.kernels.ops.kvc_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it),
``repro.kernels.ref.kvc_decode_attention_ref`` and the port's
``repro_torch.kernels.ops.kvc_attention`` on CPU tensors (which runs
``repro_torch.kernels.ref.kvc_decode_attention_ref``).  Tolerance: rtol 2e-5,
atol 2e-6 in float32, the reference's own (``tests/test_kernels.py:189``);
the bf16 case keeps the reference's 0.02.  The port also takes the cache's
un-repeated GQA codes (Hkv heads, n_rep = H / Hkv), which must give the
repeated result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as tkernels
from repro_torch.kernels import kvc_attention as tkvc
from repro_torch.kernels import ops as tops

RTOL, ATOL = 2e-5, 2e-6


def _inputs(seed, b, s, h, d, hkv=None, scale_hi=2e-2):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kc = rng.integers(-127, 128, size=(b, s, hkv, d)).astype(np.int8)
    vc = rng.integers(-127, 128, size=(b, s, hkv, d)).astype(np.int8)
    ks = rng.uniform(1e-3, scale_hi, size=(b, s, hkv)).astype(np.float32)
    vs = rng.uniform(1e-3, scale_hi, size=(b, s, hkv)).astype(np.float32)
    return q, kc, ks, vc, vs


def _jax(fn, arrs, idx):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrs), jnp.asarray(idx)))


def _port(arrs, idx, qdtype=torch.float32):
    q, kc, ks, vc, vs = (torch.from_numpy(a) for a in arrs)
    return tops.kvc_attention(q.to(qdtype), kc, ks, vc, vs, torch.as_tensor(idx))


class TestKVCAttention:
    @pytest.mark.parametrize("b,s,h,d", [(1, 128, 4, 64), (2, 256, 8, 64), (2, 384, 2, 128)])
    def test_matches_jax(self, b, s, h, d):
        arrs = _inputs(b * s, b, s, h, d)
        idx = np.int32(s - 5)
        got = _port(arrs, idx).numpy()
        np.testing.assert_allclose(got, _jax(jops.kvc_attention, arrs, idx), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, _jax(jref.kvc_decode_attention_ref, arrs, idx),
                                   rtol=RTOL, atol=ATOL)

    def test_ragged_length_needs_no_padding(self):
        """Any S: the reference pads to its 128-row chunk; the port does not."""
        arrs = _inputs(3, 2, 200, 4, 64)
        idx = np.asarray([199, 57], np.int32)
        got = _port(arrs, idx).numpy()
        np.testing.assert_allclose(got, _jax(jops.kvc_attention, arrs, idx), rtol=RTOL, atol=ATOL)

    def test_mask_respects_index(self):
        """Tokens beyond `index` must not affect the output."""
        q, kc, ks, vc, vs = _inputs(0, 1, 256, 4, 64, scale_hi=1e-2)
        out1 = _port((q, kc, ks, vc, vs), np.int32(100))
        kc2 = kc.copy()
        kc2[:, 150:] = 99
        out2 = _port((q, kc2, ks, vc, vs), np.int32(100))
        np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)

    def test_bf16_query(self):
        arrs = _inputs(1, 1, 128, 4, 64, scale_hi=1e-2)
        q32 = arrs[0]
        got = _port(arrs, np.int32(60), qdtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        jarrs = (jnp.asarray(q32).astype(jnp.bfloat16),) + tuple(jnp.asarray(a) for a in arrs[1:])
        want = np.asarray(jops.kvc_attention(*jarrs, jnp.int32(60)), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.02, atol=0.02)
        # the f32 computation on the bf16 query, cast once at the end
        q_bf = torch.from_numpy(q32).to(torch.bfloat16).float().numpy()
        want32 = _port((q_bf,) + arrs[1:], np.int32(60)).to(torch.bfloat16)
        assert torch.equal(got, want32)


class TestKVCAttentionVectorIndex:
    """Per-slot (B,) lengths (continuous batching): each lane masks at its
    own position, and lane -1 (free slot) attends over nothing."""

    def test_vector_matches_per_row_scalar(self):
        arrs = _inputs(7, 4, 256, 4, 64)
        lens = np.asarray([3, 100, 251, 17], np.int32)
        got = _port(arrs, lens).numpy()
        np.testing.assert_allclose(got, _jax(jops.kvc_attention, arrs, lens), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, _jax(jref.kvc_decode_attention_ref, arrs, lens),
                                   rtol=RTOL, atol=ATOL)
        for i, n in enumerate(lens):  # stitch scalar rows
            row = _port(tuple(a[i:i + 1] for a in arrs), np.int32(n)).numpy()
            np.testing.assert_allclose(got[i:i + 1], row, rtol=RTOL, atol=ATOL)

    def test_dead_lane_is_exactly_zero_and_ignores_cache(self):
        """index -1: the lane's output is exactly 0 whatever the cache holds,
        and the live lane does not see the dead lane's rows."""
        q, kc, ks, vc, vs = _inputs(9, 2, 128, 4, 64, scale_hi=1e-2)
        lens = np.asarray([-1, 64], np.int32)
        out1 = _port((q, kc, ks, vc, vs), lens)
        kc2, vc2 = kc.copy(), vc.copy()
        kc2[0], vc2[0] = 99, -99
        out2 = _port((q, kc2, ks, vc2, vs), lens)
        assert torch.equal(out1[0], torch.zeros_like(out1[0]))
        assert torch.equal(out2[0], torch.zeros_like(out2[0]))
        np.testing.assert_allclose(out1[1].numpy(), out2[1].numpy(), rtol=1e-6)
        np.testing.assert_allclose(out1.numpy(), _jax(jops.kvc_attention, (q, kc, ks, vc, vs), lens),
                                   rtol=RTOL, atol=ATOL)


class TestGQAUnrepeated:
    """The port's caller passes (B, S, Hkv, D) codes; they must give what
    the reference's caller gets by repeating them n_rep times first."""

    @pytest.mark.parametrize("h,hkv,d", [(24, 2, 128), (4, 2, 16), (8, 1, 64)])
    def test_unrepeated_equals_repeated(self, h, hkv, d):
        n_rep = h // hkv
        q, kc, ks, vc, vs = _inputs(h * 31 + d, 3, 160, h, d, hkv=hkv)
        lens = np.asarray([159, -1, 40], np.int32)
        rep = (q, np.repeat(kc, n_rep, axis=2), np.repeat(ks, n_rep, axis=2),
               np.repeat(vc, n_rep, axis=2), np.repeat(vs, n_rep, axis=2))
        got = _port((q, kc, ks, vc, vs), lens)
        assert torch.equal(got, _port(rep, lens))
        np.testing.assert_allclose(got.numpy(), _jax(jref.kvc_decode_attention_ref, rep, lens),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(got[1], torch.zeros_like(got[1]))


class TestWrapperOnTheCPU:
    def test_plain_version_counts_no_launch(self):
        tkernels.reset_launch_counts()
        _port(_inputs(2, 1, 64, 2, 16), np.int32(10))
        assert tkernels.launch_counts()["kvc_decode_attention"] == 0

    @pytest.mark.parametrize("b,hkv,s", [(8, 2, 2048), (8, 2, 32768), (1, 1, 64),
                                         (2, 4, 130), (64, 8, 512)])
    def test_split_plan_covers_s_in_whole_tiles(self, b, hkv, s):
        splits, chunk = tkvc.split_plan(b, hkv, s, 132)
        assert chunk % tkvc.TILE == 0 and splits * chunk >= s > (splits - 1) * chunk
        # at least one block per SM where S has the tiles for it
        assert b * hkv * splits >= min(132, b * hkv * -(-s // tkvc.TILE))
