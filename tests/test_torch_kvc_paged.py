"""K10's paged entry in the port against the JAX package on the CPU.

The same numpy inputs (a page pool, a page table, per-lane positions) go
through the reference's ``repro.models.layers.cache_codes(cache,
PagedKV(pos, table))`` and ``repro.kernels.ops.kvc_attention`` (the Pallas
kernel in interpret mode, with the GQA codes repeated first, as the
reference's caller does), and through the port's
``repro_torch.kernels.ops.kvc_attention_paged`` on CPU tensors (which runs
the gather and ``ref.kvc_decode_attention_ref``).  Tolerance: rtol 2e-5,
atol 2e-6 in float32, the reference's own (``tests/test_kernels.py:189``);
the bf16 query keeps the reference's 0.02.  The tables hold what the serving
pool gives K10: pages in any order, unmapped entries at the zero page 0, a
page id used twice, and a free lane at -1 whose output is exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch import kernels as tkernels
from repro_torch.kernels import kvc_attention as tkvc
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as tlayers

RTOL, ATOL = 2e-5, 2e-6


def _pool(seed, b, page, max_pages, hkv, n_rep, d):
    """A pool of ``b * max_pages + 2`` pages (page 0 zero, as the serving
    pool keeps it), a permuted table with a repeated id and unmapped tails,
    and positions with lane 0 free and the last lane at full capacity."""
    rng = np.random.default_rng(seed)
    n_pages = b * max_pages + 2
    q = rng.normal(size=(b, hkv * n_rep, d)).astype(np.float32)
    kp = rng.integers(-127, 128, size=(n_pages, page, hkv, d)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(n_pages, page, hkv, d)).astype(np.int8)
    ksp = rng.uniform(1e-3, 2e-2, size=(n_pages, page, hkv)).astype(np.float32)
    vsp = rng.uniform(1e-3, 2e-2, size=(n_pages, page, hkv)).astype(np.float32)
    for a in (kp, vp, ksp, vsp):
        a[0] = 0
    table = (rng.permutation(n_pages - 1)[: b * max_pages] + 1).reshape(b, max_pages)
    table = table.astype(np.int32)
    idx = rng.integers(page, page * max_pages, size=b).astype(np.int32)
    idx[0], idx[-1] = -1, page * max_pages - 1
    if b > 2:
        table[1, 1] = table[1, 0]  # one page read twice
        table[1, idx[1] // page + 1:] = 0  # unmapped past the lane's position
    table[0] = 0  # a free lane maps nothing
    return q, kp, ksp, vp, vsp, table, idx


def _jax(q, kp, ksp, vp, vsp, table, idx, n_rep):
    cache = {"k_codes": jnp.asarray(kp), "k_scale": jnp.asarray(ksp),
             "v_codes": jnp.asarray(vp), "v_scale": jnp.asarray(vsp)}
    codes = jlayers.cache_codes(cache, jlayers.PagedKV(jnp.asarray(idx), jnp.asarray(table)))
    codes = [jnp.repeat(c, n_rep, axis=2) for c in codes]
    return jops.kvc_attention(jnp.asarray(q), *codes, jnp.asarray(idx))


def _port(q, kp, ksp, vp, vsp, table, idx, qdtype=torch.float32):
    q, kp, ksp, vp, vsp, table, idx = (torch.from_numpy(a) for a in (q, kp, ksp, vp, vsp, table,
                                                                       idx))
    return tops.kvc_attention_paged(q.to(qdtype), kp, ksp, vp, vsp, table, idx)


class TestPagedMatchesJax:
    @pytest.mark.parametrize("page,max_pages,hkv,n_rep,d", [
        (8, 8, 2, 1, 16), (16, 4, 2, 2, 64), (16, 8, 1, 12, 128), (8, 12, 2, 12, 64),
        (16, 6, 2, 2, 128), (8, 16, 1, 1, 64)])
    def test_f32_query(self, page, max_pages, hkv, n_rep, d):
        arrs = _pool(page * 131 + n_rep * 7 + d, 3, page, max_pages, hkv, n_rep, d)
        got = _port(*arrs)
        want = np.asarray(_jax(*arrs, n_rep))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        assert torch.equal(got[0], torch.zeros_like(got[0]))

    @pytest.mark.parametrize("page,n_rep,d", [(16, 12, 128), (8, 2, 16)])
    def test_bf16_query(self, page, n_rep, d):
        q, *rest = _pool(5 + d, 3, page, 64 // page, 2, n_rep, d)
        got = _port(q, *rest, qdtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        q_bf = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
        want = np.asarray(_jax(q_bf, *rest, n_rep))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.02, atol=0.02)
        assert torch.equal(got[0], torch.zeros_like(got[0]))


class TestPagedSemantics:
    def test_equals_the_dense_entry_on_the_gathered_cache(self):
        """The paged entry is the dense one on ``cache_codes``' gathered view,
        bit for bit on the CPU."""
        q, kp, ksp, vp, vsp, table, idx = _pool(11, 4, 16, 5, 2, 12, 128)
        got = _port(q, kp, ksp, vp, vsp, table, idx)
        cache = {"k_codes": torch.from_numpy(kp), "k_scale": torch.from_numpy(ksp),
                 "v_codes": torch.from_numpy(vp), "v_scale": torch.from_numpy(vsp)}
        codes = tlayers.cache_codes(cache, tlayers.PagedKV(torch.from_numpy(idx),
                                                           torch.from_numpy(table)))
        assert torch.equal(got, tops.kvc_attention(torch.from_numpy(q), *codes,
                                                   torch.from_numpy(idx)))

    def test_stale_pages_and_the_zero_page_do_not_leak(self):
        """Pages no lane maps, and rows past a lane's position in its last
        page, change nothing; a free lane stays exactly 0 whatever page 0
        holds."""
        q, kp, ksp, vp, vsp, table, idx = _pool(12, 3, 8, 6, 2, 2, 64)
        out1 = _port(q, kp, ksp, vp, vsp, table, idx)
        mapped = np.zeros(kp.shape[0], bool)
        for b in range(1, 3):
            mapped[table[b, : idx[b] // 8 + 1]] = True
        kp2, vp2, ksp2 = kp.copy(), vp.copy(), ksp.copy()
        kp2[~mapped], vp2[~mapped], ksp2[~mapped] = 99, -99, 7.0
        last = table[1, idx[1] // 8]
        if table[1].tolist().count(last) == 1:  # its rows past idx[1] belong to no earlier slot
            kp2[last, idx[1] % 8 + 1:] = 77
        out2 = _port(q, kp2, ksp2, vp2, vsp, table, idx)
        assert torch.equal(out1, out2)
        assert torch.equal(out2[0], torch.zeros_like(out2[0]))

    def test_plain_version_counts_no_launch(self):
        tkernels.reset_launch_counts()
        _port(*_pool(13, 2, 8, 4, 1, 2, 16))
        assert tkernels.launch_counts()["kvc_decode_attention"] == 0


@pytest.mark.parametrize("b,hkv,page,max_pages", [(8, 2, 16, 128), (8, 2, 16, 2048),
                                                  (3, 1, 8, 5), (64, 8, 16, 32)])
def test_split_plan_covers_paged_capacity_in_whole_tiles(b, hkv, page, max_pages):
    """The paged entry splits the capacity max_pages * page as the dense
    entry splits S: whole tiles, every position covered, a block per SM
    where the tiles allow."""
    cap = page * max_pages
    splits, chunk = tkvc.split_plan(b, hkv, cap, 132)
    assert chunk % tkvc.TILE == 0 and splits * chunk >= cap > (splits - 1) * chunk
    assert b * hkv * splits >= min(132, b * hkv * -(-cap // tkvc.TILE))
