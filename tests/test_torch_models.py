"""The port's dense model family against the JAX package on the CPU.

One parameter tree is drawn by the reference (``repro.models.spec``) and
carried across with ``params_from_jax``; inputs come from numpy seeds.  At
``cfg.scaled(dtype="float32")`` the logits of ``forward``, ``prefill`` and
``decode_step`` (dense and paged caches, codec none and blockfloat8,
attention ``xla`` and ``fused``) agree within rtol 1e-4 (atol 1e-5).  Cache
leaves: blockfloat8 codes bit for bit after prefill; the scales, which
divide a K/V row's max by 127, within rtol 4e-6 (the K/V projections are
matrix products that XLA and PyTorch sum in another order); fed the same
K/V, the codec and the cache writes are bit for bit.  In bfloat16 (the
configs' own dtype) greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import spec as jspec
from repro.models import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL
from repro_torch.models import spec as tspec
from repro_torch.models import transformer as ttr
from repro_torch.models.interop import params_from_jax

ARCHS = ("starcoder2-3b", "minicpm-2b")
RTOL, ATOL = 1e-4, 1e-5  # logits are of order 0.1-1


def _np(x):
    return np.asarray(x, np.float32) if x.dtype != np.int8 else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, jax model, jax params, port model, port params) in float32."""
    cfg = jreg.get_config(request.param, smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(request.param, smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return request.param, jm, jp, tm, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


# --------------------------------------------------------------- model ----


def test_forward_logits(pair):
    arch, jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg, 2, 16, 1)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    got = tm.forward(tp, _t(toks)).numpy()
    assert got.shape == (2, 16, jm.cfg.padded_vocab)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_loss(pair):
    arch, jm, jp, tm, tp = pair
    toks, labels = _tokens(jm.cfg, 2, 12, 2), _tokens(jm.cfg, 2, 12, 3)
    want = float(jm.loss(jp, jnp.asarray(toks), jnp.asarray(labels)))
    got = float(tm.loss(tp, _t(toks), _t(labels)))
    assert got == pytest.approx(want, rel=RTOL)


def _paged_index(b, start, max_pages, pages_of):
    table = np.zeros((b, max_pages), np.int32)
    for lane, pages in pages_of.items():
        table[lane, :len(pages)] = pages
    return (JL.PagedKV(jnp.asarray(start), jnp.asarray(table)),
            TL.PagedKV(_t(start), _t(table)))


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits(pair, codec, paged):
    """A chunked prefill of two lanes (one padded), then two decode steps
    with a free lane, over dense and paged caches; attention ``xla`` and
    ``fused`` (K10's plain version) in the port."""
    arch, jm, jp, tm, tp = pair
    b, t, page, max_pages = 3, 16, 8, 4
    toks = _tokens(jm.cfg, b, t, 4)
    length = np.asarray([10, 16, 0], np.int32)
    start = np.asarray([0, 0, -1], np.int32)
    jc_codec, tc_codec = JL.KVCodecConfig(codec), TL.KVCodecConfig(codec)
    if paged:
        jcache, tcache = jm.init_cache(10, page, jc_codec), tm.init_cache(10, page, tc_codec)
        pages_of = {0: [3, 7, 1], 1: [2, 9, 5, 4]}

        def index(pos):
            return _paged_index(b, pos, max_pages, pages_of)
    else:
        jcache, tcache = jm.init_cache(b, 32, jc_codec), tm.init_cache(b, 32, tc_codec)

        def index(pos):
            return jnp.asarray(pos), _t(pos)
    ji, ti = index(start)
    jlog, jcache = jm.prefill(jp, jcache, jnp.asarray(toks), ji, jnp.asarray(length), jc_codec)
    tlog, tcache = tm.prefill(tp, tcache, _t(toks), ti, _t(length), tc_codec)
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], rtol=RTOL, atol=ATOL)
    for name in jcache:
        want, got = _np(jcache[name]), tcache[name].float().numpy() if tcache[name].dtype == \
            torch.bfloat16 else tcache[name].numpy()
        if name.endswith("codes"):
            np.testing.assert_array_equal(got, want)
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)
        else:  # bf16 K/V of codec none: one bf16 ulp (2^-7 relative at most) apart
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    pos = np.asarray([10, 16, -1], np.int32)
    step_tok = np.asarray([5, 6, 0], np.int32)
    for step in range(2):
        ji, ti = index(pos)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(step_tok), ji, jc_codec)
        outs = {}
        for attention in ("xla", "fused"):
            tc = {k: v.clone() for k, v in tcache.items()}
            outs[attention], tc = tm.decode_step(tp, tc, _t(step_tok), ti, tc_codec,
                                                 attention=attention)
            np.testing.assert_allclose(outs[attention][:2].numpy(), np.asarray(jlog)[:2],
                                       rtol=RTOL, atol=ATOL)
        tcache = tc
        pos = pos + np.asarray([1, 1, 0], np.int32)
        step_tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        step_tok[2] = 0


def test_free_lane_leaves_the_cache_untouched(pair):
    """Dropped writes (prompt padding, a free lane, a position past the
    lane's pages) never reach the pool: the zero page stays zero."""
    arch, jm, jp, tm, tp = pair
    codec = TL.KVCodecConfig("blockfloat8")
    cache = tm.init_cache(6, 4, codec)
    table = torch.zeros((2, 2), dtype=torch.int32)
    table[0] = torch.tensor([2, 5])
    toks = _t(_tokens(jm.cfg, 2, 12, 5))
    tm.prefill(tp, cache, toks, TL.PagedKV(torch.tensor([0, -1], dtype=torch.int32), table),
               torch.tensor([12, 12], dtype=torch.int32), codec)
    for name, leaf in cache.items():
        assert not leaf[:, 0].any(), name  # zero page
        assert not leaf[:, [1, 3, 4]].any(), name  # pages nobody maps
        assert leaf[:, 2].any() and leaf[:, 5].any(), name  # positions 0..7 landed


def test_decode_step_matches_forward(pair):
    """The port's twin of ``tests/test_arch_smoke.py:64`` (scalar index,
    codec none, the config's own bf16): greedy decode over cached steps
    matches the full forward within the reference's bf16 tolerance, and
    the port's last logits match the reference's decode."""
    arch = pair[0]
    jcfg = jreg.get_config(arch, smoke=True)
    jm = jreg.build_model(jcfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0))
    tm = treg.build_model(treg.get_config(arch, smoke=True), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.bfloat16)
    tokens = _tokens(jcfg, 2, 16, 6)
    full = tm.forward(tp, _t(tokens))
    codec = TL.KVCodecConfig("none")
    cache = tm.init_cache(2, 20, codec)
    jcache = jm.init_cache(2, 20, JL.KVCodecConfig("none"))
    for t in range(16):
        logits, cache = tm.decode_step(tp, cache, _t(tokens[:, t]), torch.tensor(t, dtype=torch.int32),
                                       codec)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(tokens[:, t]), jnp.int32(t),
                                      JL.KVCodecConfig("none"))
    np.testing.assert_allclose(logits.float().numpy(), full[:, -1].float().numpy(),
                               rtol=0.15, atol=0.35)
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlog, np.float32),
                               rtol=0.02, atol=0.02)


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
def test_bf16_greedy_tokens_equal(pair, codec):
    """In the configs' own bfloat16 the greedy continuation of a prefilled
    prompt over a paged cache is the reference's, token for token."""
    arch = pair[0]
    jcfg = jreg.get_config(arch, smoke=True)
    jm = jreg.build_model(jcfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0))
    tm = treg.build_model(treg.get_config(arch, smoke=True), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.bfloat16)
    toks = _tokens(jcfg, 2, 8, 7)
    length = np.asarray([8, 5], np.int32)
    jc_codec, tc_codec = JL.KVCodecConfig(codec), TL.KVCodecConfig(codec)
    pages_of = {0: [1, 2, 3], 1: [4, 5, 6]}
    jcache, tcache = jm.init_cache(7, 8, jc_codec), tm.init_cache(7, 8, tc_codec)
    ji, ti = _paged_index(2, np.zeros(2, np.int32), 3, pages_of)
    jlog, jcache = jm.prefill(jp, jcache, jnp.asarray(toks), ji, jnp.asarray(length), jc_codec)
    tlog, tcache = tm.prefill(tp, tcache, _t(toks), ti, _t(length), tc_codec)
    jt, tt = [np.asarray(jnp.argmax(jlog, -1))], [tlog.argmax(-1).numpy()]
    pos = length.copy()
    for _ in range(6):
        ji, ti = _paged_index(2, pos, 3, pages_of)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(jt[-1].astype(np.int32)), ji,
                                      jc_codec)
        tlog, tcache = tm.decode_step(tp, tcache, _t(tt[-1].astype(np.int32)), ti, tc_codec,
                                      attention="fused")
        jt.append(np.asarray(jnp.argmax(jlog, -1)))
        tt.append(tlog.argmax(-1).numpy())
        pos = pos + 1
    np.testing.assert_array_equal(np.stack(tt), np.stack(jt))


def test_vlm_prefix_forward():
    """The dense family's multimodal prefix (internvl2's stub frontend)."""
    jcfg = jreg.get_config("internvl2-76b", smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(jcfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(1), jnp.float32)
    tm = treg.build_model(treg.get_config("internvl2-76b", smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    toks = _tokens(jcfg, 2, 6, 8)
    prefix = np.random.default_rng(9).normal(size=(2, jcfg.prefix_len, jcfg.d_model))
    prefix = prefix.astype(np.float32)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks), jnp.asarray(prefix)))
    got = tm.forward(tp, _t(toks), _t(prefix)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------------- layers ----


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms(kind):
    x = _rand((2, 5, 32), 10, 3.0) + 1.5
    p = {"scale": _rand((32,), 11), "bias": _rand((32,), 12)}
    jf, tf = (JL.rmsnorm, TL.rmsnorm) if kind == "rms" else (JL.layernorm, TL.layernorm)
    want = np.asarray(jf({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = tf({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_lane", [False, True])
def test_rope(per_lane):
    x = _rand((2, 7, 3, 16), 13)
    pos = (np.asarray([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]], np.int32)
           if per_lane else np.arange(7, dtype=np.int32) * 37)
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 999_999.44))
    got = TL.rope(_t(x), _t(pos), 999_999.44).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_full_and_flash_attention(window, monkeypatch):
    """``attention`` over the materialized and the chunked online-softmax
    paths (the threshold forced low), with and without a window."""
    c = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True, window=window,
             chunk_kv=8)
    jc, tc = JL.AttnConfig(**c), TL.AttnConfig(**c)
    p = {k: _rand(s.shape, 20 + i, 0.3) for i, (k, s) in
         enumerate(sorted(JL.attention_spec(jc).items()))}
    x = _rand((2, 19, 32), 30)
    pos = np.arange(19, dtype=np.int32)
    want = np.asarray(JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jc,
                                   jnp.asarray(x), jnp.asarray(pos)))
    tp = {k: _t(v) for k, v in p.items()}
    got = TL.attention(tp, tc, _t(x), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    from repro.models import flags as jflags
    monkeypatch.setattr(jflags, "FLASH_THRESHOLD", 4)
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "Q_CHUNK", 8)
    want = np.asarray(JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jc,
                                   jnp.asarray(x), jnp.asarray(pos)))
    flash = TL.attention(tp, TL.AttnConfig(**c, flash_threshold=4), _t(x), _t(pos)).numpy()
    np.testing.assert_allclose(flash, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    p = {k: _rand(s.shape, 40 + i, 0.2) for i, (k, s) in
         enumerate(sorted(JL.mlp_spec(16, 48, kind).items()))}
    x = _rand((2, 3, 16), 50)
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind))
    got = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bf8_codec_bit_for_bit():
    x = _rand((2, 16, 4, 64), 60, 2.0)
    x[0, 0, 0] = 0.0  # an all-zero row: scale clamps to 1e-12
    x[1, 3, 2, :4] = [0.5, -0.5, 1.5, 2.5]  # ties round half to even
    jcodes, jscale = JL._bf8_encode(jnp.asarray(x))
    tcodes, tscale = TL._bf8_encode(_t(x))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(TL._bf8_decode(tcodes, tscale, torch.float32).numpy(),
                                  np.asarray(JL._bf8_decode(jcodes, jscale, jnp.float32)))


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_write_bit_for_bit(codec, paged):
    """Fed the same K/V, ``cache_write`` lands the same leaves as the
    reference's functional scatter, dropped positions included."""
    c = TL.AttnConfig(d_model=16, n_heads=4, n_kv_heads=2, head_dim=8)
    jcfgc = JL.AttnConfig(d_model=16, n_heads=4, n_kv_heads=2, head_dim=8)
    k, v = _rand((3, 5, 2, 8), 70), _rand((3, 5, 2, 8), 71)
    wpos = np.asarray([[0, 1, 2, 3, 4], [-1, 6, 7, 8, 30], [-1, -1, -1, -1, -1]], np.int32)
    if paged:
        table = np.asarray([[3, 1], [2, 4], [0, 0]], np.int32)
        ji, ti = (JL.PagedKV(jnp.zeros(3, jnp.int32), jnp.asarray(table)),
                  TL.PagedKV(torch.zeros(3, dtype=torch.int32), _t(table)))
        batch, max_len = 5, 8
    else:
        ji, ti, batch, max_len = None, None, 3, 12
    jcache = JL.init_cache(jcfgc, batch, max_len, JL.KVCodecConfig(codec))
    tcache = TL.init_cache(c, batch, max_len, TL.KVCodecConfig(codec))
    jcache = JL.cache_write(jcache, JL.KVCodecConfig(codec), jnp.asarray(k), jnp.asarray(v),
                            ji, jnp.asarray(wpos))
    tcache = TL.cache_write(tcache, TL.KVCodecConfig(codec), _t(k), _t(v), ti, _t(wpos))
    for name in jcache:
        np.testing.assert_array_equal(tcache[name].float().numpy(), _np(jcache[name]), name)
    if paged:
        assert not any(leaf[0].any() for leaf in tcache.values())  # zero page stays zero


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
def test_cache_update_scalar_index_and_read(codec):
    """The homogeneous-batch form (scalar index, clamped so the update
    fits, as ``dynamic_update_slice`` does) and ``cache_read``."""
    jc_ = JL.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    tc_ = TL.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
    jcache = JL.init_cache(jc_, 2, 16, JL.KVCodecConfig(codec))
    tcache = TL.init_cache(tc_, 2, 16, TL.KVCodecConfig(codec))
    for i, idx in enumerate((5, 15, 40)):
        k, v = _rand((2, 2, 2, 8), 80 + i), _rand((2, 2, 2, 8), 90 + i)
        jcache = JL.cache_update(jcache, JL.KVCodecConfig(codec), jnp.asarray(k), jnp.asarray(v),
                                 jnp.int32(idx))
        tcache = TL.cache_update(tcache, TL.KVCodecConfig(codec), _t(k), _t(v),
                                 torch.tensor(idx, dtype=torch.int32))
    for name in jcache:
        np.testing.assert_array_equal(tcache[name].float().numpy(), _np(jcache[name]), name)
    jk, jv = JL.cache_read(jcache, JL.KVCodecConfig(codec), jnp.float32)
    tk, tv = TL.cache_read(tcache, TL.KVCodecConfig(codec), torch.float32)
    np.testing.assert_array_equal(tk.float().numpy(), _np(jk))
    np.testing.assert_array_equal(tv.float().numpy(), _np(jv))


def test_gather_pages_and_cache_codes():
    pool = _rand((6, 4, 2, 8), 100)
    table = np.asarray([[2, 5, 0], [1, 0, 0]], np.int32)
    want = np.asarray(JL._gather_pages(jnp.asarray(pool), jnp.asarray(table)))
    np.testing.assert_array_equal(TL._gather_pages(_t(pool), _t(table)).numpy(), want)
    cache = {"k_codes": torch.ones(6, 4, 2, 8, dtype=torch.int8),
             "v_codes": torch.ones(6, 4, 2, 8, dtype=torch.int8),
             "k_scale": torch.ones(6, 4, 2), "v_scale": torch.ones(6, 4, 2)}
    kc, ks, vc, vs = TL.cache_codes(cache, TL.PagedKV(torch.zeros(2, dtype=torch.int32),
                                                      _t(table)))
    assert kc.shape == (2, 12, 2, 8) and ks.shape == (2, 12, 2)


def test_embed_unembed_and_lm_loss():
    table = _rand((40, 16), 110)
    toks = np.asarray([[1, 39, 0], [7, 7, 2]], np.int32)
    x = np.asarray(JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jnp.float32))
    np.testing.assert_array_equal(TL.embed({"table": _t(table)}, _t(toks), torch.float32).numpy(),
                                  x)
    want = np.asarray(JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))
    got = TL.unembed({"table": _t(table)}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    labels = np.asarray([[3, 1, 0], [2, 2, 39]], np.int32)
    assert float(ttr.lm_loss(_t(want), _t(labels))) == pytest.approx(
        float(jtr.lm_loss(jnp.asarray(want), jnp.asarray(labels))), rel=1e-6)


# ------------------------------------------------- configs and params ----


@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_configs_and_param_counts_match(arch):
    for smoke in (False, True):
        jc, tc = jreg.get_config(arch, smoke), treg.get_config(arch, smoke)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (tc.hd, tc.padded_vocab) == (jc.hd, jc.padded_vocab)
        assert dataclasses.asdict(tc.attn()) == dataclasses.asdict(jc.attn())
        assert tspec.param_count(treg.build_model(tc, device="cpu").specs()) == \
            jspec.param_count(jreg.build_model(jc).specs())
    assert type(treg.build_model(tc, device="cpu")).__name__ == \
        type(jreg.build_model(jc)).__name__


NEW_FAMILIES = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "hymba-1.5b",
                "whisper-base")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_params_from_jax_carries_every_family_tree(arch):
    """The reference's SMOKE tree of each non-dense family crosses leaf for
    leaf (``meta``, ``beta_*``, ``ssd``, ``time``/``channel``,
    ``enc_layers``/``dec_layers``, ``dec_pos``, ``cross_attn``, ``moe``);
    a missing or an extra leaf is refused."""
    jm = jreg.build_model(jreg.get_config(arch, smoke=True))
    jp = jax.tree.map(np.asarray, jspec.init_params(jm.specs(), jax.random.key(3), jnp.float32))
    tm = treg.build_model(treg.get_config(arch, smoke=True), device="cpu")
    tp = params_from_jax(jp, tm.specs(), "cpu", torch.float32)
    paths = [path for path, _ in tspec.spec_items(tm.specs())]
    assert len(paths) == len(jax.tree.leaves(jp))
    for path in paths:
        want, got = jp, tp
        for k in path:
            want, got = want[k], got[k]
        np.testing.assert_array_equal(got.numpy(), want)
    names = {k for path in paths for k in path}
    expect = {"qwen3-moe-30b-a3b": {"moe", "router"}, "phi3.5-moe-42b-a6.6b": {"moe"},
              "rwkv6-1.6b": {"time", "channel", "u", "wA"},
              "hymba-1.5b": {"meta", "beta_attn", "beta_ssd", "ssd", "a_log"},
              "whisper-base": {"enc_layers", "dec_layers", "dec_pos", "cross_attn"}}[arch]
    assert expect <= names
    top = next(iter(jp))
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in jp.items() if k != top}, tm.specs(), "cpu",
                        torch.float32)
    with pytest.raises(KeyError):
        params_from_jax({**jp, "junk": np.zeros(1)}, tm.specs(), "cpu", torch.float32)


def test_init_params_draws_a_large_leaf_by_slices(monkeypatch):
    """A leaf of ``SLICED_DRAW_NUMEL`` values or more is drawn one leading
    slice at a time straight into the destination dtype: right shape and
    dtype, the init's std, the same tensor from the same seed; smaller
    leaves keep the whole draw (their values do not change)."""
    specs = {"big": tspec.P((6, 64, 48), ("layers", "embed", "mlp")),
             "small": tspec.P((40, 24), ("embed", "mlp")),
             "ones": tspec.P((8,), ("embed",), "ones")}
    whole = tspec.init_params(specs, torch.Generator().manual_seed(5), "cpu", torch.bfloat16)
    monkeypatch.setattr(tspec, "SLICED_DRAW_NUMEL", 6 * 64 * 48)
    sliced = tspec.init_params(specs, torch.Generator().manual_seed(5), "cpu", torch.bfloat16)
    again = tspec.init_params(specs, torch.Generator().manual_seed(5), "cpu", torch.bfloat16)
    big = sliced["big"]
    assert big.shape == (6, 64, 48) and big.dtype == torch.bfloat16
    assert torch.equal(big, again["big"])
    std = 1 / np.sqrt(64)  # fan-in scaling over the embed axis; truncation at 3 sigma
    assert float(big.float().std()) == pytest.approx(std * 0.9866, rel=0.05)
    assert float(big.float().abs().max()) <= 3 * std * 1.01
    # every slice is a fresh draw
    assert not torch.equal(big[0], big[1])
    assert torch.equal(sliced["ones"], whole["ones"])
    # a leaf under the threshold is drawn whole: its values are those of the whole draw
    monkeypatch.setattr(tspec, "SLICED_DRAW_NUMEL", 10**9)
    assert torch.equal(tspec.init_params(specs, torch.Generator().manual_seed(5), "cpu",
                                         torch.bfloat16)["small"], whole["small"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_engine_refuses_fused_attention_without_a_k10_route(arch):
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = treg.get_config(arch, smoke=True)
    model = treg.build_model(cfg, device="cpu")
    assert not model.supports_fused_attention and not model.supports_paged_kv
    params = tspec.init_params(model.specs(), torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="no K10 route"):
        ServingEngine(model, params, EngineConfig(codec="blockfloat8", attention="fused"))
    eng = ServingEngine(model, params, EngineConfig(codec="blockfloat8", attention="auto"))
    assert not eng._fused and eng._attention == "xla"
    with pytest.raises(ValueError, match="supports_paged_kv"):
        ServingEngine(model, params, EngineConfig(codec="blockfloat8", paged=True))


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_launcher_smoke_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--codec", "blockfloat8",
                       "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "attention=xla" in out
    assert ("paged KV" in out) == (treg.get_config(arch).family == "moe")


def test_registry_rejects_unknown_and_shapes():
    with pytest.raises(KeyError):
        treg.get_config("not-an-arch")
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()}


def test_model_device_defaults_to_cuda():
    cfg = treg.get_config("starcoder2-3b", smoke=True)
    if torch.cuda.is_available():
        assert treg.build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            treg.build_model(cfg)


def test_init_params_shapes_std_and_seed():
    tm = treg.build_model(treg.get_config("starcoder2-3b", smoke=True), device="cpu")
    specs = tm.specs()
    a = tspec.init_params(specs, torch.Generator().manual_seed(3), "cpu", torch.float32)
    b = tspec.init_params(specs, torch.Generator().manual_seed(3), "cpu", torch.float32)
    c = tspec.init_params(specs, torch.Generator().manual_seed(4), "cpu", torch.bfloat16)
    for path, p in tspec.spec_items(specs):
        ta, tb, tc = (_get(t, path) for t in (a, b, c))
        assert tuple(ta.shape) == p.shape and ta.dtype == torch.float32 and tc.dtype == torch.bfloat16
        assert torch.equal(ta, tb)
        if p.init == "zeros":
            assert not ta.any()
        elif p.init == "ones":
            assert bool((ta == 1).all())
        else:
            assert float(ta.abs().max()) <= 3.0 * tspec._std(p) * (1 + 1e-6)
            if ta.numel() > 4000:
                assert float(ta.std()) == pytest.approx(0.9866 * tspec._std(p), rel=0.05)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_params_from_jax_checks_every_leaf():
    jcfg = jreg.get_config("starcoder2-3b", smoke=True)
    jp = jax.tree.map(np.asarray, jspec.init_params(jreg.build_model(jcfg).specs(),
                                                    jax.random.key(0)))
    specs = treg.build_model(treg.get_config("starcoder2-3b", smoke=True), device="cpu").specs()
    out = params_from_jax(jp, specs, "cpu", torch.bfloat16)
    assert out["layers"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["layers"]["mlp"]["up"].float().numpy(),
                                  np.asarray(jnp.asarray(jp["layers"]["mlp"]["up"])
                                             .astype(jnp.bfloat16), np.float32))
    missing = {**jp, "final_norm": {"scale": jp["final_norm"]["scale"]}}
    with pytest.raises(KeyError, match="final_norm/bias"):
        params_from_jax(missing, specs, "cpu", torch.float32)
    extra = {**jp, "stray": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="stray/w"):
        params_from_jax(extra, specs, "cpu", torch.float32)
    bad = {**jp, "embed": {"table": np.zeros((3, 3), np.float32)}}
    with pytest.raises(ValueError, match="embed/table"):
        params_from_jax(bad, specs, "cpu", torch.float32)
