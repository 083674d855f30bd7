"""The port's enc-dec model (``repro_torch.models.encdec``, whisper-base)
against the JAX package on the CPU, at ``dtype="float32"`` with one
parameter tree carried across by ``params_from_jax``.

* ``cross_attention`` and ``encode_memory`` on the same inputs (values up
  to ~15) within rtol 1e-5 / atol 2e-5; ``encode`` (the bidirectional
  encoder) within rtol 1e-4 / atol 5e-5.
* ``init_cache(params=, frames=)``: ``mem_k``/``mem_v`` (values up to ~8,
  projections of the encoder's output) within rtol 1e-4 / atol 1e-4 of
  the reference's.
* ``decode_step`` over 6 tokens, codec none and blockfloat8, with a scalar
  index and with a (B,) index holding a free lane (``dec_pos[clip(index,
  0)]``): logits within rtol 1e-4 / atol 5e-5 of the reference's; with
  blockfloat8 and a (B,) index also through ``attention="fused"`` (K10's
  plain version on its dense entry).
* The engine serves it through the token-by-token fallback with the JAX
  engine's greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import encdec as jed
from repro.models import layers as JL
from repro.models import spec as jspec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry as treg
from repro_torch.models import encdec as ted
from repro_torch.models import layers as TL
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ARCH = "whisper-base"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def twins():
    cfg = jreg.get_config(ARCH, smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(ARCH, smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    frames = _rand((3, cfg.encoder_len, cfg.d_model), 5)
    return jm, jp, tm, tp, frames


def test_cross_attention_and_encode_memory(twins):
    jm, jp, tm, tp, _ = twins
    c = jm.cfg.attn()
    jlp = jax.tree.map(lambda z: z[0], jp["dec_layers"]["cross_attn"])
    tlp = {k: v[0] for k, v in tp["dec_layers"]["cross_attn"].items()}
    enc, x = _rand((2, 12, c.d_model), 6), _rand((2, 3, c.d_model), 7)
    jk, jv = jed.encode_memory(jlp, c, jnp.asarray(enc))
    tk, tv = ted.encode_memory(tlp, tm.cfg.attn(), _t(enc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=2e-5)
    want = jed.cross_attention(jlp, c, jnp.asarray(x), jk, jv)
    got = ted.cross_attention(tlp, tm.cfg.attn(), _t(x), tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_encode_and_memory_cache(twins):
    jm, jp, tm, tp, frames = twins
    want = jm.encode(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(tp, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=5e-5)
    jc, tc = JL.KVCodecConfig("blockfloat8"), TL.KVCodecConfig("blockfloat8")
    jcache = jm.init_cache(3, 16, jc, params=jp, frames=jnp.asarray(frames))
    cache = tm.init_cache(3, 16, tc, params=tp, frames=_t(frames))
    assert set(cache) == set(jcache)
    for name in ("mem_k", "mem_v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4)
    assert all(not cache[k].any() for k in cache if k.startswith("self_"))


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("vector", [False, True])
def test_decode_logits_match_reference(twins, codec, vector):
    jm, jp, tm, tp, frames = twins
    jc, tc = JL.KVCodecConfig(codec), TL.KVCodecConfig(codec)
    jcache = jm.init_cache(3, 16, jc, params=jp, frames=jnp.asarray(frames))
    cache = tm.init_cache(3, 16, tc, params=tp, frames=_t(frames))
    toks = np.random.default_rng(8).integers(0, jm.cfg.vocab, size=(3, 6)).astype(np.int32)
    routes = ("xla", "fused") if (codec == "blockfloat8" and vector) else ("xla",)
    jdecode = jax.jit(jm.decode_step, static_argnums=4)
    live = 2 if vector else 3
    for t in range(6):
        if vector:  # lane 1 starts one step late; lane 2 is free
            idx = np.asarray([t, t - 1 if t else -1, -1], np.int32)
            ji, ti = jnp.asarray(idx), _t(idx)
        else:
            ji, ti = jnp.int32(t), torch.tensor(t, dtype=torch.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]), ji, jc)
        for attention in routes:
            c = {k: v.clone() for k, v in cache.items()}
            log, c = tm.decode_step(tp, c, _t(toks[:, t]), ti, tc, attention=attention)
            rows = [0] if (vector and t == 0) else list(range(live))
            np.testing.assert_allclose(log[rows].numpy(), np.asarray(jlog)[rows], rtol=1e-4,
                                       atol=5e-5)
        cache = c
    if vector:  # nothing was written for the free lane
        assert all(not cache[k][:, 2].any() for k in cache if k.startswith("self_"))


PROMPTS = ([9, 8, 7], [5, 4], [2, 7, 1])
MAX_NEW = (2, 8, 4)


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
def test_engine_tokens_equal_jax_engine(twins, codec):
    jm, jp, tm, tp, _ = twins
    attention = "fused" if codec == "blockfloat8" else "xla"
    eng = ServingEngine(tm, tp, EngineConfig(batch_slots=2, max_len=32, codec=codec,
                                             attention=attention))
    assert not eng.paged and not eng._can_prefill and eng._fused == (attention == "fused")
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    jeng = JServingEngine(jm, jp, JEngineConfig(batch_slots=2, max_len=32, codec=codec,
                                                attention="xla"))
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in jreqs:
        jeng.submit(r)
    assert jeng.run_until_drained().drained
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
