"""The port's Hymba model (``repro_torch.models.hybrid``) against the JAX
package on the CPU.

* ``ssd_chunked`` (the chunked SSD scan) and ``ssd_step`` (the recurrent
  decode step) on the same float32 inputs: outputs and states within rtol
  1e-5 / atol 1e-5 (values of order 1; ``torch.cumsum`` against XLA's
  cumsum of the log-decays); ``ssd_apply`` within rtol 1e-5 and 1e-5 of
  its largest magnitude.  The reference's scan and step are not one
  function (the step decays the carried state by step t's decay before
  reading it, the scan after), so the port holds each to its own twin.
* The per-layer windows (global first, middle and last layers).
* ``HymbaLM`` at ``dtype="float32"``: the forward through the chunked
  online-softmax path (``AttnConfig.flash_threshold`` in the port,
  ``flags.FLASH_THRESHOLD`` in the reference) within rtol 1e-4 / atol
  5e-5; 40 ``decode_step`` calls with a scalar and a (B,) index (a free
  lane), codec none and blockfloat8, within rtol 1e-4 / atol 5e-5 of the
  reference's logits (a bf16 K/V value of the codec-none cache may round to
  the other neighbour after another f32 summation order).
* Serving through the engine's token-by-token fallback: the greedy tokens
  equal the JAX engine's; ``attention="fused"`` is refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import flags as jflags
from repro.models import hybrid as jhy
from repro.models import layers as JL
from repro.models import spec as jspec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry as treg
from repro_torch.models import hybrid as thy
from repro_torch.models import layers as TL
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ARCH = "hymba-1.5b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _ssd_inputs(b, t, h, p, n, seed):
    xh = _rand((b, t, h, p), seed, 0.5)
    B, C = _rand((b, t, h, n), seed + 1, 0.5), _rand((b, t, h, n), seed + 2, 0.5)
    dt = np.log1p(np.exp(_rand((b, t, h), seed + 3))).astype(np.float32)
    a = -np.exp(_rand((h,), seed + 4, 0.5)).astype(np.float32)
    return xh, B, C, dt, a


@pytest.mark.parametrize("t", [64, 75, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(t, with_state):
    xh, B, C, dt, a = _ssd_inputs(2, t, 3, 8, 4, 1)
    s0 = _rand((2, 3, 4, 8), 9, 0.5) if with_state else None
    want, want_s = jhy.ssd_chunked(*(jnp.asarray(z) for z in (xh, B, C, dt, a)),
                                   None if s0 is None else jnp.asarray(s0))
    got, got_s = thy.ssd_chunked(*(_t(z) for z in (xh, B, C, dt, a)),
                                 None if s0 is None else _t(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_ssd_step_matches_reference():
    """The recurrent step token by token.  It is not the chunked scan's
    function in either package: the step reads C_t · (exp(a dt_t) h_{t-1} +
    dt_t B_t x_t), the scan C_t · (h_{t-1} + dt_t B_t x_t) (its carried and
    in-chunk decays stop before step t); the port keeps both as written."""
    xh, B, C, dt, a = _ssd_inputs(2, 70, 3, 8, 4, 2)
    S, jS = torch.zeros(2, 3, 4, 8), jnp.zeros((2, 3, 4, 8))
    for i in range(70):
        step = [z[:, i] for z in (xh, B, C, dt)]
        jy, jS = jhy.ssd_step(*(jnp.asarray(z) for z in step), jnp.asarray(a), jS)
        y, S = thy.ssd_step(*(_t(z) for z in step), _t(a), S)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5, atol=1e-5)
    # the two forms carry the same state from step to step
    _, S_c = thy.ssd_chunked(*(_t(z) for z in (xh, B, C, dt, a)))
    np.testing.assert_allclose(S_c.numpy(), S.numpy(), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def twins():
    cfg = jreg.get_config(ARCH, smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(ARCH, smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return jm, jp, tm, tp


def test_ssd_apply_matches_reference(twins):
    jm, jp, tm, tp = twins
    x = _rand((2, 11, jm.cfg.d_model), 30)
    jlp = jax.tree.map(lambda z: z[1], jp["layers"]["ssd"])
    want, want_s = jhy.ssd_apply(jlp, jm.cfg, jnp.asarray(x))
    got, got_s = thy.ssd_apply({k: v[1] for k, v in tp["layers"]["ssd"].items()}, tm.cfg, _t(x))
    want = np.asarray(want)  # of order 100: the projections sum 64 products of order 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_windows_match_reference():
    for smoke in (False, True):
        cfg = jreg.get_config(ARCH, smoke=smoke)
        want = np.asarray(jhy.HymbaLM(cfg)._windows()).tolist()
        assert treg.build_model(treg.get_config(ARCH, smoke=smoke), device="cpu")._windows() == want


def test_flash_forward_matches_reference(twins, monkeypatch):
    """The attention branch's chunked online-softmax path (the threshold
    forced low on both sides)."""
    jm, jp, tm, tp = twins
    toks = np.random.default_rng(31).integers(0, jm.cfg.vocab, size=(2, 40)).astype(np.int32)
    monkeypatch.setattr(jflags, "FLASH_THRESHOLD", 16)
    for mod in (JL, TL):
        monkeypatch.setattr(mod, "Q_CHUNK", 16)
    orig, jattn = thy.HymbaLM._attn_config, JL.AttnConfig
    monkeypatch.setattr(thy.HymbaLM, "_attn_config", lambda self: dataclasses.replace(
        orig(self), flash_threshold=16, chunk_kv=16))
    monkeypatch.setattr(JL, "AttnConfig", lambda **kw: jattn(**kw, chunk_kv=16))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks)))
    with torch.no_grad():
        got = tm.forward(tp, _t(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("vector", [False, True])
def test_decode_logits_match_reference(twins, codec, vector):
    """Decode past the SMOKE window (32) so windowed layers mask; with a
    (B,) index lane 2 is free (-1) and its logits are not compared."""
    jm, jp, tm, tp = twins
    steps = 40
    toks = np.random.default_rng(32).integers(0, jm.cfg.vocab, size=(3, steps)).astype(np.int32)
    jc, tc = JL.KVCodecConfig(codec), TL.KVCodecConfig(codec)
    jcache, cache = jm.init_cache(3, 48, jc), tm.init_cache(3, 48, tc)
    live = 2 if vector else 3
    jdecode = jax.jit(jm.decode_step, static_argnums=4)
    for t in range(steps):
        if vector:
            idx = np.asarray([t, t, -1], np.int32)
            ji, ti = jnp.asarray(idx), _t(idx)
        else:
            ji, ti = jnp.int32(t), torch.tensor(t, dtype=torch.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t]), ji, jc)
        log, cache = tm.decode_step(tp, cache, _t(toks[:, t]), ti, tc)
        np.testing.assert_allclose(log[:live].numpy(), np.asarray(jlog)[:live], rtol=1e-4,
                                   atol=5e-5)
    if vector:  # the free lane's state stays zero in the port
        assert all(not leaf[:, 2].any() for leaf in cache.values())


PROMPTS = ([9, 8, 7], [5, 4], [2, 7, 1])
MAX_NEW = (2, 8, 4)


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
def test_engine_tokens_equal_jax_engine(twins, codec):
    jm, jp, tm, tp = twins
    eng = ServingEngine(tm, tp, EngineConfig(batch_slots=2, max_len=32, codec=codec))
    assert not eng.paged and not eng._can_prefill and not eng._fused
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    assert eng.check_kv_integrity()
    jeng = JServingEngine(jm, jp, JEngineConfig(batch_slots=2, max_len=32, codec=codec))
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in jreqs:
        jeng.submit(r)
    assert jeng.run_until_drained().drained
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    with pytest.raises(ValueError, match="no K10 route"):
        tm.decode_step(tp, eng.cache, _t(np.zeros(2, np.int32)), _t(np.zeros(2, np.int32)),
                       TL.KVCodecConfig(codec), attention="fused")
