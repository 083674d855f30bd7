"""The port's RWKV-6 model (``repro_torch.models.rwkv6``) against the JAX
package on the CPU.

* ``wkv_chunked`` (the exact chunked scan) and ``wkv_step`` (the recurrent
  decode step) on the same float32 inputs: outputs and states within rtol
  1e-5 / atol 1e-5 (values of order 1; the cumulative log-decays are
  ``torch.cumsum`` against XLA's cumsum, and the exponentials of their
  differences round independently); the chunked scan also against the
  step run token by token, at a ragged length that pads the last chunk.
* ``_rkvwg`` (the token-shift-mixed projections and the data-dependent
  decay) within rtol 1e-5 / atol 1e-6.
* ``RWKV6LM.decode_step`` over several tokens at ``dtype="float32"``:
  logits within rtol 1e-4 / atol 1e-5 of the reference's, and the state.
* Serving through the engine's token-by-token fallback: greedy tokens equal
  the JAX engine's, and a recycled slot decodes as a fresh engine does
  (``tests/test_serving.py::test_nonpaged_arch_fallback_recycle``).  A free
  lane keeps its state (the port's one serving difference, stated in the
  module docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import rwkv6 as jrw
from repro.models import spec as jspec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry as treg
from repro_torch.models import rwkv6 as trw
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ARCH = "rwkv6-1.6b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _scan_inputs(b, t, h, k, seed):
    r, kk, v = (_rand((b, t, h, k), seed + i, 0.5) for i in range(3))
    logw = -np.exp(np.clip(_rand((b, t, h, k), seed + 3), -8.0, 4.0)).astype(np.float32)
    u = _rand((h, k), seed + 4, 0.3)
    return r, kk, v, logw, u


@pytest.mark.parametrize("t", [32, 45, 7])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_chunked_matches_reference(t, with_state):
    r, k, v, logw, u = _scan_inputs(2, t, 3, 8, 1)
    s0 = _rand((2, 3, 8, 8), 9, 0.5) if with_state else None
    want, want_s = jrw.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                                   None if s0 is None else jnp.asarray(s0))
    got, got_s = trw.wkv_chunked(*(_t(a) for a in (r, k, v, logw, u)),
                                 None if s0 is None else _t(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_wkv_step_matches_reference_and_the_chunked_scan():
    r, k, v, logw, u = _scan_inputs(2, 45, 3, 8, 2)
    S = torch.zeros(2, 3, 8, 8)
    jS = jnp.zeros((2, 3, 8, 8))
    outs = []
    for i in range(45):
        step = [a[:, i] for a in (r, k, v, logw)]
        jo, jS = jrw.wkv_step(*(jnp.asarray(a) for a in step), jnp.asarray(u), jS)
        o, S = trw.wkv_step(*(_t(a) for a in step), _t(u), S)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        outs.append(o)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5, atol=1e-5)
    chunked, S_c = trw.wkv_chunked(*(_t(a) for a in (r, k, v, logw, u)))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), chunked.numpy(), rtol=1e-4,
                               atol=1e-5)
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


def test_rkvwg_matches_reference(twins):
    jm, jp, tm, tp = twins
    x, prev = _rand((2, 5, jm.cfg.d_model), 20), _rand((2, 5, jm.cfg.d_model), 21)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["time"])
    want = jrw._rkvwg(lp, jm.cfg, jnp.asarray(x), jnp.asarray(prev))
    tlp = {k: v[0] for k, v in tp["layers"]["time"].items() if not isinstance(v, dict)}
    tlp["ln"] = {k: v[0] for k, v in tp["layers"]["time"]["ln"].items()}
    got = trw._rkvwg(tlp, tm.cfg, _t(x), _t(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_decode_logits_and_state_match_reference(twins):
    jm, jp, tm, tp = twins
    toks = np.random.default_rng(22).integers(0, jm.cfg.vocab, size=(3, 9)).astype(np.int32)
    jcache, cache = jm.init_cache(3, 16), tm.init_cache(3, 16)
    for t in range(9):
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        log, cache = tm.decode_step(tp, cache, _t(toks[:, t]), torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-5)
    for name in jcache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-5)


def test_free_lane_keeps_its_state(twins):
    """A (B,) index's -1 lanes keep their state; live lanes advance as with
    a scalar index."""
    _, _, tm, tp = twins
    cache = tm.init_cache(2, 8)
    tok = torch.tensor([5, 9], dtype=torch.int32)
    live, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()}, tok,
                             torch.tensor(0, dtype=torch.int32))
    out, cache = tm.decode_step(tp, cache, tok, torch.tensor([0, -1], dtype=torch.int32))
    assert torch.equal(out[0], live[0])
    assert all(not leaf[:, 1].any() for leaf in cache.values())
    assert all(leaf[:, 0].any() for leaf in cache.values())
    with pytest.raises(ValueError, match="no K10 route"):
        tm.decode_step(tp, cache, tok, torch.tensor([1, -1], dtype=torch.int32),
                       attention="fused")


PROMPTS = ([9, 8, 7], [5, 4], [2, 7, 1])
MAX_NEW = (2, 8, 4)


def test_nonpaged_arch_fallback_recycle(twins):
    """The twin of ``test_serving.py::test_nonpaged_arch_fallback_recycle``:
    rwkv6 serves through the dense per-slot fallback, a recycled slot
    decodes as a fresh engine does, the state of free lanes is zero after
    the drain, and the greedy tokens are the JAX engine's."""
    jm, jp, tm, tp = twins

    def mk():
        return ServingEngine(tm, tp, EngineConfig(batch_slots=2, max_len=32, codec="none"))

    eng = mk()
    assert not eng.paged and not eng._can_prefill and not eng._fused
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    assert eng.check_kv_integrity()
    fresh = Request(uid=2, prompt=list(PROMPTS[2]), max_new_tokens=MAX_NEW[2])
    eng2 = mk()
    eng2.submit(fresh)
    assert eng2.run_until_drained().drained
    assert reqs[2].out_tokens == fresh.out_tokens

    jeng = JServingEngine(jm, jp, JEngineConfig(batch_slots=2, max_len=32, codec="none"))
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in jreqs:
        jeng.submit(r)
    assert jeng.run_until_drained().drained
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
