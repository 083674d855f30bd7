"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package on the CPU.

* ``moe_apply``'s routing at float32 is the reference's exactly: ``top_e``
  (ties to the lower expert id, as ``jax.lax.top_k``), the capacity and the
  drop mask of the stable assignment sort; the output (of order 1) within
  rtol 1e-5 / atol 1e-5 and the aux loss within rtol 1e-6.  In bfloat16 the routing is
  exact and the output within 2^-6 of its largest magnitude (four bf16
  ulps: the combine adds each token's contributions in the reference's
  order, rounding after each add, but the expert products are matrix
  products XLA and PyTorch sum in other orders, rounded to bf16 between
  them).
* ``MoELM`` over one parameter tree carried across with ``params_from_jax``
  at ``dtype="float32"``: prefill and decode logits (dense and paged caches,
  codec none and blockfloat8, attention ``xla`` and ``fused``) within rtol
  1e-4 / atol 1e-5 (decode continues from the reference's prefilled cache,
  which the port's equals as in ``test_torch_models.py``), and the engine's
  greedy tokens equal the JAX engine's for codec none / blockfloat8 x paged
  / dense.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import spec as jspec
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry as treg
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _moe_params(c, seed, router_scale=0.3):
    d, e, f = c.d_model, c.n_experts, c.d_ff
    return {"router": _rand((d, e), seed, router_scale), "gate": _rand((e, d, f), seed + 1, 0.2),
            "up": _rand((e, d, f), seed + 2, 0.2), "down": _rand((e, f, d), seed + 3, 0.2)}


def _reference_routing(p, c, x):
    """top_e and the sorted assignments' drop mask, as ``repro.models.moe
    .moe_apply`` computes them (its own expressions)."""
    n, k, e = x.shape[0] * x.shape[1], c.top_k, c.n_experts
    xf = x.reshape(n, -1)
    logits = (xf @ p["router"].astype(x.dtype)).astype(jnp.float32)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    capacity = int(max(1, round(k * n / e * c.capacity_factor)))
    eid_s = top_e.reshape(-1)[jnp.argsort(top_e.reshape(-1), stable=True)]
    counts = jax.ops.segment_sum(jnp.ones_like(eid_s), eid_s, num_segments=e)
    rank = jnp.arange(n * k, dtype=jnp.int32) - (jnp.cumsum(counts) - counts)[eid_s]
    return np.asarray(top_e), np.asarray(rank < capacity), capacity


CASES = {
    "routed": dict(seed=1, router_scale=0.3, capacity_factor=1.25),
    # a zero router: every probability ties, so every token takes experts 0..k-1
    "all_tied": dict(seed=2, router_scale=0.0, capacity_factor=1.25),
    "drops": dict(seed=3, router_scale=1.0, capacity_factor=0.5),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(arch, case, dtype):
    spec = CASES[case]
    c = jreg.get_config(arch, smoke=True).scaled(capacity_factor=spec["capacity_factor"])
    p = _moe_params(c, 10 * spec["seed"], spec["router_scale"])
    x = _rand((3, 7, c.d_model), spec["seed"])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx = jnp.asarray(x).astype(jdt)
    want, want_aux = jmoe.moe_apply(jp, c, jx)
    top_e, valid, capacity = _reference_routing(jp, c, jx)

    tp = {k: _t(v) for k, v in p.items()}
    tx = _t(x).to(tdt)
    r = tmoe.route(tp, c, tx.reshape(-1, c.d_model))
    got, aux = tmoe.moe_apply(tp, c, tx)
    assert r.capacity == capacity
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.valid.numpy(), valid)
    if case == "all_tied":
        assert (top_e == np.arange(c.top_k)).all()
    if case == "drops":
        assert 0 < (~valid).sum() < valid.size
    want = np.asarray(want.astype(jnp.float32))
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:  # the gate and up products round to bf16 before silu and the down
        # product, so a one-ulp difference there moves an output by a few ulps
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2.0 ** -6 * np.abs(want).max())


def test_combine_is_ordered_and_repeatable():
    """The combine adds a token's contributions by ascending expert id:
    a repeated call is bit for bit the same, and the bf16 sum equals the
    sequential rounded sum written out by hand."""
    c = jreg.get_config(ARCHS[0], smoke=True)
    tp = {k: _t(v).to(torch.bfloat16) for k, v in _moe_params(c, 40).items()}
    x = _t(_rand((2, 5, c.d_model), 41)).to(torch.bfloat16)
    a, _ = tmoe.moe_apply(tp, c, x)
    b, _ = tmoe.moe_apply(tp, c, x)
    assert torch.equal(a, b)
    r = tmoe.route(tp, c, x.reshape(-1, c.d_model))
    assert (np.diff(r.top_e.gather(1, torch.argsort(r.top_e, dim=1)).numpy(), axis=1) > 0).all()
    # each token's k sorted positions are increasing: ascending expert order
    assert (np.diff(r.pos.numpy(), axis=1) > 0).all()


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = jreg.get_config(request.param, smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(request.param, smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return request.param, jm, jp, tm, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def test_model_declares_paged_and_k10_routes(pair):
    _, _, _, tm, _ = pair
    assert isinstance(tm, tmoe.MoELM)
    assert tm.supports_paged_kv and tm.supports_fused_attention


def test_loss_with_aux_weight(pair):
    _, jm, jp, tm, tp = pair
    toks, labels = _tokens(jm.cfg, 2, 12, 2), _tokens(jm.cfg, 2, 12, 3)
    for w in (0.0, 0.01, 1.0):
        want = float(jm.loss(jp, jnp.asarray(toks), jnp.asarray(labels), aux_weight=w))
        with torch.no_grad():
            got = float(tm.loss(tp, _t(toks), _t(labels), aux_weight=w))
        assert got == pytest.approx(want, rel=RTOL)
    _, jaux = jm.forward_with_aux(jp, jnp.asarray(toks))
    with torch.no_grad():
        _, aux = tm.forward_with_aux(tp, _t(toks))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def _paged_index(b, start, max_pages, pages_of):
    table = np.zeros((b, max_pages), np.int32)
    for lane, pages in pages_of.items():
        table[lane, :len(pages)] = pages
    return (JL.PagedKV(jnp.asarray(start), jnp.asarray(table)),
            TL.PagedKV(_t(start), _t(table)))


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits(pair, codec, paged):
    """A chunked prefill of two lanes (one padded, one free lane), then two
    decode steps, through the routed MLP; attention ``xla`` and ``fused``
    (K10's plain version) in the port."""
    _, jm, jp, tm, tp = pair
    b, t, page, max_pages = 3, 16, 8, 4
    toks = _tokens(jm.cfg, b, t, 4)
    length = np.asarray([10, 16, 0], np.int32)
    start = np.asarray([0, 0, -1], np.int32)
    jc, tc = JL.KVCodecConfig(codec), TL.KVCodecConfig(codec)
    if paged:
        jcache, tcache = jm.init_cache(10, page, jc), tm.init_cache(10, page, tc)
        pages_of = {0: [3, 7, 1], 1: [2, 9, 5, 4]}

        def index(pos):
            return _paged_index(b, pos, max_pages, pages_of)
    else:
        jcache, tcache = jm.init_cache(b, 32, jc), tm.init_cache(b, 32, tc)

        def index(pos):
            return jnp.asarray(pos), _t(pos)
    ji, ti = index(start)
    jlog, jcache = jm.prefill(jp, jcache, jnp.asarray(toks), ji, jnp.asarray(length), jc)
    tlog, tcache = tm.prefill(tp, tcache, _t(toks), ti, _t(length), tc)
    np.testing.assert_allclose(tlog[:2].numpy(), np.asarray(jlog)[:2], rtol=RTOL, atol=ATOL)
    for name in jcache:
        want, got = np.asarray(jcache[name], np.float32), tcache[name].float().numpy()
        if name.endswith("codes"):
            np.testing.assert_array_equal(got, want)
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=4e-6, atol=0)
        else:  # bf16 K/V of codec none: one bf16 ulp (2^-7 relative at most)
            # apart, or 1e-5 near zero, where the f32 sums cancel
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)
    # decode from the reference's cache: a K/V value that rounds to the other
    # bf16 neighbour after another f32 summation order would move later
    # logits by up to ~4e-4 through the routed MLP
    tcache = {k: _t(np.asarray(v, np.float32)).to(tcache[k].dtype) for k, v in jcache.items()}
    pos = np.asarray([10, 16, -1], np.int32)
    step_tok = np.asarray([5, 6, 0], np.int32)
    for _ in range(2):
        ji, ti = index(pos)
        jlog, jcache = jm.decode_step(jp, jcache, jnp.asarray(step_tok), ji, jc)
        for attention in ("xla", "fused") if codec == "blockfloat8" else ("xla",):
            cache = {k: v.clone() for k, v in tcache.items()}
            out, cache = tm.decode_step(tp, cache, _t(step_tok), ti, tc, attention=attention)
            np.testing.assert_allclose(out[:2].numpy(), np.asarray(jlog)[:2], rtol=RTOL,
                                       atol=ATOL)
        tcache = cache
        pos = pos + np.asarray([1, 1, 0], np.int32)
        step_tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        step_tok[2] = 0


# ------------------------------------------------------------- serving ----

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6, 4, 3, 3])
MAX_NEW = (6, 9, 5)


@pytest.fixture(scope="module")
def qwen_twins():
    arch = ARCHS[0]
    cfg = jreg.get_config(arch, smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jspec.init_params(jm.specs(), jax.random.key(0), jnp.float32)
    tm = treg.build_model(treg.get_config(arch, smoke=True).scaled(dtype="float32"),
                          device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return jm, jp, tm, tp


@pytest.mark.parametrize("codec", ["none", "blockfloat8"])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_equal_jax_engine(qwen_twins, codec, paged):
    """qwen3-moe SMOKE at float32: three requests through two slots (one
    recycles), prompts prefilled in one call; the port's engine gives the
    JAX engine's greedy tokens, request for request (``fused`` = K10's
    plain version for blockfloat8)."""
    jm, jp, tm, tp = qwen_twins
    jeng = JServingEngine(jm, jp, JEngineConfig(batch_slots=2, max_len=48, codec=codec,
                                                paged=paged, attention="xla"))
    jreqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
    for r in jreqs:
        jeng.submit(r)
    assert jeng.run_until_drained().drained
    for attention in ("xla", "fused") if codec == "blockfloat8" else ("xla",):
        eng = ServingEngine(tm, tp, EngineConfig(batch_slots=2, max_len=48, codec=codec,
                                                 paged=paged, attention=attention))
        assert eng.paged == paged and eng._fused == (attention == "fused")
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
        for r in reqs:
            eng.submit(r)
        assert eng.run_until_drained().drained
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
        assert eng.check_kv_integrity()


def test_spec_matches_reference():
    for arch in ARCHS:
        c = jreg.get_config(arch)
        want = {k: (v.shape, v.axes, v.init) for k, v in jmoe.moe_spec(c).items()}
        got = {k: (v.shape, v.axes, v.init) for k, v in tmoe.moe_spec(c).items()}
        assert got == want
        assert dataclasses.asdict(treg.get_config(arch)) == dataclasses.asdict(c)
