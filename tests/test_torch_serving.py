"""The port's serving engine (``repro_torch.serving``): twins of
``tests/test_serving.py``'s classes, run on the CPU, and the port's greedy
tokens held against the JAX engine's.

* Greedy tokens equal the JAX engine's, request for request, for codec
  none / blockfloat8 x paged / dense, with one parameter tree carried
  across (``params_from_jax``) at ``dtype="float32"``; the port's plain
  attention (``xla``) is held against the reference's ``xla`` attention,
  and for blockfloat8 K10's plain version (``fused``) too.
* Everything else holds the port to the reference's contract on its own:
  slot recycling bitwise equal to a fresh engine, zero-on-free, admission,
  ``PagePool`` accounting and its typed errors, the livelock guard, the
  failover primitives, and sampled decoding that depends only on
  ``(sample_seed, uid, token index)`` (the port's own determinism: torch
  cannot draw JAX's bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.spec import init_params as jinit
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models.interop import params_from_jax
from repro_torch.serving import engine as tengine
from repro_torch.serving.admission import AdmissionConfig, AdmissionController
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.kv_pages import PageAccountingError, PagePool, PoolExhausted


@pytest.fixture(scope="module")
def tiny():
    """starcoder2-3b SMOKE (bf16 compute) with the reference fixture's
    float32 parameters (``init_params(specs, key(0))``) carried across.
    Some properties hold for those weights and not for every draw: on the
    port's own ``torch.Generator`` draws with seeds 0 and 1, the bf16 and
    blockfloat8 caches agree in 2 and 3 of 8 greedy tokens, in the JAX
    package as in the port (``test_bf8_decode_quality``)."""
    cfg = registry.get_config("starcoder2-3b", smoke=True)
    model = registry.build_model(cfg, device="cpu")
    jp = jinit(jreg.build_model(jreg.get_config("starcoder2-3b", smoke=True)).specs(),
               jax.random.key(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jp), model.specs(), "cpu", torch.float32)
    return cfg, model, params


def _mk_engine(model, params, codec, slots=4, max_len=64):
    return ServingEngine(model, params, EngineConfig(
        batch_slots=slots, max_len=max_len, codec=codec))


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert done.drained
    return done


# ------------------------------------------------------ against the JAX ----

PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6, 4, 3, 3])
MAX_NEW = (6, 9, 5)


@pytest.fixture(scope="module")
def twins():
    cfg = jreg.get_config("starcoder2-3b", smoke=True).scaled(dtype="float32")
    jm = jreg.build_model(cfg)
    jp = jinit(jm.specs(), jax.random.key(0), jnp.float32)
    tm = registry.build_model(registry.get_config("starcoder2-3b", smoke=True)
                              .scaled(dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return jm, jp, tm, tp, {}


def _jax_tokens(twins, codec, paged):
    jm, jp, _, _, memo = twins
    if (codec, paged) not in memo:
        eng = JServingEngine(jm, jp, JEngineConfig(batch_slots=2, max_len=48, codec=codec,
                                                   paged=paged, attention="xla"))
        reqs = [JRequest(uid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
        for r in reqs:
            eng.submit(r)
        assert eng.run_until_drained().drained
        memo[(codec, paged)] = [r.out_tokens for r in reqs]
    return memo[(codec, paged)]


class TestGreedyMatchesJAX:
    """Three requests through two slots (one recycles), prompts prefilled
    in one chunked call, each lane at its own position."""

    @pytest.mark.parametrize("codec,paged,attention", [
        ("none", True, "xla"), ("none", False, "xla"), ("blockfloat8", True, "xla"),
        ("blockfloat8", False, "xla"), ("blockfloat8", True, "fused"),
        ("blockfloat8", False, "fused")])
    def test_greedy_tokens_equal(self, twins, codec, paged, attention):
        _, _, tm, tp, _ = twins
        eng = ServingEngine(tm, tp, EngineConfig(batch_slots=2, max_len=48, codec=codec,
                                                 paged=paged, attention=attention))
        assert eng._fused == (attention == "fused")
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW))]
        _drain(eng, reqs)
        assert [r.out_tokens for r in reqs] == _jax_tokens(twins, codec, paged)

    @pytest.mark.parametrize("codec", ["none", "blockfloat8"])
    def test_cache_bytes_match_jax(self, twins, codec):
        jm, jp, tm, tp, _ = twins
        for paged in (True, False):
            je = JServingEngine(jm, jp, JEngineConfig(batch_slots=3, max_len=40, codec=codec,
                                                      paged=paged))
            te = ServingEngine(tm, tp, EngineConfig(batch_slots=3, max_len=40, codec=codec,
                                                    paged=paged))
            assert te.cache_nbytes() == je.cache_nbytes()
            if paged:
                assert (te.pool.n_pages, te.pool.page_nbytes) == (je.pool.n_pages,
                                                                  je.pool.page_nbytes)


# -------------------------------------------------------------- engine ----


class TestEngine:
    def test_drains_batch_of_requests(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none")
        for uid in range(6):  # more requests than slots -> queueing
            eng.submit(Request(uid=uid, prompt=[1 + uid, 2, 3], max_new_tokens=4))
        done = eng.run_until_drained()
        assert len(done) == 6
        assert all(len(r.out_tokens) == 4 for r in done)
        assert all(0 <= t < cfg.padded_vocab for r in done for t in r.out_tokens)

    def test_greedy_decode_deterministic(self, tiny):
        cfg, model, params = tiny
        outs = []
        for _ in range(2):
            eng = _mk_engine(model, params, "none")
            eng.submit(Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6))
            outs.append(eng.run_until_drained()[0].out_tokens)
        assert outs[0] == outs[1]

    def test_bf8_cache_half_bytes(self, tiny):
        cfg, model, params = tiny
        raw = _mk_engine(model, params, "none").cache_nbytes()
        cmp = _mk_engine(model, params, "blockfloat8").cache_nbytes()
        expect = (1 + 4 / cfg.hd) / 2  # int8 codes + f32/(token,head) scale vs bf16
        assert cmp == pytest.approx(raw * expect, rel=1e-6), (raw, cmp)

    def test_bf8_decode_quality(self, tiny):
        """Compressed-cache greedy decode matches the bf16 cache on most
        steps (block-float8 KV is near-lossless for attention)."""
        cfg, model, params = tiny
        seqs = {}
        for codec in ("none", "blockfloat8"):
            eng = _mk_engine(model, params, codec)
            eng.submit(Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=8))
            seqs[codec] = eng.run_until_drained()[0].out_tokens
        agree = sum(a == b for a, b in zip(seqs["none"], seqs["blockfloat8"]))
        assert agree >= 6, seqs

    def test_max_len_stops_decode(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", max_len=8)
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=100))
        done = eng.run_until_drained()
        assert len(done) == 1 and len(done[0].out_tokens) <= 6

    def test_steps_count_model_ticks(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none")
        eng.tick()  # idle
        _drain(eng, [Request(uid=0, prompt=[1, 2], max_new_tokens=4)])
        assert eng.steps == 3 and eng.ticks == eng.steps + 2  # + the idle and the last tick


class TestCodecLayer:
    def test_bf8_roundtrip_error(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(2, 16, 4, 64)).astype(np.float32))
        codes, scale = L._bf8_encode(x)
        y = L._bf8_decode(codes, scale, torch.float32)
        amax = x.abs().amax(dim=-1, keepdim=True)
        assert bool(((y - x).abs() <= amax / 127.0 * 0.5 + 1e-6).all())

    def test_cache_update_and_read(self):
        c = L.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
        codec = L.KVCodecConfig("blockfloat8")
        cache = L.init_cache(c, batch=2, max_len=16, codec=codec)
        k = torch.ones((2, 1, 2, 8)) * 3.0
        cache = L.cache_update(cache, codec, k, -k, torch.tensor(5, dtype=torch.int32))
        kk, vv = L.cache_read(cache, codec, torch.float32)
        torch.testing.assert_close(kk[:, 5], torch.full_like(kk[:, 5], 3.0), rtol=1e-2, atol=0)
        torch.testing.assert_close(vv[:, 5], torch.full_like(vv[:, 5], -3.0), rtol=1e-2, atol=0)
        assert float(kk[:, 4].abs().max()) == 0.0  # untouched slots stay zero


class TestRecycleIsolation:
    """A slot freed mid-flight and recycled to a new request behaves
    exactly as a fresh engine: bitwise."""

    @pytest.mark.parametrize("codec,paged", [
        ("none", True), ("blockfloat8", True), ("none", False), ("blockfloat8", False)])
    def test_recycled_slot_bitwise_equals_fresh(self, tiny, codec, paged):
        cfg, model, params = tiny

        def mk():
            return ServingEngine(model, params, EngineConfig(
                batch_slots=2, max_len=64, codec=codec, paged=paged))
        a = Request(uid=0, prompt=[9, 8, 7, 6], max_new_tokens=2)
        b = Request(uid=1, prompt=[5, 4, 3], max_new_tokens=12)
        c = Request(uid=2, prompt=[2, 7, 1, 8, 2], max_new_tokens=6)
        _drain(mk(), [a, b, c])
        fresh = Request(uid=2, prompt=[2, 7, 1, 8, 2], max_new_tokens=6)
        _drain(mk(), [fresh])
        assert c.out_tokens == fresh.out_tokens, (codec, paged)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_staggered_admission_any_order(self, tiny, seed):
        cfg, model, params = tiny
        rng = np.random.default_rng(seed)
        protos = [([int(t) for t in rng.integers(1, 99, size=2 + i % 3)],
                   2 + int(rng.integers(0, 4))) for i in range(4)]

        def mk():
            return ServingEngine(model, params, EngineConfig(
                batch_slots=2, max_len=48, codec="blockfloat8"))
        solo = []
        for prompt, max_new in protos:
            r = Request(uid=0, prompt=list(prompt), max_new_tokens=max_new)
            _drain(mk(), [r])
            solo.append(r.out_tokens)
        eng = mk()
        live = []
        for uid in rng.permutation(len(protos)):
            prompt, max_new = protos[uid]
            r = Request(uid=int(uid), prompt=list(prompt), max_new_tokens=max_new)
            eng.submit(r)
            live.append(r)
            for _ in range(int(rng.integers(0, 3))):  # stagger admissions
                eng.tick()
        assert eng.run_until_drained().drained
        for r in live:
            assert r.out_tokens == solo[r.uid], (seed, r.uid)

    @pytest.mark.parametrize("paged", [True, False])
    def test_cache_zeroed_after_drain(self, tiny, paged):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=2, max_len=32, codec="blockfloat8", paged=paged))
        _drain(eng, [Request(uid=u, prompt=[3 + u, 1, 4], max_new_tokens=3) for u in range(3)])
        for leaf in eng.cache.values():
            assert not leaf.any(), paged


class TestSamplingAndConfig:
    def _mk(self, model, params, **kw):
        return ServingEngine(model, params, EngineConfig(
            batch_slots=2, max_len=48, codec="none", greedy=False, temperature=0.8,
            sample_seed=7, **kw))

    def test_temperature_sampling_deterministic_seeded(self, tiny):
        cfg, model, params = tiny
        outs = []
        for _ in range(2):
            r = Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6)
            _drain(self._mk(model, params), [r])
            assert len(r.out_tokens) == 6
            assert all(0 <= t < cfg.padded_vocab for t in r.out_tokens)
            outs.append(r.out_tokens)
        assert outs[0] == outs[1]  # same seed -> same sequence

    def test_seed_uid_and_index_each_change_the_draw(self):
        seeds = {tengine.sample_seed(s, u, t) for s in (0, 7) for u in (0, 1, 2**31 - 1)
                 for t in (0, 1, 5)}
        assert len(seeds) == 18
        assert tengine.sample_seed(7, 3, 4) == tengine.sample_seed(7, 3, 4)

    def test_sampling_follows_the_distribution(self, tiny):
        """Gumbel-max over logits / T draws each token with softmax
        probability: a peaked row is drawn at its peak, a flat row spreads."""
        cfg, model, params = tiny
        eng = self._mk(model, params)
        logits = torch.full((2, 50), -30.0)
        logits[0, 17] = 30.0
        logits[1] = 0.0
        picks = {0: [], 1: []}
        for uid in range(60):
            req = Request(uid=uid, prompt=[1], max_new_tokens=1)
            out = eng._sample(logits, [(0, req), (1, req)])
            picks[0].append(out[0])
            picks[1].append(out[1])
        assert set(picks[0]) == {17}
        assert len(set(picks[1])) > 25

    def test_invalid_temperature_rejected(self):
        with pytest.raises(ValueError, match="temperature"):
            EngineConfig(greedy=False, temperature=0.0)
        with pytest.raises(ValueError, match="temperature"):
            EngineConfig(greedy=False, temperature=-1.0)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="codec"):
            EngineConfig(codec="zstd")
        with pytest.raises(ValueError, match="fused"):
            EngineConfig(attention="fused", codec="none")
        with pytest.raises(ValueError, match="attention"):
            EngineConfig(attention="flash")
        with pytest.raises(ValueError, match="paged"):
            EngineConfig(paged="yes")
        with pytest.raises(ValueError, match="positive"):
            EngineConfig(page_size=0)

    def test_prompt_longer_than_max_len_rejected(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", max_len=8)
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=2))

    def test_auto_attention_is_plain_on_the_cpu(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(codec="blockfloat8"))
        assert not eng._fused and eng._attention == "xla"


class TestDrainAndTicks:
    def test_drain_returns_all_submitted_with_flag(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", slots=2)
        reqs = [Request(uid=u, prompt=[1 + u, 2], max_new_tokens=50) for u in range(3)]
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained(max_ticks=3)
        assert len(done) == 3 and done.drained is False
        assert any(not r.done for r in done)
        done2 = eng.run_until_drained()
        assert done2.drained and all(r.done for r in done2)

    def test_idle_ticks_are_counted(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none")
        before = eng.ticks
        assert eng.tick() == 0 and eng.tick() == 0
        assert eng.ticks == before + 2 and eng.steps == 0

    def test_prefill_matches_tokenwise_decode(self, tiny):
        cfg, model, params = tiny
        eng_pf = _mk_engine(model, params, "none")
        assert eng_pf._can_prefill
        r_pf = Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
        _drain(eng_pf, [r_pf])
        eng_tw = _mk_engine(model, params, "none")
        eng_tw._can_prefill = False  # force the token-by-token fallback
        r_tw = Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
        _drain(eng_tw, [r_tw])
        assert r_pf.out_tokens == r_tw.out_tokens

    def test_fused_attention_agrees(self, tiny):
        """attention='fused' routes decode through K10 (its plain version on
        the CPU); greedy tokens agree with the plain attention."""
        cfg, model, params = tiny
        seqs = {}
        for mode in ("xla", "fused"):
            eng = ServingEngine(model, params, EngineConfig(
                batch_slots=2, max_len=32, codec="blockfloat8", attention=mode))
            assert eng._fused == (mode == "fused")
            r = Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=8)
            _drain(eng, [r])
            seqs[mode] = r.out_tokens
        agree = sum(a == b for a, b in zip(seqs["xla"], seqs["fused"]))
        assert agree >= 6, seqs


class TestAdmission:
    def test_ladder_quantization(self):
        ctl = AdmissionController(AdmissionConfig(ladder=(1, 2, 4)), 8)
        assert ctl.rung(1) == 1 and ctl.rung(2) == 2 and ctl.rung(3) == 4
        assert ctl.rung(9) == 4
        assert ctl.admittable(live=0, queued=3) == 4
        assert ctl.admittable(live=4, queued=10) == 0

    def test_max_live_batches(self):
        ctl = AdmissionController(AdmissionConfig(ladder=(2,), max_live_batches=2), 8)
        assert ctl.max_live == 4
        assert ctl.admittable(live=3, queued=5) == 1

    def test_validation(self):
        with pytest.raises(ValueError):
            AdmissionController(AdmissionConfig(ladder=(0, 2)), 8)
        with pytest.raises(ValueError):
            AdmissionController(AdmissionConfig(ladder=(16,)), 8)
        with pytest.raises(ValueError):
            AdmissionController(AdmissionConfig(max_live_batches=0), 8)

    def test_engine_respects_ladder(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=4, max_len=32, codec="none", ladder=(2,), max_live_batches=1))
        for u in range(4):
            eng.submit(Request(uid=u, prompt=[1 + u, 2], max_new_tokens=4))
        eng.tick()
        assert len(eng._live()) <= 2
        done = eng.run_until_drained()
        assert done.drained and len(done) == 4


class TestPagePool:
    def _pool(self, model, **kw):
        kw = {"batch_slots": 4, "max_len": 64, "page_size": 16, **kw}
        return PagePool(model, L.KVCodecConfig(kw.pop("codec", "none")), **kw)

    def test_alloc_free_roundtrip(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model)
        assert pool.max_pages == 4
        total = pool.free_pages
        pages = pool.allocate(0, 40)  # 3 pages
        assert len(pages) == 3 and 0 not in pages  # page 0 is reserved
        table = pool.page_table()
        assert list(table[0][:3]) == pages and table[0][3] == 0
        assert (table[1:] == 0).all() and pool.used_pages == 3
        with pytest.raises(ValueError):
            pool.allocate(0, 8)  # slot already mapped
        assert sorted(pool.free_slot(0)) == sorted(pages)
        assert pool.free_pages == total and (pool.page_table() == 0).all()

    def test_exhaustion_and_capacity(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model, batch_slots=8, max_len=32, n_pages=4)
        assert pool.capacity_requests(32) == 2
        pool.allocate(0, 32)
        pool.allocate(1, 32)
        assert not pool.can_admit(16)
        with pytest.raises(PoolExhausted):
            pool.allocate(2, 16)

    def test_bf8_pool_admits_1p8x_at_equal_bytes(self, tiny):
        model64 = registry.build_model(
            registry.get_config("starcoder2-3b", smoke=True).scaled(head_dim=64), device="cpu")
        raw = PagePool(model64, L.KVCodecConfig("none"), 32, 64, 16)
        budget = raw.page_nbytes * 32
        caps = {codec: PagePool(model64, L.KVCodecConfig(codec), 32, 64, 16,
                                pool_bytes=budget).capacity_requests(64)
                for codec in ("none", "blockfloat8")}
        assert caps["blockfloat8"] >= 1.8 * caps["none"], caps

    def test_double_free_raises_typed_error(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model)
        pages = pool.allocate(0, 40)
        pool._slot_pages[1] = [pages[0]]  # simulate an aliasing bug
        pool.free_slot(0)
        before = pool.free_pages
        with pytest.raises(PageAccountingError, match="double free"):
            pool.free_slot(1)
        assert pool.free_pages == before

    def test_freeing_zero_page_raises_typed_error(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model)
        pool._slot_pages[0] = [0]
        with pytest.raises(PageAccountingError, match="zero page"):
            pool.free_slot(0)
        pool._slot_pages[1] = [pool.n_pages + 5]
        with pytest.raises(PageAccountingError, match="outside the pool"):
            pool.free_slot(1)

    def test_failed_admission_leaves_accounting_untouched(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model, batch_slots=8, n_pages=4)
        pool.allocate(0, 32)
        free_before = pool.free_pages
        with pytest.raises(PoolExhausted):
            pool.allocate(1, 64)
        assert pool.free_pages == free_before and pool.slot_pages(1) == []
        pool.allocate(1, 32)
        assert pool.free_pages == 0

    def test_out_of_band_reservation_and_reset(self, tiny):
        cfg, model, params = tiny
        pool = self._pool(model, n_pages=6, codec="blockfloat8")
        pool.reserve_pages(("fault", 0, 2), 2)
        assert pool.free_pages == 4 and (pool.page_table() == 0).all()
        assert ("fault", 0, 2) in pool.owners()
        with pytest.raises(PageAccountingError, match="still mapped"):
            pool.reset()
        pool.free_slot(("fault", 0, 2))
        pool.cache["k_codes"][:, 3] = 5  # stale contents a restart must clear
        pool.reset()
        assert pool.free_pages == 6 and pool.free_ids() == tuple([0, *pool._free])
        assert not any(leaf.any() for leaf in pool.cache.values())

    def test_engine_bounded_by_pool_not_slots(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=6, max_len=32, codec="none", paged=True, page_size=16, pool_pages=4))
        for u in range(6):
            eng.submit(Request(uid=u, prompt=[1 + u, 2], max_new_tokens=29))
        eng.tick()
        assert len(eng._live()) == 2 and len(eng.pending) == 4
        done = eng.run_until_drained()
        assert done.drained and len(done) == 6 and all(r.done for r in done)


class TestPerRequestSampling:
    """Sampling seeds are a pure function of (seed, uid, token index), so a
    re-dispatched sampled request reproduces its stream on any engine."""

    def _mk(self, model, params):
        return ServingEngine(model, params, EngineConfig(
            batch_slots=2, max_len=48, codec="none", greedy=False, temperature=0.8,
            sample_seed=7))

    def test_sampled_continuation_matches_solo_run(self, tiny):
        cfg, model, params = tiny
        solo = Request(uid=9, prompt=[3, 1, 4], max_new_tokens=8)
        _drain(self._mk(model, params), [solo])
        k = 3  # re-dispatch after k emitted tokens, as a router would
        cont = Request(uid=9, prompt=[3, 1, 4] + solo.out_tokens[:k], max_new_tokens=8 - k,
                       key_offset=k)
        _drain(self._mk(model, params), [cont])
        assert cont.out_tokens == solo.out_tokens[k:]

    def test_sampled_independent_of_batch_composition(self, tiny):
        cfg, model, params = tiny
        solo = Request(uid=5, prompt=[2, 7, 1], max_new_tokens=6)
        _drain(self._mk(model, params), [solo])
        crowded = Request(uid=5, prompt=[2, 7, 1], max_new_tokens=6)
        other = Request(uid=6, prompt=[8, 8], max_new_tokens=9)
        _drain(self._mk(model, params), [crowded, other])
        assert crowded.out_tokens == solo.out_tokens


class TestLivelockGuard:
    def test_unservable_request_stalls_out_early(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=2, max_len=64, codec="none", paged=True, page_size=16, pool_pages=2))
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=60))
        done = eng.run_until_drained(max_ticks=500, stall_ticks=20)
        assert done.drained is False and done.stalls >= 20
        assert eng.ticks < 100

    def test_normal_drain_reports_zero_stalls(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(batch_slots=2, max_len=32, codec="none"))
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=4))
        done = eng.run_until_drained()
        assert done.drained and done.stalls == 0


class TestFailoverPrimitives:
    """The engine-side seams a router builds on: cancel, drain, integrity
    probe, reset."""

    def test_cancel_queued_and_live(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", slots=2)
        a, b, c = (Request(uid=u, prompt=[1 + 2 * u, 2 + 2 * u], max_new_tokens=20)
                   for u in range(3))
        for r in (a, b, c):
            eng.submit(r)
        eng.tick()  # a, b live; c queued
        assert eng.cancel(c) and c not in eng.pending
        assert eng.cancel(a) and len(eng._live()) == 1
        assert not a.done
        assert eng.cancel(a) is False

    def test_drain_requests_returns_everything_and_empties(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", slots=2)
        for u in range(4):
            eng.submit(Request(uid=u, prompt=[1 + u], max_new_tokens=20))
        eng.tick()
        evicted = eng.drain_requests()
        assert len(evicted) == 4 and not eng._live() and not eng.pending
        assert eng.check_kv_integrity()

    @pytest.mark.parametrize("paged", [True, False])
    def test_integrity_probe_detects_poison(self, tiny, paged):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=2, max_len=32, codec="none", paged=paged))
        assert eng.check_kv_integrity()
        idx = eng.free_resource_ids()[0]
        for x in eng.cache.values():  # poison a free row, as a fault injector would
            x[:, idx] = 17
        assert eng.check_kv_integrity() is False
        eng.reset()
        assert eng.check_kv_integrity()

    def test_reset_refuses_with_work_owned(self, tiny):
        cfg, model, params = tiny
        eng = _mk_engine(model, params, "none", slots=2)
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=8))
        eng.tick()
        with pytest.raises(RuntimeError, match="drain_requests"):
            eng.reset()
        eng.drain_requests()
        eng.reset()

    def test_can_accept_reflects_capacity(self, tiny):
        cfg, model, params = tiny
        eng = ServingEngine(model, params, EngineConfig(
            batch_slots=1, max_len=32, codec="none", paged=True, page_size=16))
        r = Request(uid=0, prompt=[1, 2], max_new_tokens=4)
        assert eng.can_accept(r)
        eng.submit(r)
        eng.tick()
        assert not eng.can_accept(Request(uid=1, prompt=[3], max_new_tokens=4))
        assert not eng.can_accept(Request(uid=2, prompt=list(range(1, 40)), max_new_tokens=4))

    def test_tick_hook_aborts_the_tick_untouched(self, tiny):
        cfg, model, params = tiny
        calls = []

        def hook(engine):
            calls.append(engine.ticks)
            if len(calls) == 2:
                raise RuntimeError("injected")

        eng = ServingEngine(model, params, EngineConfig(batch_slots=2, max_len=32, codec="none"),
                            tick_hook=hook)
        r = Request(uid=0, prompt=[1, 2], max_new_tokens=3)
        eng.submit(r)
        eng.tick()
        pos, ticks = eng.pos.copy(), eng.ticks
        with pytest.raises(RuntimeError, match="injected"):
            eng.tick()
        assert eng.ticks == ticks and (eng.pos == pos).all()
        assert eng.run_until_drained().drained and len(r.out_tokens) == 3


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu", "--codec",
                       "blockfloat8", "--requests", "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "paged KV" in out


def test_attention_probe_on_the_cpu():
    """The probe's f32 comparison at SMOKE size: K10's plain version and the
    plain attention give the same first tokens and, at 2 layers, decode-step
    logits within f32 rounding (1e-4)."""
    from repro_torch.launch import attention_probe

    out = attention_probe.main(["--smoke", "--device", "cpu", "--max-len", "64",
                                "--prompt-len", "3", "20", "--requests", "4", "--max-new", "4"])
    assert 0.0 <= out["agree_after_first"] <= 1.0
    assert list(out["depth"]) == [1, 2]
    assert all(0.0 <= v < 1e-4 for pair in out["depth"].values() for v in pair)
