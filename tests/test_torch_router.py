"""Twin tests of the port's multi-replica router and serving fault drill
(``repro_torch.serving.router``, ``repro_torch.serving.faults``): every test
of ``tests/test_router.py`` has its twin here, on the port's engine with the
reference fixture's parameters (starcoder2-3b SMOKE, ``init_params(specs,
key(0))``) carried across by ``params_from_jax``, run in float32.

* Greedy routed outcomes equal the *reference engine's* fault-free tokens,
  request for request, for every fault kind, paged and dense.
* Sampled routed outcomes equal the port's own fault-free single-engine
  run: the port draws token t of request ``uid`` from a generator seeded by
  ``sample_seed(seed, uid, t)``, which cannot equal JAX's keys; the
  reference's claim is that re-dispatch reproduces the original stream.
* Drill plans equal the reference's event for event, and their JSON byte
  for byte, for several seeds.
* The poison write hits exactly the reference's cache rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.spec import init_params as jinit
from repro.serving import faults as jfaults
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import registry
from repro_torch.models.interop import params_from_jax
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.faults import (DrillClock, InjectedTickError, ReplicaHang,
                                        SERVE_FAULT_KINDS, ServeFaultEvent,
                                        ServeFaultInjector, ServeFaultPlan)
from repro_torch.serving.router import (Router, RouterConfig, RouterRequest,
                                        SHED_REASONS, ShedResult)


def _cfg(reg):
    return reg.get_config("starcoder2-3b", smoke=True).scaled(dtype="float32")


@pytest.fixture(scope="module")
def twins():
    """(JAX model, JAX params, port model, port params): one tree of
    float32 weights in both packages."""
    jm = jreg.build_model(_cfg(jreg))
    jp = jinit(jm.specs(), jax.random.key(0), jnp.float32)
    tm = registry.build_model(_cfg(registry), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tm.specs(), "cpu", torch.float32)
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def tiny(twins):
    _, _, tm, tp = twins
    return None, tm, tp


def _ecfg(greedy: bool, paged: bool, slots: int = 2, max_len: int = 48, cls=EngineConfig):
    return cls(batch_slots=slots, max_len=max_len, codec="none", paged=paged, page_size=16,
               greedy=greedy, temperature=0.8, sample_seed=7)


_PROTOS = [([3, 1, 4, 1], 4), ([5, 9, 2], 5), ([6, 5, 3, 5], 4), ([8, 9], 6)]


def _fault_free(eng, request_cls) -> dict:
    reqs = [request_cls(uid=u, prompt=list(p), max_new_tokens=m)
            for u, (p, m) in enumerate(_PROTOS)]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained().drained
    return {r.uid: list(r.out_tokens) for r in reqs}


@pytest.fixture(scope="module")
def reference(twins):
    """Ground truth per (greedy, paged): the JAX engine's fault-free tokens
    for greedy decoding; for sampled decoding the port's own fault-free
    single engine."""
    jm, jp, tm, tp = twins
    cache = {}

    def get(greedy: bool, paged: bool) -> dict:
        key = (greedy, paged)
        if key not in cache:
            if greedy:
                eng = JServingEngine(jm, jp, _ecfg(True, paged, slots=4, cls=JEngineConfig))
                cache[key] = _fault_free(eng, JRequest)
            else:
                eng = ServingEngine(tm, tp, _ecfg(False, paged, slots=4))
                cache[key] = _fault_free(eng, Request)
        return cache[key]

    return get


def test_reference_greedy_equals_port_single_engine(twins, reference):
    """The ground truth the greedy cells use is also the port's own
    fault-free single-engine run (paged and dense)."""
    _, _, tm, tp = twins
    for paged in (True, False):
        mine = _fault_free(ServingEngine(tm, tp, _ecfg(True, paged, slots=4)), Request)
        assert mine == reference(True, paged)


_FAULT_KWARGS = {
    "pool_pressure": {},                          # seize everything free
    "kv_poison": {"seed": 3},
    "tick_error": {"count": 3},                   # outlasts health_failures
    "tick_stall": {"count": 3, "stall_s": 1.0},   # blows tick_deadline_s
    "hang": {},
}


def _routed_drill(model, params, kind: str, greedy: bool, paged: bool):
    clock = DrillClock()
    plan = ServeFaultPlan.single(kind, replica=1, tick=2, **_FAULT_KWARGS[kind])
    injector = ServeFaultInjector(plan, clock=clock)
    engines = [ServingEngine(model, params, _ecfg(greedy, paged),
                             tick_hook=injector.hook_for(rid), clock=clock)
               for rid in range(2)]
    router = Router(engines, RouterConfig(
        tick_deadline_s=0.5, max_retries=3, health_failures=2,
        probe_every=2, probe_successes=2, integrity_every=1), clock=clock)
    for u, (p, m) in enumerate(_PROTOS):
        router.submit(RouterRequest(uid=u, prompt=list(p), max_new_tokens=m))
    result = router.run_until_drained(max_ticks=300)
    return router, injector, result


class TestFaultMatrix:
    """Every (fault kind x sampling x cache layout) cell resolves every
    request — equal to the fault-free ground truth, or a typed shed."""

    @pytest.mark.parametrize("kind", SERVE_FAULT_KINDS)
    @pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
    @pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
    def test_matrix_cell(self, tiny, reference, kind, greedy, paged):
        _, model, params = tiny
        ref = reference(greedy, paged)
        router, injector, result = _routed_drill(model, params, kind, greedy, paged)
        assert result.drained, (kind, greedy, paged)
        assert len(result) == len(_PROTOS)  # nothing vanished
        assert injector.log, "the planned fault never fired"
        for rr in result:
            assert rr.finished, (kind, rr.uid, rr.status)
            if rr.status == "done":
                assert rr.tokens == ref[rr.uid], (kind, greedy, paged, rr.uid)
            else:
                assert rr.shed is not None and rr.shed.reason in SHED_REASONS
        # the drill is sized to be survivable: no shed under these faults
        assert not result.shed_requests, [r.shed for r in result.shed_requests]

    def test_hang_redispatches_to_other_replica(self, tiny):
        _, model, params = tiny
        router, injector, result = _routed_drill(model, params, "hang", greedy=True, paged=True)
        assert router.replicas[1].state == "quarantined"  # hangs never heal
        assert len(router.healthy()) == 1
        moved = [rr for rr in result if rr.attempts[:1] == [1]]
        assert moved, "nothing was ever dispatched to the hung replica"
        for rr in moved:
            assert rr.attempts[-1] == 0 and rr.retries >= 1

    def test_transient_error_readmits_replica(self, tiny):
        _, model, params = tiny
        router, injector, result = _routed_drill(model, params, "tick_error", greedy=True,
                                                 paged=True)
        assert result.drained
        for _ in range(12):
            if router.replicas[1].state == "healthy":
                break
            router.tick()
        assert router.replicas[1].state == "healthy"
        assert len(router.healthy()) == 2

    def test_kv_poison_never_leaks_into_output(self, tiny, reference):
        _, model, params = tiny
        ref = reference(True, True)
        router, injector, result = _routed_drill(model, params, "kv_poison", greedy=True,
                                                 paged=True)
        assert "kv_poison" in {k for _, _, k in injector.log}
        for rr in result.completed:
            assert rr.tokens == ref[rr.uid]
        assert result.drained


class TestRouterSemantics:
    def test_shed_result_validates_reason(self):
        with pytest.raises(ValueError, match="unknown shed reason"):
            ShedResult("oops")
        assert ShedResult("deadline").reason == "deadline"

    def test_config_validation(self):
        with pytest.raises(ValueError):
            RouterConfig(max_retries=-1)
        with pytest.raises(ValueError):
            RouterConfig(health_failures=0)
        with pytest.raises(ValueError):
            RouterConfig(integrity_every=-2)

    def test_deadline_sheds_queued_request(self, tiny):
        _, model, params = tiny
        clock = DrillClock()
        eng = ServingEngine(model, params, _ecfg(True, True, slots=1), clock=clock)
        router = Router([eng], RouterConfig(), clock=clock)
        router.submit(RouterRequest(uid=0, prompt=[1, 2], max_new_tokens=30))
        router.tick()
        router.submit(RouterRequest(uid=1, prompt=[3, 4], max_new_tokens=4, deadline_s=0.5))
        clock.advance(1.0)
        router.tick()
        rr = router.requests[1]
        assert rr.status == "shed" and rr.shed.reason == "deadline"
        result = router.run_until_drained(max_ticks=100)
        assert result.drained and router.requests[0].status == "done"

    def test_deadline_sheds_live_request_keeps_partial(self, tiny):
        _, model, params = tiny
        clock = DrillClock()
        eng = ServingEngine(model, params, _ecfg(True, True), clock=clock)
        router = Router([eng], RouterConfig(deadline_s=1.0), clock=clock)
        router.submit(RouterRequest(uid=0, prompt=[1, 2], max_new_tokens=40))
        for _ in range(3):
            router.tick()
        clock.advance(2.0)
        router.tick()
        rr = router.requests[0]
        assert rr.status == "shed" and rr.shed.reason == "deadline"
        assert rr.tokens, "partial decode should survive the shed"
        assert not eng._live() and not eng.pending
        assert eng.check_kv_integrity()  # the cancelled slot was zeroed

    def test_saturated_shed_is_newest_first(self, tiny):
        _, model, params = tiny
        eng = ServingEngine(model, params, _ecfg(True, True, slots=1))
        router = Router([eng], RouterConfig(max_queue=1))
        for u in range(4):
            router.submit(RouterRequest(uid=u, prompt=[1 + u], max_new_tokens=3))
        router.tick()
        shed = {rr.uid for rr in router.requests if rr.status == "shed"}
        assert shed == {2, 3}
        assert all(rr.shed.reason == "saturated"
                   for rr in router.requests if rr.status == "shed")
        result = router.run_until_drained(max_ticks=200)
        assert result.drained and len(result.completed) == 2

    def test_retries_exhausted_is_typed(self, tiny):
        _, model, params = tiny
        clock = DrillClock()
        injector = ServeFaultInjector(ServeFaultPlan.kill_replica(0, tick=1), clock=clock)
        eng = ServingEngine(model, params, _ecfg(True, True),
                            tick_hook=injector.hook_for(0), clock=clock)
        router = Router([eng], RouterConfig(max_retries=0, health_failures=2), clock=clock)
        router.submit(RouterRequest(uid=0, prompt=[1, 2], max_new_tokens=6))
        result = router.run_until_drained(max_ticks=50)
        assert result.drained
        rr = result[0]
        assert rr.status == "shed" and rr.shed.reason == "retries_exhausted"

    def test_submit_rejects_unservable_prompt(self, tiny):
        _, model, params = tiny
        eng = ServingEngine(model, params, _ecfg(True, True, max_len=16))
        router = Router([eng], RouterConfig())
        with pytest.raises(ValueError, match="fits no replica"):
            router.submit(RouterRequest(uid=0, prompt=list(range(1, 20)), max_new_tokens=2))

    def test_router_requires_replicas(self):
        with pytest.raises(ValueError, match="at least one"):
            Router([], RouterConfig())


class TestFaultPlans:
    @pytest.mark.parametrize("seed,n_replicas", [(0, 2), (7, 2), (11, 2), (5, 3), (123, 1)])
    def test_drill_equals_reference(self, seed, n_replicas):
        """Event for event and JSON byte for byte (both draw from
        ``np.random.default_rng(seed)``)."""
        mine = ServeFaultPlan.drill(seed=seed, n_replicas=n_replicas)
        ref = jfaults.ServeFaultPlan.drill(seed=seed, n_replicas=n_replicas)
        assert mine.to_json() == ref.to_json()
        assert [dataclass_tuple(e) for e in mine.events] == \
            [dataclass_tuple(e) for e in ref.events]
        assert ServeFaultPlan.from_json(ref.to_json()) == mine

    def test_drill_is_deterministic(self):
        a = ServeFaultPlan.drill(seed=11, n_replicas=2)
        b = ServeFaultPlan.drill(seed=11, n_replicas=2)
        assert a == b
        assert a != ServeFaultPlan.drill(seed=12, n_replicas=2)

    def test_json_roundtrip(self):
        plan = ServeFaultPlan.drill(seed=5, n_replicas=3)
        again = ServeFaultPlan.from_json(plan.to_json())
        assert again == plan and again.to_json() == plan.to_json()

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown serving fault kind"):
            ServeFaultEvent(tick=0, kind="meteor")

    def test_events_fire_at_most_once_and_replay_identically(self, tiny):
        _, model, params = tiny

        def run():
            clock = DrillClock()
            plan = ServeFaultPlan.from_events([
                ServeFaultEvent(tick=1, kind="tick_error", replica=0),
                ServeFaultEvent(tick=3, kind="pool_pressure", replica=0, pages=1)])
            injector = ServeFaultInjector(plan, clock=clock)
            eng = ServingEngine(model, params, _ecfg(True, True),
                                tick_hook=injector.hook_for(0), clock=clock)
            router = Router([eng], RouterConfig(health_failures=3), clock=clock)
            router.submit(RouterRequest(uid=0, prompt=[2, 3], max_new_tokens=8))
            router.run_until_drained(max_ticks=60)
            return injector.log

        log1, log2 = run(), run()
        assert log1 == log2
        assert len(log1) == len(set(log1)) == 2  # at most once each

    def test_hook_raises_before_engine_state_changes(self, tiny):
        _, model, params = tiny
        injector = ServeFaultInjector(ServeFaultPlan.single("tick_error", replica=0, tick=0))
        eng = ServingEngine(model, params, _ecfg(True, True), tick_hook=injector.hook_for(0))
        eng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=2))
        with pytest.raises(InjectedTickError):
            eng.tick()
        assert not eng._live() and len(eng.pending) == 1 and eng.ticks == 0
        assert eng.run_until_drained().drained

    def test_hang_raises_forever(self, tiny):
        _, model, params = tiny
        clock = DrillClock()
        injector = ServeFaultInjector(ServeFaultPlan.kill_replica(0, tick=0, stall_s=0.25),
                                      clock=clock)
        eng = ServingEngine(model, params, _ecfg(True, True),
                            tick_hook=injector.hook_for(0), clock=clock)
        for _ in range(3):
            with pytest.raises(ReplicaHang):
                eng.tick()
        assert clock.t == pytest.approx(0.75)  # each attempt burns stall_s


def dataclass_tuple(ev) -> tuple:
    return (ev.tick, ev.kind, ev.replica, ev.count, ev.stall_s, ev.pages, ev.lanes,
            ev.squat_tokens, ev.seed)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_poison_hits_the_reference_rows(twins, paged):
    """``_poison`` writes 17 into exactly the cache rows the reference's
    ``.at[:, idx].set(17)`` writes: the zero page (paged), or the free lane
    the event's seed picks (dense, with lane 0 live)."""
    jm, jp, tm, tp = twins
    ev = ServeFaultEvent(tick=0, kind="kv_poison", seed=5)
    jev = jfaults.ServeFaultEvent(tick=0, kind="kv_poison", seed=5)
    jeng = JServingEngine(jm, jp, _ecfg(True, paged, slots=4, cls=JEngineConfig))
    teng = ServingEngine(tm, tp, _ecfg(True, paged, slots=4))
    jeng.submit(JRequest(uid=0, prompt=[1, 2], max_new_tokens=4))
    teng.submit(Request(uid=0, prompt=[1, 2], max_new_tokens=4))
    jeng.tick()
    teng.tick()
    assert jfaults.ServeFaultInjector(jfaults.ServeFaultPlan((jev,)))._poison(jeng, jev)
    assert ServeFaultInjector(ServeFaultPlan((ev,)))._poison(teng, ev)
    assert set(jeng.cache) == set(teng.cache)
    for k in teng.cache:
        want = np.asarray(jeng.cache[k]) == 17
        got = (teng.cache[k] == 17).numpy()
        np.testing.assert_array_equal(got, want, err_msg=k)
        assert got.any()
    assert not teng.check_kv_integrity()


def test_serve_launcher_routed_drill(capsys):
    """``launch/serve.py main --replicas 2 --fault-seed 0`` on the CPU: every
    request completes, faults fire, both replicas end healthy."""
    from repro_torch.launch import serve

    assert serve.main(["--arch", "starcoder2-3b", "--smoke", "--device", "cpu",
                       "--replicas", "2", "--fault-seed", "0", "--requests", "6",
                       "--max-new", "8"]) == 0
    out = capsys.readouterr().out
    assert "6 requests: 6 completed, 0 shed" in out
    assert "2/2 replicas healthy" in out
    assert "faults fired: none" not in out
