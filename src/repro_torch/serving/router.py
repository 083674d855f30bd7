"""Multi-replica request router: health-checked failover, deadlines,
bounded retry, typed shedding, and verified re-dispatch (the port of
``repro.serving.router``; DESIGN.md §13).

The router fronts N :class:`~repro_torch.serving.engine.ServingEngine` replicas
and owns the request queue; replicas own only the work they will actually
run (dispatch waits for ``engine.can_accept``).  Every submitted request
ends in exactly one typed terminal state — completed, or shed with a
:class:`ShedResult` reason — never a silent drop.

Semantics
---------
* **Deadlines** — each request carries a completion deadline (router
  default or per-request).  Expiry sheds it with reason ``deadline``,
  whether queued or live (a live request's slot is cancelled and zeroed).
  Time comes from an injectable ``clock`` so drills are deterministic.
* **Health / circuit breaking** — a replica tick that raises, blows the
  ``tick_deadline_s`` budget, or fails the zero-on-free integrity probe
  counts a failure; ``health_failures`` CONSECUTIVE failures (or a single
  integrity failure — corruption is definitive) quarantines the replica.
  Quarantined replicas are drained, reset to a pristine cache, and probed
  every ``probe_every`` router ticks; ``probe_successes`` consecutive
  clean probes re-admit them.  A hung replica keeps failing its probes
  and stays quarantined.
* **Failover / re-dispatch** — quarantining a replica evicts its live and
  queued requests back to the router, which re-dispatches each one onto a
  DIFFERENT replica (when one exists) after an exponential
  ``backoff_ticks`` pause, at most ``max_retries`` times
  (``retries_exhausted`` shed beyond that).  Re-dispatch re-prefills
  ``prompt + tokens_so_far`` with the sampling-key offset advanced, so a
  greedy continuation is bitwise identical to an uninterrupted run and a
  sampled one reproduces its original token stream (engine keys are
  per-(seed, uid, token index)).
* **Verified re-dispatch** — with ``integrity_every`` set, a replica's
  output is only trusted up to its last clean zero-on-free probe:
  completions hold until the replica's next clean probe, and a replica
  caught corrupt has its requests rolled back to their verified prefix
  before re-dispatch — tokens decoded against poisoned KV never escape.
* **Shedding** — ``max_queue`` bounds the router queue once every healthy
  pool is saturated; overflow is shed newest-first with reason
  ``saturated``.  A continuation that no longer fits any replica's
  ``max_len`` sheds as ``capacity``.

Observability: gauges ``router.healthy`` / ``router.queue_depth``,
counters ``router.{completed,shed,redispatched,quarantined,readmitted}``,
events ``router.{quarantine,readmit,redispatch,shed,tick_failed}``,
histogram ``router.request_s``, span ``router.tick``.

The router is host code and the reference's line for line.  Replicas on one
card share one parameter tree; each owns only its cache or page pool.  A
sampled continuation reproduces the original stream because the port's
engine draws token t of a request from a generator seeded by
``sample_seed(seed, uid, key_offset + t)``, not from JAX's keys.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.engine import Request, ServingEngine

SHED_REASONS = ("deadline", "saturated", "retries_exhausted", "capacity")


@dataclasses.dataclass(frozen=True)
class ShedResult:
    """A typed refusal: why the router gave up on a request.  Partial
    tokens (if any) stay on the request itself."""

    reason: str
    detail: str = ""

    def __post_init__(self):
        if self.reason not in SHED_REASONS:
            raise ValueError(f"unknown shed reason {self.reason!r}; "
                             f"one of {SHED_REASONS}")


@dataclasses.dataclass
class RouterConfig:
    # per-request completion deadline (seconds on ``clock``); None = none.
    deadline_s: Optional[float] = None
    # one engine tick slower than this counts as a health failure
    # (None = no tick deadline — the right default under real wall clocks,
    # where the first tick pays jit compilation).
    tick_deadline_s: Optional[float] = None
    max_retries: int = 2          # re-dispatches per request
    backoff_ticks: int = 1        # base re-dispatch pause, doubles per retry
    health_failures: int = 2      # k consecutive failures => quarantine
    probe_every: int = 2          # router ticks between quarantine probes
    probe_successes: int = 2      # consecutive clean probes => re-admit
    integrity_every: int = 0      # zero-on-free probe cadence (0 = never)
    max_queue: Optional[int] = None  # queue bound; overflow sheds saturated

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_ticks < 0:
            raise ValueError("max_retries and backoff_ticks must be >= 0")
        if self.health_failures <= 0 or self.probe_every <= 0 \
                or self.probe_successes <= 0:
            raise ValueError("health_failures, probe_every and "
                             "probe_successes must be positive")
        if self.integrity_every < 0:
            raise ValueError(f"integrity_every must be >= 0: "
                             f"{self.integrity_every}")


@dataclasses.dataclass
class RouterRequest:
    """One routed request.  Terminal state is ``status`` ``done`` (tokens
    complete) or ``shed`` (``.shed`` holds the typed reason; ``tokens``
    keeps whatever verified prefix was decoded)."""

    uid: int
    prompt: list[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None  # overrides RouterConfig.deadline_s
    tokens: list[int] = dataclasses.field(default_factory=list)
    status: str = "queued"              # queued | live | done | shed
    shed: Optional[ShedResult] = None
    attempts: list[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    verified_len: int = 0               # tokens vouched by a clean probe
    submitted_t: Optional[float] = None
    completed_t: Optional[float] = None
    eligible_tick: int = 0              # backoff: no dispatch before this
    _engine_req: Optional[Request] = dataclasses.field(
        default=None, repr=False)

    @property
    def finished(self) -> bool:
        return self.status in ("done", "shed")


class _Replica:
    __slots__ = ("rid", "engine", "state", "fail_streak", "probe_streak",
                 "quarantined_at", "failures", "live", "pending_done")

    def __init__(self, rid: int, engine: ServingEngine):
        self.rid = rid
        self.engine = engine
        self.state = "healthy"          # healthy | quarantined
        self.fail_streak = 0
        self.probe_streak = 0
        self.quarantined_at = -1
        self.failures = 0               # lifetime failure count
        self.live: dict[int, RouterRequest] = {}
        self.pending_done: list[RouterRequest] = []  # await integrity probe


class RouterDrainResult(list):
    """All requests ever submitted, in submission order.  ``drained`` is
    False when ``max_ticks`` ran out with work still unresolved (those
    requests come back with status ``queued``/``live`` — visible, never
    dropped)."""

    def __init__(self, requests, drained: bool):
        super().__init__(requests)
        self.drained = drained

    @property
    def completed(self) -> list[RouterRequest]:
        return [r for r in self if r.status == "done"]

    @property
    def shed_requests(self) -> list[RouterRequest]:
        return [r for r in self if r.status == "shed"]


class Router:
    def __init__(self, engines: list[ServingEngine],
                 cfg: RouterConfig = RouterConfig(), *, clock=time.time):
        if not engines:
            raise ValueError("Router needs at least one engine replica")
        self.cfg = cfg
        self.clock = clock
        self.replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self.queue: list[RouterRequest] = []
        self.requests: list[RouterRequest] = []  # everything ever submitted
        self.ticks = 0
        self._g_healthy = obs_metrics.gauge("router.healthy")
        self._g_queue = obs_metrics.gauge("router.queue_depth")
        self._c_completed = obs_metrics.counter("router.completed")
        self._c_shed = obs_metrics.counter("router.shed")
        self._c_redispatched = obs_metrics.counter("router.redispatched")
        self._c_quarantined = obs_metrics.counter("router.quarantined")
        self._c_readmitted = obs_metrics.counter("router.readmitted")
        self._h_request = obs_metrics.histogram("router.request_s")

    # -------------------------------------------------------- lifecycle --
    def submit(self, rr: RouterRequest) -> None:
        if not rr.prompt:
            rr.prompt = [0]
        fit = max(r.engine.cfg.max_len for r in self.replicas)
        if len(rr.prompt) > fit - 1:
            raise ValueError(f"prompt of {len(rr.prompt)} tokens fits no "
                             f"replica (largest max_len={fit})")
        rr.submitted_t = self.clock()
        rr.status = "queued"
        self.queue.append(rr)
        self.requests.append(rr)

    def healthy(self) -> list[_Replica]:
        return [r for r in self.replicas if r.state == "healthy"]

    def unresolved(self) -> list[RouterRequest]:
        return [r for r in self.requests if not r.finished]

    # ------------------------------------------------------------- tick --
    def tick(self) -> None:
        """One router step: shed expired work, dispatch the queue, tick
        every healthy replica under the health guard, then probe
        quarantined replicas."""
        t = self.ticks
        with obs_trace.span("router.tick", tick=t):
            self._shed_expired()
            self._dispatch(t)
            for rep in self.replicas:
                if rep.state == "healthy":
                    self._tick_replica(rep, t)
            self._probe(t)
        self._g_healthy.set(len(self.healthy()))
        self._g_queue.set(len(self.queue))
        self.ticks += 1

    def run_until_drained(self, max_ticks: int = 10_000) -> RouterDrainResult:
        for _ in range(max_ticks):
            if not self.unresolved():
                break
            self.tick()
        drained = not self.unresolved()
        if not drained:
            obs_metrics.event("router.drain_exhausted",
                              unresolved=len(self.unresolved()),
                              max_ticks=max_ticks)
        return RouterDrainResult(self.requests, drained)

    # -------------------------------------------------------- deadlines --
    def _deadline(self, rr: RouterRequest) -> Optional[float]:
        return rr.deadline_s if rr.deadline_s is not None \
            else self.cfg.deadline_s

    def _shed_expired(self) -> None:
        now = self.clock()
        for rr in list(self.queue):
            d = self._deadline(rr)
            if d is not None and now - rr.submitted_t > d:
                self.queue.remove(rr)
                self._shed(rr, "deadline", f"queued past {d}s")
        for rep in self.replicas:
            for rr in list(rep.live.values()):
                d = self._deadline(rr)
                if d is not None and now - rr.submitted_t > d:
                    rep.engine.cancel(rr._engine_req)
                    rr.tokens = rr.tokens + list(rr._engine_req.out_tokens)
                    del rep.live[rr.uid]
                    self._shed(rr, "deadline", f"live past {d}s "
                               f"on replica {rep.rid}")

    def _shed(self, rr: RouterRequest, reason: str, detail: str = "") -> None:
        rr.status = "shed"
        rr.shed = ShedResult(reason, detail)
        rr._engine_req = None
        self._c_shed.inc()
        obs_metrics.event("router.shed", uid=rr.uid, reason=reason,
                          detail=detail)

    # --------------------------------------------------------- dispatch --
    def _engine_request(self, rr: RouterRequest) -> Request:
        """The engine-level (re-)dispatch: re-prefill the prompt plus every
        token already decoded, ask only for the remainder, and advance the
        sampling-key offset by the prefix — deterministic continuation."""
        return Request(uid=rr.uid, prompt=rr.prompt + rr.tokens,
                       max_new_tokens=rr.max_new_tokens - len(rr.tokens),
                       key_offset=len(rr.tokens))

    def _pick(self, ereq: Request,
              attempted: list[int]) -> Optional[_Replica]:
        ready = [r for r in self.healthy() if r.engine.can_accept(ereq)]
        if not ready:
            return None
        fresh = [r for r in ready if r.rid not in attempted]
        pool = fresh or ready  # a different replica when one exists
        return min(pool, key=lambda r: (len(r.live), r.rid))

    def _dispatch(self, t: int) -> None:
        for rr in list(self.queue):
            if rr.eligible_tick > t:
                continue
            ereq = self._engine_request(rr)
            rep = self._pick(ereq, rr.attempts)
            if rep is None:
                continue
            rep.engine.submit(ereq)
            rr._engine_req = ereq
            rr.status = "live"
            rr.attempts.append(rep.rid)
            rep.live[rr.uid] = rr
            self.queue.remove(rr)
        if self.cfg.max_queue is not None:
            while len(self.queue) > self.cfg.max_queue:
                rr = self.queue.pop()  # newest first: oldest keep their turn
                self._shed(rr, "saturated",
                           f"queue > {self.cfg.max_queue} with every "
                           "healthy pool saturated")

    # ----------------------------------------------------------- health --
    def _tick_replica(self, rep: _Replica, t: int) -> None:
        t0 = self.clock()
        cause = None
        try:
            rep.engine.tick()
        except Exception as e:  # noqa: BLE001 — any tick blow-up is a fault
            cause = f"tick_error: {type(e).__name__}: {e}"
        if cause is None and self.cfg.tick_deadline_s is not None:
            dt = self.clock() - t0
            if dt > self.cfg.tick_deadline_s:
                cause = (f"tick_stall: {dt:.3f}s > "
                         f"{self.cfg.tick_deadline_s}s")
        corrupt = False
        verified = False
        if cause is None and self.cfg.integrity_every \
                and t % self.cfg.integrity_every == 0:
            if rep.engine.check_kv_integrity():
                verified = True
            else:
                corrupt = True
                cause = "kv_integrity: zero-on-free invariant violated"
        if cause is None:
            rep.fail_streak = 0
            self._collect(rep, verified)
            return
        rep.fail_streak += 1
        rep.failures += 1
        obs_metrics.event("router.tick_failed", replica=rep.rid, cause=cause)
        if corrupt or rep.fail_streak >= self.cfg.health_failures:
            self._quarantine(rep, t, cause, corrupt)

    def _collect(self, rep: _Replica, verified: bool) -> None:
        """Harvest a healthy replica's completions and (when this tick ran
        a clean integrity probe) extend every live request's verified
        prefix.  With probing enabled, completions hold in ``pending_done``
        until the replica's next clean probe vouches for them."""
        for rr in list(rep.live.values()):
            ereq = rr._engine_req
            if ereq.done:
                del rep.live[rr.uid]
                if self.cfg.integrity_every and not verified:
                    rep.pending_done.append(rr)
                else:
                    self._finalize(rr)
            elif verified:
                rr.verified_len = len(rr.tokens) + len(ereq.out_tokens)
        if verified:
            for rr in rep.pending_done:
                rr.verified_len = len(rr.tokens) + len(rr._engine_req.out_tokens)
                self._finalize(rr)
            rep.pending_done = []

    def _finalize(self, rr: RouterRequest) -> None:
        rr.tokens = rr.tokens + list(rr._engine_req.out_tokens)
        rr.status = "done"
        rr._engine_req = None
        rr.completed_t = self.clock()
        self._c_completed.inc()
        if rr.submitted_t is not None:
            self._h_request.observe(rr.completed_t - rr.submitted_t)

    def _quarantine(self, rep: _Replica, t: int, cause: str,
                    corrupt: bool) -> None:
        """Open the circuit: drain every request off the replica, roll each
        back to its trustworthy prefix (everything decoded so far for
        crash-class faults; only the verified prefix when the KV was caught
        corrupt), reset the replica to a pristine cache, and requeue the
        work for re-dispatch elsewhere."""
        rep.state = "quarantined"
        rep.quarantined_at = t
        rep.probe_streak = 0
        self._c_quarantined.inc()
        obs_metrics.event("router.quarantine", replica=rep.rid, cause=cause,
                          live=len(rep.live), pending_done=len(rep.pending_done))
        rep.engine.drain_requests()
        victims = list(rep.live.values()) + rep.pending_done
        rep.live = {}
        rep.pending_done = []
        rep.engine.reset()  # pristine zeroed cache: probes verify a clean slate
        for rr in victims:
            full = rr.tokens + list(rr._engine_req.out_tokens)
            kept = full[:rr.verified_len] if corrupt else full
            self._requeue(rr, kept, t, rep.rid)

    def _requeue(self, rr: RouterRequest, kept: list[int], t: int,
                 rid: int) -> None:
        rr.tokens = kept
        rr._engine_req = None
        if len(kept) >= rr.max_new_tokens:
            # everything it needed was already decoded (and trusted)
            rr.status = "done"
            rr.completed_t = self.clock()
            self._c_completed.inc()
            if rr.submitted_t is not None:
                self._h_request.observe(rr.completed_t - rr.submitted_t)
            return
        rr.retries += 1
        if rr.retries > self.cfg.max_retries:
            self._shed(rr, "retries_exhausted",
                       f"{rr.retries - 1} re-dispatches after losing "
                       f"replica {rid}")
            return
        fit = max(r.engine.cfg.max_len for r in self.replicas)
        if len(rr.prompt) + len(kept) > fit - 1:
            self._shed(rr, "capacity",
                       f"continuation of {len(rr.prompt) + len(kept)} tokens "
                       f"fits no replica (largest max_len={fit})")
            return
        rr.status = "queued"
        rr.eligible_tick = t + self.cfg.backoff_ticks * (2 ** (rr.retries - 1))
        self.queue.insert(0, rr)  # evicted work is oldest: keep its turn
        self._c_redispatched.inc()
        obs_metrics.event("router.redispatch", uid=rr.uid, from_replica=rid,
                          retries=rr.retries, kept_tokens=len(kept),
                          eligible_tick=rr.eligible_tick)

    def _probe(self, t: int) -> None:
        for rep in self.replicas:
            if rep.state != "quarantined" or t == rep.quarantined_at:
                continue
            if (t - rep.quarantined_at) % self.cfg.probe_every != 0:
                continue
            t0 = self.clock()
            ok = True
            try:
                rep.engine.tick()  # idle probe tick (drained at quarantine)
            except Exception:  # noqa: BLE001
                ok = False
            if ok and self.cfg.tick_deadline_s is not None \
                    and self.clock() - t0 > self.cfg.tick_deadline_s:
                ok = False
            if ok and self.cfg.integrity_every:
                ok = rep.engine.check_kv_integrity()
            if not ok:
                rep.probe_streak = 0
                continue
            rep.probe_streak += 1
            if rep.probe_streak >= self.cfg.probe_successes:
                rep.state = "healthy"
                rep.fail_streak = 0
                self._c_readmitted.inc()
                obs_metrics.event("router.readmit", replica=rep.rid,
                                  quarantined_for=t - rep.quarantined_at)
