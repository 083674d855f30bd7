"""Deterministic fault injection for the serving-tier drill (the port of
``repro.serving.faults``).

The paged compressed-KV engine only earns the capacity claim if the
tier around it survives a replica dying mid-decode.  This module is the
adversary half of that story, in the exact mold of ``train.faults``: a
seeded :class:`ServeFaultPlan` (a list of :class:`ServeFaultEvent` keyed
by (replica, replica-local tick)) and a :class:`ServeFaultInjector` that
delivers the plan through ONE explicit hook — ``ServingEngine(tick_hook=
injector.hook_for(rid))`` fires at the top of every engine tick, before
any state changes — never by monkeypatching, so the same seeded plan
replays the same failure sequence.

Fault kinds (``SERVE_FAULT_KINDS`` order = same-tick application order)
-----------------------------------------------------------------------
``pool_pressure``   squeeze the replica's admission capacity: on a paged
                    engine, reserve ``pages`` raw pages out-of-band
                    (``PagePool.reserve_pages``); on a dense engine,
                    submit ``lanes`` squatter requests through the public
                    ``submit`` path.  Exercises deferral, rerouting, and
                    typed saturation shedding.
``kv_poison``       write nonzero garbage into a FREE resource row — the
                    reserved zero page (paged) or a seeded free lane
                    (dense; stays armed until a lane is free).  Detected
                    by the router's zero-on-free integrity probe
                    (``engine.check_kv_integrity``), never by the hook
                    announcing itself.
``tick_error``      the next ``count`` ticks raise
                    :class:`InjectedTickError` before any state changes.
``tick_stall``      the next ``count`` ticks advance the clock (or really
                    sleep) ``stall_s`` each — a straggling replica whose
                    ticks blow the router's tick deadline but still land.
``hang``            every tick from now on advances the clock ``stall_s``
                    and raises :class:`ReplicaHang` — a wedged replica
                    that never comes back (probes keep failing).

Every fired event lands in ``injector.log`` as ``(replica, tick, kind)``
so tests can assert a replayed plan fired identically, and events fire at
most once.

What differs from the reference: the poison is an in-place index write
(``leaf[:, idx] = 17``) into every leaf of the engine's cache or page
pool, on the device the cache lives on.  Plans, their draws from
``np.random.default_rng(seed)`` and their JSON are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional

import numpy as np

SERVE_FAULT_KINDS = ("pool_pressure", "kv_poison", "tick_error",
                     "tick_stall", "hang")


class ServingFault(RuntimeError):
    """Base class for injected serving faults raised out of a tick."""


class InjectedTickError(ServingFault):
    """A planned transient tick failure (raised before any state change)."""


class ReplicaHang(ServingFault):
    """A wedged replica: every tick fails, forever, until the process is
    replaced (which the drill never does — hangs are terminal)."""


class DrillClock:
    """Deterministic fake clock: time advances only when told to (``auto``
    per read, plus explicit :meth:`advance` from stall/hang events), so
    deadline and backoff semantics are testable without real sleeps."""

    def __init__(self, t0: float = 0.0, auto: float = 0.0):
        self.t = float(t0)
        self.auto = float(auto)

    def __call__(self) -> float:
        t = self.t
        self.t += self.auto
        return t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclasses.dataclass(frozen=True)
class ServeFaultEvent:
    """One planned fault against one replica.  ``tick`` is the replica's
    OWN tick counter (``engine.ticks``) at whose start the event fires —
    probe ticks count too, so replays are deterministic regardless of how
    the router interleaves replicas."""

    tick: int
    kind: str
    replica: int = 0
    count: int = 1          # tick_error / tick_stall: afflicted ticks
    stall_s: float = 0.0    # tick_stall / hang: clock advance per tick
    pages: int = 0          # pool_pressure, paged: pages seized (0 = all free)
    lanes: int = 0          # pool_pressure, dense: squatters (0 = all free)
    squat_tokens: int = 8   # pool_pressure, dense: squatter decode length
    seed: int = 0           # kv_poison: free-lane choice on dense engines

    def __post_init__(self):
        if self.kind not in SERVE_FAULT_KINDS:
            raise ValueError(f"unknown serving fault kind {self.kind!r}; "
                             f"one of {SERVE_FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class ServeFaultPlan:
    """An ordered, replayable fault schedule.  Two plans built from the
    same seed/arguments are equal, serialize to the same JSON, and drive
    identical injections."""

    events: tuple[ServeFaultEvent, ...]

    @classmethod
    def from_events(cls, events) -> "ServeFaultPlan":
        evs = tuple(sorted(
            events,
            key=lambda e: (e.replica, e.tick, SERVE_FAULT_KINDS.index(e.kind))))
        return cls(evs)

    @classmethod
    def single(cls, kind: str, replica: int = 0, tick: int = 2,
               **kw) -> "ServeFaultPlan":
        """One-fault plan — the unit cell of the drill matrix."""
        return cls.from_events([
            ServeFaultEvent(tick=tick, kind=kind, replica=replica, **kw)])

    @classmethod
    def kill_replica(cls, replica: int, tick: int,
                     stall_s: float = 0.0) -> "ServeFaultPlan":
        """A mid-run replica death: hang forever from ``tick`` on."""
        return cls.single("hang", replica=replica, tick=tick, stall_s=stall_s)

    @classmethod
    def drill(cls, seed: int, n_replicas: int = 2,
              first_tick: int = 2, span: int = 8) -> "ServeFaultPlan":
        """The canonical serving drill: a transient error burst, a stall
        burst, a capacity squeeze, and a KV poison, placed deterministically
        from ``seed`` across the replicas inside ``[first_tick,
        first_tick + span)``.  No hang — the drill must be survivable with
        every replica eventually re-admitted."""
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")
        rng = np.random.default_rng(seed)
        pick = lambda: (int(rng.integers(0, n_replicas)),
                        first_tick + int(rng.integers(0, span)))
        r0, t0 = pick()
        r1, t1 = pick()
        r2, t2 = pick()
        r3, t3 = pick()
        return cls.from_events([
            ServeFaultEvent(tick=t0, kind="tick_error", replica=r0,
                            count=int(rng.integers(1, 4))),
            ServeFaultEvent(tick=t1, kind="tick_stall", replica=r1,
                            count=int(rng.integers(1, 3)),
                            stall_s=float(rng.uniform(0.01, 0.05))),
            ServeFaultEvent(tick=t2, kind="pool_pressure", replica=r2,
                            pages=int(rng.integers(1, 4)), lanes=1),
            ServeFaultEvent(tick=t3, kind="kv_poison", replica=r3,
                            seed=int(rng.integers(0, 2**31))),
        ])

    def at(self, replica: int, tick: int) -> tuple[ServeFaultEvent, ...]:
        return tuple(e for e in self.events
                     if e.replica == replica and e.tick == tick)

    # ------------------------------------------------------ serialization --
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServeFaultPlan":
        return cls.from_events(ServeFaultEvent(**d) for d in json.loads(text))


# ------------------------------------------------------------- injector --


class ServeFaultInjector:
    """Delivers a :class:`ServeFaultPlan` through per-replica tick hooks.

    ``injector.hook_for(rid)`` is the value for that replica's
    ``ServingEngine(tick_hook=...)``.  The hook runs at the top of every
    tick: it fires any not-yet-fired events planned for (rid,
    ``engine.ticks``), then applies armed effects (stalls advance
    ``clock`` — or really sleep when no fake clock is given — errors and
    hangs raise).  State mutation happens strictly through public engine/
    pool API: ``PagePool.reserve_pages``, ``ServingEngine.submit``, and
    one in-place index write into the cache for poison."""

    def __init__(self, plan: ServeFaultPlan, clock=None):
        self.plan = plan
        self.clock = clock
        self.log: list[tuple[int, int, str]] = []  # fired (replica, tick, kind)
        self._fired: set[tuple[int, int, str]] = set()
        self._lock = threading.Lock()
        self._errors: dict[int, int] = {}           # rid -> ticks left
        self._stalls: dict[int, tuple[int, float]] = {}  # rid -> (left, s)
        self._hangs: dict[int, float] = {}          # rid -> stall_s
        # events whose planned tick passed without a target (kv_poison on a
        # fully-live dense engine): retried every subsequent tick
        self._deferred: dict[int, list[ServeFaultEvent]] = {}
        self._squat_uid = -1000

    def hook_for(self, rid: int):
        def hook(engine):
            self.on_tick(rid, engine)
        return hook

    # ----------------------------------------------------------- firing --
    def on_tick(self, rid: int, engine) -> None:
        tick = engine.ticks
        with self._lock:
            due = self._deferred.pop(rid, [])
        for ev in due + list(self.plan.at(rid, tick)):
            key = (ev.replica, ev.tick, ev.kind)
            with self._lock:
                if key in self._fired:
                    continue
                if ev.kind == "kv_poison" and not self._poison(engine, ev):
                    # no free lane yet: stay armed, retry on later ticks
                    self._deferred.setdefault(rid, []).append(ev)
                    continue
                self._fired.add(key)
                self.log.append(key)
                if ev.kind == "tick_error":
                    self._errors[rid] = self._errors.get(rid, 0) + ev.count
                elif ev.kind == "tick_stall":
                    self._stalls[rid] = (ev.count, ev.stall_s)
                elif ev.kind == "hang":
                    self._hangs[rid] = ev.stall_s
            if ev.kind == "pool_pressure":
                self._squeeze(engine, ev)
        # armed effects, in severity order: hang > stall > error
        with self._lock:
            hang = self._hangs.get(rid)
            stall = self._stalls.get(rid)
            if stall is not None and stall[0] > 0:
                self._stalls[rid] = (stall[0] - 1, stall[1])
            else:
                stall = None
            errs = self._errors.get(rid, 0)
            if hang is None and stall is None and errs > 0:
                self._errors[rid] = errs - 1
            else:
                errs = 0
        if hang is not None:
            self._advance(hang)
            raise ReplicaHang(f"injected: replica {rid} hung at tick {tick}")
        if stall is not None:
            self._advance(stall[1])
        if errs > 0:
            raise InjectedTickError(
                f"injected: transient tick failure on replica {rid} "
                f"at tick {tick}")

    # ---------------------------------------------------------- effects --
    def _advance(self, dt: float) -> None:
        if dt <= 0:
            return
        if self.clock is not None and hasattr(self.clock, "advance"):
            self.clock.advance(dt)
        else:
            time.sleep(dt)

    def _squeeze(self, engine, ev: ServeFaultEvent) -> None:
        from repro_torch.serving.engine import Request  # local: avoid cycle

        if engine.paged:
            n = ev.pages or engine.pool.free_pages
            n = min(n, engine.pool.free_pages)
            if n > 0:
                engine.pool.reserve_pages(("fault", ev.replica, ev.tick), n)
            return
        free = sum(1 for s in engine.slots if s is None)
        lanes = min(ev.lanes or free, free) or 1
        for _ in range(lanes):
            self._squat_uid -= 1
            engine.submit(Request(uid=self._squat_uid, prompt=[1],
                                  max_new_tokens=ev.squat_tokens))

    def _poison(self, engine, ev: ServeFaultEvent) -> bool:
        """Write garbage into a free resource row.  Returns False when no
        target exists yet (dense engine, all lanes live) — the event stays
        armed.  Detection is the zero-on-free probe, nothing else."""
        if engine.paged:
            idx = 0  # the reserved zero page: read by every short/dead lane
        else:
            free = [i for i, s in enumerate(engine.slots) if s is None]
            if not free:
                return False
            rng = np.random.default_rng(ev.seed)
            idx = free[int(rng.integers(0, len(free)))]
        for x in engine.cache.values():
            x[:, idx] = 17
        return True
