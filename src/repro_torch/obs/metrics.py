"""Process-global, thread-safe, low-overhead runtime metrics.

Three instrument kinds, one registry:

  * :class:`Counter`   — monotonically increasing event counts
    (``ckpt.retry``, ``snapshot.launches``);
  * :class:`Gauge`     — last-write-wins point samples
    (``ckpt.queue_depth``, ``serving.batch_occupancy``);
  * :class:`Histogram` — a **fixed-size ring buffer** of observations, so
    p50/p90/p99 come out without unbounded memory no matter how long the
    run is (``train.step_s``, ``serving.request_s``).

Contract (DESIGN.md §11):

  * instruments are safe to update from any thread — the training thread
    and the checkpoint drain thread hit the same registry concurrently;
  * a **disabled** registry makes every update a no-op behind a single
    attribute check, so instrumented hot paths cost one branch when
    observability is off (the overhead-guard test in tests/test_obs.py
    holds enabled-vs-disabled step wall within a few percent);
  * nothing in this module imports jax or touches a device — recording a
    metric can never add a device sync.

Export surface: :meth:`Registry.export_snapshot` appends one
``{"kind": "metrics", ...}`` line to the JSONL sink (percentiles, counter
values, gauge samples); :meth:`Registry.event` appends a
``{"kind": "event", ...}`` line *and* bumps the same-named counter;
:meth:`Registry.summary` renders the human view.
"""

from __future__ import annotations

import json
import math
import threading
import time
from pathlib import Path
from typing import Any, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "event", "events", "enable", "disable",
    "enabled", "export_snapshot", "summary", "snapshot", "reset",
]


class Counter:
    __slots__ = ("name", "_reg", "_lock", "_v")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        if not self._reg._enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    __slots__ = ("name", "_reg", "_v")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self._v = 0.0

    def set(self, v: float) -> None:
        if not self._reg._enabled:
            return
        self._v = float(v)  # single reference assignment: atomic under the GIL

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Ring-buffered observations: the newest ``size`` samples back every
    percentile query.  Count/sum/min/max track the full stream."""

    __slots__ = ("name", "size", "_reg", "_lock", "_buf", "_n", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, reg: "Registry", size: int = 1024):
        self.name = name
        self.size = max(1, int(size))
        self._reg = reg
        self._lock = threading.Lock()
        self._buf: list[float] = [0.0] * self.size
        self._n = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        if not self._reg._enabled:
            return
        v = float(v)
        with self._lock:
            self._buf[self._n % self.size] = v
            self._n += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._n

    def percentiles(self) -> dict:
        with self._lock:
            live = min(self._n, self.size)
            data = sorted(self._buf[:live])
            n, s = self._n, self._sum
            lo, hi = self._min, self._max
        if not data:
            return {"count": 0}

        def pct(p: float) -> float:
            # nearest-rank on the ring window
            return data[max(0, math.ceil(p / 100.0 * len(data)) - 1)]

        return {
            "count": n, "mean": s / n, "min": lo, "max": hi,
            "p50": pct(50), "p90": pct(90), "p99": pct(99),
        }


class Registry:
    """One process-global home for every instrument.  ``enable()`` turns
    recording on (optionally aimed at a JSONL sink); until then every
    instrument update is a no-op."""

    def __init__(self, max_events: int = 10000):
        self._lock = threading.Lock()       # instrument dictionaries
        self._sink_lock = threading.Lock()  # JSONL file writes
        self._enabled = False
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._events: list[dict] = []
        self._events_dropped = 0
        self._max_events = int(max_events)
        self._sink = None  # open file object, JSONL lines

    # -------------------------------------------------------- lifecycle --
    def enable(self, jsonl_path: Optional[str | Path] = None) -> None:
        """Start recording.  With ``jsonl_path``, every event and metric
        snapshot also lands as one JSON line in that file (append mode, so
        a supervised run's segments share a stream)."""
        with self._sink_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
            if jsonl_path is not None:
                p = Path(jsonl_path)
                p.parent.mkdir(parents=True, exist_ok=True)
                self._sink = open(p, "a", encoding="utf-8")
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False
        with self._sink_lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    def reset(self) -> None:
        """Drop every instrument and buffered event (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._events.clear()
            self._events_dropped = 0

    # ------------------------------------------------------ instruments --
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self)
            return g

    def histogram(self, name: str, size: int = 1024) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, self, size)
            return h

    # ----------------------------------------------------------- events --
    def event(self, name: str, **fields: Any) -> None:
        """Record a discrete occurrence: bumps the same-named counter,
        keeps a bounded in-memory log, and appends a JSONL line when a
        sink is attached."""
        if not self._enabled:
            return
        self.counter(name).inc()
        ev = {"kind": "event", "name": name, "t": time.time(), **fields}
        with self._lock:
            if len(self._events) < self._max_events:
                self._events.append(ev)
            else:
                self._events_dropped += 1
        self._emit(ev)

    def events(self, name: Optional[str] = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        return evs

    # ----------------------------------------------------------- export --
    def snapshot(self) -> dict:
        """Point-in-time view of every instrument (no I/O)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = list(self._hists.items())
        return {
            "kind": "metrics", "t": time.time(),
            "counters": counters, "gauges": gauges,
            "hists": {n: h.percentiles() for n, h in hists},
        }

    def export_snapshot(self, **extra: Any) -> Optional[dict]:
        """Append one metrics line to the JSONL sink; returns the dict
        (None when disabled)."""
        if not self._enabled:
            return None
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        self._emit(snap)
        return snap

    def _emit(self, obj: dict) -> None:
        with self._sink_lock:
            if self._sink is None:
                return
            self._sink.write(json.dumps(obj) + "\n")
            self._sink.flush()

    def summary(self) -> str:
        """Human-readable roll-up of everything recorded so far."""
        snap = self.snapshot()
        lines = ["== obs summary =="]
        for n in sorted(snap["counters"]):
            lines.append(f"  counter {n:<28s} {snap['counters'][n]}")
        for n in sorted(snap["gauges"]):
            lines.append(f"  gauge   {n:<28s} {snap['gauges'][n]:.6g}")
        for n in sorted(snap["hists"]):
            p = snap["hists"][n]
            if not p.get("count"):
                continue
            lines.append(
                f"  hist    {n:<28s} n={p['count']} mean={p['mean']:.6g} "
                f"p50={p['p50']:.6g} p90={p['p90']:.6g} p99={p['p99']:.6g} "
                f"max={p['max']:.6g}")
        if self._events_dropped:
            lines.append(f"  (events dropped: {self._events_dropped})")
        if len(lines) == 1:
            lines.append("  (nothing recorded)")
        return "\n".join(lines)


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, size: int = 1024) -> Histogram:
    return REGISTRY.histogram(name, size)


def event(name: str, **fields: Any) -> None:
    REGISTRY.event(name, **fields)


def events(name: Optional[str] = None) -> list[dict]:
    return REGISTRY.events(name)


def enable(jsonl_path: Optional[str | Path] = None) -> None:
    REGISTRY.enable(jsonl_path)


def disable() -> None:
    REGISTRY.disable()


def enabled() -> bool:
    return REGISTRY._enabled


def export_snapshot(**extra: Any) -> Optional[dict]:
    return REGISTRY.export_snapshot(**extra)


def summary() -> str:
    return REGISTRY.summary()


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
