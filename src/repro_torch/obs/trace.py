"""Nested span timers emitting Chrome-trace/Perfetto-compatible JSON.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.span("snapshot.dispatch", step=120):
        ...
    trace.export("trace_run.json")   # open in chrome://tracing / Perfetto

Every span becomes one complete ("ph": "X") event with microsecond
``ts``/``dur`` relative to ``enable()``; events carry the recording
thread's ``tid``, so the exported file renders **one track per thread** —
the training thread's ``train.step`` spans and the ckpt-drain thread's
``ckpt.drain.save`` spans land on separate rows of the same timeline, and
nesting within a track is inferred from containment (standard
Chrome-trace semantics).  Thread names are attached via "M" (metadata)
events at export time.

Cost contract: a disabled tracer hands back a shared no-op span (one
attribute check, zero allocation); an enabled one takes two
``perf_counter`` calls plus one dict append under a lock — never a device
sync (DESIGN.md §11).  The event buffer is bounded (default 200k spans);
overflow increments a drop counter instead of growing without limit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Optional

__all__ = ["Tracer", "TRACER", "span", "instant", "enable", "disable",
           "enabled", "export", "clear"]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        end = time.perf_counter()
        tid = threading.get_ident()
        ev = {
            "name": self._name, "ph": "X", "pid": tr._pid, "tid": tid,
            "ts": (self._t0 - tr._t0) * 1e6,
            "dur": (end - self._t0) * 1e6,
        }
        if self._args:
            ev["args"] = self._args
        tr._record(ev, tid)
        return False


class Tracer:
    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._enabled = False
        self._events: list[dict] = []
        self._dropped = 0
        self._max_events = int(max_events)
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._threads: dict[int, str] = {}

    # -------------------------------------------------------- recording --
    def span(self, name: str, **args: Any):
        """Context manager timing one nested region on the calling thread."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (renders as an arrow in the viewer)."""
        if not self._enabled:
            return
        tid = threading.get_ident()
        ev = {
            "name": name, "ph": "i", "s": "t", "pid": self._pid, "tid": tid,
            "ts": (time.perf_counter() - self._t0) * 1e6,
        }
        if args:
            ev["args"] = args
        self._record(ev, tid)

    def _record(self, ev: dict, tid: int) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(ev)
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name

    # -------------------------------------------------------- lifecycle --
    def enable(self) -> None:
        with self._lock:
            self._events.clear()
            self._threads.clear()
            self._dropped = 0
            self._t0 = time.perf_counter()
            self._pid = os.getpid()
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._threads.clear()
            self._dropped = 0

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    # ----------------------------------------------------------- export --
    def export(self, path: str | Path) -> Path:
        """Write ``{"traceEvents": [...]}`` Chrome-trace JSON: thread-name
        metadata first, then every recorded span/instant."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
        meta = [
            {"name": "thread_name", "ph": "M", "pid": self._pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(threads.items())
        ]
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(doc))
        return p


TRACER = Tracer()


def span(name: str, **args: Any):
    return TRACER.span(name, **args)


def instant(name: str, **args: Any) -> None:
    TRACER.instant(name, **args)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return TRACER._enabled


def export(path: str | Path) -> Path:
    return TRACER.export(path)


def clear() -> None:
    TRACER.clear()
