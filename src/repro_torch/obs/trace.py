"""Nested span timers on the profiler's clock, emitting Chrome-trace/Perfetto
JSON.

Usage::

    from repro_torch.obs import trace
    trace.enable()
    with trace.call("api.compress", compressor="tpu-sz"):   # one call of an entry point
        with trace.span("sz.guarded_eb"):
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

Beside the Chrome keys each event holds, in keys of its own (the export
leaves them out):

* ``start_ns``, ``end_ns``: integer nanoseconds on the Unix-epoch clock
  (``time.time_ns``), the clock of ``torch.profiler``'s kineto events, so a
  span and a profiler event compare directly: a device operation belongs to
  the span open on the host when the runtime call that launched it began.
  ``enable()`` takes one anchor pair (``perf_counter_ns``, ``time_ns``);
  spans read ``perf_counter_ns`` alone.
* ``id``; ``parent``, the id of the span open around it on its thread
  (``None`` at the top); ``call``, the id of the :func:`call` span it runs
  in (an entry point gives each call an id), or ``None`` outside one.

Cost contract: a disabled tracer hands back a shared no-op span after one
attribute check (no record, no allocation); an enabled one takes two
``perf_counter_ns`` calls plus one tuple append under a lock — never a
device sync (DESIGN.md §11).  The event buffer is bounded (default 200k
spans); overflow increments a drop counter instead of growing without limit.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Any

__all__ = ["Tracer", "TRACER", "span", "call", "enable", "disable", "enabled", "export",
           "clear"]

_CHROME_KEYS = ("name", "ph", "pid", "tid", "ts", "dur", "args")


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_is_call", "_stack", "_id", "_parent", "_call",
                 "_t0")

    def __init__(self, tr: "Tracer", name: str, args: dict, is_call: bool = False):
        self._tr = tr
        self._name = name
        self._args = args
        self._is_call = is_call

    def __enter__(self):
        tr = self._tr
        try:
            stack = tr._local.stack
        except AttributeError:
            stack = tr._local.stack = []
        top = stack[-1] if stack else None
        self._stack = stack
        self._id = next(tr._ids)
        self._parent = top._id if top is not None else None
        self._call = self._id if self._is_call else (top._call if top is not None else None)
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._stack.pop()
        # atomic fields only, so the collector soon stops tracking the record;
        # :attr:`Tracer.events` builds the event's dict on read
        self._tr._record((self._name, self._t0, end, self._id, self._parent, self._call,
                          threading.get_ident()), self._args)
        return False


class Tracer:
    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._enabled = False
        self._events: list[tuple] = []  # see _Span.__exit__
        self._args: dict[int, dict] = {}  # by span id, where a span has arguments
        self._dropped = 0
        self._max_events = int(max_events)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._pc0, self._epoch0 = time.perf_counter_ns(), time.time_ns()
        self._pid = os.getpid()
        self._threads: dict[int, str] = {}

    # -------------------------------------------------------- recording --
    def span(self, name: str, **args: Any):
        """Context manager timing one nested region on the calling thread."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def call(self, name: str, **args: Any):
        """A span that starts a call: it and every span opened inside it on
        this thread carry its id as ``call``."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, args, is_call=True)

    def _record(self, rec: tuple, args: dict) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(rec)
            if args:
                self._args[rec[3]] = args
            if rec[6] not in self._threads:
                self._threads[rec[6]] = threading.current_thread().name

    # -------------------------------------------------------- lifecycle --
    def enable(self) -> None:
        with self._lock:
            self._clear()
            a = time.perf_counter_ns()
            self._epoch0 = time.time_ns()
            self._pc0 = (a + time.perf_counter_ns()) // 2
            self._pid = os.getpid()
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._clear()

    def _clear(self) -> None:
        self._events.clear()
        self._args.clear()
        self._threads.clear()
        self._dropped = 0

    @property
    def events(self) -> list[dict]:
        """The recorded spans, each a new dict."""
        with self._lock:
            recs, args = list(self._events), dict(self._args)
        pc0, off, pid = self._pc0, self._epoch0 - self._pc0, self._pid
        out = []
        for name, t0, end, id_, parent, call, tid in recs:
            ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
                  "ts": (t0 - pc0) / 1e3, "dur": (end - t0) / 1e3,
                  "start_ns": t0 + off, "end_ns": end + off,
                  "id": id_, "parent": parent, "call": call}
            if id_ in args:
                ev["args"] = args[id_]
            out.append(ev)
        return out

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def anchor(self) -> tuple[int, int]:
        """The pair (``perf_counter_ns``, ``time_ns``) read together at
        ``enable()``: ``t - anchor[0] + anchor[1]`` puts a
        ``perf_counter_ns`` reading on the spans' clock."""
        return self._pc0, self._epoch0

    # ----------------------------------------------------------- export --
    def export(self, path: str | Path) -> Path:
        """Write ``{"traceEvents": [...]}`` Chrome-trace JSON: thread-name
        metadata first, then every recorded span."""
        events = [{k: ev[k] for k in _CHROME_KEYS if k in ev} for ev in self.events]
        with self._lock:
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

# the process-wide tracer's methods themselves, so a disabled site costs one
# call and one attribute check
span = TRACER.span
call = TRACER.call


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
