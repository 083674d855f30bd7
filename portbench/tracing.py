"""The traced run: ``torch.profiler`` over the measured window, tracing the
device's activity alone (kernels, copies, fills and the CUDA runtime's
calls), and the arithmetic that turns its events into per-layer metrics.

The host's own operations are not traced: recording each of them slows the
host, and with it every phase the host paces.  The benchmark marks each
phase on the host clock instead (:class:`Phase`: its start, the return of
its last call, and the return of the device synchronise that ends it), and
places the marks on the trace's clock by that synchronise: the phase's end
on the host clock, less the end of the phase's ``cudaDeviceSynchronize`` in
the trace, is the offset between the two clocks (the median over the
window's phases).  Nothing else in the window synchronises the whole device.

Device operations are placed by time: the phases are synchronised, so every
operation a phase puts on the card runs inside the phase.  Timestamps are
nanoseconds on the profiler's clock."""

from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict

PHASE_END = "cudaDeviceSynchronize"
# runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")

Interval = tuple[str, int, int]  # (name, start ns, end ns)


@dataclasses.dataclass
class Phase:
    kind: str  # "compress" or "decompress"
    start: int  # before the first call, ns
    calls_end: int  # after the last call returned
    end: int  # after the synchronise that ends the phase returned
    calls: int  # calls into the port

    def shifted(self, by: int) -> Phase:
        return Phase(self.kind, self.start - by, self.calls_end - by, self.end - by, self.calls)


@dataclasses.dataclass
class Trace:
    device_ops: list[Interval]  # operations on the card, by start
    runtime: list[Interval]  # CUDA runtime (cuda*) and driver (cu*) calls on the host
    phases: list[Phase]  # on the trace's clock; empty where they could not be placed
    note: str = ""  # how the phases were placed

    def spans(self, kind: str, calls_only: bool = False) -> list[tuple[int, int]]:
        return [(p.start, p.calls_end if calls_only else p.end)
                for p in self.phases if p.kind == kind]

    def calls(self, kind: str) -> int:
        return sum(p.calls for p in self.phases if p.kind == kind)

    @property
    def window(self) -> tuple[int, int] | None:
        return (self.phases[0].start, self.phases[-1].end) if self.phases else None


def place(phases: list[Phase], runtime: list[Interval]) -> tuple[list[Phase], str]:
    """The host-clock ``phases`` on the trace's clock, matched in order to the
    trace's ``cudaDeviceSynchronize`` calls (skipping up to three leading
    ones the profiler may have made), by the median offset of their ends."""
    ends = [e for n, _, e in runtime if n == PHASE_END]
    if not phases or len(ends) < len(phases):
        return [], f"{len(ends)} device synchronises for {len(phases)} phases: not placed"
    best = None
    for skip in range(min(3, len(ends) - len(phases)) + 1):
        off = [p.end - t for p, t in zip(phases, ends[skip:])]
        spread = max(off) - min(off)
        if best is None or spread < best[0]:
            best = (spread, int(statistics.median(off)))
    spread, offset = best
    return ([p.shifted(offset) for p in phases],
            f"phases placed by {len(phases)} synchronises, offsets within {spread / 1e3:.1f} us")


def collect(prof, phases: list[Phase]) -> Trace:
    """The events of a finished ``torch.profiler.profile`` (``None``: an
    empty trace), read raw (the profiler's own per-event objects are never
    built), in one pass, with the window's phases placed on its clock."""
    if prof is None:
        return Trace([], [], [], "no profiler")
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if dur > 0:
                device.append((name, start, start + dur))
        elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            runtime.append((name, start, start + dur))
    device.sort(key=lambda t: (t[1], -t[2]))
    runtime.sort(key=lambda t: (t[1], -t[2]))
    placed, note = place(phases, runtime)
    return Trace(device, runtime, placed, note)


def merged(intervals: list[Interval]) -> list[tuple[int, int]]:
    """The union of intervals (sorted by start) as disjoint (start, end)."""
    out: list[list[int]] = []
    for _, s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(busy: list[tuple[int, int]], spans: list[tuple[int, int]]) -> int:
    """Nanoseconds of ``busy`` (disjoint, sorted) inside ``spans`` (disjoint,
    sorted)."""
    total, i = 0, 0
    for s, e in spans:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            total += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return total


def _starting_in(events: list[Interval], spans: list[tuple[int, int]]):
    """The events (sorted by start) that start inside ``spans`` (sorted)."""
    i = 0
    for s, e in spans:
        while i < len(events) and events[i][1] < s:
            i += 1
        while i < len(events) and events[i][1] < e:
            yield events[i]
            i += 1


def device_time_in(trace: Trace, spans: list[tuple[int, int]]) -> int:
    """Summed duration of the device operations that start inside ``spans``."""
    return sum(e - s for _, s, e in _starting_in(trace.device_ops, spans))


def syncs_per_call(trace: Trace, kind: str) -> float | None:
    """Synchronising runtime calls made while the phases' calls ran (from
    each phase's start to its last call's return), per call."""
    calls = trace.calls(kind)
    if not calls or not trace.runtime:
        return None
    spans = trace.spans(kind, calls_only=True)
    return sum(n in SYNC_CALLS for n, _, _ in _starting_in(trace.runtime, spans)) / calls


def idle_pct(trace: Trace, kind: str) -> float | None:
    """Share of the phases' wall time with nothing running on the card."""
    spans = trace.spans(kind)
    wall = sum(e - s for s, e in spans)
    if not spans or not trace.device_ops or wall <= 0:
        return None
    return 100.0 * (wall - overlap(merged(trace.device_ops), spans)) / wall


def busy_s(trace: Trace) -> float:
    w = trace.window
    if w is None:
        return 0.0
    return overlap(merged(trace.device_ops), [w]) / 1e9


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _gaps(trace: Trace) -> list[tuple[int, int]]:
    w = trace.window
    gaps: list[tuple[int, int]] = []
    if w is None:
        return gaps
    t = w[0]
    for s, e in merged(trace.device_ops):
        if e <= w[0] or s >= w[1]:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w[1]:
        gaps.append((t, w[1]))
    return gaps


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the window's idle time
    summed by what the host was doing: ``<phase> calls`` until the phase's
    last call returned, with the runtime call open as each idle stretch
    began (``host`` where none was), ``<phase> sync`` in the synchronise
    that ends it, ``between phases`` outside them."""
    per_op: dict[str, int] = defaultdict(int)
    for name, s, e in trace.device_ops:
        per_op[_short(name)] += e - s
    parts = []  # (start, end, label) of the window's stretches, in order
    t = trace.window[0] if trace.phases else 0
    for p in trace.phases:
        if p.start > t:
            parts.append((t, p.start, None))
        parts += [(p.start, p.calls_end, f"{p.kind} calls"), (p.calls_end, p.end, f"{p.kind} sync")]
        t = p.end
    per_gap: dict[str, int] = defaultdict(int)
    rt, i, open_calls, k = trace.runtime, 0, [], 0
    for g0, g1 in _gaps(trace):
        while k < len(parts) and parts[k][1] <= g0:
            k += 1
        j = k
        while j < len(parts) and parts[j][0] < g1:
            a, b = max(g0, parts[j][0]), min(g1, parts[j][1])
            label = parts[j][2]
            if label is None:
                label = "between phases"
            elif label.endswith("calls"):
                while i < len(rt) and rt[i][1] <= a:
                    open_calls.append(rt[i])
                    i += 1
                open_calls = [c for c in open_calls if c[2] > a]
                label += f" / {open_calls[-1][0] if open_calls else 'host'}"
            per_gap[label] += b - a
            j += 1
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[n, v / 1e9] for n, v in order(per_op)],
            "idle_gaps": [[n, v / 1e9] for n, v in order(per_gap)]}


@dataclasses.dataclass
class CallRecord:
    phase: str  # "compress" or "decompress"
    raw_nbytes: int  # bytes of the field or box
    nbytes: int  # the result's stored bytes (CompressionResult.nbytes)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is given."""

    trace: Trace
    compressor: str  # the cell's compressor (every call of a cell uses one)
    calls: list[CallRecord]  # the traced window's calls
    peaks: dict  # peaks.json


def roofline_pct(ctx: Context, compressor: str, phase: str, least_bytes) -> float | None:
    """The least time the peak memory rate allows for the phase's calls
    (``least_bytes(raw_nbytes, nbytes)`` each) over the device time of
    every operation the phases put on the card, in percent; ``None`` where
    the cell runs another compressor or the trace has no device time."""
    if ctx.compressor != compressor:
        return None
    device_ns = device_time_in(ctx.trace, ctx.trace.spans(phase))
    calls = [c for c in ctx.calls if c.phase == phase]
    if device_ns <= 0 or not calls:
        return None
    least_s = sum(least_bytes(c.raw_nbytes, c.nbytes) for c in calls) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (device_ns / 1e9)
