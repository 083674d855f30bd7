"""One run of one cell: set-up, the measured window, the traced reading and
the check that decides ``correct``.

Closed loop, one client.  Each iteration is one snapshot dump and its
read-back: every field or box goes to ``compress`` and the phase ends in a
synchronise (the **compress phase**), then every payload goes to
``decompress`` and the phase ends in a synchronise (the **decompress
phase**).  The fields are made on the device from the seed during set-up and
stay resident, as in a GPU simulation; the port is handed only those
tensors.

End-to-end metrics (``--trace 0``):

* ``compress_GBps``, ``decompress_GBps``: raw bytes (1e9) over the summed
  host wall time of the window's compress (decompress) phases;
* ``snapshot_compress_ms_p95``, ``snapshot_decompress_ms_p95``: the 95th
  percentile of the compress (decompress) phases, each timed on the
  device's clock by a pair of CUDA events on the stream, from the first
  call's enqueue to the last operation's end, so it spans the host's gaps
  between the calls too;
* ``setup_s``: from process start to the first timed snapshot, building
  the kernels and warming up included.

An end-to-end metric's name is its quantity, then a dot and the cells it is
kept for (``compress_GBps.zfp``): each route's own bound.  Standard error
gives every quantity in each run.  With ``--trace 1`` the window, cut to
``TRACE_SECONDS``, runs under ``torch.profiler`` tracing the device's
activity alone (kernels, copies and the CUDA runtime's calls), the phases
placed on its clock by their host-clock marks, and the cell's per-layer
metrics are read from it (``metrics/``).

Correctness: for every judged call of the snapshot (all, or a sample drawn
from the seed where the reference is slow: ``judge.judged_calls``) one
iteration of the window is drawn from the seed (a reservoir of one, so each
iteration is as likely); that call's payload, a digest of its
reconstruction and the numbers of the configuration's guarantees are kept
on the device (taken after the decompress phase, outside both phases) and,
once the window has closed and the peak has been read, judged against the
plain reference (``reference/``): the stream bit for bit, the
reconstruction's digest against that of the reference's decode, and the
guarantee the configuration states (SZ ABS: ``max |x' - x| <= eb``)."""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench import judge, traffic
from portbench import metrics as metric_files
from portbench import reference as references
from portbench import tracing

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
WARMUP_ITERATIONS = 2  # two sets of outputs alive at once: the allocator's pool for the window
TRACE_SECONDS = 4.0  # the traced window's length at most: reading the trace grows with it


def manifest(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in man['workloads']]}")


def config_of(man: dict, cell: dict) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def per_layer_for(man: dict, cell: dict) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(man, cell)}
    return [m for m in man["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def end_to_end_for(man: dict, cell: dict) -> list[dict]:
    return [m for m in man["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def p95(values: list[float]) -> float:
    """The 95th percentile, Python's exclusive method (needs two values)."""
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 else values[0]


class _Clock:
    """Device synchronise and phase marks: CUDA events on the card, the host
    clock where a test drives a run on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def sync(self, stream_only: bool = False) -> None:
        """Wait for the device: a device synchronise ends a phase (the traced
        run finds the phases' ends by it), a stream synchronise anything else."""
        if self.cuda:
            if stream_only:
                torch.cuda.current_stream(self.device).synchronize()
            else:
                torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclasses.dataclass
class Window:
    iterations: int = 0
    compress_s: list[float] = dataclasses.field(default_factory=list)  # host wall a phase
    decompress_s: list[float] = dataclasses.field(default_factory=list)
    marks: list[tuple] = dataclasses.field(default_factory=list)  # each phase's (start, end)
    phases: list[tracing.Phase] = dataclasses.field(default_factory=list)  # host clock, ns
    calls: list[tracing.CallRecord] = dataclasses.field(default_factory=list)
    kept: dict[int, tuple] = dataclasses.field(default_factory=dict)  # call -> (result, digest, guarantees)
    start: float = 0.0
    seconds: float = 0.0


def _iteration(comp, snap, ref, clock: _Clock, keep, win: Window | None, records: bool = False):
    """One snapshot dump and its read-back.  Returns ``{call: (result,
    digest, guarantees)}`` for the calls in ``keep``, observed once the
    decompress phase has ended (outside both phases, then synchronised).
    With ``records`` (the traced run) each call's bytes go to
    ``win.calls``."""
    calls = snap.calls
    h0 = time.perf_counter_ns()
    m0 = clock.mark()
    results = [comp.compress(c.x, **c.kwargs) for c in calls]
    hc = time.perf_counter_ns()
    m1 = clock.mark()
    clock.sync()
    h1 = time.perf_counter_ns()
    m2 = clock.mark()
    recons = [comp.decompress(r) for r in results]
    hd = time.perf_counter_ns()
    m3 = clock.mark()
    clock.sync()
    h2 = time.perf_counter_ns()
    kept = {j: (results[j], *judge.observe(ref, calls[j], recons[j])) for j in keep}
    del recons
    if kept:
        clock.sync(stream_only=True)
    if win is not None:
        win.compress_s.append((h1 - h0) / 1e9)
        win.decompress_s.append((h2 - h1) / 1e9)
        win.marks.append((m0, m1, m2, m3))
        win.phases += [tracing.Phase("compress", h0, hc, h1, len(calls)),
                       tracing.Phase("decompress", h1, hd, h2, len(calls))]
        for c, r in zip(calls, results) if records else ():
            win.calls.append(tracing.CallRecord("compress", c.raw_nbytes, int(r.nbytes)))
            win.calls.append(tracing.CallRecord("decompress", c.raw_nbytes, int(r.nbytes)))
    return kept


def _measure(comp, snap, ref, clock, seconds: float, seed: int, judged: list[int],
             records: bool) -> Window:
    """The window: iterations until ``seconds`` have passed.  For each judged
    call a reservoir of one, drawn from the seed, keeps one iteration's
    output (the i-th replaces it with chance 1/i, so each iteration is as
    likely)."""
    win = Window()
    rng = random.Random(f"portbench-sample-{seed}")
    win.start = time.perf_counter()
    while True:
        keep = [j for j in judged if rng.random() * (win.iterations + 1) < 1.0]
        win.kept.update(_iteration(comp, snap, ref, clock, keep, win, records))
        win.iterations += 1
        if time.perf_counter() - win.start >= seconds:
            break
    win.seconds = time.perf_counter() - win.start
    return win


def _fifths(a: list[float], b: list[float]):
    """The phases' walls in five consecutive parts of the window (fewer
    where the window holds fewer than five iterations)."""
    cuts = sorted({round(i * len(a) / 5) for i in range(6)})
    return [(a[i:j], b[i:j]) for i, j in zip(cuts, cuts[1:])]


def peaks() -> dict:
    return json.loads((Path(__file__).parent / "peaks.json").read_text())


def _per_layer(man: dict, entry: dict, ctx: tracing.Context) -> dict:
    """The cell's per-layer metrics that find something to read."""
    out = {}
    for m in per_layer_for(man, entry):
        v = metric_files.load(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _quantities(snap, win: Window, clock: _Clock, setup_s: float) -> dict:
    """Every quantity an end-to-end metric can name; a metric's name is the
    quantity, or the quantity, a dot and the cells it is kept for
    (``compress_GBps.zfp``: the quantity ``compress_GBps`` under its route's
    own bound)."""
    raw = snap.raw_nbytes * win.iterations
    return {"compress_GBps": raw / sum(win.compress_s) / 1e9,
            "decompress_GBps": raw / sum(win.decompress_s) / 1e9,
            "snapshot_compress_ms_p95": p95([clock.ms(a, b) for a, b, _, _ in win.marks]),
            "snapshot_decompress_ms_p95": p95([clock.ms(c, d) for _, _, c, d in win.marks]),
            "setup_s": setup_s}


def run(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t0: float | None = None, config_overrides: dict | None = None,
        compressor_args: dict | None = None, man: dict | None = None,
        log=sys.stderr) -> dict:
    """Run one cell once and return the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, optionally
    ``breakdown``, and ``checks`` last).  ``device="cpu"``,
    ``config_overrides`` and ``compressor_args`` let a test drive the whole
    run at a small size without a card."""
    from repro_torch.core.api import get_compressor

    t0 = time.perf_counter() if t0 is None else t0
    man = man or manifest()
    entry = cell_entry(man, cell)
    cfg = {**config_of(man, entry), **(config_overrides or {})}
    mix = traffic.load("mixes", entry["traffic"])
    dev = torch.device(device)
    clock = _Clock(dev)

    stages = {"start": time.perf_counter() - t0}
    if clock.cuda:
        torch.empty(1, device=dev)
        stages["cuda"] = time.perf_counter() - t0
    snap = traffic.build(cfg, mix, seed, dev)
    clock.sync()
    stages["inputs"] = time.perf_counter() - t0
    comp = get_compressor(snap.compressor, device=dev, **(compressor_args or {}))
    ref = references.load(snap.reference)
    judged = judge.judged_calls(snap, ref, seed)
    warm = [_iteration(comp, snap, ref, clock, judged, None) for _ in range(WARMUP_ITERATIONS)]
    del warm
    clock.sync()
    stages["warm-up"] = time.perf_counter() - t0
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way during the window

    prof = None
    if trace and clock.cuda:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity alone: recording every host operation as well
        # slows the host, and so the host-paced phases, about 2.5 times
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    allocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0) if clock.cuda else 0
    setup_s = time.perf_counter() - t0
    print("set-up, seconds since process start: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f", window {setup_s:.3f}", file=log)
    try:
        win = _measure(comp, snap, ref, clock, min(seconds, TRACE_SECONDS) if trace else seconds,
                       seed, judged, records=trace)
    finally:
        t_stop = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        gc.unfreeze()
        t_stop = time.perf_counter() - t_stop
    clock.sync()
    peak = torch.cuda.max_memory_allocated(dev) if clock.cuda else 0
    if clock.cuda:
        allocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0) - allocs
    print(f"window: {win.iterations} snapshots in {win.seconds:.3f} s, "
          f"{len(snap.calls)} calls each, {allocs} device allocations", file=log)
    print("window by fifths, compress / decompress GB/s: " + ", ".join(
        f"{snap.raw_nbytes * len(c) / sum(c) / 1e9:.1f} / {snap.raw_nbytes * len(d) / sum(d) / 1e9:.1f}"
        for c, d in _fifths(win.compress_s, win.decompress_s)), file=log)
    quantity = _quantities(snap, win, clock, setup_s)
    print("quantities: " + json.dumps(quantity), file=log)

    out: dict = {"correct": False, "attempted": win.iterations * len(snap.calls), "failed": 0}
    device_info = {"platform": "gpu" if clock.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if clock.cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        t_read = time.perf_counter()
        tr = tracing.collect(prof, win.phases)
        del prof
        metrics = _per_layer(man, entry, tracing.Context(tr, snap.compressor, win.calls, peaks()))
        w = tr.window
        device_info.update(busy_s=tracing.busy_s(tr),
                           window_s=(w[1] - w[0]) / 1e9 if w else win.seconds)
        out["breakdown"] = tracing.breakdown(tr)
        print(f"trace: {len(tr.device_ops)} device ops, {len(tr.runtime)} runtime calls, "
              f"{tr.note}; profiler stopped in {t_stop:.3f} s, read in "
              f"{time.perf_counter() - t_read:.3f} s", file=log)
    else:
        metrics = {m["name"]: {"value": quantity[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in end_to_end_for(man, entry)}

    # the program's state goes; the inputs and the kept results stay for the check
    kept = win.kept
    del win, comp
    if clock.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed = judge.judge_program(snap, kept, judged)
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=log)
    out.update(correct=all(v <= lim for v, lim in checks.values()), failed=failed,
               metrics=metrics, device=device_info)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=log)
    return out


def jsonable(x):
    """Non-finite floats as strings, so the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x
