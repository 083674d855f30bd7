"""Device timing on a CUDA card, shared by ``chip_smoke.py`` and
``tools/zfp_kernel_times.py`` so that both read a kernel the same way.

Imports only ``torch``: the timing tool loads it beside an older tree of
the port, which may not have it.
"""

from __future__ import annotations

import statistics

import torch


def cuda_times(fn, iters: int) -> list[float]:
    """Milliseconds of each of ``iters`` CUDA-event-timed runs of ``fn()``,
    after one warm-up run (the host's launch time included)."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def cuda_ms(fn, iters: int) -> float:
    return statistics.median(cuda_times(fn, iters))


def graph_ms(fn, iters: int = 20, rounds: int = 5) -> float:
    """Device milliseconds of one ``fn()``: its launches captured in a CUDA
    graph, ``iters`` replays back to back between two events (so the card
    never waits for the host), median of ``rounds``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    out = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(out)
