"""The port's tracer (``repro_torch.obs.trace``) and the spans the compressor
path opens, with no JAX in the file, so that its card case also runs on a
machine that has a card and no JAX.

* The tracer: spans stamped on the Unix-epoch clock (``torch.profiler``'s),
  parent and call ids, the shared no-op span of a disabled tracer, a module
  that needs nothing beyond the standard library, a raising span, a stack a
  thread, the bounded buffer's drop count, and a Chrome export without the
  extra keys.
* The span trees on the CPU: SZ through the kernel backend (``api.compress``
  > ``sz.guarded_eb``, one ``sync.total_bits`` a call), ZFP on a 1-D field
  (``route.to_3d`` a partition, ``zfp.carve``, ``route.cat``, no ``sync.*``
  span), SZ's 1-D core route under PW_REL (``pwrel.log_forward``,
  ``route.to_3d`` with its counters, ``sz.core_compress`` > ``sz.lorenzo``,
  ``sz.pack``; ``sz.core_decompress`` > ``sz.unpack``, ``sz.reconstruct``,
  ``route.cat``, ``pwrel.log_inverse``), the stream the same with the tracer
  on or off.
* On a card (marked ``cuda``): one ``kernel.*`` span a launch that
  ``kernels.launch_counts()`` counts, each innermost, every span inside its
  parent on the clock.  Run it with
  ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_obs_trace.py``.
* The benchmark patch that reads these spans still applies.
"""

import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import transforms
from repro_torch.core.api import get_compressor
from repro_torch.obs import trace


@pytest.fixture
def tracer():
    """The process-wide tracer the compressor path records into, enabled,
    and off and empty afterwards."""
    trace.enable()
    yield trace.TRACER
    trace.disable()
    trace.clear()


def _by_id(events):
    return {ev["id"]: ev for ev in events}


def test_spans_are_stamped_on_the_epoch_clock():
    tr = trace.Tracer()
    before = time.time_ns()
    tr.enable()
    with tr.span("outer"):
        time.sleep(0.002)
    after = time.time_ns()
    (ev,) = tr.events
    pc0, epoch0 = tr.anchor
    assert before <= epoch0 <= after
    slack = 1_000_000  # the anchor pair is read within microseconds; 1 ms of room
    assert before - slack <= ev["start_ns"] < ev["end_ns"] <= after + slack
    assert ev["end_ns"] - ev["start_ns"] >= 2_000_000
    assert ev["end_ns"] - ev["start_ns"] == pytest.approx(ev["dur"] * 1e3, abs=1)
    assert isinstance(ev["start_ns"], int) and isinstance(ev["end_ns"], int)
    # a perf_counter_ns reading goes onto the same clock through the anchor
    assert abs(time.perf_counter_ns() - pc0 + epoch0 - time.time_ns()) < slack


def test_parent_and_call_ids():
    tr = trace.Tracer()
    tr.enable()
    with tr.span("loose"):
        pass
    with tr.call("api.compress", compressor="tpu-sz"):
        with tr.span("sz.guarded_eb"):
            pass
        with tr.span("kernel.fused_compress"):
            pass
        with tr.span("sync.total_bits"):
            pass
    with tr.call("api.decompress"):
        with tr.span("kernel.fused_decompress"):
            pass
    ev = {e["name"]: e for e in tr.events}
    assert ev["loose"]["parent"] is None and ev["loose"]["call"] is None
    c1, c2 = ev["api.compress"]["id"], ev["api.decompress"]["id"]
    assert c1 != c2 and ev["api.compress"]["call"] == c1 and ev["api.compress"]["parent"] is None
    inner = ("sz.guarded_eb", "kernel.fused_compress", "sync.total_bits")
    assert {ev[n]["parent"] for n in inner} == {c1} and {ev[n]["call"] for n in inner} == {c1}
    assert ev["kernel.fused_decompress"]["parent"] == c2 == ev["kernel.fused_decompress"]["call"]
    assert len({e["id"] for e in tr.events}) == len(tr.events)


def test_a_disabled_tracer_hands_back_the_shared_null_span():
    tr = trace.Tracer()
    assert tr.span("a", k=1) is trace._NULL_SPAN
    assert tr.call("a") is trace._NULL_SPAN
    with tr.call("a"):
        with tr.span("b"):
            pass
    assert tr.events == [] and tr._args == {}
    tr.enable()
    tr.disable()
    assert tr.span("a") is trace._NULL_SPAN
    trace.disable()
    assert trace.span("a") is trace._NULL_SPAN and trace.call("a") is trace._NULL_SPAN


def test_the_tracer_imports_nothing_but_the_standard_library():
    """The module loads and records with torch, numpy and jax unimportable."""
    src = Path(trace.__file__)
    code = ("import sys, importlib.util\n"
            "for m in ('torch', 'numpy', 'jax'): sys.modules[m] = None\n"
            f"spec = importlib.util.spec_from_file_location('t', {str(src)!r})\n"
            "t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)\n"
            "t.enable()\n"
            "with t.call('api.compress'):\n"
            "    with t.span('sync.total_bits'): pass\n"
            "print(len(t.TRACER.events))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "2"


def test_a_span_that_raises_is_recorded_and_leaves_the_stack_whole():
    tr = trace.Tracer()
    tr.enable()
    with tr.span("outer"):
        with pytest.raises(ValueError):
            with tr.span("fails"):
                raise ValueError("x")
        with tr.span("after"):
            pass
    with tr.span("top"):
        pass
    ev = {e["name"]: e for e in tr.events}
    assert ev["fails"]["parent"] == ev["outer"]["id"] == ev["after"]["parent"]
    assert ev["top"]["parent"] is None


def test_each_thread_has_its_own_stack():
    tr = trace.Tracer()
    tr.enable()
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        with tr.span("drain"):
            pass
        done.set()

    t = threading.Thread(target=other, name="drain-thread")
    t.start()
    with tr.call("api.compress"):
        go.set()
        done.wait()
    t.join()
    ev = {e["name"]: e for e in tr.events}
    assert ev["drain"]["parent"] is None and ev["drain"]["call"] is None
    assert ev["drain"]["tid"] != ev["api.compress"]["tid"]


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    tr = trace.Tracer(max_events=3)
    tr.enable()
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [e["name"] for e in tr.events] == ["s0", "s1", "s2"] and tr.dropped == 2
    tr.enable()
    assert tr.events == [] and tr.dropped == 0


def test_the_chrome_export_keeps_its_keys(tmp_path):
    tr = trace.Tracer()
    tr.enable()
    with tr.call("api.compress", compressor="tpu-zfp"):
        with tr.span("zfp.carve"):
            pass
    doc = json.loads(tr.export(tmp_path / "t.json").read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["zfp.carve", "api.compress"]
    assert all(set(e) <= {"name", "ph", "pid", "tid", "ts", "dur", "args"} for e in spans)
    assert spans[1]["args"] == {"compressor": "tpu-zfp"}


def test_sz_through_the_kernel_backend_spans_its_call(tracer):
    comp = get_compressor("tpu-sz", backend="kernel", device="cpu")
    x = torch.linspace(-2.0, 3.0, 8 * 64 * 128).reshape(8, 64, 128)
    for _ in range(2):
        comp.decompress(comp.compress(x, eb=1e-3))
    events = tracer.events
    ids = _by_id(events)
    calls = [e for e in events if e["name"] == "api.compress"]
    assert len(calls) == 2
    assert all(e["args"] == {"compressor": "tpu-sz", "raw_bytes": x.numel() * 4} for e in calls)
    for call in calls:
        inside = [e for e in events if e["call"] == call["id"] and e is not call]
        names = Counter(e["name"] for e in inside)
        assert names == Counter({"sz.guarded_eb": 1, "sync.total_bits": 1})
        assert all(ids[e["parent"]] is call for e in inside)
    dec = [e for e in events if e["name"] == "api.decompress"]
    assert len(dec) == 2 and not [e for e in events if e["call"] in {d["id"] for d in dec}
                                  and e not in dec]


def test_zfp_on_a_1d_field_spans_its_route(tracer, monkeypatch):
    part = 1000  # partitions of 1000 points, so a small field has three
    real = transforms.partition_1d
    monkeypatch.setattr(transforms, "partition_1d", lambda x: real(x, part))
    comp = get_compressor("tpu-zfp", backend="kernel", device="cpu")
    x = torch.linspace(-1.0, 1.0, 2500)
    xr = comp.decompress(comp.compress(x, rate=8))
    assert xr.shape == x.shape
    events = tracer.events
    (c,) = [e for e in events if e["name"] == "api.compress"]
    (d,) = [e for e in events if e["name"] == "api.decompress"]
    cn = Counter(e["name"] for e in events if e["call"] == c["id"] and e is not c)
    dn = Counter(e["name"] for e in events if e["call"] == d["id"] and e is not d)
    assert cn == Counter({"route.to_3d": 3, "zfp.carve": 3})
    assert dn == Counter({"route.cat": 1})
    assert not [e for e in events if e["name"].startswith("sync.")]
    # the route's three pads come first, then each partition's carve
    assert [e["name"] for e in sorted(events, key=lambda e: e["start_ns"])
            if e["call"] == c["id"] and e is not c] == ["route.to_3d"] * 3 + ["zfp.carve"] * 3
    assert all(e["parent"] == c["id"] for e in events if e["call"] == c["id"] and e is not c)


def test_sz_on_a_1d_pwrel_field_spans_the_core_route(tracer):
    comp = get_compressor("tpu-sz", backend="core", device="cpu")
    x = torch.linspace(-3.0, 5.0, 1000)
    x[::9] = 0.0
    r = comp.compress(x, pw_rel=1e-2)
    xr = comp.decompress(r)
    events = tracer.events
    ids = _by_id(events)
    (c,) = [e for e in events if e["name"] == "api.compress"]
    (d,) = [e for e in events if e["name"] == "api.decompress"]
    tree = lambda call: Counter((e["name"], ids[e["parent"]]["name"])  # noqa: E731
                                for e in events if e["call"] == call["id"] and e is not call)
    assert tree(c) == Counter({("pwrel.log_forward", "api.compress"): 1,
                               ("route.to_3d", "api.compress"): 1,
                               ("sz.core_compress", "api.compress"): 1,
                               ("sz.lorenzo", "sz.core_compress"): 1,
                               ("sz.pack", "sz.core_compress"): 1,
                               ("sync.total_bits", "api.compress"): 1})
    assert tree(d) == Counter({("sz.core_decompress", "api.decompress"): 1,
                               ("sz.unpack", "sz.core_decompress"): 1,
                               ("sz.reconstruct", "sz.core_decompress"): 1,
                               ("route.cat", "api.decompress"): 1,
                               ("pwrel.log_inverse", "api.decompress"): 1})
    by_name = {e["name"]: e for e in events}
    assert by_name["route.to_3d"]["args"] == {"codes": 10**3, "pad": 0}
    assert by_name["pwrel.log_forward"]["args"] == {"sign_bits": 2 * x.numel()}
    # compress in order: the log transform, the cube, the coder, the host read-back
    assert [e["name"] for e in sorted(events, key=lambda e: e["start_ns"])
            if e["parent"] == c["id"]] == ["pwrel.log_forward", "route.to_3d",
                                           "sz.core_compress", "sync.total_bits"]
    assert all(ids[e["parent"]]["start_ns"] <= e["start_ns"] <= e["end_ns"]
               <= ids[e["parent"]]["end_ns"] for e in events if e["parent"] is not None)
    # the stream and the reconstruction are the same with the tracer off
    trace.disable()
    r_off = comp.compress(x, pw_rel=1e-2)
    assert torch.equal(comp.decompress(r_off), xr) and r_off.nbytes == r.nbytes
    assert torch.equal(r_off.payload["signs"], r.payload["signs"])
    (p_on,), (p_off,) = r.payload["parts"], r_off.payload["parts"]
    assert torch.equal(p_on.packed.words.view(torch.int32), p_off.packed.words.view(torch.int32))
    assert torch.equal(p_on.packed.widths, p_off.packed.widths)
    assert torch.equal(p_on.eb, p_off.eb) and int(p_on.packed.total_bits) == int(p_off.packed.total_bits)
    # a piece that needs padding counts its zeros
    trace.enable()
    comp.compress(torch.linspace(0.0, 1.0, 1001), eb=1e-3)
    (pad,) = [e for e in trace.TRACER.events if e["name"] == "route.to_3d"]
    assert pad["args"] == {"codes": 11**3, "pad": 11**3 - 1001}
    assert "pwrel.log_forward" not in {e["name"] for e in trace.TRACER.events}


@pytest.mark.cuda
def test_a_cuda_compress_spans_each_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sz = get_compressor("tpu-sz", device="cuda")
    zfp = get_compressor("tpu-zfp", device="cuda")
    x3 = torch.linspace(-2.0, 3.0, 16 * 64 * 128, device="cuda").reshape(16, 64, 128)
    x1 = torch.linspace(-1.0, 1.0, 64 * 1000 + 5, device="cuda")
    sz.decompress(sz.compress(x3, eb=1e-3))  # builds and loads the kernels untraced
    zfp.decompress(zfp.compress(x1, rate=8))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    trace.enable()
    try:
        sz.decompress(sz.compress(x3[:, :, :100], eb=1e-3))  # padded
        sz.decompress(sz.compress(x3, eb=1e-3))
        zfp.decompress(zfp.compress(x1, rate=8))
        torch.cuda.synchronize()
    finally:
        trace.disable()
    events = trace.TRACER.events
    trace.clear()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    spans = Counter(e["name"][len("kernel."):] for e in events if e["name"].startswith("kernel."))
    assert launched and dict(spans) == launched
    names = {e["name"] for e in events}
    assert names >= {"sz.guarded_eb", "sync.total_bits", "route.to_3d", "route.cat"}
    assert not names & {"zfp.carve", "zfp.uncarve"}  # K6 and K7 read and write the field
    ids = _by_id(events)
    # a launch's span is innermost, and every span lies inside its parent on the clock
    assert not [e for e in events if e["parent"] is not None
                and ids[e["parent"]]["name"].startswith("kernel.")]
    assert all(ids[e["parent"]]["start_ns"] <= e["start_ns"] < e["end_ns"]
               <= ids[e["parent"]]["end_ns"] for e in events if e["parent"] is not None)
    assert Counter(e["name"] for e in events if e["parent"] is None) == Counter(
        {"api.compress": 3, "api.decompress": 3})


def test_the_benchmark_patch_still_applies():
    """``experiments/portbench_span_window.patch`` (the benchmark's reading of
    these spans, for a benchmark change to take up) applies to ``portbench/``
    and ``BENCHMARK.json`` as they stand, so a change there that breaks it
    shows here."""
    root = Path(__file__).resolve().parents[1]
    # a checkout inside another repository's tree must not be read as that
    # tree's subdirectory, where git skips every path outside it
    env = {**os.environ, "GIT_CEILING_DIRECTORIES": str(root.parent)}
    out = subprocess.run(["git", "apply", "--check", "-v", "experiments/portbench_span_window.patch"],
                         cwd=root, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    checked = {line.split()[-1].rstrip(".") for line in out.stderr.splitlines()
               if line.startswith("Checking patch ")}
    assert {"BENCHMARK.json", "portbench/harness.py", "portbench/tracing.py"} <= checked
