"""The frozen byte counts of the roofline metrics against hand counts on a
small box, and the reduction from trace intervals to per-layer numbers on
hand-made traces."""

import pytest
import torch

from portbench import metrics, tracing
from repro_torch.core.api import get_compressor

PEAKS = {"hbm_bytes_per_s": 1e9}  # 1 B/ns: a least time in ns equals its bytes


def _sz_hand_count(x, r):
    """f32 in, and the stream out: 2 * width words of 4 B for every block of
    64 codes, one width byte a block (what total_bits counts, 8 bits a
    header); never the n + 2-word capacity buffer."""
    widths = r.payload["kpacked"].widths.to(torch.int64)
    return 4 * x.numel() + 4 * int((2 * widths).sum()) + widths.numel()


def test_sz_byte_count_is_the_field_and_the_stored_stream():
    x = torch.linspace(-3.0, 5.0, 16 * 64 * 128).reshape(16, 64, 128)
    r = get_compressor("tpu-sz", backend="kernel", device="cpu").compress(x, eb=1e-3)
    capacity = 4 * (x.numel() + 2)
    got = metrics.load("sz_compress_roofline").least_bytes(r.raw_nbytes, r.nbytes)
    assert got == _sz_hand_count(x, r) and got < 4 * x.numel() + capacity


@pytest.mark.parametrize("rate", [4, 8, 16])
def test_zfp_byte_count_is_the_field_and_rate_over_32_of_it(rate):
    x = torch.randn(64 * 1000)
    r = get_compressor("tpu-zfp", backend="kernel", device="cpu").compress(x, rate=rate)
    for name in ("zfp_compress_roofline", "zfp_decompress_roofline"):
        got = metrics.load(name).least_bytes(r.raw_nbytes, r.nbytes)
        assert got == 4 * x.numel() + 4 * x.numel() * rate // 32


def _ctx(compressor="tpu-sz"):
    """Two compress phases of 100 ns, each holding two calls (the second
    returning 80 ns in) and its end's synchronise; device work of 30 + 20 ns
    (overlapping by 10) in the first, 40 ns in the second; a synchronise
    inside the first call of each.  The host's marks run 1000 ns ahead of
    the trace's clock."""
    host = [tracing.Phase("compress", 1100, 1180, 1200, 2),
            tracing.Phase("compress", 1500, 1590, 1600, 2)]
    device = [("k3", 110, 140), ("copy", 130, 150), ("k3", 510, 550)]
    runtime = [("cudaDeviceSynchronize", 5, 9),  # the profiler's own, before the window
               ("cudaLaunchKernel", 101, 103), ("cudaStreamSynchronize", 104, 139),
               ("cudaLaunchKernel", 501, 503), ("cudaStreamSynchronize", 504, 549),
               ("cudaDeviceSynchronize", 181, 199), ("cudaDeviceSynchronize", 591, 601)]
    runtime.sort(key=lambda t: (t[1], -t[2]))  # as collect() hands them over
    phases, note = tracing.place(host, runtime)
    tr = tracing.Trace(device, runtime, phases, note)
    calls = [tracing.CallRecord("compress", 10, 5)] * 4 + [tracing.CallRecord("decompress", 10, 5)]
    return tracing.Context(tr, compressor, calls, PEAKS)


def test_phases_are_placed_by_the_synchronises_that_end_them():
    tr = _ctx().trace
    assert tr.spans("compress") == [(100, 200), (500, 600)]  # offset: median of 1001, 999
    assert tr.spans("compress", calls_only=True) == [(100, 180), (500, 590)]
    assert tr.window == (100, 600) and "2 synchronises" in tr.note
    assert tracing.place(tr.phases, [])[0] == []  # nothing to place them by


def test_roofline_is_least_time_over_the_phases_device_time():
    ctx = _ctx()
    # 4 calls x 15 B at 1 B/ns = 60 ns least; device 30 + 20 + 40 = 90 ns
    assert metrics.load("sz_compress_roofline").read(ctx) == pytest.approx(100 * 60 / 90)
    assert metrics.load("zfp_compress_roofline").read(ctx) is None  # another compressor
    assert metrics.load("zfp_decompress_roofline").read(_ctx("tpu-zfp")) is None  # no decompress phase


def test_idle_share_and_syncs_per_field():
    ctx = _ctx()
    # busy 40 ns of 100 in the first phase (110-150), 40 of 100 in the second
    for route in ("sz", "zfp"):
        assert metrics.load(f"device_idle_pct.{route}_compress").read(ctx) == pytest.approx(60.0)
        assert metrics.load(f"host_syncs_per_field.{route}").read(ctx) == pytest.approx(0.5)
    assert metrics.load("device_idle_pct.zfp_decompress").read(ctx) is None
    assert tracing.busy_s(ctx.trace) == pytest.approx(80e-9)


def test_breakdown_names_the_costly_ops_and_what_the_host_did_in_the_gaps():
    b = tracing.breakdown(_ctx().trace)
    assert b["device_ops"][0] == ["k3", pytest.approx(70e-9)]
    # idle 100-110, 150-510 and 550-600, cut where the phases' parts meet:
    # calls 100-110, 150-180, 500-510, 550-590; the end's synchronise 180-200
    # and 590-600; between the phases 200-500
    assert dict(b["idle_gaps"]) == {"compress calls / host": pytest.approx(90e-9),
                                    "compress sync": pytest.approx(30e-9),
                                    "between phases": pytest.approx(300e-9)}
