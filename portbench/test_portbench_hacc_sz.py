"""HACC's in-situ SZ dump (``hacc1024_quarter.sz_pwrel``) on the CPU at small
sizes: the generator's pieces, the plain reference of SZ's 1-D core route
against the port bit for bit, a whole run of the cell, the faults the check
has to catch, and the control in bfloat16."""

import functools
import io
import math

import pytest
import torch

from portbench import control, harness, judge, metrics, tracing, traffic
from portbench.generators import hacc, hacc_quarter
from portbench.reference import sz_core
from portbench.reference.bits import mismatches
from repro_torch.core import api
from repro_torch.core.api import get_compressor

CELL = "hacc1024_quarter.sz_pwrel"
# 13,747 particles a field, 8,192 kept, pieces of 2,048 (cubes of side 13: 149 zeros of pad)
SMALL = {"grid": 24, "particles": 24**3 - 77, "keep": 8192, "piece": 2048}
SEED = 2**31 + 33


def _cfg(**over):
    return {**traffic.load("configs", "hacc1024_quarter"), **SMALL, **over}


def _run(seed=SEED):
    return harness.run(CELL, seed, 0.2, False, device="cpu", config_overrides=SMALL,
                       log=io.StringIO())


def _equal_to_the_port(x: torch.Tensor, kwargs: dict) -> None:
    comp = get_compressor("tpu-sz", backend="core", device="cpu")
    r = comp.compress(x, **kwargs)
    want = sz_core.compress(x, kwargs)
    got = sz_core.program_stream(r)
    assert set(got) == set(want) == ({"words", "widths", "total_bits", "eb_i"}
                                     | ({"signs"} if "pw_rel" in kwargs else set()))
    assert {k: mismatches(want[k], got[k]) for k in want} == {k: 0 for k in want}
    recon = comp.decompress(r)
    assert mismatches(sz_core.decompress(want, tuple(x.shape), kwargs), recon) == 0
    for k, v in sz_core.guarantees(x, recon, kwargs).items():
        assert float(v) <= sz_core.LIMITS[k], (k, float(v))


def test_the_pieces_are_the_hacc_fields_cut_to_keep():
    cfg = _cfg()
    pieces = list(hacc_quarter.fields(cfg, SEED, "cpu"))
    whole = dict(hacc.fields(cfg, SEED, "cpu"))
    per = SMALL["keep"] // SMALL["piece"]
    assert [n for n, _ in pieces] == [n for n in cfg["fields"] for _ in range(per)]
    for name in cfg["fields"]:
        mine = [p for n, p in pieces if n == name]
        assert all(p.shape == (SMALL["piece"],) and p.is_contiguous() for p in mine)
        assert torch.equal(torch.cat(mine), whole[name][:SMALL["keep"]])
    snap = traffic.build(cfg, traffic.load("mixes", "sz_pwrel"), SEED, torch.device("cpu"))
    assert len(snap.calls) == 6 * per
    for c in snap.calls:  # ABS bounds from each piece's own range; PW_REL on the velocities
        if c.field.startswith("v"):
            assert c.kwargs == {"pw_rel": 1e-2}
        else:
            assert c.kwargs == {"eb": 1e-4 * float(c.x.amax() - c.x.amin())}


def test_a_keep_beyond_the_field_is_refused():
    with pytest.raises(ValueError):
        next(hacc_quarter.fields(_cfg(keep=10**6), SEED, "cpu"))


def test_the_reference_equals_the_port_on_every_piece_of_a_snapshot():
    snap = traffic.build(_cfg(), traffic.load("mixes", "sz_pwrel"), SEED + 1,
                         torch.device("cpu"))
    for call in snap.calls:
        _equal_to_the_port(call.x, call.kwargs)


@pytest.mark.parametrize("kwargs", [{"eb": 1e-3}, {"pw_rel": 1e-2}], ids=["abs", "pw_rel"])
@pytest.mark.parametrize("n", [64, 1000, 4096 + 17], ids=["cube", "padded", "padded_large"])
def test_the_reference_equals_the_port_with_zeros_and_signs(kwargs, n):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=g) * torch.logspace(-3, 3, n)
    x[::7] = 0.0  # exact zeros: the sign channel's third value
    x[5] = -0.0
    _equal_to_the_port(x, kwargs)


def test_the_reference_equals_the_port_across_partitions(monkeypatch):
    """A field longer than a partition: one cube a partition, the last one
    padded, each with its own ``eb_i``, joined on decompress (a partition of
    2^10 points here; the card's pieces of 2^25 take one)."""
    part = 1 << 10
    monkeypatch.setattr(api.transforms, "partition_1d",
                        functools.partial(api.transforms.partition_1d, part=part))
    monkeypatch.setattr(api.transforms, "HACC_PARTITION", part)
    monkeypatch.setattr(sz_core, "PARTITION", part)
    x = torch.linspace(-50.0, 80.0, 3 * part + 300) ** 2 - 100.0
    for kwargs in ({"eb": 0.05}, {"pw_rel": 1e-3}):
        r = get_compressor("tpu-sz", backend="core", device="cpu").compress(x, **kwargs)
        assert len(r.payload["parts"]) == 4 and len(sz_core.cube_sides(x.numel())) == 4
        assert sz_core.compress(x, kwargs)["eb_i"].shape == (4,)
        _equal_to_the_port(x, kwargs)


def test_the_guarantees_catch_a_moved_zero_and_a_wrong_shape():
    x = torch.tensor([0.0, 1.0, -2.0])
    assert float(sz_core.guarantees(x, torch.tensor([1e-30, 1.0, -2.0]),
                                    {"pw_rel": 0.01})["max_relerr_over_pwrel"]) == math.inf
    g = sz_core.guarantees(x, torch.tensor([0.0, 1.02, -2.0]), {"pw_rel": 0.01})
    assert float(g["max_relerr_over_pwrel"]) == pytest.approx(2.0) and float(g["max_err_over_eb"]) == 0
    g = sz_core.guarantees(x, torch.tensor([0.0, 1.5, -2.0]), {"eb": 0.25})
    assert float(g["max_err_over_eb"]) == pytest.approx(2.0) and float(g["max_relerr_over_pwrel"]) == 0
    assert all(float(v) == math.inf for v in sz_core.guarantees(x, x[:2], {"eb": 1.0}).values())


def test_a_small_run_of_the_cell_is_correct():
    out = _run()
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] % 24 == 0
    assert set(out["metrics"]) == {"snapshot_compress_ms_p95.sz", "setup_s"}
    assert {k: v["value"] for k, v in out["checks"].items()
            if k in ("stream_mismatch", "recon_chunk_mismatch", "calls_unchecked")} == {
        "stream_mismatch": 0, "recon_chunk_mismatch": 0, "calls_unchecked": 0}
    assert 0.9 < out["checks"]["max_err_over_eb"]["value"] <= 1.0
    assert 0.9 < out["checks"]["max_relerr_over_pwrel"]["value"] <= 1.0


def _flip_a_word(r):
    w = r.payload["parts"][0].packed.words.view(torch.int32)
    w[w.numel() // 3] ^= 1 << 7


def _flip_a_sign(r):
    if r.payload["signs"] is not None:
        s = r.payload["signs"]
        s[s.numel() // 2] *= -1


FLIPS = {"word": _flip_a_word, "sign": _flip_a_sign}


@pytest.mark.parametrize("fault", ["word", "sign", "dropped"])
def test_each_fault_in_the_timed_path_makes_the_run_not_correct(fault, monkeypatch):
    real, last = api.SZCompressor.compress, {}

    def compress(self, x, **kw):
        if fault == "dropped" and last.get("n", 0) % 2:
            r = last["r"]  # every other call left out: the previous answer served
        else:
            r = real(self, x, **kw)
            if fault in FLIPS:
                FLIPS[fault](r)
        last.update(r=r, n=last.get("n", 0) + 1)
        return r
    monkeypatch.setattr(api.SZCompressor, "compress", compress)
    out = _run()
    assert out["correct"] is False and out["failed"] > 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["stream_mismatch"] > 0 and checks["recon_chunk_mismatch"] > 0
    if fault == "sign":  # a sign flipped moves a velocity by twice itself
        assert checks["max_relerr_over_pwrel"] > 100 and checks["max_err_over_eb"] <= 1.0


def test_the_control_in_bfloat16_is_not_correct():
    line = control.readings(CELL, SEED + 2, device="cpu", config_overrides=SMALL)
    assert all(v <= line["limits"][k] for k, v in line["program"].items()), line
    assert line["control_correct"] is False
    assert line["control"]["stream_mismatch"] > 0 and line["control"]["recon_chunk_mismatch"] > 0
    assert line["control"]["max_relerr_over_pwrel"] > 1.0  # bf16 rounding breaks PW_REL 1e-2
    assert line["control"]["max_err_over_eb"] > 3.0  # and the ABS bound


def test_every_call_is_judged_and_on_the_core_route():
    snap = traffic.build(_cfg(), traffic.load("mixes", "sz_pwrel"), SEED, torch.device("cpu"))
    assert judge.judged_calls(snap, sz_core, SEED) == list(range(len(snap.calls)))
    comp = get_compressor("tpu-sz", device="cpu")
    r = comp.compress(snap.calls[-1].x, **snap.calls[-1].kwargs)
    assert r.meta["was_1d"] and not r.payload.get("kernel") and r.meta["mode"] == "pw_rel"


@pytest.mark.parametrize("kwargs", [{"eb": 1e-3}, {"pw_rel": 1e-2}], ids=["abs", "pw_rel"])
def test_the_core_roofline_counts_the_piece_and_its_stored_stream(kwargs):
    """f32 in, and out every part's words as ``total_bits`` counts them (2 *
    width words of 4 B a block of 64 codes, a width byte a block) plus,
    under PW_REL, 2 bits a value of sign channel; never the padded cube's
    capacity buffer."""
    x = torch.linspace(-3.0, 5.0, 1000) ** 3
    r = get_compressor("tpu-sz", backend="core", device="cpu").compress(x, **kwargs)
    widths = torch.cat([c.packed.widths.to(torch.int64) for c in r.payload["parts"]])
    bits = 64 * int(widths.sum()) + 8 * widths.numel() + (2 * x.numel() if "pw_rel" in kwargs else 0)
    got = metrics.load("sz_core_compress_roofline").least_bytes(r.raw_nbytes, r.nbytes)
    assert got == 4 * x.numel() + (bits + 7) // 8


def _one_sz_phase():
    """One compress phase of 100 ns on the trace's clock, four calls each
    ending on its ``int(total_bits)`` stream synchronise, device work from
    110 to 190 ns; the host's marks run 1000 ns ahead."""
    host = [tracing.Phase("compress", 1100, 1190, 1200, 4)]
    device = [("lorenzo", 110, 150), ("pack", 150, 190)]
    runtime = sorted([("cudaStreamSynchronize", 120 + 15 * i, 125 + 15 * i) for i in range(4)]
                     + [("cudaDeviceSynchronize", 191, 199)], key=lambda t: (t[1], -t[2]))
    phases, note = tracing.place(host, runtime)
    calls = [tracing.CallRecord("compress", 10, 5)] * 4
    return tracing.Context(tracing.Trace(device, runtime, phases, note), "tpu-sz", calls,
                           {"hbm_bytes_per_s": 1e9})


@pytest.mark.parametrize("name,want", [("sz_core_compress_roofline", 100 * 60 / 80),
                                       ("host_syncs_per_field.sz", 1.0),
                                       ("device_idle_pct.sz_compress", 20.0)])
def test_the_cell_reads_the_sz_route_metrics(name, want):
    """The cell reports the SZ route's entry-point and device readers beside
    its own roofline, each moving the SZ compress p95, and each reads a hand
    trace of the route: 4 calls x 15 B at 1 B/ns over 80 ns of device time,
    a synchronise a call, 20 of 100 ns idle."""
    man = harness.manifest()
    mine = {m["name"]: m for m in harness.per_layer_for(man, harness.cell_entry(man, CELL))}
    assert set(mine) == {"sz_core_compress_roofline", "host_syncs_per_field.sz",
                         "device_idle_pct.sz_compress"}
    assert mine[name]["moves"] == "snapshot_compress_ms_p95.sz"
    assert metrics.load(name).read(_one_sz_phase()) == pytest.approx(want)
