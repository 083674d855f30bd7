"""The plain references against the port on the CPU (its plain versions of
the card's routes): 64^3 Nyx fields through SZ's tiled route, 2^18 HACC
particles through ZFP's 1-D route; and the control, the reference in
bfloat16, which the check must call not correct."""

import pytest
import torch

from portbench import control, judge, traffic
from portbench.reference import sz_tiled, zfp_fixed
from portbench.reference.bits import mismatches
from repro_torch.core.api import get_compressor


@pytest.fixture(scope="module")
def nyx64():
    cfg = {**traffic.load("configs", "nyx512"), "grid": 64, "box": [32, 32, 64]}
    return traffic.build(cfg, traffic.load("mixes", "sz_abs"), 2**31 + 99, torch.device("cpu"))


@pytest.fixture(scope="module")
def hacc_2_18():
    cfg = {**traffic.load("configs", "hacc1024"), "grid": 64, "particles": 2**18}
    return traffic.build(cfg, traffic.load("mixes", "zfp_r8"), 4242, torch.device("cpu"))


@pytest.mark.parametrize("which", ["nyx64", "hacc_2_18"])
def test_reference_streams_and_reconstructions_equal_the_port(which, request):
    snap = request.getfixturevalue(which)
    ref = sz_tiled if which == "nyx64" else zfp_fixed
    comp = get_compressor(snap.compressor, backend="kernel", device="cpu")
    assert len(snap.calls) == (24 if which == "nyx64" else 6)
    for call in snap.calls:
        r = comp.compress(call.x, **call.kwargs)
        want = ref.compress(call.x, call.kwargs)
        got = ref.program_stream(r)
        assert set(got) == set(want)
        for k in want:
            assert mismatches(want[k], got[k]) == 0, (call.field, k)
        recon = comp.decompress(r)
        assert mismatches(ref.decompress(want, tuple(call.x.shape), call.kwargs), recon) == 0
        assert recon.shape == call.x.shape
        for k, v in ref.guarantees(call.x, recon, call.kwargs).items():
            assert float(v) <= ref.LIMITS[k], (call.field, k, v)


def test_the_multi_partition_route_equals_the_port(monkeypatch):
    """A 1-D field longer than a partition: the port's split, the padded last
    partition and ``torch.cat``, against the reference's, at a partition of
    2^12 points (the card's cell takes eight of 2^27)."""
    import functools

    from repro_torch.core import api

    part = 1 << 12
    monkeypatch.setattr(api.transforms, "partition_1d",
                        functools.partial(api.transforms.partition_1d, part=part))
    monkeypatch.setattr(zfp_fixed, "PARTITION", part)
    cfg = {**traffic.load("configs", "hacc1024"), "grid": 24, "particles": 3 * part + 1000}
    snap = traffic.build(cfg, traffic.load("mixes", "zfp_r8"), 77, torch.device("cpu"))
    comp = get_compressor(snap.compressor, backend="kernel", device="cpu")
    call = snap.calls[0]
    r = comp.compress(call.x, **call.kwargs)
    assert len(r.payload["parts"]) == 4 and len(zfp_fixed.part_shapes(call.x.shape)) == 4
    want = zfp_fixed.compress(call.x, call.kwargs)
    got = zfp_fixed.program_stream(r)
    assert all(mismatches(want[k], got[k]) == 0 for k in want)
    recon = comp.decompress(r)
    assert mismatches(zfp_fixed.decompress(want, tuple(call.x.shape), call.kwargs), recon) == 0
    checks, failed = judge.judge_program(snap, control.program_outputs(snap, comp))
    assert failed == 0 and all(v <= lim for v, lim in checks.values())


def test_the_sz_check_holds_the_abs_bound_tightly(nyx64):
    comp = get_compressor("tpu-sz", backend="kernel", device="cpu")
    checks, failed = judge.judge_program(nyx64, control.program_outputs(nyx64, comp))
    assert failed == 0 and checks["stream_mismatch"] == (0, 0)
    assert 0.95 < checks["max_err_over_eb"][0] <= 1.0


@pytest.mark.parametrize("cell,over", [("nyx512.sz_abs", {"grid": 64, "box": [32, 32, 64]}),
                                       ("hacc1024.zfp_r8", {"grid": 32, "particles": 2**15})])
def test_the_control_in_bfloat16_is_not_correct(cell, over):
    line = control.readings(cell, 2**31 + 7, device="cpu", config_overrides=over,
                            compressor_args={"backend": "kernel"})
    assert all(v <= line["limits"][k] for k, v in line["program"].items()), line
    assert line["control_correct"] is False
    assert line["control"]["stream_mismatch"] > 0 and line["control"]["recon_chunk_mismatch"] > 0
    if cell.startswith("nyx"):
        assert line["control"]["max_err_over_eb"] > 3.0  # bf16 rounding breaks the ABS bound


def test_a_slow_reference_judges_calls_drawn_from_the_seed_within_its_budget(hacc_2_18,
                                                                             monkeypatch):
    monkeypatch.setattr(zfp_fixed, "CHECK_VALUES", 2 * 2**18)
    picks = {seed: judge.judged_calls(hacc_2_18, zfp_fixed, seed) for seed in range(2**31, 2**31 + 8)}
    assert all(len(p) == 2 and p == sorted(p) for p in picks.values())
    assert len({tuple(p) for p in picks.values()}) > 1  # the seed draws them
    assert judge.judged_calls(hacc_2_18, zfp_fixed, 2**31) == picks[2**31]
    monkeypatch.setattr(zfp_fixed, "CHECK_VALUES", 1)
    assert len(judge.judged_calls(hacc_2_18, zfp_fixed, 5)) == 1  # one at least
    assert judge.judged_calls(hacc_2_18, sz_tiled, 5) == list(range(6))  # no budget: all
