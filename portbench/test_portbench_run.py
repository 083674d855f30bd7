"""Whole runs of the harness on the CPU at small sizes (the look for a card
skipped): the result line's keys, the traced run, and the faults the check
has to catch, each planted in the timed path underneath."""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from repro_torch.core import api

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"nyx512.sz_abs": {"grid": 32, "box": [16, 16, 32]},
         "hacc1024.zfp_r8": {"grid": 16, "particles": 16**3 - 5}}


def _run(cell, trace=False, seed=2**31 + 3, seconds=0.2):
    return harness.run(cell, seed, seconds, trace, device="cpu", config_overrides=SMALL[cell],
                       compressor_args={"backend": "kernel"}, log=io.StringIO())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_run_prints_the_contract_keys_with_checks_last(cell):
    out = _run(cell)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    e2e = {m["name"]: m["unit"] for m in harness.end_to_end_for(harness.manifest(),
                                                                 harness.cell_entry(harness.manifest(), cell))}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    json.loads(json.dumps(harness.jsonable(out)))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reports_per_layer_metrics_only_and_a_breakdown(cell):
    out = _run(cell, trace=True)
    per_layer = {m["name"] for m in harness.per_layer_for(harness.manifest(),
                                                          harness.cell_entry(harness.manifest(), cell))}
    assert set(out["metrics"]) <= per_layer  # no device here: the device readers find nothing
    assert out["correct"] is True and list(out)[-1] == "checks"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]


def _flip_a_word(monkeypatch, cls):
    real = cls.compress

    def compress(self, x, **kw):
        r = real(self, x, **kw)
        words = r.payload["kpacked"].words if "kpacked" in r.payload else r.payload["parts"][0].words
        w = words.view(torch.int32).reshape(-1)
        w[w.numel() // 3] ^= 1 << 7
        return r
    monkeypatch.setattr(cls, "compress", compress)


def _half_the_snapshot(monkeypatch, cls):
    """Every other call is left out: the previous call's answer is served."""
    real, last = cls.compress, {}

    def compress(self, x, **kw):
        if last.get("r") is not None and last.get("n", 0) % 2:
            r = last["r"]
        else:
            r = real(self, x, **kw)
        last.update(r=r, n=last.get("n", 0) + 1)
        return r
    monkeypatch.setattr(cls, "compress", compress)


def _state_unchanged(monkeypatch, cls):
    """Decompress hands back the same buffer every call, never rewritten."""
    real, held = cls.decompress, {}

    def decompress(self, r):
        if "x" not in held:
            held["x"] = real(self, r)
        return held["x"]
    monkeypatch.setattr(cls, "decompress", decompress)


@pytest.mark.parametrize("fault", [_flip_a_word, _half_the_snapshot, _state_unchanged],
                         ids=["altered_answer", "half_left_out", "state_unchanged"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_each_fault_in_the_timed_path_makes_the_run_not_correct(cell, fault, monkeypatch):
    cls = api.SZCompressor if cell.startswith("nyx") else api.ZFPCompressor
    fault(monkeypatch, cls)
    out = _run(cell)
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["stream_mismatch"]["value"] + out["checks"]["recon_chunk_mismatch"]["value"] > 0


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nyx512.sz_abs",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_the_command_refuses_to_run_without_the_port_beside_it(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nyx512.sz_abs",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell, over in SMALL.items():
        out = harness.run(cell, 5, 0.5, False, device="cuda", config_overrides=over,
                          log=io.StringIO())
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
