"""BENCHMARK.json against the benchmark's contract: names, units, keys, and
every file a cell's entry names."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness, metrics, traffic

ROOT = Path(__file__).resolve().parents[1]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.fullmatch(p) for p in MAN["paths"])
    assert all((ROOT / p).is_dir() and not p.endswith("_torch") for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                                 for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_keeps_to_the_contract():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), [n for n in names if not NAME.fullmatch(n)]
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([c["why"] for c in MAN["configs"]] + [w["why"] for w in MAN["workloads"]]
                 + [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["bound"] for m in MAN["end_to_end"] if m["name"] == "setup_s"] == [0.25]
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_are_spelled_alike_and_per_layer_cells_report_what_they_move():
    cells = {w["name"]: w for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in cells
            assert m["moves"] in {e["name"] for e in harness.end_to_end_for(MAN, cells[cell])}
    for cell in cells.values():
        e2e = {e["name"] for e in harness.end_to_end_for(MAN, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_for(MAN, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files(cell):
    entry = harness.cell_entry(MAN, cell)
    cfg = harness.config_of(MAN, entry)
    conf = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    assert conf["file"].startswith("portbench/configs/") and cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"] and "assumed" in cfg and cfg["source"] == conf["source"]
    assert (ROOT / "portbench" / "generators" / f"{cfg['generator']}.py").is_file()
    mix = traffic.load("mixes", entry["traffic"])
    assert (ROOT / "portbench" / "reference" / f"{mix['reference']}.py").is_file()
    for m in harness.per_layer_for(MAN, entry):
        assert callable(metrics.load(m["name"]).read)


def test_configs_files_are_their_own():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
