"""The port's cost sweep (``repro_torch.launch.costrun``) on the CPU:
``meta`` tensors and a fake process group, no card.

* ``_combine`` gives the reference's numbers on the same inputs;
* the depth extrapolation from 2 and 4 layers gives the dry run's
  full-depth FLOP count within 1e-9 relative for SMOKE dense, MoE and RWKV6
  configs (train at the same microbatch, prefill, decode): every layer of
  these families does the same work;
* hymba's gap (its global-attention layers break the linearity) is printed,
  not held;
* a cell's JSON carries the reference's keys (its committed
  ``experiments/costrun`` files).
"""

import dataclasses
import json
from pathlib import Path

import pytest

from repro.launch import costrun as jcost
from repro_torch.configs import registry as treg
from repro_torch.launch import costrun, dryrun

ROOT = Path(__file__).resolve().parents[1]
DEPTH = 6  # the "full" depth the extrapolation from 2 and 4 layers must reach
SHAPES = {"train": treg.ShapeCell("train_small", 32, 512, "train"),  # k = 2: a row a rank
          "prefill": treg.ShapeCell("prefill_small", 48, 32, "prefill"),
          "decode": treg.ShapeCell("decode_small", 64, 32, "decode")}


@pytest.mark.parametrize("layers,mult", [(40, 1.0), (24, 8.0), (1, 2.5)])
def test_combine_matches_reference(layers, mult):
    c_lo = {"flops": 3.0e12, "bytes": 7.5e11, "collective": 1.0e9}
    c_hi = {"flops": 5.5e12, "bytes": 7.0e11, "collective": 3.5e9}  # bytes shrink: clamped
    assert costrun._combine(c_lo, c_hi, layers, mult) == jcost._combine(c_lo, c_hi, layers, mult)
    assert (costrun.L_LO, costrun.L_HI) == (jcost.L_LO, jcost.L_HI)


def _full_and_extrapolated(arch, kind, k=2):
    cfg = treg.get_config(arch, smoke=True).scaled(n_layers=DEPTH)
    shape = SHAPES[kind]
    with dryrun.fake_mesh(multi_pod=False) as mesh:
        model = treg.build_model(cfg, device="meta")
        if kind == "train":
            full = dryrun.train_cost(model, cfg, shape, mesh, k, runs=1)
            lo, hi = (costrun._scaled_cfg(cfg, n) for n in (costrun.L_LO, costrun.L_HI))
            ext = costrun._combine(costrun.train_at(lo, shape, mesh, k),
                                   costrun.train_at(hi, shape, mesh, k), DEPTH)
        else:
            full = (dryrun.prefill_cost if kind == "prefill" else dryrun.decode_cost)(
                model, cfg, shape, mesh)
            ext, mult, _ = costrun.cell_cost(cfg, shape, mesh)
            assert mult == 1.0
    return full, ext


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-30b-a3b", "rwkv6-1.6b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolated_flops_equal_full_depth(arch, kind):
    full, ext = _full_and_extrapolated(arch, kind)
    assert full["flops"] > 0
    assert ext["flops"] == pytest.approx(full["flops"], rel=1e-9)


def test_hymba_gap_is_printed(monkeypatch):
    """Hymba's global-attention layers are quadratic in T: costed at T_c
    and scaled, their share is undercounted (the module docstring's caveat).
    Printed beside the depth extrapolation's gap, not held."""
    full, ext = _full_and_extrapolated("hymba-1.5b", "prefill")
    monkeypatch.setattr(costrun, "T_C", 16)  # the rule at a SMOKE length
    cfg = treg.get_config("hymba-1.5b", smoke=True).scaled(n_layers=DEPTH)
    with dryrun.fake_mesh(multi_pod=False) as mesh:
        long = dryrun.prefill_cost(treg.build_model(cfg, device="meta"), cfg, SHAPES["prefill"],
                                   mesh)
        scaled, mult, _ = costrun.cell_cost(cfg, SHAPES["prefill"], mesh)
    print(f"hymba-1.5b SMOKE prefill, {DEPTH} layers: depth extrapolation "
          f"{ext['flops'] / full['flops'] - 1:+.3%} against the full depth; costed at T_c = "
          f"{costrun.T_C} and scaled {mult}x, {scaled['flops'] / long['flops'] - 1:+.3%} against "
          f"the full length {SHAPES['prefill'].seq_len}")
    assert min(full["flops"], ext["flops"], long["flops"], scaled["flops"]) > 0


def test_cell_json_has_the_reference_keys(tmp_path):
    # the reference's train keys, and its other kinds' (prefill's, as decode's)
    for shape, ref in (("train_4k", "train_4k"), ("decode_32k", "prefill_32k")):
        want = set(json.loads((ROOT / f"experiments/costrun/minicpm-2b__{ref}__single.json")
                              .read_text()))
        assert costrun.main(["--arch", "whisper-base", "--shape", shape, "--out",
                             str(tmp_path)]) == 0
        cell = json.loads((tmp_path / f"whisper-base__{shape}__single.json").read_text())
        assert cell["status"] == "ok" and want <= set(cell), want - set(cell)
    assert costrun.main(["--arch", "minicpm-2b", "--shape", "long_500k", "--out",
                         str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "minicpm-2b__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["skip_reason"]


def test_linear_families_scale_long_prefills(monkeypatch):
    monkeypatch.setattr(costrun, "T_C", 64)  # the rule at a SMOKE length
    cfg = treg.get_config("rwkv6-1.6b", smoke=True)
    shape = dataclasses.replace(SHAPES["prefill"], seq_len=3 * costrun.T_C)
    with dryrun.fake_mesh(multi_pod=False) as mesh:
        small = dataclasses.replace(shape, seq_len=costrun.T_C)
        base, _, _ = costrun.cell_cost(cfg, small, mesh)
        scaled, mult, _ = costrun.cell_cost(cfg, shape, mesh)
    assert mult == 3.0 and scaled["flops"] == pytest.approx(3 * base["flops"], rel=1e-12)
