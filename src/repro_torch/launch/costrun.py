"""Cost per cell by depth extrapolation (companion to dryrun.py; the port of
``repro.launch.costrun``).

The dry run's counters see every executed operation, so its full-depth count
is exact and has no loop undercount to correct.  This runner exists for
another reason in the port: a full-depth, full-length trace is slow, because
every operation on ``meta`` costs host time, and rwkv6's and hymba's Python
chunk loops (``models/rwkv6.py``, chunk 32; ``models/hybrid.py``, chunk 64)
issue far more operations than a transformer layer.  The reference's cheap
method keeps the whole 80-cell sweep short:

  1. trace the *same* step at n_layers in {L_LO, L_HI} = {2, 4} with the
     dry run's counters (:func:`repro_torch.launch.dryrun.measure`);
  2. per-layer cost = (c(L_HI) - c(L_LO)) / 2, fixed cost = c(L_LO) -
     L_LO * per-layer; extrapolate linearly to the real depth;
  3. train cells: one microbatch is costed, with the float32 accumulators
     of ``k`` microbatches present, and the optimizer update separately
     (it runs once per step, the fwd+bwd ``microbatches`` times):
         total = k * [full - opt] + opt
     for flops and bytes; collective bytes are the microbatch's own (the
     port's gradient mean and pod hop run once a step).  ``k`` is the dry
     run's rule (the smallest power of two up to the local batch whose peak
     fits one card) on the peak extrapolated in depth the same way;
  4. linear-time archs (rwkv6, hymba) at 32k prefill are costed at
     T_c = 4096 and scaled by T/T_c — exact for every linear-in-T op;
     hymba's 3 *global* attention layers are quadratic in T, so their share
     is undercounted ~(T/T_c)x; documented in EXPERIMENTS.md §Roofline
     (< 15% of that cell's flops).

The meshes are the dry run's (:func:`repro_torch.launch.dryrun.fake_mesh`):
every cell on the reference's (16, 16) and (2, 16, 16), the parameters
placed as its ``DEFAULT_RULES`` place them; decode cells take one step of
``train.step.build_serve_step`` over a cache placed as the reference's
(the sequence over ``model`` from 4096 positions).

``meta`` tensors never allocate, so the full-attention tensors (e.g. (B, H,
32k, 32k) f32) are shape metadata only.  ``compile_s`` keeps the reference's
key: the seconds the cell's traces took.

Writes experiments/torch_costrun/<arch>__<shape>__<mesh>.json.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.costrun --arch rwkv6-1.6b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.costrun --mesh multi
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import _ensure_cli_logging
from repro_torch.models.spec import empty_params
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch_costrun"

_log = logging.getLogger("repro_torch.launch.costrun")

LINEAR_FAMILIES = {"ssm", "hybrid"}
T_C = 4096  # the length linear-time archs are costed at

L_LO, L_HI = 2, 4  # the reference's depths (its L=1 lowers hit special-case fusions)


def _combine(c_lo: dict, c_hi: dict, layers: int, mult: float = 1.0) -> dict:
    """Linear-in-depth extrapolation with non-negativity clamps (XLA's
    fusion choices can make byte counts mildly non-monotone)."""
    out = {}
    for k in c_lo:
        d = max((c_hi[k] - c_lo[k]) / (L_HI - L_LO), 0.0)
        base = max(c_lo[k] - d * L_LO, 0.0)
        out[k] = (base + d * layers) * mult
    return out


def _scaled_cfg(cfg, n_layers: int):
    kw = {"n_layers": n_layers}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = n_layers
    return cfg.scaled(**kw)


def _flat(c: dict) -> dict:
    """The counters the extrapolation combines: flops, bytes, collective
    bytes (all kinds) and the peak."""
    return {"flops": c["flops"], "bytes": c["bytes"],
            "collective": float(sum(c["collective"].values())), "peak": float(c["peak"])}


def _model(cfg):
    return registry.build_model(cfg, device="meta")


def opt_cost(cfg, grad_dtype: torch.dtype, param_dtype=torch.bfloat16) -> dict:
    """The AdamW update alone (:func:`repro_torch.optim.adamw.apply_updates`)
    on ``meta`` parameters, moments and gradients."""
    specs = _model(cfg).specs()
    params = empty_params(specs, "meta", param_dtype)
    opt = {"m": empty_params(specs, "meta", torch.float32),
           "v": empty_params(specs, "meta", torch.float32),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    grads = empty_params(specs, "meta", grad_dtype)
    lr = torch.full((), 1e-4, dtype=torch.float32, device="meta")
    return _flat(dryrun.measure(lambda: adamw.apply_updates(params, opt, grads, lr),
                                params, opt, grads))


def train_at(cfg, shape, mesh, k: int) -> dict:
    """Counters of one microbatch of the ``k``-microbatch step at ``cfg``'s
    depth (the step stops after its first microbatch)."""
    return _flat(dryrun.train_cost(_model(cfg), cfg, shape, mesh, k, runs=1))


def train_total(cfg, shape, mesh, k: int) -> dict:
    """``k * [full - opt] + opt`` extrapolated to ``cfg``'s depth, plus the
    extrapolated peak of one microbatch."""
    lo, hi = _scaled_cfg(cfg, L_LO), _scaled_cfg(cfg, L_HI)
    full = _combine(train_at(lo, shape, mesh, k), train_at(hi, shape, mesh, k), cfg.n_layers)
    gdt = torch.float32 if k > 1 else torch.bfloat16
    opt = _combine(opt_cost(lo, gdt), opt_cost(hi, gdt), cfg.n_layers)
    # fwd+bwd repeats k times; the optimizer update runs once (clamp: the
    # separate update need not be exactly the step's own).  The gradient
    # mean's elementwise passes, which run once too, are counted k times.
    total = {key: k * max(full[key] - opt[key], 0.0) + opt[key] for key in ("flops", "bytes")}
    # the port's microbatches exchange nothing: the gradient mean and the
    # pod hop run once a step, after the last one
    total["collective"] = full["collective"]
    total["peak"] = full["peak"]
    return total


def choose_train(cfg, shape, mesh) -> tuple[int, dict]:
    """The dry run's microbatch rule on the extrapolated peak."""
    return dryrun.choose_microbatches(lambda k: train_total(cfg, shape, mesh, k),
                                      dryrun.train_rows(shape, mesh),
                                      *dryrun.train_arg_bytes(_model(cfg), mesh))


def prefill_at(cfg, shape, mesh) -> dict:
    return _flat(dryrun.prefill_cost(_model(cfg), cfg, shape, mesh))


def decode_at(cfg, shape, mesh) -> dict:
    return _flat(dryrun.decode_cost(_model(cfg), cfg, shape, mesh))


def cell_cost(cfg, shape, mesh) -> tuple[dict, float, int]:
    """``(counters, t_scale, microbatches)`` of one cell, extrapolated."""
    # linear archs cost long prefills at T_c and scale linearly
    mult = 1.0
    if shape.kind in ("train", "prefill") and cfg.family in LINEAR_FAMILIES and shape.seq_len > T_C:
        mult = shape.seq_len / T_C
        shape = dataclasses.replace(shape, seq_len=T_C)
    if shape.kind == "train":
        k, total = choose_train(cfg, shape, mesh)
        return {key: v * mult for key, v in total.items()}, mult, k
    at = prefill_at if shape.kind == "prefill" else decode_at
    lo, hi = _scaled_cfg(cfg, L_LO), _scaled_cfg(cfg, L_HI)
    return _combine(at(lo, shape, mesh), at(hi, shape, mesh), cfg.n_layers, mult), mult, 1


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    ok, why = registry.supports(cfg, shape)
    if ok and shape.kind == "train":
        why = dryrun.train_refusal(shape, multi_pod)
        ok = why is None
    mesh_name = "multi" if multi_pod else "single"
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if not ok:
        cell.update(status="skipped", skip_reason=why)
        return cell
    t0 = time.time()
    try:
        with dryrun.fake_mesh(multi_pod) as mesh:
            total, mult, k = cell_cost(cfg, shape, mesh)
            n_dev = mesh.size()
        if shape.kind == "train":
            cell["microbatches"] = k
            cell["peak_bytes_per_device"] = int(total["peak"])
            cell["fits_device"] = bool(total["peak"] <= dryrun.DEVICE_MEMORY_BYTES)
        cell.update(status="ok", compile_s=round(time.time() - t0, 1),
                    n_devices=n_dev,
                    flops_per_device=total["flops"],
                    bytes_per_device=total["bytes"],
                    collective_bytes_per_device=total["collective"],
                    t_scale=mult)
        obs_metrics.event("costrun.cell", arch=arch, shape=shape_name,
                          mesh=mesh_name, status="ok",
                          compile_s=cell["compile_s"],
                          flops_per_device=total["flops"],
                          bytes_per_device=total["bytes"],
                          collective_bytes_per_device=total["collective"],
                          t_scale=mult)
        _log.info("[%s x %s x %s] cost ok in %ss flops/dev=%.3e "
                  "bytes/dev=%.3e coll/dev=%.3e", arch, shape_name, mesh_name,
                  cell["compile_s"], total["flops"], total["bytes"],
                  total["collective"])
    except Exception as e:  # noqa: BLE001
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-1500:])
        obs_metrics.event("costrun.error", arch=arch, shape=shape_name,
                          mesh=mesh_name, error=cell["error"])
        _log.error("[%s x %s x %s] COST FAILED: %s",
                   arch, shape_name, mesh_name, cell["error"])
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", choices=list(registry.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--metrics-dir", default=None,
                    help="also append per-cell records to DIR/metrics.jsonl")
    args = ap.parse_args(argv)
    _ensure_cli_logging()
    if args.metrics_dir is not None:
        mdir = Path(args.metrics_dir)
        mdir.mkdir(parents=True, exist_ok=True)
        obs_metrics.enable(mdir / "metrics.jsonl")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(registry.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(registry.SHAPES)
    fails = 0
    for arch in archs:
        for shape in shapes:
            cell = run_cell(arch, shape, args.mesh == "multi")
            tag = f"{arch}__{shape}__{cell['mesh']}"
            (out_dir / f"{tag}.json").write_text(json.dumps(cell, indent=1))
            fails += cell["status"] == "error"
    if obs_metrics.enabled():
        obs_metrics.export_snapshot(final=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
