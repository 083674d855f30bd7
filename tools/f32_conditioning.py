#!/usr/bin/env python3
"""How far float32 rounding moves one train step's gradient of a SMOKE
architecture, on the CPU, in one process.

    PYTHONPATH=src python3 tools/f32_conditioning.py --arch whisper-base
    PYTHONPATH=src python3 tools/f32_conditioning.py --arch minicpm-2b \\
        --set n_heads=2 --set n_kv_heads=2

Draws the SMOKE parameters (seed 0) and one batch of 8 x 16 tokens (the
``TokenPipeline`` of seed 5; standard normal frames of seed 9 for the audio
family), and prints one JSON line:

* ``f32_vs_f64``: the largest, over the parameter leaves, of the float32
  gradient's largest elementwise distance from a float64 evaluation of the
  same step at the same parameters, relative to that leaf's largest float64
  element (the model modules' float32 casts made float64 through a
  stand-in for their ``torch``, as ``chip_smoke.float64_model`` does);
* ``one_ulp``: for each layer function (``layers.mlp``, ``attention``,
  ``layernorm``, ``rmsnorm``, ``embed``, ``unembed``), the same measure
  between the float32 gradient and the float32 gradient with that
  function's output scaled by one float32 ulp (1 + 2^-23): how strongly the
  step amplifies a rounding-sized change there.

A step whose gradient moves by much more than float32's 6e-8 under a
one-ulp change cannot be held to another float32 program of the same
function (a sharded one sums in another order) at a tolerance near the
rounding; ``tests/test_torch_sharded_train.py`` holds such cases in
float64.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import types

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.models import encdec, layers, moe, transformer
from repro_torch.models.spec import init_params

LAYER_FUNCTIONS = ("mlp", "attention", "layernorm", "rmsnorm", "embed", "unembed")
ULP = 1.0 + 2.0**-23


@contextlib.contextmanager
def float64_modules(model):
    """``model`` and the model modules computing in float64; restored on
    exit."""
    mods = (layers, transformer, moe, encdec)
    saved = [m.torch for m in mods]
    proxy = types.ModuleType("torch")
    proxy.__dict__.update(vars(torch))
    proxy.float32 = torch.float64
    for m in mods:
        m.torch = proxy
    dtype, model.dtype = model.dtype, torch.float64
    try:
        yield
    finally:
        for m, t in zip(mods, saved):
            m.torch = t
        model.dtype = dtype


@contextlib.contextmanager
def scaled_output(name: str):
    """``layers.<name>``'s output scaled by one float32 ulp."""
    real = getattr(layers, name)
    setattr(layers, name, lambda *a, **k: real(*a, **k) * ULP)
    try:
        yield
    finally:
        setattr(layers, name, real)


def grads(model, params, batch, dtype) -> list:
    leaves, treedef = tree_util.tree_flatten(params)
    req = [p.detach().to(dtype).requires_grad_(True) for p in leaves]
    extras = [batch["frames"].to(dtype)] if "frames" in batch else []
    loss = model.loss(tree_util.tree_unflatten(treedef, req), batch["tokens"], batch["labels"],
                      *extras)
    return [g.to(torch.float64) for g in torch.autograd.grad(loss, req)]


def worst(got: list, want: list) -> float:
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for a, b in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCH_IDS))
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=INT",
                    help="override an integer field of the SMOKE config")
    args = ap.parse_args(argv)
    over = {k: int(v) for k, v in (s.split("=", 1) for s in args.set)}
    cfg = registry.get_config(args.arch, smoke=True).scaled(dtype="float32", **over)
    model = registry.build_model(cfg, device="cpu")
    params = init_params(model.specs(), torch.Generator().manual_seed(0), "cpu")
    host = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8,
                                    seed=5)).batch_at(0)
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(np.random.default_rng(9).standard_normal(
            (8, cfg.encoder_len, cfg.d_model), dtype=np.float32))
    g32 = grads(model, params, batch, torch.float32)
    with float64_modules(model):
        g64 = grads(model, params, batch, torch.float64)
    one_ulp = {}
    for name in LAYER_FUNCTIONS:
        with scaled_output(name):
            one_ulp[name] = worst(grads(model, params, batch, torch.float32), g32)
    print(json.dumps({"arch": args.arch, "overrides": over, "f32_vs_f64": worst(g32, g64),
                      "one_ulp": one_ulp}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
