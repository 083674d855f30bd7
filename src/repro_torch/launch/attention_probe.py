"""How far K10 and the plain attention part on random weights, by depth.

Greedy tokens of the two attention paths disagree after the first at full
width (the first comes from prefill, where K10 is not used).  This probe
says why, in float32 with TF32 off:

- ``agree_after_first``: the same requests served with
  ``attention="fused"`` (K10 on a CUDA device, its plain version on the
  CPU) and ``attention="xla"``; the share of the tokens after the first
  that agree.
- ``depth``: for the first 1, 2, 4, ... layers of the same weights, the
  largest |difference| of one decode step's logits between the two paths,
  beside the plain path's own move when the embeddings are scaled by
  1 + 1e-7.  With random weights both grow with depth to the logits' own
  spread, so token agreement at full depth says nothing about either path.

It is not part of ``chip_smoke.py``: it builds the model in float32 (about
12.7 GB at starcoder2-3b) and serves the requests twice more.

    PYTHONPATH=src python -m repro_torch.launch.attention_probe          # the card
    PYTHONPATH=src python -m repro_torch.launch.attention_probe --smoke --device cpu \\
        --max-len 64 --prompt-len 3 20 --requests 4 --max-new 4
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models.spec import init_params
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine


def prompts(n: int, vocab: int, lo: int, hi: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def served_tokens(model, params, ecfg: EngineConfig, ps, new: int) -> list[list[int]]:
    eng = ServingEngine(model, params, ecfg)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new) for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    if not eng.run_until_drained().drained:
        raise RuntimeError(f"serving ({ecfg.attention}) did not drain")
    return [r.out_tokens for r in reqs]


def agreement(model, params, ecfg: dict, ps, new: int) -> float:
    toks = {a: served_tokens(model, params, EngineConfig(**ecfg, attention=a), ps, new)
            for a in ("fused", "xla")}
    if any(a[0] != b[0] for a, b in zip(toks["fused"], toks["xla"])):
        raise RuntimeError("first tokens (from prefill) differ between the attention paths")
    rest = [(a, b) for r, t in zip(toks["fused"], toks["xla"]) for a, b in zip(r[1:], t[1:])]
    return sum(a == b for a, b in rest) / max(len(rest), 1)


def depth_sensitivity(cfg, params, ecfg: dict, ps, new: int, depths, device) -> dict:
    out = {}
    for depth in depths:
        model = registry.build_model(cfg.scaled(n_layers=depth), device=device)
        p = {**params, "layers": {k: {kk: v[:depth] for kk, v in sub.items()}
                                  for k, sub in params["layers"].items()}}
        eng = ServingEngine(model, p, EngineConfig(**ecfg, attention="xla"))
        for i, pr in enumerate(ps[:ecfg["batch_slots"]]):
            eng.submit(Request(uid=i, prompt=list(pr), max_new_tokens=new))
        eng.tick()
        tokens = torch.tensor([r.out_tokens[-1] if r is not None else 0 for r in eng.slots],
                              dtype=torch.int32, device=model.device)
        index = eng._index_arg(eng.pos)
        logits = {}
        for name, attention, scale in (("plain", "xla", 1.0), ("k10", "fused", 1.0),
                                       ("perturbed", "xla", 1.0 + 1e-7)):
            cache = {k: v.clone() for k, v in eng.cache.items()}
            pp = {**p, "embed": {"table": p["embed"]["table"] * scale}}
            logits[name] = model.decode_step(pp, cache, tokens, index, eng.codec,
                                             attention=attention)[0]
        out[depth] = [float((logits["k10"] - logits["plain"]).abs().max()),
                      float((logits["perturbed"] - logits["plain"]).abs().max())]
        if not all(math.isfinite(v) for v in out[depth]):
            raise RuntimeError(f"non-finite logits at depth {depth}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS), default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(256, 1024))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_config(args.arch, smoke=args.smoke).scaled(dtype="float32")
    model = registry.build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model.specs(), gen, device, torch.float32)
    ps = prompts(args.requests, cfg.vocab, *args.prompt_len, seed=args.seed)
    ecfg = dict(batch_slots=args.slots, max_len=args.max_len, page_size=args.page_size,
                codec="blockfloat8", paged=True)
    depths = [n for n in (1, 2, 4, 8, 16, 32, 64) if n < cfg.n_layers] + [cfg.n_layers]
    out = {"agree_after_first": agreement(model, params, ecfg, ps, args.max_new),
           "depth": depth_sensitivity(cfg, params, ecfg, ps, args.max_new, depths, device)}
    print(f"{cfg.name} float32, K10 (fused) against plain (xla) attention: " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
