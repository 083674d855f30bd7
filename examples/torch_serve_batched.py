"""Serve a small model with batched requests on the PyTorch/CUDA port,
comparing bf16 and compressed (block-float8) KV caches — the paper's
fixed-rate mode applied to inference state — then the same requests
through two routed replicas under the seeded serving fault drill.

    PYTHONPATH=src python examples/torch_serve_batched.py                 # on the card (K10)
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu    # plain versions
"""

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models.spec import init_params, param_count
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.faults import DrillClock, ServeFaultInjector, ServeFaultPlan
from repro_torch.serving.router import Router, RouterConfig, RouterRequest


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_config("starcoder2-3b").scaled(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, d_ff=1024, vocab=8192,
        max_seq=256)
    model = registry.build_model(cfg, device=device)
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(0),
                         device, torch.float32)
    print(f"serving a {param_count(model.specs())/1e6:.1f}M-param starcoder2-family model "
          f"on {device}")

    prompts = [[7, 11, 13, 17 + i] for i in range(12)]
    ecfg = {}
    for codec in ("none", "blockfloat8"):
        ecfg[codec] = EngineConfig(batch_slots=6, max_len=128, codec=codec)
        eng = ServingEngine(model, params, ecfg[codec])
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=list(p), max_new_tokens=16))
        t0 = time.time()
        done = eng.run_until_drained()
        _sync(device)
        dt = time.time() - t0
        toks = sum(len(r.out_tokens) for r in done)
        print(f"\n== codec={codec} (attention={eng._attention})")
        print(f"   requests: {len(done)} finished, {toks} tokens in {dt:.2f}s "
              f"({toks/dt:.1f} tok/s, {eng.ticks} engine ticks)")
        print(f"   KV cache: {eng.cache_nbytes()/1e6:.2f} MB "
              f"({'baseline' if codec == 'none' else 'compressed — 2x capacity headroom'})")
        print(f"   sample continuation: {done[0].out_tokens[:8]}")

    # two replicas behind the router, the seeded drill against them: every
    # request completes or is shed with a typed reason, none is dropped
    clock = DrillClock()
    injector = ServeFaultInjector(ServeFaultPlan.drill(seed=0, n_replicas=2), clock=clock)
    engines = [ServingEngine(model, params, ecfg["blockfloat8"],
                             tick_hook=injector.hook_for(rid), clock=clock)
               for rid in range(2)]
    router = Router(engines, RouterConfig(max_retries=3, integrity_every=1), clock=clock)
    for uid, p in enumerate(prompts):
        router.submit(RouterRequest(uid=uid, prompt=list(p), max_new_tokens=16))
    t0 = time.time()
    done = router.run_until_drained()
    _sync(device)
    dt = time.time() - t0
    fired = ", ".join(f"r{r}t{t}:{k}" for r, t, k in injector.log) or "none"
    print("\n== 2 routed replicas (blockfloat8) under the fault drill, seed 0")
    print(f"   {len(done.completed)} completed, {len(done.shed_requests)} shed in {dt:.2f}s, "
          f"{router.ticks} router ticks; faults fired: {fired}")
    print(f"   {len(router.healthy())}/{len(router.replicas)} replicas healthy at the end")


if __name__ == "__main__":
    main()
