"""Serving launcher: continuous-batched requests against a registered arch
(the port of ``repro.launch.serve``).

Slots admit work through a saxml-style batch-size ladder; each slot decodes
at its own position, prompts prefill in one chunked call, and the KV cache
can run as a paged compressed pool (``--pool-pages`` / ``--pool-bytes``).
Parameters are random, drawn from ``--seed`` on the device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --smoke \\
        --device cpu --requests 8 --max-new 16 --codec blockfloat8

With ``--replicas N`` (or ``--fault-seed``) requests go through the
multi-replica router (``serving/router.py``) instead of a bare engine:
health-checked failover, per-request deadlines (``--deadline-ms``),
bounded retry onto a different replica (``--retries``), and typed
shedding.  ``--fault-seed`` arms the seeded serving fault drill
(``serving/faults.py``) against the replicas.  The replicas share one
parameter tree; each owns its cache or page pool.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b --smoke \\
        --device cpu --replicas 2 --fault-seed 0

``--arch`` takes every registered arch.  The dense and MoE families
(``DenseLM``, ``MoELM``) prefill prompts in one call into a paged pool;
rwkv6 (``RWKV6LM``), hymba (``HymbaLM``) and whisper (``EncDecLM``) feed
prompts token by token into a dense per-slot cache (``--paged on`` is
refused for them).  ``--device`` defaults to CUDA; there blockfloat8 decode
attention runs through K10 for the dense, MoE and enc-dec families (whisper
decodes with an empty encoder memory here); rwkv6 has no attention and
hymba decodes with its own windowed attention, so neither has a K10 route.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models.spec import init_params, param_count
from repro_torch.models.transformer import torch_dtype
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.faults import ServeFaultInjector, ServeFaultPlan
from repro_torch.serving.router import Router, RouterConfig, RouterRequest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(registry.ARCH_IDS), required=True,
                    help="any registered arch; the dense and MoE families take the paged "
                         "pool, and with blockfloat8 on CUDA K10 (as does whisper)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--codec", choices=["none", "blockfloat8"], default="none")
    ap.add_argument("--paged", choices=["auto", "on", "off"], default="auto",
                    help="paged KV pool (auto: on for models that support it)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="KV pool size in pages (default: slots * max_len)")
    ap.add_argument("--pool-bytes", type=int, default=None,
                    help="KV pool size in bytes (overrides --pool-pages)")
    ap.add_argument("--ladder", type=str, default="",
                    help="comma-separated admission batch-size ladder, e.g. 1,2,4")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 enables seeded sampling instead of greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1 serves through the multi-replica router")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="arm the seeded serving fault drill (implies router)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request completion deadline (router only)")
    ap.add_argument("--retries", type=int, default=2,
                    help="max re-dispatches after losing a replica")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    model = registry.build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model.specs(), gen, device, torch_dtype(cfg.dtype))
    print(f"{cfg.name}: {param_count(model.specs())/1e6:.1f}M params, codec={args.codec}, "
          f"device={device}")

    ladder = tuple(int(x) for x in args.ladder.split(",") if x) if args.ladder else ()
    ecfg = EngineConfig(
        batch_slots=args.slots, max_len=args.max_len, codec=args.codec,
        paged={"auto": "auto", "on": True, "off": False}[args.paged],
        page_size=args.page_size, pool_pages=args.pool_pages,
        pool_bytes=args.pool_bytes, ladder=ladder,
        greedy=args.temperature <= 0,
        temperature=args.temperature if args.temperature > 0 else 1.0,
        sample_seed=args.seed)

    routed = args.replicas > 1 or args.fault_seed is not None
    if not routed:
        eng = ServingEngine(model, params, ecfg)
        if eng.paged:
            print(f"paged KV: {eng.pool.n_pages - 1} pages x {eng.pool.page_size} tokens "
                  f"({eng.pool.nbytes()/1e6:.2f} MB pool)")
        for uid in range(args.requests):
            eng.submit(Request(uid=uid, prompt=[1 + uid % 7, 2, 3],
                               max_new_tokens=args.max_new))
        t0 = time.time()
        done = eng.run_until_drained()
        _sync(device)
        dt = time.time() - t0
        if not done.drained:
            print("WARNING: drain exhausted max_ticks with requests still live")
        toks = sum(len(r.out_tokens) for r in done)
        print(f"{len(done)} requests, {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s); "
              f"KV cache {eng.cache_nbytes()/1e6:.2f} MB; attention={eng._attention}")
        return 0

    injector = None
    if args.fault_seed is not None:
        plan = ServeFaultPlan.drill(args.fault_seed, n_replicas=max(1, args.replicas))
        injector = ServeFaultInjector(plan)
        print(f"fault drill armed: seed={args.fault_seed}, {len(plan.events)} events")
    engines = [ServingEngine(model, params, ecfg,
                             tick_hook=injector.hook_for(rid) if injector else None)
               for rid in range(max(1, args.replicas))]
    router = Router(engines, RouterConfig(
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
        max_retries=args.retries,
        integrity_every=2 if injector else 0))
    print(f"router: {len(engines)} replicas, retries={args.retries}, "
          f"deadline={args.deadline_ms or 'none'}ms")
    for uid in range(args.requests):
        router.submit(RouterRequest(uid=uid, prompt=[1 + uid % 7, 2, 3],
                                    max_new_tokens=args.max_new))
    t0 = time.time()
    done = router.run_until_drained()
    _sync(device)
    dt = time.time() - t0
    if not done.drained:
        print("WARNING: router drain exhausted max_ticks with work unresolved")
    toks = sum(len(r.tokens) for r in done)
    shed = done.shed_requests
    print(f"{len(done)} requests: {len(done.completed)} completed, "
          f"{len(shed)} shed, {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s); "
          f"{len(router.healthy())}/{len(router.replicas)} replicas healthy")
    for r in shed:
        print(f"  shed uid={r.uid}: {r.shed.reason} ({r.shed.detail})")
    if injector:
        fired = ", ".join(f"r{r}t{t}:{k}" for r, t, k in injector.log) or "none"
        print(f"faults fired: {fired}")
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

if __name__ == "__main__":
    raise SystemExit(main())
