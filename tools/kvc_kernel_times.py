#!/usr/bin/env python3
"""Time K10 (decode attention over the blockfloat8 KV cache) of one source
tree on the card, paged and dense.

    python3 tools/kvc_kernel_times.py [--src PATH] [--label NAME]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
builds that tree's kernels in its own ``kernels/build/``, and prints one
JSON line with, at the serving shape (starcoder2-3b: B = 8 lanes, 24/2
heads, head dim 128, capacity 2048 in 16-token pages, positions of 256-1024
prompt tokens part-way through 32 new ones, lane 0 free) and at
``decode_32k`` (capacity 32768, positions from S/2 to S, lane 0 free), bf16
queries:

* ``<shape>.paged_ms``: the tree's paged decode path, from the pool and a
  permuted page table: ``ops.kvc_attention_paged`` where the tree has it,
  else the gather of ``layers.cache_codes(cache, PagedKV(...))`` followed by
  ``ops.kvc_attention`` (``paged_path`` says which);
* ``<shape>.dense_ms``: ``ops.kvc_attention`` on the gathered dense cache;
* ``*_call_ms``: an event pair around one direct call (host time included);
* ``resources`` and ``sass``: registers, stack and shared memory of each
  kernel of the tree's ``kvc_attention`` library (``cuobjdump -res-usage``)
  and its static SASS instruction count with the ten most frequent opcodes.

Device ms come from CUDA-graph replays (median of 5 rounds of 50), event
pairs from a median of 50, both by ``tools/cuda_timing.py`` as in
``chip_smoke.py``, which also holds the kernels to their plain versions;
this script only times them.  The inputs are drawn on the card from fixed
seeds, so two trees time the same data: to compare them, unpack the older
one into a gitignored directory and run the script on each in one chip
call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cuda_timing import cuda_ms, graph_ms  # this script's directory
from zfp_kernel_times import cuobjdump, sass_counts

SEED = 42
B, H, HKV, D, PAGE = 8, 24, 2, 128, 16
SHAPES = {"serving": 2048, "decode_32k": 32768}
PROMPT, NEW = (256, 1024), 32


def positions(label: str, s: int) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    if label == "serving":
        idx = rng.integers(PROMPT[0], PROMPT[1] + 1, size=B) + rng.integers(0, NEW, size=B)
    else:
        idx = rng.integers(s // 2, s, size=B)
        idx[-1] = s - 1
    idx = np.minimum(idx, s - 1)
    idx[0] = -1
    return idx.astype(np.int32)


def pool(s: int, device):
    """Pool of B * max_pages + 1 pages (page 0 zero) with every lane's pages
    in a random order, and the table that maps them."""
    max_pages = s // PAGE
    n_pages = B * max_pages + 1
    g = torch.Generator(device=device).manual_seed(SEED)
    kp, vp = (torch.randint(-127, 128, (n_pages, PAGE, HKV, D), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ksp, vsp = (torch.rand(n_pages, PAGE, HKV, generator=g, device=device) * 1.9e-2 + 1e-3
                for _ in range(2))
    for t in (kp, vp, ksp, vsp):
        t[0] = 0
    table = (torch.randperm(n_pages - 1, generator=g, device=device)[: B * max_pages] + 1)
    q = torch.randn(B, H, D, generator=g, device=device).to(torch.bfloat16)
    return q, kp, ksp, vp, vsp, table.reshape(B, max_pages).to(torch.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    if not torch.cuda.is_available():
        print("kvc_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.models import layers

    _build.build()
    device = torch.device("cuda")
    paged_entry = getattr(ops, "kvc_attention_paged", None)
    out = {
        "label": args.label or str(src),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip(),
        "paged_path": "kvc_attention_paged" if paged_entry else "cache_codes + kvc_attention",
    }
    for label, s in SHAPES.items():
        q, kp, ksp, vp, vsp, table = pool(s, device)
        idx = torch.from_numpy(positions(label, s)).to(device)
        cache = {"k_codes": kp, "k_scale": ksp, "v_codes": vp, "v_scale": vsp}
        dense = layers.cache_codes(cache, layers.PagedKV(idx, table))
        if paged_entry:
            def paged():
                return paged_entry(q, kp, ksp, vp, vsp, table, idx)
        else:
            def paged():
                return ops.kvc_attention(q, *layers.cache_codes(cache, layers.PagedKV(idx, table)),
                                         idx)
        runs = {"paged": paged, "dense": lambda: ops.kvc_attention(q, *dense, idx)}
        out[f"{label}.positions"] = int(sum(min(int(i) + 1, s) for i in idx if i >= 0))
        for name, fn in runs.items():
            out[f"{label}.{name}_ms"] = graph_ms(fn, iters=50)
            out[f"{label}.{name}_call_ms"] = cuda_ms(fn, 50)
        del q, kp, ksp, vp, vsp, table, dense, cache
        torch.cuda.empty_cache()

    lib = _build.library_path("kvc_attention")
    res = cuobjdump(_build.nvcc(), "-res-usage", str(lib))
    out["resources"] = {m.group(1): m.group(2).strip()
                        for m in re.finditer(r"Function (\S+):\s*\n?\s*(REG:.*)", res)}
    out["sass"] = sass_counts(cuobjdump(_build.nvcc(), "-sass", str(lib)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
