#!/usr/bin/env python3
"""Time the SZ stream functions (K3, K4 and the batched K8, K9) and the
quantizer K1 of one source tree on the card.

    python3 tools/sz_kernel_times.py [--src PATH] [--label NAME]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
builds that tree's kernels in its own ``kernels/build/``, and prints one
JSON line for the 256^3 Nyx baryon density (``nyx_fields(n=256, seed=42)``,
eb = 1e-4 x its value range) and the snapshot's first kernel bucket (the
first four 256^3 fields, each at 1e-4 x its own range):

* ``fused_compress``, ``fused_decompress``, ``fused_compress_batched``,
  ``fused_decompress_batched``, ``lorenzo3d_quantize`` (K1, on the
  ``xla`` path's 256^3 field): device ms of one call from CUDA-graph
  replays (median of 5 rounds of 50; null, with the error beside it, where
  the tree's function does not capture) and ``*_call_ms``, an event pair
  around one direct call (host time included), median of 50;
* ``compress_ms``, ``decompress_ms``: the ``tpu-sz`` entry points, and
  ``szk_compress_bucket_ms``, ``szk_decompress_bucket_ms``: the kernel
  bucket's coders, each event-timed, median of 20;
* ``resources`` and ``sass``: registers, stack and shared memory of each
  kernel of the tree's ``sz_fused`` and ``lorenzo3d`` libraries
  (``cuobjdump -res-usage``) and their static SASS instruction counts with
  the ten most frequent opcodes.

The timing is ``tools/cuda_timing.py``'s, as in ``chip_smoke.py``, which
also holds the kernels to their plain versions; this script only times
them.  It calls only the stream-level names that every tree of the port
since the snapshot slice has, so it runs on an older tree as well: to
compare two trees, unpack the older one into a gitignored directory and run
the script on each in one chip call, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from cuda_timing import cuda_ms, graph_ms  # this script's directory
from zfp_kernel_times import cuobjdump, sass_counts

N = 256
SEED = 42
REL_EB = 1e-4
ROWS = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    if not torch.cuda.is_available():
        print("sz_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import arena
    from repro_torch.core import sz as sz_core
    from repro_torch.core.api import get_compressor
    from repro_torch.data import cosmo
    from repro_torch.dist import insitu
    from repro_torch.kernels import _build
    from repro_torch.kernels import lorenzo3d as lor
    from repro_torch.kernels import sz_fused as szf

    _build.build()
    fields = cosmo.nyx_fields(n=N, seed=SEED)
    names = list(fields)[:ROWS]
    xs = [torch.from_numpy(fields[k]).cuda() for k in names]
    ebs = [REL_EB * float(fields[k].max() - fields[k].min()) for k in names]

    x = xs[0]
    shape = tuple(x.shape)
    eb_i = lor.guarded_eb(x, ebs[0])
    packed = szf.fused_compress(x, eb_i)
    xb = torch.stack(xs)
    eb_rows = sz_core.internal_bound(xb.abs().amax(dim=(1, 2, 3)),
                                     torch.tensor(ebs, device=x.device))
    enc = szf.fused_compress_batched(xb, eb_rows)
    runs = {
        "fused_compress": lambda: szf.fused_compress(x, eb_i),
        "fused_decompress": lambda: szf.fused_decompress(packed, shape, eb_i),
        "fused_compress_batched": lambda: szf.fused_compress_batched(xb, eb_rows),
        "fused_decompress_batched": lambda: szf.fused_decompress_batched(enc[0], enc[1], shape,
                                                                         eb_rows),
        "lorenzo3d_quantize": lambda: lor.lorenzo3d_quantize(x, eb_i),
    }
    out = {
        "label": args.label or str(src),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip(),
        "total_bits": int(packed.total_bits), "bucket_used_words": int(enc[5]),
    }
    for name, fn in runs.items():
        try:
            out[f"{name}_ms"] = graph_ms(fn, iters=50)
        except RuntimeError as e:  # an older tree's function may not capture
            out[f"{name}_ms"], out[f"{name}_graph_error"] = None, str(e).splitlines()[0]
        out[f"{name}_call_ms"] = cuda_ms(fn, 50)

    comp = get_compressor("tpu-sz")
    r = comp.compress(x, eb=ebs[0])
    out["compress_ms"] = cuda_ms(lambda: comp.compress(x, eb=ebs[0]), 20)
    out["decompress_ms"] = cuda_ms(lambda: comp.decompress(r), 20)
    entries = [(k, tuple(t.shape), t.dtype) for k, t in zip(names, xs)]
    kbuckets, _ = insitu.plan_kernel_buckets(entries)
    kb = kbuckets[0]
    leaves = dict(zip(names, xs))
    bxs = [leaves[k] for k in kb.names]
    beb = torch.tensor([ebs[names.index(k)] for k in kb.names], device=x.device)
    a = arena.szk_compress_bucket(bxs, kb, beb)
    out["bucket_rows"] = kb.rows
    out["szk_compress_bucket_ms"] = cuda_ms(lambda: arena.szk_compress_bucket(bxs, kb, beb), 20)
    out["szk_decompress_bucket_ms"] = cuda_ms(lambda: arena.szk_decompress_bucket(a, kb), 20)

    out["resources"], out["sass"] = {}, {}
    for name in ("sz_fused", "lorenzo3d"):
        lib = str(_build.library_path(name))
        res = cuobjdump(_build.nvcc(), "-res-usage", lib)
        out["resources"].update({m.group(1): m.group(2).strip()
                                 for m in re.finditer(r"Function (\S+):\s*\n?\s*(REG:.*)", res)})
        out["sass"].update(sass_counts(cuobjdump(_build.nvcc(), "-sass", lib)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
