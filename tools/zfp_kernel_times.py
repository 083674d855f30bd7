#!/usr/bin/env python3
"""Time K6 and K7 (the fused TPU-ZFP encode and decode kernels) of one
source tree on the card.

    python3 tools/zfp_kernel_times.py [--src PATH] [--label NAME]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
builds that tree's kernels in its own ``kernels/build/``, and on the 256^3
Nyx baryon density (``nyx_fields(n=256, seed=42)``) at rate 8 prints one
JSON line:

* ``k6_ms``, ``k7_ms``: device time of one launch from CUDA-graph replays
  (median of 5 rounds of 50 back-to-back replays), and ``*_call_ms``: an
  event pair around one direct call (the ctypes launch's host time
  included), median of 50;
* ``compress_ms``, ``decompress_ms``: the ``tpu-zfp`` entry points,
  event-timed, median of 20;
* ``resources``: registers, stack and shared memory of each kernel of the
  tree's ``zfp_fused`` library (``cuobjdump -res-usage``), and ``sass``: its
  static SASS instruction count per kernel with the ten most frequent
  opcodes (``cuobjdump -sass``).

The timing is ``tools/cuda_timing.py``'s, as in ``chip_smoke.py``, which
also holds the kernels to their plain versions; this script only times
them.  It uses only what every tree of the port has, so it runs on an older
tree as well: to compare two trees, unpack the older one into a gitignored
directory and run the script on each in one chip call, in the order A, B,
B, A.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from cuda_timing import cuda_ms, graph_ms  # this script's directory

RATE = 8
N = 256
SEED = 42


def cuobjdump(nvcc: str, *args: str) -> str:
    tool = Path(nvcc).with_name("cuobjdump")
    return subprocess.run([str(tool), *args], capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_counts(text: str) -> dict:
    """Static SASS instructions per kernel and its ten most frequent opcodes."""
    out, name, ops = {}, None, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, ops = m.group(1), collections.Counter()
            out[name] = ops
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and ops is not None:
            ops[m.group(1).split(".")[0]] += 1
    return {k: {"instructions": sum(c.values()), "top": dict(c.most_common(10))}
            for k, c in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))

    if not torch.cuda.is_available():
        print("zfp_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import zfp as zfp_core
    from repro_torch.core.api import get_compressor
    from repro_torch.data import cosmo
    from repro_torch.kernels import _build
    from repro_torch.kernels import zfp_fused as zff

    _build.build()
    x = torch.from_numpy(cosmo.nyx_fields(n=N, seed=SEED)["baryon_density"]).cuda()
    blocks = zfp_core._carve_blocks(x)
    enc = zff.fused_compress_blocks(blocks, RATE)

    def k6():
        return zff.fused_compress_blocks(blocks, RATE)

    def k7():
        return zff.fused_decompress_blocks(*enc, RATE)

    comp = get_compressor("tpu-zfp")
    r = comp.compress(x, rate=RATE)
    lib = _build.library_path("zfp_fused")
    res = cuobjdump(_build.nvcc(), "-res-usage", str(lib))
    resources = {m.group(1): m.group(2).strip()
                 for m in re.finditer(r"Function (\S+):\s*\n?\s*(REG:.*)", res)}
    out = {
        "label": args.label or str(src),
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip(),
        "blocks": int(blocks.shape[0]), "rate": RATE,
        "k6_ms": graph_ms(k6, iters=50), "k7_ms": graph_ms(k7, iters=50),
        "k6_call_ms": cuda_ms(k6, 50), "k7_call_ms": cuda_ms(k7, 50),
        "compress_ms": cuda_ms(lambda: comp.compress(x, rate=RATE), 20),
        "decompress_ms": cuda_ms(lambda: comp.decompress(r), 20),
        "resources": resources,
        "sass": sass_counts(cuobjdump(_build.nvcc(), "-sass", str(lib))),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
