"""Run one cell of the port's benchmark once and print its result line.

From the root of a checkout::

    python3 -m portbench.run --workload nyx512.sz_abs --seed 12345 --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit (also the last lines of standard error).

Exits with another code than 0, printing no result, when CUDA is missing or
has fewer devices than the cell asks for, when the port is not beside this
folder, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``
was imported.  Kernel builds go to the port's own ``kernels/build/`` inside
the checkout; any other cache a library keeps goes under ``.portbench_cache/``
there."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _since_process_start() -> float:
    """Seconds from this process's start to ``T0`` (its start time in clock
    ticks since boot against the uptime, both read from /proc), 0 where
    they cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - started - (time.perf_counter() - T0))


def _fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    lead = _since_process_start()

    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"the port (src/repro_torch) is not beside {Path(__file__).parent.name}/")
    sys.path.insert(0, str(ROOT / "src"))

    import torch

    from portbench import harness

    man = harness.manifest()
    cell = harness.cell_entry(man, args.workload)
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{cell['name']} wants {cell['chips']} devices, "
                     f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    torch.set_num_threads(1)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      t0=T0 - lead, man=man)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"forbidden modules were imported: {', '.join(bad)}", 3)
    print(json.dumps(harness.jsonable(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
