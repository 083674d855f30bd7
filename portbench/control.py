"""The control of the correctness check, and the program's readings beside it.

The control is the plain reference put in the program's place, computed in
the nearest precision below the configuration's (bfloat16 for float32): each
field or box is rounded to bfloat16 before the reference codes it.  The
check has to call it not correct.  For each seed this prints one JSON line
with the numbers the check compares, for the control and for one pass of
the program over the same snapshot (the calls a run with that seed judges),
at the cell's own size on the card::

    python3 -m portbench.control --workload nyx512.sz_abs --seeds 11 12 13

The benchmark's own runs never run it; ``portbench/test_portbench_reference.py``
runs it at a small size on the CPU."""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"float32": torch.bfloat16, "float64": torch.float32}


def control_outputs(snap, ref, dtype: torch.dtype, calls: list[int] | None = None) -> dict[int, tuple]:
    """The reference in the program's place, its inputs rounded to ``dtype``:
    (stream, digest, guarantees) for each of ``calls`` (default all)."""
    from portbench.judge import observe

    out = {}
    for j in range(len(snap.calls)) if calls is None else calls:
        call = snap.calls[j]
        x = call.x.to(dtype).to(call.x.dtype)
        stream = ref.compress(x, call.kwargs)
        out[j] = (stream, *observe(ref, call, ref.decompress(stream, tuple(x.shape), call.kwargs)))
    return out


def program_outputs(snap, comp, calls: list[int] | None = None) -> dict[int, tuple]:
    """One pass of the program over the snapshot: (result, digest,
    guarantees) for each of ``calls`` (default all), as the harness keeps
    them."""
    from portbench import reference as references
    from portbench.judge import observe

    ref = references.load(snap.reference)
    out = {}
    for j in range(len(snap.calls)) if calls is None else calls:
        call = snap.calls[j]
        r = comp.compress(call.x, **call.kwargs)
        out[j] = (r, *observe(ref, call, comp.decompress(r)))
    return out


def readings(cell: str, seed: int, *, device: str = "cuda", config_overrides: dict | None = None,
             compressor_args: dict | None = None) -> dict:
    from portbench import harness, judge, traffic
    from portbench import reference as references

    man = harness.manifest()
    entry = harness.cell_entry(man, cell)
    cfg = {**harness.config_of(man, entry), **(config_overrides or {})}
    snap = traffic.build(cfg, traffic.load("mixes", entry["traffic"]), seed, torch.device(device))
    ref = references.load(snap.reference)
    calls = judge.judged_calls(snap, ref, seed)  # those a run with this seed judges
    line: dict = {"workload": cell, "seed": seed, "calls": calls}
    with torch.no_grad():
        from repro_torch.core.api import get_compressor

        comp = get_compressor(snap.compressor, device=device, **(compressor_args or {}))
        checks, _ = judge.judge_program(snap, program_outputs(snap, comp, calls), calls)
        line["program"] = {k: v for k, (v, _) in checks.items()}
        del comp
        checks, _ = judge.judge(snap, control_outputs(snap, ref, LOWER[cfg["dtype"]], calls),
                                ref, calls)
    line["control"] = {k: v for k, (v, _) in checks.items()}
    line["limits"] = {k: lim for k, (_, lim) in checks.items()}
    line["control_correct"] = all(v <= lim for v, lim in checks.values())
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()  # the next seed's set-up needs large blocks whole
    return 0


if __name__ == "__main__":
    sys.exit(main())
