"""CBench — the Foresight compression benchmark component (paper §IV-A1),
the port of ``repro.foresight.cbench``.

Configured by a JSON-able dict (the paper: "By only configuring a simple
JSON file, Foresight can automatically evaluate diverse compression
configurations"), CBench runs compressor x configuration x field sweeps and
reports compression ratio, distortion (PSNR/MSE/MRE), throughput, and the
reconstructed fields for downstream PAT analyses.

Each case runs on one device, CUDA unless ``device="cpu"`` is passed
(:func:`repro_torch.device.resolve_device`): the field is moved there once,
the compressor's payload lives there.  Timing keeps the reference's
meaning: the host clock over ``iters`` calls after ``warmup``, each call
ended by a device synchronisation on CUDA (the reference's
``jax.block_until_ready``); the CPU needs none.  The reconstruction is
copied to the host outside the timed windows.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.analysis import metrics
from repro_torch.core.api import get_compressor


@dataclasses.dataclass
class CBenchResult:
    compressor: str
    field: str
    config: dict
    ratio: float
    bitrate: float
    psnr: float
    mse: float
    mre: float
    max_abs_err: float
    compress_s: float
    decompress_s: float
    throughput_c_mbs: float
    throughput_d_mbs: float
    reconstructed: Optional[np.ndarray] = None

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("reconstructed")
        return d


def run_case(name: str, field_name: str, field: np.ndarray, config: dict,
             keep_reconstruction: bool = True, warmup: int = 1, iters: int = 3,
             device: str | torch.device | None = None) -> CBenchResult:
    comp = get_compressor(name, device=device)
    dev = comp.device
    x = torch.as_tensor(field, device=dev)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _compress():
        r = comp.compress(x, **config)
        _sync()
        return r

    for _ in range(warmup):
        r = _compress()
    t0 = time.perf_counter()
    for _ in range(iters):
        r = _compress()
    c_s = (time.perf_counter() - t0) / iters

    def _decompress():
        y = comp.decompress(r)
        _sync()
        return y

    for _ in range(warmup):
        y = _decompress()
    t0 = time.perf_counter()
    for _ in range(iters):
        y = _decompress()
    d_s = (time.perf_counter() - t0) / iters

    recon = y.cpu().numpy()
    dist = metrics.distortion(field, recon)
    mb = field.nbytes / 1e6
    return CBenchResult(
        compressor=name,
        field=field_name,
        config=config,
        ratio=float(r.ratio),
        bitrate=32.0 / float(r.ratio),
        psnr=dist.psnr,
        mse=dist.mse,
        mre=dist.mre,
        max_abs_err=dist.max_abs_err,
        compress_s=c_s,
        decompress_s=d_s,
        throughput_c_mbs=mb / c_s,
        throughput_d_mbs=mb / d_s,
        reconstructed=recon if keep_reconstruction else None,
    )


def run_sweep(spec: dict, fields: Dict[str, np.ndarray], keep_reconstruction: bool = False,
              device: str | torch.device | None = None) -> list[CBenchResult]:
    """spec: {"cases": [{"compressor": ..., "fields": [...], "configs": [...]}]}
    — the JSON configuration surface of the paper's CBench."""
    out: list[CBenchResult] = []
    for case in spec["cases"]:
        name = case["compressor"]
        for fname in case.get("fields", list(fields)):
            for config in case["configs"]:
                out.append(run_case(name, fname, fields[fname], dict(config),
                                    keep_reconstruction=keep_reconstruction, device=device))
    return out


def save_results(results: Iterable[CBenchResult], path: str | Path) -> None:
    Path(path).write_text(json.dumps([r.row() for r in results], indent=1))
