"""The paper's §V-D configuration-optimization guideline, as code:

  1. benchmark compressor x configuration sweeps on the target data (CBench),
  2. keep configurations whose reconstructions pass the *domain* gates
     (power-spectrum ratio within 1 +/- tol, halo-count ratio within tol —
     NOT PSNR: the paper shows PSNR mis-ranks configs, §V-B),
  3. of the survivors, pick the highest compression ratio — which the paper
     shows also maximizes overall throughput (kernel + transfer both scale
     with compressed bytes, Fig. 10).

The same machinery gates *checkpoint* compression for training (the gate is
a held-out loss delta instead of pk ratio) — one guideline, two substrates.

The port of ``repro.foresight.guideline``: the sweeps run on one device,
CUDA unless ``device="cpu"`` is passed; the gates run on the host with
numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import halos, spectrum
from repro_torch.foresight.cbench import run_case


@dataclasses.dataclass
class GateResult:
    config: dict
    compressor: str
    ratio: float
    passed: bool
    worst_pk_dev: float
    worst_halo_dev: float
    psnr: float


@dataclasses.dataclass
class BestFit:
    field_results: Dict[str, GateResult]
    overall_ratio: float

    def config_for(self, field: str) -> dict:
        return self.field_results[field].config


def evaluate_gates(original: Dict[str, np.ndarray], reconstructed: Dict[str, np.ndarray],
                   pk_tol: float = 0.01, halo_tol: float = 0.1,
                   particles: Optional[tuple] = None) -> tuple[bool, float, float]:
    """Domain gates over a set of fields (+ optional (pos_orig, pos_recon,
    box) particle tuple for the FoF gate)."""
    worst_pk = 0.0
    for name, orig in original.items():
        if orig.ndim == 3:
            ok, dev = spectrum.pk_gate(orig, reconstructed[name], tol=pk_tol)
            worst_pk = max(worst_pk, dev)
    worst_halo = 0.0
    if particles is not None:
        pos_o, pos_r, box = particles
        cat_o = halos.fof_halos(pos_o, box)
        cat_r = halos.fof_halos(pos_r, box)
        _, worst_halo = halos.halo_gate(cat_o, cat_r, tol=halo_tol)
    passed = worst_pk <= pk_tol and worst_halo <= halo_tol
    return passed, worst_pk, worst_halo


def best_fit_per_field(fields: Dict[str, np.ndarray], compressor: str,
                       configs: Sequence[dict], pk_tol: float = 0.01,
                       device: str | torch.device | None = None) -> BestFit:
    """Per-field: run the sweep, gate on pk ratio, take max CR survivor
    (paper: Nyx per-field bounds/bitrates chosen exactly this way)."""
    chosen: Dict[str, GateResult] = {}
    total_raw = total_stored = 0.0
    for name, field in fields.items():
        gated: list[GateResult] = []
        for cfg in configs:
            res = run_case(compressor, name, field, dict(cfg), keep_reconstruction=True,
                           device=device)
            if field.ndim == 3:
                ok, dev = spectrum.pk_gate(field, res.reconstructed, tol=pk_tol)
            else:
                ok, dev = True, 0.0
            gated.append(GateResult(dict(cfg), compressor, res.ratio, ok, dev, 0.0, res.psnr))
        survivors = [g for g in gated if g.passed]
        pick = max(survivors, key=lambda g: g.ratio) if survivors else \
            min(gated, key=lambda g: g.worst_pk_dev)  # least-bad fallback
        chosen[name] = pick
        total_raw += field.nbytes
        total_stored += field.nbytes / pick.ratio
    return BestFit(chosen, total_raw / max(total_stored, 1e-9))


def checkpoint_gate(loss_fn: Callable[[dict], float], params: dict,
                    reconstructed_params: dict, tol: float = 1e-3) -> tuple[bool, float]:
    """Training-substrate gate: relative loss delta from lossy checkpoint
    reconstruction must stay under tol (the pk-ratio gate's analogue)."""
    base = float(loss_fn(params))
    lossy = float(loss_fn(reconstructed_params))
    delta = abs(lossy - base) / max(abs(base), 1e-12)
    return delta <= tol, delta


def rate_quality_feedback(trajectory: Sequence[dict], window: int = 3,
                          stall_tol: float = 0.02) -> dict:
    """Read a run's compression-observatory trajectory
    (``repro_torch.obs.observatory.run_trajectory``) into the signal an online
    error-bound controller acts on: the paper's guideline run *during* the
    run instead of once offline.

    Returns ``{"n", "latest_ratio", "mean_ratio", "trend", "stalled"}``.
    ``trend`` is the relative ratio change across the last ``window``
    snapshots; ``stalled`` is True when that change stays within
    ``stall_tol`` — the "ratio stopped improving, consider loosening the
    bound (if the domain gates report headroom)" trigger from the ROADMAP's
    foresight-in-the-loop item."""
    ratios = [float(t["ratio"]) for t in trajectory if t.get("ratio")]
    if not ratios:
        return {"n": 0, "latest_ratio": None, "mean_ratio": None,
                "trend": None, "stalled": False}
    recent = ratios[-max(2, window):]
    trend = ((recent[-1] - recent[0]) / max(abs(recent[0]), 1e-9)
             if len(recent) >= 2 else 0.0)
    return {
        "n": len(ratios),
        "latest_ratio": ratios[-1],
        "mean_ratio": float(np.mean(ratios)),
        "trend": trend,
        "stalled": len(recent) >= 2 and abs(trend) <= stall_tol,
    }
