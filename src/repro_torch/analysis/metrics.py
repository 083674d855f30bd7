"""General distortion metrics (paper §III Metric 1-2).

A verbatim copy of the JAX package's ``repro.analysis.metrics`` (numpy only):
the port imports nothing of ``repro``."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Distortion:
    psnr: float
    mse: float
    mre: float  # mean relative error over nonzero points
    max_abs_err: float
    max_rel_err: float
    value_range: float


def distortion(original: np.ndarray, reconstructed: np.ndarray) -> Distortion:
    a = np.asarray(original, np.float64).reshape(-1)
    b = np.asarray(reconstructed, np.float64).reshape(-1)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    if a.size == 0:
        raise ValueError("distortion of empty arrays is undefined")
    # reject NaN/Inf up front: they would silently poison every statistic
    # (mean of NaN is NaN, max of Inf is Inf) and a rate-distortion table
    # with poisoned rows mis-ranks configurations
    if not np.isfinite(a).all():
        raise ValueError("original contains NaN/Inf — distortion metrics "
                         "are undefined on non-finite data")
    if not np.isfinite(b).all():
        raise ValueError("reconstructed contains NaN/Inf — the codec "
                         "produced non-finite values")
    diff = b - a
    mse = float(np.mean(diff**2))
    rng = float(a.max() - a.min())
    psnr = float(20 * np.log10(rng) - 10 * np.log10(max(mse, 1e-300))) if rng > 0 else np.inf
    nz = a != 0
    rel = np.abs(diff[nz] / a[nz]) if nz.any() else np.zeros(1)
    return Distortion(
        psnr=psnr,
        mse=mse,
        mre=float(rel.mean()),
        max_abs_err=float(np.abs(diff).max()),
        max_rel_err=float(rel.max()),
        value_range=rng,
    )


def bitrate(nbytes_compressed: int, n_values: int) -> float:
    """Average bits per value (paper's rate-distortion x-axis)."""
    return 8.0 * nbytes_compressed / n_values


def compression_ratio(nbytes_compressed: int, n_values: int, dtype_bytes: int = 4) -> float:
    return n_values * dtype_bytes / max(nbytes_compressed, 1)
