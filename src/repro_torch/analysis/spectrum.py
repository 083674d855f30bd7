"""Matter power spectrum P(k) and the paper's pk-ratio acceptance gate.

P(k) is the Fourier transform of the two-point correlation (paper §III
Metric 3b): we bin |FFT(field)|^2 in spherical shells of comoving wavenumber
k. The evaluation compares ``pk(reconstructed) / pk(original)`` per bin and
requires it inside **1 ± tolerance** (the paper uses 1%) over the resolved
range (up to ~80% of the Nyquist frequency, past which grid aliasing
dominates and the paper's own plots cut off).

A verbatim copy of the JAX package's ``repro.analysis.spectrum`` (numpy
only): the port imports nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerSpectrum:
    k: np.ndarray  # bin centers (cycles per box side)
    pk: np.ndarray  # binned power
    counts: np.ndarray  # modes per bin


def power_spectrum(field: np.ndarray, n_bins: int = 64) -> PowerSpectrum:
    """Spherically averaged P(k) of a 3-D scalar field."""
    f = np.asarray(field, np.float64)
    assert f.ndim == 3, "power spectrum is defined on 3-D fields"
    n = f.shape[0]
    delta = f - f.mean()
    fk = np.fft.rfftn(delta)
    p3 = np.abs(fk) ** 2 / f.size

    kx = np.fft.fftfreq(f.shape[0]) * f.shape[0]
    ky = np.fft.fftfreq(f.shape[1]) * f.shape[1]
    kz = np.fft.rfftfreq(f.shape[2]) * f.shape[2]
    kk = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)

    k_ny = n / 2
    edges = np.linspace(0.5, k_ny, n_bins + 1)
    idx = np.digitize(kk.reshape(-1), edges) - 1
    valid = (idx >= 0) & (idx < n_bins)
    pk = np.bincount(idx[valid], weights=p3.reshape(-1)[valid], minlength=n_bins)
    counts = np.bincount(idx[valid], minlength=n_bins)
    centers = 0.5 * (edges[:-1] + edges[1:])
    nonzero = counts > 0
    return PowerSpectrum(centers[nonzero], pk[nonzero] / counts[nonzero], counts[nonzero])


def pk_ratio(original: np.ndarray, reconstructed: np.ndarray, n_bins: int = 64) -> tuple[np.ndarray, np.ndarray]:
    po = power_spectrum(original, n_bins)
    pr = power_spectrum(reconstructed, n_bins)
    safe = np.where(po.pk > 0, po.pk, 1.0)
    return po.k, pr.pk / safe


def pk_gate(original: np.ndarray, reconstructed: np.ndarray, tol: float = 0.01,
            k_frac: float = 0.8, n_bins: int = 64) -> tuple[bool, float]:
    """The paper's acceptance test: pk ratio within 1 +/- tol for all bins up
    to ``k_frac`` of Nyquist. Returns (pass, worst deviation)."""
    k, ratio = pk_ratio(original, reconstructed, n_bins)
    cut = k <= k_frac * (original.shape[0] / 2)
    dev = np.abs(ratio[cut] - 1.0)
    return bool((dev <= tol).all()), float(dev.max())


def velocity_magnitude(vx: np.ndarray, vy: np.ndarray, vz: np.ndarray) -> np.ndarray:
    """The paper's composite spectrum field sqrt(vx^2+vy^2+vz^2) (Fig. 5)."""
    return np.sqrt(np.asarray(vx) ** 2 + np.asarray(vy) ** 2 + np.asarray(vz) ** 2)


def overall_density(baryon: np.ndarray, dm: np.ndarray) -> np.ndarray:
    """Composite baryon+dark-matter density (Fig. 5 'overall density')."""
    return np.asarray(baryon, np.float64) + np.asarray(dm, np.float64)
