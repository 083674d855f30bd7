"""Gaussian random fields with a power-law spectrum, made on the device.

The arithmetic of ``repro_torch.data.cosmo._grf`` (numpy on the host),
rewritten for torch so a 512^3 field costs milliseconds of set-up, not
seconds: white noise from the run's generator, scaled by ``k^(slope/2)`` in
Fourier space with the DC mode zeroed, transformed back and normalised to
unit variance."""

from __future__ import annotations

import torch


def _k2(n: int, device) -> torch.Tensor:
    """|k|^2 on the rfft grid of an n^3 field, float32, DC set to 1."""
    k = torch.fft.fftfreq(n, device=device, dtype=torch.float32)
    kz = torch.fft.rfftfreq(n, device=device, dtype=torch.float32)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None, :] ** 2
    k2[0, 0, 0] = 1.0
    return k2


def spectrum(n: int, slope: float, gen: torch.Generator, device) -> torch.Tensor:
    """The Fourier coefficients (rfft layout) of a field with P(k) ~ k^slope
    before normalisation."""
    white = torch.randn((n, n, n), generator=gen, device=device, dtype=torch.float32)
    amp = _k2(n, device) ** (slope / 4.0)  # k^(slope/2) = (k^2)^(slope/4)
    amp[0, 0, 0] = 0.0  # zero the DC mode
    return torch.fft.rfftn(white) * amp


def unit_variance(f: torch.Tensor) -> torch.Tensor:
    return f / f.std().clamp_min(1e-12)


def grf(n: int, slope: float, gen: torch.Generator, device) -> torch.Tensor:
    """Real-space float32 field on an n^3 grid, P(k) ~ k^slope, unit variance."""
    return unit_variance(torch.fft.irfftn(spectrum(n, slope, gen, device), s=(n, n, n)))


def gradient(phi_k: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """d phi / d axis of the field whose rfft is ``phi_k`` (grid units),
    flattened, unit variance."""
    freq = (torch.fft.rfftfreq if axis == 2 else torch.fft.fftfreq)(
        n, device=phi_k.device, dtype=torch.float32)
    shape = [1, 1, 1]
    shape[axis] = freq.numel()
    ik = (2j * torch.pi) * freq.reshape(shape)
    return unit_variance(torch.fft.irfftn(phi_k * ik, s=(n, n, n)).reshape(-1))
