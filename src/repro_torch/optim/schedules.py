"""LR schedules: cosine (default) and WSD (warmup-stable-decay, the minicpm
trait) — pure functions of the step (the port of ``repro.optim.schedules``).

``step`` may be a Python number or a tensor (the optimiser's int32 step
counter); the result is a float32 tensor on the step's device.  Every
division is by a float32 tensor, as the reference's ``jnp`` program divides:
PyTorch multiplies a CUDA tensor by the reciprocal of a Python divisor,
which would give the card other bits than the CPU.  The reference's ``cos``
and ``power`` are XLA's and these are PyTorch's, so a value may differ from
the reference's by an ulp or two.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def _like(t: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(t, v)


def cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
           final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / _like(step, max(warmup_steps, 1))
    t = torch.clamp((step - warmup_steps) / _like(step, max(total_steps - warmup_steps, 1)),
                    0, 1)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup -> stable plateau -> sharp exponential decay (arXiv:2404.06395)."""
    step = _f32(step)
    decay_steps = decay_frac * total_steps
    decay_start = total_steps - decay_steps
    warm = peak_lr * step / _like(step, max(warmup_steps, 1))
    t = torch.clamp((step - decay_start) / _like(step, max(decay_steps, 1)), 0, 1)
    dec = peak_lr * torch.pow(_like(t, final_frac), t)
    out = torch.where(step < warmup_steps, warm, _like(step, peak_lr))
    return torch.where(step > decay_start, dec, out)


SCHEDULES = {"cosine": cosine, "wsd": wsd}
