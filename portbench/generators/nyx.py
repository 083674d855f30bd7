"""Nyx-like snapshot fields, made on the device.

The arithmetic of ``repro_torch.data.cosmo.nyx_fields`` in torch: the three
densities are log-normal (``exp(sigma * GRF)`` with P(k) ~ k^slope, scaled so
the field's maximum is the top of its Table II range, temperature clipped
into its range), the three velocities are smoother GRFs (slope - 1.2)
scaled to 0.8 of their range.  Each field is made whole and handed out
alone, so set-up holds one field's transforms at a time."""

from __future__ import annotations

from typing import Iterator

import torch

from portbench.generators.grf import grf


def fields(cfg: dict, seed: int, device) -> Iterator[tuple[str, torch.Tensor]]:
    n = int(cfg["grid"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for name in cfg["fields"]:
        lo, hi = cfg["ranges"][name]
        if name in cfg["log_normal_sigma"]:
            f = torch.exp(cfg["log_normal_sigma"][name] * grf(n, cfg["slope"], gen, device))
            f = f / f.amax() * hi
            f = f.clamp(lo, hi) if name == "temperature" else f.clamp_min(lo)
        else:
            g = grf(n, cfg["slope"] + cfg["velocity_slope_offset"], gen, device)
            f = g / g.abs().amax().clamp_min(1e-12) * (cfg["velocity_fill"] * hi)
        yield name, f.to(torch.float32).contiguous()
