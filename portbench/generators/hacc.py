"""HACC-like particle snapshot, made on the device.

The arithmetic of ``repro_torch.data.cosmo.hacc_particles`` in torch, with
its per-halo Python loop vectorised: ``halo_fraction`` of the particles sit
in haloes whose member counts follow n(m) ~ m^mass_slope between the two
``halo_members`` bounds (NFW-like radii, bulk flow plus a virial-scaled
dispersion), the rest are a Zel'dovich-displaced lattice; velocities are
clipped to the Table II range and the particles are put in GenericIO's
rank-major order (an 8 x 8 x 4 decomposition of the box), which is what
gives the 1-D arrays their spatial coherence.  ``particles`` (default
``grid^3``) is the count a field holds; the lattice is ``grid^3`` sites, of
which the background takes distinct ones."""

from __future__ import annotations

from typing import Iterator

import torch

from portbench.generators.grf import gradient, spectrum, unit_variance


def _halo_masses(n_in: int, lo: float, hi: float, slope: float, gen, device) -> torch.Tensor:
    """Member counts drawn by inverse CDF until they hold ``n_in`` particles,
    the last one cut to fit (int64, may end in 0)."""
    a = slope + 1.0
    draws = n_in // int(lo) + 1  # every draw holds at least lo members
    u = torch.rand(draws, generator=gen, device=device, dtype=torch.float64)
    m = ((lo ** a + u * (hi ** a - lo ** a)) ** (1.0 / a)).to(torch.int64)
    csum = torch.cumsum(m, 0)
    k = int(torch.searchsorted(csum, torch.tensor([n_in], device=device))[0]) + 1
    m = m[:k].clone()
    m[-1] -= int(csum[k - 1]) - n_in
    return m


def _haloes(cfg: dict, n_in: int, cell: float, gen, device):
    box, vmax = float(cfg["box_mpc_h"]), float(cfg["velocity_max"])
    lo, hi = cfg["halo_members"]
    m = _halo_masses(n_in, float(lo), float(hi), float(cfg["mass_slope"]), gen, device)
    k = m.numel()
    centres = torch.rand(k, 3, generator=gen, device=device) * box
    bulk = torch.randn(k, 3, generator=gen, device=device) * (0.15 * vmax)
    hid = torch.repeat_interleave(torch.arange(k, device=device), m)
    growth = (m.to(torch.float32) / 20.0) ** (1.0 / 3.0)
    r_s = (0.10 * cell * growth)[hid]
    u = torch.rand(n_in, generator=gen, device=device) * 0.95 + 0.05
    r = torch.minimum(r_s * (u ** -0.6 - 1.0 + 0.05), 8.0 * r_s)
    d = torch.randn(n_in, 3, generator=gen, device=device)
    d = d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-12)
    pos = torch.remainder(centres[hid] + r[:, None] * d, box)
    sigma = (0.02 * vmax * growth)[hid]
    vel = bulk[hid] + torch.randn(n_in, 3, generator=gen, device=device) * sigma[:, None]
    return pos, vel


def _background(cfg: dict, n: int, n_field: int, cell: float, gen, device):
    box, vmax = float(cfg["box_mpc_h"]), float(cfg["velocity_max"])
    phi_k = torch.fft.rfftn(unit_variance(torch.fft.irfftn(
        spectrum(n, float(cfg["potential_slope"]), gen, device), s=(n, n, n))))
    sel = torch.randperm(n ** 3, generator=gen, device=device)[:n_field]
    dvec = torch.stack([gradient(phi_k, n, a)[sel] for a in range(3)], dim=1)
    del phi_k
    lattice = torch.stack([sel // (n * n), (sel // n) % n, sel % n], dim=1)
    pos = torch.remainder((lattice.to(torch.float32) + 0.5) * cell + (1.5 * cell) * dvec, box)
    vel = (0.25 * vmax) * dvec + torch.randn(n_field, 3, generator=gen, device=device) * (0.02 * vmax)
    return pos, vel


def fields(cfg: dict, seed: int, device) -> Iterator[tuple[str, torch.Tensor]]:
    n = int(cfg["grid"])
    n_total = int(cfg.get("particles", n ** 3))
    if n_total > n ** 3:
        raise ValueError(f"{n_total} particles do not fit a {n}^3 lattice")
    box, vmax = float(cfg["box_mpc_h"]), float(cfg["velocity_max"])
    cell = box / n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_in = int(cfg["halo_fraction"] * n_total)
    hp, hv = _haloes(cfg, n_in, cell, gen, device)
    fp, fv = _background(cfg, n, n_total - n_in, cell, gen, device)
    pos = torch.cat([hp, fp])
    vel = torch.cat([hv, fv]).clamp(-vmax, vmax)
    del hp, hv, fp, fv
    nx, ny, nz = cfg["rank_grid"]
    ranks = ((torch.floor(pos[:, 0] / (box / nx)).to(torch.int32) * ny
              + torch.floor(pos[:, 1] / (box / ny)).to(torch.int32)) * nz
             + torch.floor(pos[:, 2] / (box / nz)).to(torch.int32))
    order = torch.argsort(ranks, stable=True)
    del ranks
    for name, src, axis in (("x", pos, 0), ("y", pos, 1), ("z", pos, 2),
                            ("vx", vel, 0), ("vy", vel, 1), ("vz", vel, 2)):
        if name in cfg["fields"]:
            yield name, src[:, axis][order].contiguous()
