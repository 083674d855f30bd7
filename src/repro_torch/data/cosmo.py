"""Synthetic cosmological datasets standing in for the paper's HACC and Nyx
snapshots (Table II), which are 38 GB / 6.6 GB downloads unavailable offline.

A verbatim copy of the JAX package's ``repro.data.cosmo`` (numpy only), kept
here because the port imports nothing of ``repro``; ``nyx_fields`` and
``hacc_particles`` give the same arrays as the original for the same seed.

The generators are physically motivated so the paper's *analyses* exercise
real structure:

* **Nyx-like fields** — Gaussian random fields with a power-law P(k) ~ k^n
  (n ≈ -2.4 emulates the processed matter spectrum on the scales a 512^3 box
  resolves). Density fields are exponentiated (log-normal approximation to
  the non-Gaussian density PDF) and scaled into Table II value ranges:
  baryon density (0, 1e5), dark-matter density (0, 1e4), temperature
  (1e2, 1e7), velocities (-1e8, 1e8).

* **HACC-like particles** — Zel'dovich approximation: particles start on a
  uniform lattice and are displaced by the gradient of a GRF potential,
  which produces the filament/halo clustering the FoF finder needs.
  Positions live in (0, 256) Mpc/h (module M001's 256 Mpc/h box), velocities
  in (-1e4, 1e4) km/s, six 1-D float32 arrays (x, y, z, vx, vy, vz).

Everything is deterministic in ``seed`` and sized by ``n`` so CI smoke tests
use 64^3 while benchmarks use 256^3+ (``--full`` for 512^3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

NYX_FIELDS = ("baryon_density", "dark_matter_density", "temperature", "vx", "vy", "vz")
HACC_FIELDS = ("x", "y", "z", "vx", "vy", "vz")

NYX_RANGES = {
    "baryon_density": (0.0, 1e5),
    "dark_matter_density": (0.0, 1e4),
    "temperature": (1e2, 1e7),
    "vx": (-1e8, 1e8),
    "vy": (-1e8, 1e8),
    "vz": (-1e8, 1e8),
}

HACC_BOX = 256.0  # Mpc/h, paper module M001 (0.36 Gpc)^3 ~ small outer rim
HACC_VEL = 1e4


def _grf(n: int, slope: float, seed: int) -> np.ndarray:
    """Real-space Gaussian random field with P(k) ~ k^slope, unit variance."""
    rng = np.random.default_rng(seed)
    kx = np.fft.fftfreq(n)[:, None, None]
    ky = np.fft.fftfreq(n)[None, :, None]
    kz = np.fft.rfftfreq(n)[None, None, :]
    k = np.sqrt(kx**2 + ky**2 + kz**2)
    k[0, 0, 0] = 1.0
    amp = k ** (slope / 2.0)
    amp[0, 0, 0] = 0.0  # zero the DC mode
    white = np.fft.rfftn(rng.normal(size=(n, n, n)))
    f = np.fft.irfftn(white * amp, s=(n, n, n), axes=(0, 1, 2))
    return (f / max(f.std(), 1e-12)).astype(np.float32)


def nyx_fields(n: int = 64, seed: int = 42, slope: float = -2.4) -> Dict[str, np.ndarray]:
    """Six 3-D float32 fields in Table II ranges on an n^3 grid."""
    out: Dict[str, np.ndarray] = {}
    # log-normal densities: exp(GRF) gives the heavy positive tail real
    # density fields have (and makes SZ-vs-ZFP behave like the paper's Fig 4)
    for i, (name, sigma) in enumerate(
        [("baryon_density", 2.0), ("dark_matter_density", 1.8), ("temperature", 1.5)]
    ):
        g = _grf(n, slope, seed + i)
        f = np.exp(sigma * g)
        lo, hi = NYX_RANGES[name]
        f = f / f.max() * hi
        out[name] = np.maximum(f, lo).astype(np.float32) if name != "temperature" else np.clip(
            f, lo, hi
        ).astype(np.float32)
    for i, name in enumerate(("vx", "vy", "vz")):
        # velocity ~ gradient of the (smoother) potential: real velocity
        # fields carry much less small-scale power than the density
        g = _grf(n, slope - 1.2, seed + 10 + i)
        lo, hi = NYX_RANGES[name]
        out[name] = (g / max(np.abs(g).max(), 1e-12) * 0.8 * hi).astype(np.float32)
    return out


@dataclasses.dataclass
class HACCSnapshot:
    fields: Dict[str, np.ndarray]  # six 1-D float32 arrays
    box: float
    n_particles: int

    def positions(self) -> np.ndarray:
        return np.stack([self.fields["x"], self.fields["y"], self.fields["z"]], axis=1)


def hacc_particles(grid: int = 64, seed: int = 7, halo_fraction: float = 0.35,
                   mass_slope: float = -2.0) -> HACCSnapshot:
    """Halo-model particle snapshot: grid^3 particles in a 256 Mpc/h box.

    ``halo_fraction`` of the particles live in haloes whose member counts
    follow a power-law mass function n(m) ~ m^mass_slope (what FoF + the
    Fig.-6 mass-function analysis need); the rest are a Zel'dovich-displaced
    field background. Velocities = halo bulk flow + virial-scaled internal
    dispersion, clipped to the (-1e4, 1e4) Table II range.
    """
    n = grid
    n_total = n**3
    rng = np.random.default_rng(seed)
    cell = HACC_BOX / n
    mean_sep = cell

    # --- halo members ---
    n_in_halos = int(halo_fraction * n_total)
    masses: list[int] = []
    while sum(masses) < n_in_halos:
        # inverse-CDF sample of m^slope between 20 and 3000 members
        u = rng.uniform()
        lo, hi, a = 20.0, 3000.0, mass_slope + 1.0
        m = (lo**a + u * (hi**a - lo**a)) ** (1.0 / a)
        masses.append(int(m))
    masses[-1] -= sum(masses) - n_in_halos
    centers = rng.uniform(0, HACC_BOX, size=(len(masses), 3))
    bulk_v = rng.normal(scale=0.15 * HACC_VEL, size=(len(masses), 3))

    pos_chunks, vel_chunks = [], []
    for m, c, bv in zip(masses, centers, bulk_v):
        if m <= 0:
            continue
        # NFW-ish isotropic profile: r ~ r_s * (u^-0.6 - 1), truncated
        r_s = 0.10 * mean_sep * (m / 20.0) ** (1 / 3)
        u = rng.uniform(0.05, 1.0, size=m)
        r = np.minimum(r_s * (u**-0.6 - 1.0 + 0.05), 8 * r_s)
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
        pos_chunks.append((c[None, :] + r[:, None] * d) % HACC_BOX)
        sigma = 0.02 * HACC_VEL * (m / 20.0) ** (1 / 3)  # ~virial scaling
        vel_chunks.append(bv[None, :] + rng.normal(scale=sigma, size=(m, 3)))

    # --- field background: Zel'dovich-displaced sub-lattice ---
    n_field = n_total - n_in_halos
    phi_k = np.fft.rfftn(_grf(n, -2.5, seed + 3))
    kx = 2j * np.pi * np.fft.fftfreq(n)[:, None, None]
    ky = 2j * np.pi * np.fft.fftfreq(n)[None, :, None]
    kz = 2j * np.pi * np.fft.rfftfreq(n)[None, None, :]
    disp = []
    for kv in (kx, ky, kz):
        d = np.fft.irfftn(phi_k * kv, s=(n, n, n), axes=(0, 1, 2)).reshape(-1)
        disp.append(d / max(d.std(), 1e-12))
    sel = rng.choice(n_total, size=n_field, replace=False)
    lattice = (np.arange(n, dtype=np.float64) + 0.5) * cell
    gx, gy, gz = np.meshgrid(lattice, lattice, lattice, indexing="ij")
    base = np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], axis=1)[sel]
    dvec = np.stack([disp[0][sel], disp[1][sel], disp[2][sel]], axis=1)
    pos_chunks.append((base + 1.5 * cell * dvec) % HACC_BOX)
    vel_chunks.append(0.25 * HACC_VEL * dvec + rng.normal(scale=0.02 * HACC_VEL, size=(n_field, 3)))

    pos = np.concatenate(pos_chunks)[:n_total]
    vel = np.clip(np.concatenate(vel_chunks)[:n_total], -HACC_VEL, HACC_VEL)
    # GenericIO stores each MPI rank's sub-box contiguously (the paper's
    # 8x8x4 decomposition): emulate that *spatial locality* by ordering
    # particles rank-major — it is exactly what makes the paper's 1-D->3-D
    # reshape compress well (both Lorenzo prediction and ZFP blocks see
    # coherent neighbours).
    ranks = (np.floor(pos[:, 0] / (HACC_BOX / 8)).astype(np.int64) * 8
             + np.floor(pos[:, 1] / (HACC_BOX / 8)).astype(np.int64)) * 4 \
        + np.floor(pos[:, 2] / (HACC_BOX / 4)).astype(np.int64)
    order = np.argsort(ranks, kind="stable")
    pos, vel = pos[order], vel[order]

    fields: Dict[str, np.ndarray] = {
        "x": pos[:, 0].astype(np.float32),
        "y": pos[:, 1].astype(np.float32),
        "z": pos[:, 2].astype(np.float32),
        "vx": vel[:, 0].astype(np.float32),
        "vy": vel[:, 1].astype(np.float32),
        "vz": vel[:, 2].astype(np.float32),
    }
    return HACCSnapshot(fields, HACC_BOX, n_total)


def dataset_nbytes(fields: Dict[str, np.ndarray]) -> int:
    return sum(f.nbytes for f in fields.values())
