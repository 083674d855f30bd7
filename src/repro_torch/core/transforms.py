"""Field transforms used by the paper's evaluation pipeline (the port of
``repro.core.transforms``).

* ``log_forward``/``log_inverse``: point-wise-relative (PW_REL) error bounds
  emulated via a natural-log transform + ABS compression of the transformed
  field (Liang et al. 2018, adopted by the paper §IV-B4 for HACC velocity).
  Signs and exact zeros are carried in a 2-bit side channel that the CR
  accounting charges for.  ``torch.log``/``torch.exp`` may differ from XLA's
  by an ulp, so this route is held to its bound, not to bit identity.

* ``to_3d``/``from_3d``: the paper's HACC dimension conversion — 1-D particle
  arrays are zero-padded and reshaped into 3-D partitions (§IV-B4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HACC_PARTITION = 1 << 27  # 2^27 points per partition, as in the paper


class LogTransformed(NamedTuple):
    logs: torch.Tensor  # float32, ln|x| (0 where x == 0)
    signs: torch.Tensor  # int8 in {-1, 0, +1}
    min_log: torch.Tensor  # float32[] for documentation / debugging


def pwrel_to_abs(pw_rel: float) -> float:
    """ABS bound on ln|x| equivalent to a PW_REL bound on x (Liang'18)."""
    return float(np.log1p(pw_rel))


def log_forward(x: torch.Tensor) -> LogTransformed:
    sign = torch.sign(x).to(torch.int8)
    mag = x.abs()
    nonzero = mag > 0
    logs = torch.where(nonzero, torch.log(torch.where(nonzero, mag, 1.0)), 0.0)
    logs = logs.to(torch.float32)
    return LogTransformed(logs, sign, logs.amin())


def log_inverse(t: LogTransformed) -> torch.Tensor:
    return torch.where(t.signs == 0, 0.0, t.signs.to(torch.float32) * torch.exp(t.logs))


def sign_channel_bits(n: int) -> int:
    """Side-channel cost charged to CR: 2 bits/value (sign + zero flag)."""
    return 2 * n


def to_3d(x1d: torch.Tensor, shape3d: tuple[int, int, int]) -> torch.Tensor:
    """Zero-pad a 1-D array up to prod(shape3d) and reshape (paper §IV-B4)."""
    n = int(np.prod(shape3d))
    if x1d.shape[0] > n:
        raise ValueError(f"1-D field of {x1d.shape[0]} exceeds partition {n}; chunk first")
    return F.pad(x1d, (0, n - x1d.shape[0])).reshape(shape3d)


def from_3d(x3d: torch.Tensor, n: int) -> torch.Tensor:
    return x3d.reshape(-1)[:n]


def partition_1d(x: torch.Tensor, part: int = HACC_PARTITION) -> list[torch.Tensor]:
    """Split a long 1-D field into paper-style fixed partitions."""
    return [x[i : i + part] for i in range(0, x.shape[0], part)]
