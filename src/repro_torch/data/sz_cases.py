"""Hard inputs for the SZ stream coders (K3, K4 and the batched K8, K9),
made from a numpy seed as CPU float32 tensors, so that the CPU twin tests,
the card's tests and ``chip_smoke.py`` hold the same cases.

Each one-field case is a TILE-padded (Z, Y, X) field with its guarded bound
``eb_i``:

* ``zero``: an all-zero field, so every block has width 0 and the stream is
  all tail;
* ``full_width``: +-3e38, NaN and +inf at random, quantized at eb_i = 1, so
  the saturating conversion gives codes near +-2^31 and every block has width
  32 (the widest payload, 64 words);
* ``ragged``: a smooth (10, 70, 130) field zero-padded to (16, 128, 256), as
  ``kernels.ops`` pads it;
* ``out_of_range <v>``: a smooth (8, 64, 128) field with one value whose
  quantized value leaves the int32 range (5e6 at eb_i 1e-3, 3e38, +inf) or is
  NaN.

:func:`rows` is a 3-row batch whose rows' compression ratios differ by more
than 4x, so that the row offsets are arbitrary.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = (8, 64, 128)


def pad_to_tile(x: np.ndarray) -> np.ndarray:
    return np.pad(x, [(0, (-s) % t) for s, t in zip(x.shape, TILE)])


def smooth(shape, seed: int, scale: float = 100.0) -> np.ndarray:
    """A random walk along every axis, scaled to |x|max = ``scale``."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=shape).astype(np.float32)
    for ax in range(len(shape)):
        f = np.cumsum(f, axis=ax)
    return (f * scale / max(np.abs(f).max(), 1e-9)).astype(np.float32)


def _full_width(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    values = np.asarray([3e38, -3e38, np.nan, np.inf, 0.0], np.float32)
    return values[rng.integers(0, len(values), size=shape)]


def cases(seed: int = 0) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Name -> (TILE-padded f32 field, guarded bound f32 scalar)."""
    out = {"zero": (np.zeros((16, 64, 128), np.float32), 1e-2),
           "full_width": (_full_width((8, 64, 128), seed), 1.0),
           "ragged": (pad_to_tile(smooth((10, 70, 130), seed + 11)), 1e-2)}
    base = smooth((8, 64, 128), seed + 3)
    for label, value in (("5e6", 5e6), ("nan", np.nan), ("3e38", 3e38), ("inf", np.inf)):
        x = base.copy()
        x[1, 2, 3] = value
        out[f"out_of_range {label}"] = (x, 1e-3)
    return {k: (torch.from_numpy(np.ascontiguousarray(x)), torch.tensor(eb, dtype=torch.float32))
            for k, (x, eb) in out.items()}


def rows(seed: int = 13) -> tuple[torch.Tensor, torch.Tensor]:
    """(3, 16, 64, 128) f32 rows and their bounds: a smooth row at a loose
    bound (~2 bits a value), white noise at a tight one (~17 bits) and a
    smooth row at a tight one."""
    rng = np.random.default_rng(seed)
    x = np.stack([smooth((16, 64, 128), seed, 100.0),
                  (rng.normal(size=(16, 64, 128)) * 20).astype(np.float32),
                  smooth((16, 64, 128), seed + 1, 1e3)])
    return torch.from_numpy(x), torch.tensor([0.5, 1e-3, 1e-2], dtype=torch.float32)
