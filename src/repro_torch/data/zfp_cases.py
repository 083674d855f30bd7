"""Hard inputs for the TPU-ZFP block kernels (K5-K7), built once for the
card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``.

Both builders return CPU tensors made from a numpy seed; move them to the
device the check runs on.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import zfp


def hard_blocks(nb: int, seed: int) -> torch.Tensor:
    """``nb`` blocks f32[nb, 4, 4, 4] of wide dynamic range led by the hard
    cases, as many as fit: blocks of +-inf and +-3.4e38 (the quantizer
    saturates, the lifts wrap, and every group's top plane is 22 or higher,
    so most planes carry close to the full 64 bits), one +inf, one -inf,
    one NaN, one 3e38, a zero block and a subnormal block."""
    rng = np.random.default_rng(seed)
    b = (rng.normal(size=(nb, 4, 4, 4)) * 10 ** rng.uniform(-6, 6, size=(nb, 1, 1, 1)))
    b = b.astype(np.float32)
    hard = list(rng.choice(np.array([np.inf, -np.inf, 3.4e38, -3.4e38], np.float32),
                           size=(8, 4, 4, 4)))
    for v in (np.inf, -np.inf, np.nan, 3e38):
        one = rng.normal(size=(4, 4, 4)).astype(np.float32)
        one[1, 2, 3] = v
        hard.append(one)
    hard += [np.zeros((4, 4, 4), np.float32), np.full((4, 4, 4), 1e-39, np.float32)]
    k = min(nb, len(hard))
    b[:k] = np.stack(hard[:k])
    return torch.from_numpy(b)


def full_streams(nb: int, rate: int, seed: int):
    """(words u32[nb, wpb], emax u8[nb], gtops u8[nb, 10]): random stream
    words whose 10 group tops are all 32, so every plane carries a full
    64-bit payload (the largest K7 decodes; no float block gives groups 0
    and 1 a top of 32)."""
    rng = np.random.default_rng(seed)
    wpb = zfp.payload_words(rate)
    words = torch.from_numpy(rng.integers(0, 2**32, size=(nb, wpb), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).view(torch.uint32)
    emax = torch.from_numpy(rng.integers(0, 256, size=nb).astype(np.uint8))
    return words, emax, torch.full((nb, 10), 32, dtype=torch.uint8)
