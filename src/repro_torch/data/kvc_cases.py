"""Paged blockfloat8 KV pools for K10's paged entry, built once for the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``.

The pool is laid out as the serving engine keeps it, (n_pages, page, Hkv,
D) int8 codes and (n_pages, page, Hkv) f32 scales with page 0 the zero
page, and the table holds what K10 must survive: every lane's pages in a
random order, one page id used twice, and the last lane's last page left
unmapped (the zero page) when its position does not reach it.
"""

from __future__ import annotations

import numpy as np
import torch


def paged_pool(b: int, cap: int, h: int, hkv: int, d: int, qdtype, index, device,
               seed: int, page: int = 16):
    """(q, k_pool, k_scale_pool, v_pool, v_scale_pool, page_table, index) for
    ``b`` lanes of capacity ``cap`` (a multiple of ``page``) at positions
    ``index`` (a list; -1 marks a free lane), drawn on ``device`` from
    ``seed``: codes in [-127, 127], scales in [1e-3, 2e-2)."""
    max_pages = cap // page
    n_pages = b * max_pages + 1
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=device).to(qdtype)
    kp, vp = (torch.randint(-127, 128, (n_pages, page, hkv, d), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ksp, vsp = (torch.rand(n_pages, page, hkv, generator=g, device=device) * 1.9e-2 + 1e-3
                for _ in range(2))
    for t in (kp, vp, ksp, vsp):
        t[0] = 0
    table = torch.randperm(n_pages - 1, generator=g, device=device)[: b * max_pages] + 1
    table = table.reshape(b, max_pages).to(torch.int32)
    if b > 1 and max_pages > 1:
        table[1, 1] = table[1, 0]
    if index[-1] < cap - page:
        table[-1, -1] = 0
    idx = torch.as_tensor(np.asarray(index, np.int32)).to(device)
    return q, kp, ksp, vp, vsp, table, idx
