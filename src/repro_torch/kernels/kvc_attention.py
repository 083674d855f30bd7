"""K10: one-token decode attention fused with blockfloat8 KV decompression
(the port of ``repro.kernels.kvc_attention``).

Serving from a compressed cache without fusion costs an extra pass over the
cache (dequantize, write bf16 K/V, read them back).  The kernel reads the
int8 codes and per-(token, KV head) scales and dequantizes them on the fly,
so the KV traffic on the card is the compressed bytes (8.25 bits a value).

The codes come un-repeated and the kernel maps query head h to KV head
h // n_rep; the reference's caller repeats them n_rep times first.  Two
entries share the one kernel in ``csrc/kvc_attention.cu``:

* :func:`kvc_decode_attention_paged` reads the serving pool, (n_pages,
  page, Hkv, D), through a (B, max_pages) page table, so the dense view that
  the reference's ``cache_codes`` gathers never exists on the card;
* :func:`kvc_decode_attention` reads a dense (B, S, Hkv, D) cache, the
  counterpart of the Pallas function (a pool of B pages of S positions).

Either reads only positions 0..index[b] of lane b and takes any capacity,
so the reference's padding to its 128-row chunk has no counterpart.  A
cache whose sequence is split over ranks (the sharded serving step) passes
its block's first global position (``offset``: row r holds position offset
+ r) and asks for each row's log-sum-exp (``lse=True``), with which the
blocks' partial softmaxes combine exactly; the whole-cache call (offset 0,
no ``lse``) is unchanged.  On CUDA
tensors an entry launches the kernel once (the splits of the capacity merge
inside it) or raises; on CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref`.  ``launches`` counts kernel launches,
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE = 64  # positions per tile in csrc/kvc_attention.cu; a split is a whole number of tiles
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instantiations
MAX_REP = 16  # query heads per KV head: the rows of one tensor-core tile
BLOCKS_PER_SM = 4  # splits aim at this many blocks per SM (the kernel's occupancy)
MIN_SPLIT_TILES = 2  # splits this long at least, while a block per SM remains

launches = {"kvc_decode_attention": 0}

_SMS: dict[int, int] = {}
# The splits' merge tickets, one int32 per (lane, KV head), per (device,
# stream): the kernel leaves them zero, so they are allocated (zeroed) once.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """The merge tickets of ``device``'s current stream (at least ``n``)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    key = (i, torch.cuda.current_stream(i).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=torch.device("cuda", i))
        _TICKETS[key] = t
    return t


def split_plan(b: int, hkv: int, s: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): the capacity S (positions a lane can address:
    max_pages * page, or a dense cache's S) cut into whole tiles so that
    about ``BLOCKS_PER_SM * sms`` blocks of (lane, KV head, split) fill the
    card; a split is at least ``MIN_SPLIT_TILES`` tiles long (each costs a
    partial and a merge step) while that leaves a block per SM.  It depends
    on the capacity, never on the positions (no host sync)."""
    tiles = max(1, -(-s // TILE))
    want = max(1, -(-BLOCKS_PER_SM * sms // max(1, b * hkv)))
    per = -(-tiles // min(want, tiles))
    if per < MIN_SPLIT_TILES and b * hkv * -(-tiles // MIN_SPLIT_TILES) >= sms:
        per = MIN_SPLIT_TILES
    chunk = per * TILE
    return -(-s // chunk) if s else 1, chunk


def _check_cuda(q, codes, scales, index, paged: bool):
    """The checks both entries share; ``codes`` / ``scales`` are (K, V)
    pairs of (lead, rows, Hkv, D) and (lead, rows, Hkv), the lead being the
    pool's pages (``paged``) or B.  Returns (b, h, hkv, d, idx (B,))."""
    if q.ndim != 3:
        raise ValueError(f"q: want (B, H, D), got {tuple(q.shape)}")
    b, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: want float32 or bfloat16, got {q.dtype}")
    _build.check_cuda(q, q.dtype, "kvc_attention q")
    kc = codes[0]
    if kc.ndim != 4 or kc.shape[3] != d or (not paged and kc.shape[0] != b):
        raise ValueError(f"k codes: want ({'n_pages' if paged else b}, rows, Hkv, {d}), "
                         f"got {tuple(kc.shape)}")
    kv_lead = kc.shape[0]
    rows, hkv = kc.shape[1], kc.shape[2]
    for t, dt, shape, what in ((codes[0], torch.int8, (kv_lead, rows, hkv, d), "k codes"),
                               (codes[1], torch.int8, (kv_lead, rows, hkv, d), "v codes"),
                               (scales[0], torch.float32, (kv_lead, rows, hkv), "k scales"),
                               (scales[1], torch.float32, (kv_lead, rows, hkv), "v scales")):
        _build.check_cuda(t, dt, f"kvc_attention {what}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: want {shape}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what} on {t.device}, q on {q.device}")
    if h % hkv or h // hkv > MAX_REP:
        raise ValueError(f"{h} query heads over {hkv} KV heads: want H = n_rep * Hkv, "
                         f"n_rep <= {MAX_REP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: want one of {HEAD_DIMS}")
    if codes[0].data_ptr() % 16 or codes[1].data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned (16-byte copies)")
    if kv_lead * rows * hkv >= 2 ** 31:
        raise ValueError(f"{kv_lead * rows * hkv} code rows: the kernel indexes fewer than 2^31")
    idx = torch.as_tensor(index)
    if idx.device != q.device or idx.dtype != torch.int32 or idx.numel() not in (1, b):
        raise ValueError(f"index: want int32 () or ({b},) on {q.device}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    return b, h, hkv, d, idx.reshape(-1).expand(b).contiguous()


def _launch(q, kc, ks, vc, vs, table, idx, b, h, hkv, d, page, max_pages, offset: int = 0,
            lse: bool = False):
    out = torch.empty_like(q)
    lse_out = torch.empty((b, h), dtype=torch.float32, device=q.device) if lse else None
    splits, chunk = split_plan(b, hkv, page * max_pages, _sm_count(q.device))
    parts = [None, None, None, None]
    if splits > 1:
        parts = [torch.empty(b * h * splits, dtype=torch.float32, device=q.device),
                 torch.empty(b * h * splits, dtype=torch.float32, device=q.device),
                 torch.empty(b * h * splits * d, dtype=torch.float32, device=q.device),
                 tickets(q.device, b * hkv)]
    P, I = _build.P, _build.I
    _build.launch("kvc_attention", "kvc_attention",
                  [P, I, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                   ctypes.c_float],
                  q.data_ptr(), int(q.dtype == torch.bfloat16), kc.data_ptr(), ks.data_ptr(),
                  vc.data_ptr(), vs.data_ptr(), table.data_ptr() if table is not None else None,
                  idx.data_ptr(), out.data_ptr(),
                  *[p.data_ptr() if p is not None else None for p in parts],
                  lse_out.data_ptr() if lse else None,
                  b, h, hkv, d, page, max_pages, splits, chunk, int(offset), float(d ** -0.5),
                  device=q.device)
    launches["kvc_decode_attention"] += 1
    return (out, lse_out) if lse else out


def _check_offset(offset) -> int:
    offset = int(offset)
    if not 0 <= offset < 2 ** 31:
        raise ValueError(f"offset {offset}: want a position in [0, 2^31)")
    return offset


def kvc_decode_attention(q: torch.Tensor, k_codes: torch.Tensor, k_scale: torch.Tensor,
                         v_codes: torch.Tensor, v_scale: torch.Tensor, index, offset: int = 0,
                         lse: bool = False):
    """q: (B, H, D) f32 or bf16; codes: (B, S, Hkv, D) int8; scales:
    (B, S, Hkv) f32; index: () shared position or (B,) per-slot positions
    (on CUDA an int32 tensor on q's device); lane b attends to the rows
    whose position ``offset + row`` is at most index[b] (a whole cache:
    cache[0..index[b]]), and a lane with no such row gives exactly 0.
    Returns (B, H, D) in q's dtype, and with ``lse`` also each row's
    log-sum-exp of its scaled logits, (B, H) float32 (-inf for a lane with
    no row).  On CUDA: D in ``HEAD_DIMS``, n_rep <= 16."""
    offset = _check_offset(offset)
    tensors = (q, k_codes, k_scale, v_codes, v_scale, torch.as_tensor(index))
    if all(t.device.type == "cpu" for t in tensors):
        return ref.kvc_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, index,
                                            offset, lse)
    b, h, hkv, d, idx = _check_cuda(q, (k_codes, v_codes), (k_scale, v_scale), index,
                                    paged=False)
    return _launch(q, k_codes, k_scale, v_codes, v_scale, None, idx, b, h, hkv, d,
                   k_codes.shape[1], 1, offset, lse)


def kvc_decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor, k_scale_pool: torch.Tensor,
                               v_pool: torch.Tensor, v_scale_pool: torch.Tensor,
                               page_table: torch.Tensor, index, offset: int = 0,
                               lse: bool = False):
    """K10 over the paged pool: exactly ``kvc_decode_attention(q,
    *cache_codes(pool, PagedKV(index, page_table)), index, offset, lse)``
    without the gathered copy.  Pools: (n_pages, page, Hkv, D) int8 codes and (n_pages,
    page, Hkv) f32 scales; ``page_table``: (B, max_pages) int32 page ids
    below n_pages (page 0 is the zero page, where unmapped entries point;
    an id may repeat); lane b's position p lies in page ``page_table[b, p //
    page]``.  The capacity is max_pages * page."""
    offset = _check_offset(offset)
    tensors = (q, k_pool, k_scale_pool, v_pool, v_scale_pool, page_table, torch.as_tensor(index))
    if all(t.device.type == "cpu" for t in tensors):
        return ref.kvc_decode_attention_paged_ref(q, k_pool, k_scale_pool, v_pool, v_scale_pool,
                                                  page_table, index, offset, lse)
    b, h, hkv, d, idx = _check_cuda(q, (k_pool, v_pool), (k_scale_pool, v_scale_pool), index,
                                    paged=True)
    _build.check_cuda(page_table, torch.int32, "kvc_attention page_table")
    if page_table.ndim != 2 or page_table.shape[0] != b or page_table.device != q.device:
        raise ValueError(f"page_table: want ({b}, max_pages) on {q.device}, got "
                         f"{tuple(page_table.shape)} on {page_table.device}")
    return _launch(q, k_pool, k_scale_pool, v_pool, v_scale_pool, page_table, idx, b, h, hkv, d,
                   k_pool.shape[1], page_table.shape[1], offset, lse)
