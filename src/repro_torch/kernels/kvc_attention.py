"""K10: one-token decode attention fused with blockfloat8 KV decompression
(the port of ``repro.kernels.kvc_attention``).

Serving from a compressed cache without fusion costs an extra pass over the
cache (dequantize, write bf16 K/V, read them back).  The kernel reads the
int8 codes and per-(token, KV head) scales and dequantizes them on the fly,
so the KV traffic on the card is the compressed bytes (8.25 bits a value).

The codes come un-repeated, (B, S, Hkv, D), and the kernel maps query head
h to KV head h // n_rep; the reference's caller repeats them n_rep times
first.  The kernel takes any S and reads only positions 0..index[b] of lane
b, so the reference's padding to its 128-row chunk has no counterpart.

On CUDA tensors :func:`kvc_decode_attention` launches the kernel in
``csrc/kvc_attention.cu`` (a split over S, then a merge of the splits, both
counted as one launch of K10) or raises; on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.kvc_decode_attention_ref`.
``launches`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

TILE = 64  # positions per tile in csrc/kvc_attention.cu; a split is a whole number of tiles
MAX_D = 256
MAX_REP = 32  # query heads per KV head: one warp each
BLOCKS_PER_SM = 2  # splits aim at this many blocks per SM

launches = {"kvc_decode_attention": 0}

_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def split_plan(b: int, hkv: int, s: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): S cut into whole tiles so that about
    ``BLOCKS_PER_SM * sms`` blocks of (lane, KV head, split) fill the card.
    It depends on the capacity S, never on the positions (no host sync)."""
    tiles = max(1, -(-s // TILE))
    want = max(1, -(-BLOCKS_PER_SM * sms // max(1, b * hkv)))
    per = -(-tiles // min(want, tiles))
    chunk = per * TILE
    return -(-s // chunk) if s else 1, chunk


def _check(q, k_codes, k_scale, v_codes, v_scale, index):
    if q.ndim != 3:
        raise ValueError(f"q: want (B, H, D), got {tuple(q.shape)}")
    b, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: want float32 or bfloat16, got {q.dtype}")
    _build.check_cuda(q, q.dtype, "kvc_attention q")
    if k_codes.ndim != 4 or k_codes.shape[0] != b or k_codes.shape[3] != d:
        raise ValueError(f"k_codes: want (B, S, Hkv, D) = ({b}, S, Hkv, {d}), "
                         f"got {tuple(k_codes.shape)}")
    s, hkv = k_codes.shape[1], k_codes.shape[2]
    for t, dt, shape, what in ((k_codes, torch.int8, (b, s, hkv, d), "k_codes"),
                               (v_codes, torch.int8, (b, s, hkv, d), "v_codes"),
                               (k_scale, torch.float32, (b, s, hkv), "k_scale"),
                               (v_scale, torch.float32, (b, s, hkv), "v_scale")):
        _build.check_cuda(t, dt, f"kvc_attention {what}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: want {shape}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what} on {t.device}, q on {q.device}")
    if h % hkv or h // hkv > MAX_REP:
        raise ValueError(f"{h} query heads over {hkv} KV heads: want H = n_rep * Hkv, "
                         f"n_rep <= {MAX_REP}")
    if d % 4 or d > MAX_D:
        raise ValueError(f"head dim {d}: want a multiple of 4, at most {MAX_D}")
    if k_codes.data_ptr() % 4 or v_codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned")
    idx = torch.as_tensor(index)
    if idx.device != q.device or idx.dtype != torch.int32 or idx.numel() not in (1, b):
        raise ValueError(f"index: want int32 () or ({b},) on {q.device}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    return b, s, h, hkv, d, idx


def kvc_decode_attention(q: torch.Tensor, k_codes: torch.Tensor, k_scale: torch.Tensor,
                         v_codes: torch.Tensor, v_scale: torch.Tensor, index) -> torch.Tensor:
    """q: (B, H, D) f32 or bf16; codes: (B, S, Hkv, D) int8; scales:
    (B, S, Hkv) f32; index: () shared position or (B,) per-slot positions
    (on CUDA an int32 tensor on q's device); lane b attends to
    cache[0..index[b]], and a lane with index -1 gives exactly 0.  Returns
    (B, H, D) in q's dtype."""
    tensors = (q, k_codes, k_scale, v_codes, v_scale, torch.as_tensor(index))
    if all(t.device.type == "cpu" for t in tensors):
        return ref.kvc_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, index)
    b, s, h, hkv, d, idx = _check(q, k_codes, k_scale, v_codes, v_scale, index)
    idx = idx.reshape(-1).expand(b).contiguous()
    out = torch.empty_like(q)
    splits, chunk = split_plan(b, hkv, s, _sm_count(q.device))
    parts = [None, None, None]
    if splits > 1:
        parts = [torch.empty(b * h * splits, dtype=torch.float32, device=q.device),
                 torch.empty(b * h * splits, dtype=torch.float32, device=q.device),
                 torch.empty(b * h * splits * d, dtype=torch.float32, device=q.device)]
    P, I = _build.P, _build.I
    _build.launch("kvc_attention", "kvc_attention",
                  [P, I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float],
                  q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
                  k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), *[p.data_ptr() if p is not None else None for p in parts],
                  b, s, h, hkv, d, splits, chunk, float(d ** -0.5), device=q.device)
    launches["kvc_decode_attention"] += 1
    return out
