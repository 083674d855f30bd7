"""Shared model layers of the dense family (the port of ``repro.models.layers``):
norms, RoPE, GQA attention (full / chunked-flash / sliding-window), the MLPs,
embeddings, and KV caches with the optional fixed-rate block-float codec (the
paper's technique applied to inference state).

Parameters arrive as nested dicts of tensors built from ``spec.P``
declarations, with the reference's names and layouts.  Every weight is cast
to the activation dtype where it is used (``p[...].to(dt)``), as the
reference does; holding the weights in that dtype already makes the cast a
no-op and computes the same numbers.

Differences from the reference, none of them in the numbers:

* Cache writes are in place.  The reference scatters functionally with
  ``.at[].set(mode="drop")``; here the dropped positions (prompt padding,
  free lanes, positions past a lane's pages) are filtered out and the kept
  ones written with ``index_put_``, so a dropped write never touches the
  cache and the zero page stays zero.  ``cache_write`` still returns the
  cache dict, whose leaves are the tensors it was given.
* The kept positions are a :class:`WritePlan`, computed once per model call
  (one host sync on CUDA) and shared by every layer.
* ``constrain_batch`` is the identity without a mesh, as the reference's
  is; in the sharded train step (``repro_torch.dist.spmd``) it keeps this
  rank's rows of an activation that holds the whole microbatch (the MoE
  combine's) and refuses any other row count.
* In the sharded train step, where the model computes on ``model`` blocks
  (``spmd.model_split``), the layers are Megatron's, as the reference's
  GSPMD program partitions them: attention runs this rank's q heads
  (column-parallel ``wq``, ``wk``, ``wv`` and their biases, row-parallel
  ``wo``); where the kv heads fall back to replication beside split q
  heads each rank cuts the kv heads its q heads read (q head ``i`` of
  rank ``r`` reads global kv head ``(r * h_local + i) // n_rep``); the
  MLP is column-parallel ``gate``, ``up`` and ``up_b`` and row-parallel
  ``down``, with ``down_b`` added once after the reduction; the embedding
  and the unembedding are vocab-parallel.  Heads that fall back to
  replication run whole on every rank.  Outside the step every hook is the
  identity.
* In the sharded serving step (``train.step.build_serve_step``) decode
  attention gathers the query heads over ``model`` and computes every new
  kv head (a rank of the cache holds them all), attends every head over
  this rank's cache, then applies the row-parallel ``wo`` to its own heads.
  Where the step split the cache's sequence over a mesh axis
  (``spmd.seq_block``), each rank attends to its block of positions, the
  new token's k/v land on the rank whose block holds its position, and the
  blocks' partial softmaxes combine exactly: the max over the axis, then
  the sums and the weighted values summed over it (:func:`_softmax_over`;
  K10's route returns each block's log-sum-exp, :func:`_combine_lse`).
* The reference's process-wide flags are not ported: the flash threshold
  is ``AttnConfig.flash_threshold`` alone, and ``KVC_FUSED`` is the
  ``attention`` argument carried from ``EngineConfig`` to
  ``_attend_cached``.
* Mixed-dtype products (a float32 query against a bfloat16 cache) promote
  explicitly, as JAX's type promotion does implicitly.
* Blockfloat8 decode attention (``attention="fused"``) passes the cache's
  un-repeated (B, S, Hkv, D) codes to K10, which maps query head h to KV
  head h // n_rep; the reference repeats the codes n_rep times first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist import spmd
from repro_torch.kernels.ref import gather_pages as _gather_pages  # the paged cache's dense view
from repro_torch.models.spec import P

# ---------------------------------------------------------------- norms ----


def rmsnorm_spec(d: int) -> dict:
    return {"scale": P((d,), ("embed",), "ones")}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"].to(dt)


def layernorm_spec(d: int) -> dict:
    return {"scale": P((d,), ("embed",), "ones"), "bias": P((d,), ("embed",), "zeros")}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["scale"].to(dt) + p["bias"].to(dt)


# ----------------------------------------------------------------- RoPE ----


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions: (S,) batch-free, or
    (B, S) per-slot (serving: every slot sits at its own position)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs  # (S, half) or (B, S, half)
    if positions.ndim == 2:
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    else:
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    dt = x.dtype
    return torch.cat([(x1 * cos - x2 * sin).to(dt), (x2 * cos + x1 * sin).to(dt)], dim=-1)


# ------------------------------------------------------------ attention ----


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    window: Optional[int] = None  # sliding-window size (None = full)
    chunk_kv: int = 2048  # flash-chunk size for long sequences
    flash_threshold: int = 8192  # switch to chunked softmax above this


def attention_spec(c: AttnConfig) -> dict:
    s = {
        "wq": P((c.d_model, c.n_heads, c.head_dim), ("embed", "heads", "head_dim")),
        "wk": P((c.d_model, c.n_kv_heads, c.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": P((c.d_model, c.n_kv_heads, c.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": P((c.n_heads, c.head_dim, c.d_model), ("heads", "head_dim", "embed")),
    }
    if c.qkv_bias:
        s["bq"] = P((c.n_heads, c.head_dim), ("heads", "head_dim"), "zeros")
        s["bk"] = P((c.n_kv_heads, c.head_dim), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = P((c.n_kv_heads, c.head_dim), ("kv_heads", "head_dim"), "zeros")
    return s


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in their common promoted dtype (JAX promotes implicitly)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bqhk,hkd->bqd") as one matrix product."""
    h, k, d = wo.shape
    out, w = _promoted(out, wo.to(out.dtype))
    return out.reshape(*out.shape[:-2], h * k) @ w.reshape(h * k, d)


def _qkv(p: dict, c: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if c.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if c.use_rope:
        q = rope(q, positions, c.rope_theta)
        k = rope(k, positions, c.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


@dataclasses.dataclass
class HeadBlocks:
    """This rank's heads of an attention layer in the sharded step: ``p``
    holds its q-head blocks and the k/v leaves of the kv heads they read;
    ``kv_index`` maps each local q head to its local kv head where the kv
    heads were cut from replicated leaves (``None``: split like the q
    heads, ``n_rep`` to each)."""

    p: dict
    kv_index: Optional[torch.Tensor]


def head_blocks(p: dict, c: AttnConfig, device) -> Optional[HeadBlocks]:
    """This rank's :class:`HeadBlocks` where the sharded step splits the q
    heads over ``model``; ``None`` where they are whole (no mesh, or heads
    that fall back to replication).  Replicated k/v leaves enter the model
    region (``spmd.to_model``: each rank's gradient is its q heads' part)
    before they are cut."""
    q_names = [k for k in ("wq", "wo", "bq") if k in p]
    kv_names = [k for k in ("wk", "wv", "bk", "bv") if k in p]
    heads = spmd.model_split(*(p[k] for k in q_names))
    kv = spmd.model_split(*(p[k] for k in kv_names))
    if heads is None:
        if kv is not None:
            raise ValueError("kv heads split over model beside whole q heads")
        return None
    if kv is not None:
        return HeadBlocks(p, None)
    r, n = heads
    h_local, n_rep = c.n_heads // n, c.n_heads // c.n_kv_heads
    lo, hi = (r * h_local) // n_rep, (r * h_local + h_local - 1) // n_rep + 1
    cut = dict(p)
    for k in kv_names:
        cut[k] = spmd.to_model(p[k]).narrow(1 if k.startswith("w") else 0, lo, hi - lo)
    index = torch.div(r * h_local + torch.arange(h_local, device=device), n_rep,
                      rounding_mode="floor") - lo
    return HeadBlocks(cut, index)


def _kv_for_q(k: torch.Tensor, c: AttnConfig, hb: Optional[HeadBlocks]) -> torch.Tensor:
    """K or V (B, S, kv heads, D) laid out for the q heads: each kv head
    repeated ``n_rep`` times, or picked by ``hb.kv_index``."""
    if hb is not None and hb.kv_index is not None:
        return k.index_select(2, hb.kv_index)
    return _repeat_kv(k, c.n_heads // c.n_kv_heads)


def _close_heads(y: torch.Tensor, hb: Optional[HeadBlocks]) -> torch.Tensor:
    """The row-parallel output projection's partial sum ``y`` reduced over
    ``model`` where the heads are split."""
    return y if hb is None else spmd.from_model(y)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """einsum("bqhk,bshk->bhqs") in the promoted dtype, then float32 (the
    reference rounds the product to its dtype before the cast)."""
    q, k = _promoted(q, k)
    return torch.einsum("bqhk,bshk->bhqs", q, k).to(torch.float32)


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bhqs,bshk->bqhk") in the promoted dtype."""
    probs, v = _promoted(probs, v)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def _sdpa_full(q, k, v, q_pos, k_pos, window, causal=True):
    """Materialized-scores attention. q_pos: (Q,), k_pos: (S,) batch-free."""
    scale = q.shape[-1] ** -0.5
    logits = _scores(q, k) * scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]  # (Q, S)
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _weighted(probs, v)


Q_CHUNK = 2048  # flash query-block size (bounds the f32 accumulator)
_INT32_MAX = 2**31 - 1


def _sdpa_flash(q, k, v, q_pos, k_pos, window, chunk, causal=True):
    """Online softmax tiled over both queries and KV (flash form): Python
    loops over Q_CHUNK query blocks and ``chunk`` KV blocks replace the
    reference's ``lax.map`` and ``lax.scan``.  q_pos: (Q,), k_pos: (S,)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    posp = F.pad(k_pos, (0, pad), value=_INT32_MAX)
    scale = hd**-0.5

    def one_q_block(qb, qpb):
        qc_len = qb.shape[1]
        m = torch.full((b, h, qc_len), -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, qc_len), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, qc_len, hd), dtype=torch.float32, device=q.device)
        for j in range(n_chunks):
            sl = slice(j * chunk, (j + 1) * chunk)
            kb, vb, pb = kp[:, sl], vp[:, sl], posp[sl]
            logits = _scores(qb, kb) * scale
            mask = pb[None, :] <= qpb[:, None] if causal else (pb < _INT32_MAX)[None, :]
            if window is not None:
                mask = mask & (pb[None, :] > qpb[:, None] - window)
            logits = logits.masked_fill(~mask[None, None], -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(logits - m_new[..., None])
            l = l * alpha + pexp.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshk->bhqk", pexp, vb.to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        return out.permute(0, 2, 1, 3).to(q.dtype)  # (B, QC, H, D)

    if sq <= Q_CHUNK:
        return one_q_block(q, q_pos)
    outs = [one_q_block(q[:, i:i + Q_CHUNK], q_pos[i:i + Q_CHUNK])
            for i in range(0, sq, Q_CHUNK)]
    return torch.cat(outs, dim=1)


def attention(p: dict, c: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Self-attention over a full sequence (training / prefill); this
    rank's heads in the sharded step (:func:`head_blocks`)."""
    hb = head_blocks(p, c, x.device)
    if hb is not None:
        p, x = hb.p, spmd.to_model(x)
    q, k, v = _qkv(p, c, x, positions)
    k, v = _kv_for_q(k, c, hb), _kv_for_q(v, c, hb)
    if x.shape[1] > c.flash_threshold:
        out = _sdpa_flash(q, k, v, positions, positions, c.window, c.chunk_kv, causal)
    else:
        out = _sdpa_full(q, k, v, positions, positions, c.window, causal)
    return _close_heads(_out_proj(out, p["wo"]), hb)


# -------------------------------------------------- KV cache (+ codec) ----


@dataclasses.dataclass
class PagedKV:
    """Cache address for paged serving: per-slot write positions plus the
    slot -> page mapping, passed through ``decode_step`` in place of the
    scalar ``index``.

    ``pos``: (B,) int32, next write position per slot; -1 marks a free lane
    (its writes are dropped and its attention mask is empty).
    ``page_table``: (B, max_pages) int32 page ids into the pool's leading
    axis.  Page 0 is the reserved zero page: unmapped table entries point at
    it, so gathers through a free lane read exact zeros.
    """

    pos: torch.Tensor
    page_table: torch.Tensor


def _is_vector_index(index) -> bool:
    return isinstance(index, PagedKV) or (hasattr(index, "ndim") and index.ndim == 1)


@dataclasses.dataclass(frozen=True)
class KVCodecConfig:
    """Fixed-rate block-float KV compression (the paper's cuZFP fixed-rate
    mode adapted to inference state): int8 codes + one f32 scale per
    (token, kv_head) block => 8.25 effective bits/value vs 16 (bf16).
    ``none`` disables."""

    mode: str = "none"  # none | blockfloat8


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a cache leaf (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * torch.empty((), dtype=self.dtype).element_size()


def cache_spec(c: AttnConfig, batch: int, max_len: int, codec: KVCodecConfig,
               dtype: torch.dtype = torch.bfloat16) -> dict[str, TensorSpec]:
    if codec.mode == "blockfloat8":
        return {
            "k_codes": TensorSpec((batch, max_len, c.n_kv_heads, c.head_dim), torch.int8),
            "v_codes": TensorSpec((batch, max_len, c.n_kv_heads, c.head_dim), torch.int8),
            "k_scale": TensorSpec((batch, max_len, c.n_kv_heads), torch.float32),
            "v_scale": TensorSpec((batch, max_len, c.n_kv_heads), torch.float32),
        }
    return {
        "k": TensorSpec((batch, max_len, c.n_kv_heads, c.head_dim), dtype),
        "v": TensorSpec((batch, max_len, c.n_kv_heads, c.head_dim), dtype),
    }


def init_cache(c: AttnConfig, batch: int, max_len: int, codec: KVCodecConfig,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_spec(c, batch, max_len, codec, dtype).items()}


def _bf8_encode(x: torch.Tensor):
    """x: (b, s, h, d) -> int8 codes + per-(token,head) scale."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    codes = torch.round(x32 / scale[..., None]).to(torch.int8)  # half to even
    return codes, scale


def _bf8_decode(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


@dataclasses.dataclass
class WritePlan:
    """The kept cache writes of one call: ``src`` selects (lane, token) rows
    of the new values, ``dst`` the (page or lane, offset or position) each
    lands at.  Dropped positions appear in neither."""

    src: tuple[torch.Tensor, torch.Tensor]
    dst: tuple[torch.Tensor, torch.Tensor]


def write_plan(index, wpos: torch.Tensor, leaf_shape, offset: int = 0) -> WritePlan:
    """Where per-slot token rows land in a cache leaf of ``leaf_shape``.

    ``wpos``: (B, T) global write positions; entries < 0 or past capacity
    are dropped (masked prompt padding and free lanes).  Dense leaves are
    (B, S, ...), whose row r holds position ``offset + r`` (a block of a
    sequence split over ranks: positions outside it are dropped); paged
    leaves are pools (n_pages, page, ...) addressed through
    ``index.page_table``, where positions past ``page * max_pages`` and page
    ids outside the pool are dropped too.
    """
    if isinstance(index, PagedKV):
        n_pages, page = leaf_shape[0], leaf_shape[1]
        table = index.page_table.to(torch.int64)
        max_pages = table.shape[1]
        w = wpos.to(torch.int64)
        pi = torch.clamp(torch.div(w, page, rounding_mode="floor"), 0, max_pages - 1)
        pages = torch.take_along_dim(table, pi, dim=1)  # (B, T)
        keep = (w >= 0) & (w < page * max_pages) & (pages >= 0) & (pages < n_pages)
        src = keep.nonzero(as_tuple=True)
        return WritePlan(src, (pages[src], w[src] % page))
    w = wpos.to(torch.int64)
    if offset:
        w = torch.where(w >= 0, w - offset, -1)
    keep = (w >= 0) & (w < leaf_shape[1])
    src = keep.nonzero(as_tuple=True)
    return WritePlan(src, (src[0], w[src]))


def _scatter_tokens(dest: torch.Tensor, val: torch.Tensor, index, wpos: torch.Tensor,
                    plan: Optional[WritePlan] = None) -> torch.Tensor:
    """Write per-slot token rows ``val`` (B, T, ...) into ``dest`` in place
    at ``wpos`` (B, T) (see :func:`write_plan`); returns ``dest``."""
    if plan is None:
        plan = write_plan(index, wpos, dest.shape)
    dest.index_put_(plan.dst, val[plan.src].to(dest.dtype))
    return dest


def cache_write(cache: dict, codec: KVCodecConfig, k_new: torch.Tensor,
                v_new: torch.Tensor, index, wpos: torch.Tensor,
                plan: Optional[WritePlan] = None) -> dict:
    """Per-slot cache write: K/V (B, T, h, d) land at per-lane positions
    ``wpos`` (B, T); negative positions are dropped. ``index`` selects the
    layout (``PagedKV`` pool vs dense (B, S) lanes)."""
    if plan is None:
        leaf = next(iter(cache.values()))
        plan = write_plan(index, wpos, leaf.shape, seq_offset(leaf))
    if codec.mode == "blockfloat8":
        kc, ks = _bf8_encode(k_new)
        vc, vs = _bf8_encode(v_new)
        for name, val in (("k_codes", kc), ("v_codes", vc), ("k_scale", ks), ("v_scale", vs)):
            _scatter_tokens(cache[name], val, index, wpos, plan)
        return cache
    _scatter_tokens(cache["k"], k_new, index, wpos, plan)
    _scatter_tokens(cache["v"], v_new, index, wpos, plan)
    return cache


def _vector_wpos(pos: torch.Tensor, t: int) -> torch.Tensor:
    wpos = pos[:, None] + torch.arange(t, dtype=torch.int32, device=pos.device)[None, :]
    return torch.where(pos[:, None] >= 0, wpos, -1)


def cache_update(cache: dict, codec: KVCodecConfig, k_new: torch.Tensor, v_new: torch.Tensor,
                 index) -> dict:
    """Write new K/V (b, t, h, d) at position ``index`` (decode: t == 1).

    ``index`` may be a scalar (homogeneous batch: every lane writes at the
    same position, clamped so the update fits, as ``dynamic_update_slice``
    does), a (B,) vector (per-slot positions; -1 lanes are dropped), or a
    :class:`PagedKV` (per-slot positions into a page pool).
    """
    if _is_vector_index(index):
        pos = index.pos if isinstance(index, PagedKV) else index
        return cache_write(cache, codec, k_new, v_new, index, _vector_wpos(pos, k_new.shape[1]))
    t = k_new.shape[1]
    leaf = next(iter(cache.values()))
    s = leaf.shape[1]
    blk = spmd.seq_block(leaf)
    i = min(max(int(index), 0), (s * blk.count if blk else s) - t)
    lo = i - (blk.offset if blk else 0)  # this block's rows lo .. lo + t - 1
    a, b = max(lo, 0), min(lo + t, s)
    if a >= b:  # the position lies in another rank's block
        return cache
    if codec.mode == "blockfloat8":
        kc, ks = _bf8_encode(k_new)
        vc, vs = _bf8_encode(v_new)
        new = {"k_codes": kc, "v_codes": vc, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k_new, "v": v_new}
    for name, val in new.items():
        cache[name][:, a:b] = val[:, a - lo:b - lo].to(cache[name].dtype)
    return cache


def cache_codes(cache: dict, index=None):
    """Raw compressed view (k_codes, k_scale, v_codes, v_scale).  Paged
    caches are stitched through the page table here; K10's paged entry
    (``kernels.ops.kvc_attention_paged``) reads the pool itself instead."""
    if isinstance(index, PagedKV):
        t = index.page_table
        return (_gather_pages(cache["k_codes"], t), _gather_pages(cache["k_scale"], t),
                _gather_pages(cache["v_codes"], t), _gather_pages(cache["v_scale"], t))
    return cache["k_codes"], cache["k_scale"], cache["v_codes"], cache["v_scale"]


def cache_read(cache: dict, codec: KVCodecConfig, dtype=torch.bfloat16, index=None):
    if codec.mode == "blockfloat8":
        kc, ks, vc, vs = cache_codes(cache, index)
        return _bf8_decode(kc, ks, dtype), _bf8_decode(vc, vs, dtype)
    if isinstance(index, PagedKV):
        t = index.page_table
        return _gather_pages(cache["k"], t), _gather_pages(cache["v"], t)
    return cache["k"], cache["v"]


def attend_plan(index, length: torch.Tensor, t: int, leaf_shape, offset: int = 0) -> WritePlan:
    """The :class:`WritePlan` of :func:`_attend_cached` for tokens (B, T):
    lane b keeps its first ``length[b]`` tokens from its start position
    (``offset``: the first position of the cache block, :func:`write_plan`)."""
    start = index.pos if isinstance(index, PagedKV) else index
    tpos = torch.arange(t, dtype=torch.int32, device=start.device)
    gpos = start[:, None] + tpos[None, :]
    valid = (tpos[None, :] < length[:, None]) & (start[:, None] >= 0)
    return write_plan(index, torch.where(valid, gpos, -1), leaf_shape, offset)


def seq_offset(leaf: torch.Tensor) -> int:
    """The first position of the sequence block that cache leaf ``leaf``
    holds in the sharded serving step (``spmd.seq_block``); 0 otherwise."""
    blk = spmd.seq_block(leaf)
    return 0 if blk is None else blk.offset


def serve_qkv(p: dict, c: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    """``(q, k_new, v_new, hb)`` of a cached attention layer: every query
    head and every kv head of ``x``'s tokens.  In the sharded serving step
    (``hb`` from :func:`head_blocks`: the q heads split over ``model``) the
    query heads are gathered over ``model``, and the kv heads are gathered
    too where they split like the q heads, or computed whole from their
    replicated leaves; ``hb`` is ``None`` elsewhere, where this is
    :func:`_qkv`."""
    hb = head_blocks(p, c, x.device)
    q, k, v = _qkv(p, c, x, positions)  # p: the q blocks beside whole or split kv leaves
    if hb is None:
        return q, k, v, None
    if hb.kv_index is None:
        k, v = spmd.gather_model(k, 2), spmd.gather_model(v, 2)
    return spmd.gather_model(q, 2), k, v, hb


def serve_out(out: torch.Tensor, p: dict, hb: Optional[HeadBlocks]) -> torch.Tensor:
    """The output projection of every head's attention ``out`` (B, T, H,
    D): the row-parallel ``wo`` on this rank's heads, reduced over
    ``model``, where :func:`serve_qkv` gave ``hb``."""
    if hb is None:
        return _out_proj(out, p["wo"])
    h_local = p["wo"].shape[0]
    own = out.narrow(2, spmd.model_index() * h_local, h_local)
    return spmd.from_model(_out_proj(own, p["wo"]))


def _softmax_over(logits: torch.Tensor, v: torch.Tensor, blk, dtype) -> torch.Tensor:
    """softmax(logits) @ v over a sequence split into blocks along mesh
    axis ``blk.axis``: ``logits`` (B, H, T, S) float32 over this rank's
    positions (masked with -1e30), ``v`` (B, S, H, D).  The max and the sum
    of exponents are reduced over the axis, each rank weighs its values by
    the global probabilities (rounded to ``dtype`` as the whole softmax's
    are), and the weighted sums are summed over the axis in float32."""
    m = spmd.reduce_over(logits.amax(dim=-1), blk.axis, op=torch.distributed.ReduceOp.MAX)
    e = torch.exp(logits - m[..., None])
    den = spmd.reduce_over(e.sum(dim=-1), blk.axis)
    part = _weighted((e / den[..., None]).to(dtype), v)
    return spmd.reduce_over(part.to(torch.float32), blk.axis).to(part.dtype)


def _combine_lse(out: torch.Tensor, lse: torch.Tensor, blk) -> torch.Tensor:
    """K10's per-block results combined over mesh axis ``blk.axis``:
    ``out`` (B, H, D) normalized over this rank's positions and ``lse``
    (B, H) their log-sum-exp (-inf for none).  Each block weighs
    exp(lse - max lse); a lane with no position anywhere gives exactly 0."""
    big = spmd.reduce_over(lse, blk.axis, op=torch.distributed.ReduceOp.MAX)
    w = torch.exp(lse - torch.where(torch.isfinite(big), big, torch.zeros_like(big)))
    den = spmd.reduce_over(w, blk.axis)
    acc = spmd.reduce_over(w[..., None] * out.to(torch.float32), blk.axis)
    return (acc / torch.clamp_min(den, 1e-30)[..., None]).to(out.dtype)


def _attend_cached(p: dict, c: AttnConfig, x: torch.Tensor, cache: dict,
                   codec: KVCodecConfig, index, length: torch.Tensor,
                   attention: str = "xla", plan: Optional[WritePlan] = None
                   ) -> tuple[torch.Tensor, dict]:
    """Per-slot attention of x (B, T, d) against the cache.

    Each lane b writes its tokens at positions ``start[b] .. start[b]+T-1``
    (only the first ``length[b]`` are kept: prompt padding and free lanes
    are dropped) and attends causally at its own position.  The one code
    path behind both chunked prefill (T = prompt chunk) and per-slot decode
    (T = 1), for dense and paged caches alike.  ``attention="fused"`` sends
    blockfloat8 decode (T = 1, no window) through K10
    (:func:`repro_torch.kernels.ops.kvc_attention_paged`, which reads the
    pool through the page table, or ``kvc_attention`` for a dense cache);
    ``plan`` is the call's :func:`attend_plan`, computed here when not
    given.
    """
    start = index.pos if isinstance(index, PagedKV) else index  # (B,)
    t = x.shape[1]
    tpos = torch.arange(t, dtype=torch.int32, device=x.device)
    gpos = start[:, None] + tpos[None, :]  # (B, T) global positions
    q, k_new, v_new, hb = serve_qkv(p, c, x, gpos)
    leaf = next(iter(cache.values()))
    blk = spmd.seq_block(leaf)  # this rank's block of a split sequence, or None
    if blk is not None and isinstance(index, PagedKV):
        raise ValueError("a paged pool is one card's: its sequence does not split over ranks")
    if plan is None:
        plan = attend_plan(index, length, t, leaf.shape, seq_offset(leaf))
    cache = cache_write(cache, codec, k_new, v_new, index, None, plan)
    n_rep = c.n_heads // c.n_kv_heads
    if t == 1 and codec.mode == "blockfloat8" and attention == "fused" and c.window is None:
        from repro_torch.kernels import ops as _kops

        if isinstance(index, PagedKV):  # read through the page table: no gathered copy
            out = _kops.kvc_attention_paged(q[:, 0].contiguous(), cache["k_codes"],
                                            cache["k_scale"], cache["v_codes"], cache["v_scale"],
                                            index.page_table, start)[:, None]
        elif blk is None:
            kc, ks, vc, vs = cache_codes(cache, index)
            out = _kops.kvc_attention(q[:, 0].contiguous(), kc, ks, vc, vs, start)[:, None]
        else:  # K10 over this rank's block, the blocks combined by their log-sum-exp
            kc, ks, vc, vs = cache_codes(cache, index)
            o, lse = _kops.kvc_attention(q[:, 0].contiguous(), kc, ks, vc, vs, start,
                                         blk.offset, lse=True)
            out = _combine_lse(o, lse, blk)[:, None]
    else:
        k, v = cache_read(cache, codec, x.dtype, index)
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        if blk is not None:
            k_pos = k_pos + blk.offset
        mask = k_pos[None, None, :] <= gpos[:, :, None]  # (B, T, S) causal
        if c.window is not None:
            mask &= k_pos[None, None, :] > gpos[:, :, None] - c.window
        scale = c.head_dim**-0.5
        logits = _scores(q, k) * scale
        logits = logits.masked_fill(~mask[:, None], -1e30)
        if blk is None:
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = _weighted(probs, v)
        else:
            out = _softmax_over(logits, v, blk, x.dtype)
    return serve_out(out, p, hb), cache


def prefill_attention(p: dict, c: AttnConfig, x: torch.Tensor, cache: dict,
                      codec: KVCodecConfig, index, length: torch.Tensor,
                      attention: str = "xla", plan: Optional[WritePlan] = None
                      ) -> tuple[torch.Tensor, dict]:
    """Chunked-prefill attention: x (B, T, d) holds each lane's prompt chunk
    (padded to T; ``length`` (B,) = valid tokens, 0 = inactive lane)."""
    return _attend_cached(p, c, x, cache, codec, index, length, attention, plan)


def decode_attention(p: dict, c: AttnConfig, x: torch.Tensor, cache: dict,
                     codec: KVCodecConfig, index, attention: str = "xla",
                     plan: Optional[WritePlan] = None) -> tuple[torch.Tensor, dict]:
    """One-token attention against the cache. x: (b, 1, d). ``index`` may
    be a scalar (homogeneous batch), a (B,) per-slot position vector, or a
    :class:`PagedKV` (per-slot positions + page table)."""
    if _is_vector_index(index):
        pos = index.pos if isinstance(index, PagedKV) else index
        length = (pos >= 0).to(torch.int32)  # free lanes write nothing
        return _attend_cached(p, c, x, cache, codec, index, length, attention, plan)
    positions = index.reshape(1)
    q, k_new, v_new, hb = serve_qkv(p, c, x, positions)
    cache = cache_update(cache, codec, k_new, v_new, index)
    blk = spmd.seq_block(next(iter(cache.values())))
    k, v = cache_read(cache, codec, x.dtype)
    n_rep = c.n_heads // c.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    max_len = k.shape[1]
    k_pos = torch.arange(max_len, dtype=torch.int32, device=x.device)
    if blk is not None:  # this rank's block of the positions, combined over its axis
        k_pos = k_pos + blk.offset
        mask = k_pos[None, :] <= positions[:, None]
        if c.window is not None:
            mask &= k_pos[None, :] > positions[:, None] - c.window
        logits = (_scores(q, k) * q.shape[-1] ** -0.5).masked_fill(~mask[None, None], -1e30)
        out = _softmax_over(logits, v, blk, q.dtype)
    elif max_len > c.flash_threshold:
        out = _sdpa_flash(q, k, v, positions, k_pos, c.window, c.chunk_kv)
    else:
        out = _sdpa_full(q, k, v, positions, k_pos, c.window)
    return serve_out(out, p, hb), cache


# ------------------------------------------------------------------ MLP ----


def mlp_spec(d_model: int, d_ff: int, kind: str = "swiglu") -> dict:
    if kind == "swiglu":
        return {
            "gate": P((d_model, d_ff), ("embed", "mlp")),
            "up": P((d_model, d_ff), ("embed", "mlp")),
            "down": P((d_ff, d_model), ("mlp", "embed")),
        }
    return {  # gelu
        "up": P((d_model, d_ff), ("embed", "mlp")),
        "up_b": P((d_ff,), ("mlp",), "zeros"),
        "down": P((d_ff, d_model), ("mlp", "embed")),
        "down_b": P((d_model,), ("embed",), "zeros"),
    }


def mlp(p: dict, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """The MLP; in the sharded step, column-parallel ``gate``, ``up`` and
    ``up_b`` and row-parallel ``down`` where ``mlp`` splits over ``model``,
    ``down_b`` added once after the reduction."""
    dt = x.dtype
    split = spmd.model_split(*(p[k] for k in (("gate", "up", "down") if kind == "swiglu"
                                              else ("up", "up_b", "down"))))
    if split is not None:
        x = spmd.to_model(x)
    if kind == "swiglu":
        g = x @ p["gate"].to(dt)
        u = x @ p["up"].to(dt)
        y = (F.silu(g) * u) @ p["down"].to(dt)
        return y if split is None else spmd.from_model(y)
    h = x @ p["up"].to(dt) + p["up_b"].to(dt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
    y = h @ p["down"].to(dt)
    return (y if split is None else spmd.from_model(y)) + p["down_b"].to(dt)


# ------------------------------------------------------------ embedding ----


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Re-pin batch (dim 0) sharding on activations (the reference's
    ``with_sharding_constraint`` after the embedding and the MoE combine):
    this rank's rows in the sharded train step, the identity without a
    mesh."""
    return spmd.own_rows(x)


def embedding_spec(vocab: int, d_model: int) -> dict:
    # std 0.02 (llama/gpt convention): keeps tied unembed logits calibrated
    return {"table": P((vocab, d_model), ("vocab", "embed"), "small")}


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The tokens' rows of the table; vocab-parallel in the sharded step
    where ``vocab`` splits over ``model``: ids outside this rank's block
    give zero rows, and the rows are summed over ``model``."""
    # F.embedding, not p["table"][tokens]: its backward sums a token's rows
    # in a fixed order, where the index's (index_put_ with accumulate) runs
    # in parallel on the CPU and gave the table's gradient other bits run to
    # run.  The forward values are the same gather.
    ids = tokens.to(torch.int64)
    split = spmd.model_split(p["table"])
    if split is None:
        return constrain_batch(F.embedding(ids, p["table"]).to(dtype))
    rows = p["table"].shape[0]
    ids = ids - split[0] * rows
    inside = (ids >= 0) & (ids < rows)
    x = F.embedding(torch.where(inside, ids, 0), p["table"]).to(dtype)
    return constrain_batch(spmd.from_model(x.masked_fill(~inside[..., None], 0)))


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits; in the sharded step where ``vocab`` splits over ``model``,
    this rank's vocab block of them (``spmd.as_block``)."""
    split = spmd.model_split(p["table"])
    if split is not None:
        x = spmd.to_model(x)
    return spmd.as_block(x @ p["table"].to(x.dtype).T, split)
