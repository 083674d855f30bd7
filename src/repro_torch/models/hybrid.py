"""Hymba: hybrid-head LM (the port of ``repro.models.hybrid``).  Every layer
runs attention and an SSM branch in parallel on the same input and fuses
their normalized outputs (arXiv:2411.13676), with learnable meta tokens
prepended to the sequence and sliding-window attention in all but three
global layers (first, middle, last).

The SSM branch is the reference's Mamba-2 / SSD scalar-decay head form
(state 16 per head): with a scalar per-head decay the chunked recurrence
(:func:`ssd_chunked`, chunk 64) is a pure matrix product whose per-head
(C x C) decay matrix has non-positive exponents, so it is f32-stable.
Decode is the recurrent step (:func:`ssd_step`).

Above ``AttnConfig.flash_threshold`` tokens the attention branch takes the
chunked online-softmax path (the reference reads ``flags.FLASH_THRESHOLD``
first; the port has no ``flags``).  Decode attends over the dense cache
with the layer's window as its own plain attention, as the reference does:
there is no K10 route (a windowed layer is not K10's function) and no
paged pool.  With a (B,) per-slot index a free lane (-1) keeps its SSD
state (see ``repro_torch.models.rwkv6``); its attention writes are dropped
as on every cache.

In the sharded train and serving steps (``dist.spmd``) the layers compute
on Megatron blocks over ``model``, as the reference's GSPMD program
partitions them: the attention is ``models.layers``' (this rank's q heads,
kv heads split alike or cut from replicated leaves; decode gathers the q
heads and combines the blocks of a split cache), the SSD branch is
column-parallel (``w_in``, ``w_bc``, ``w_dt``, ``dt_bias``, ``a_log`` and
``skip`` on this rank's heads) with a row-parallel ``w_out``, and the MLP,
the embedding and the unembedding are ``models.layers``'.  Heads that do
not divide over ``model`` (hymba-1.5b's 25 and 5) are replicated and run
whole on every rank.  Decode advances this rank's SSD heads of the
recurrent state and gathers the whole state over ``model``, since every
``model`` rank holds all of it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.rwkv6 import _keep_free_lanes
from repro_torch.models.spec import P
from repro_torch.models.transformer import lm_loss, stack_specs, torch_dtype, unstack

CHUNK = 64
GLOBAL_WINDOW = 1 << 30


def ssd_spec(c: ArchConfig) -> dict:
    d, n = c.d_model, c.ssm_state
    h = c.ssm_heads or c.n_heads
    hd = d // h
    return {
        "w_in": P((d, h, hd), ("embed", "heads", "head_dim")),
        "w_bc": P((d, h, 2 * n), ("embed", "heads", None)),
        "w_dt": P((d, h), ("embed", "heads"), "small"),
        "dt_bias": P((h,), ("heads",), "zeros"),
        "a_log": P((h,), ("heads",), "zeros"),
        "skip": P((h, hd), ("heads", "head_dim"), "ones"),
        "w_out": P((h, hd, d), ("heads", "head_dim", "embed")),
    }


def ssd_chunked(xh, B, C, dt, a, state0=None):
    """SSD scan. xh: (b,T,H,P); B,C: (b,T,H,N); dt: (b,T,H) >= 0; a: (H,) < 0.

    h_t = exp(a*dt_t) h_{t-1} + dt_t * (B_t ⊗ x_t);   y_t = C_t · h_t
    Chunked: scores[t,s] = (C_t·B_s) exp(A_t - A_s) dt_s, exponents <= 0."""
    b, t, H, Pd = xh.shape
    n = B.shape[-1]
    pad = (-t) % CHUNK
    if pad:
        xh, B, C = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (xh, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    nch = xh.shape[1] // CHUNK
    f32 = torch.float32
    maskl = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=xh.device), -1)
    maskl = maskl[None, :, :, None]  # s < t
    S = torch.zeros((b, H, n, Pd), dtype=f32, device=xh.device) if state0 is None else state0
    ys = []
    for i in range(nch):
        sl = slice(i * CHUNK, (i + 1) * CHUNK)
        xb, Bb, Cb, db = (z[:, sl].to(f32) for z in (xh, B, C, dt))
        la = a[None, None, :] * db  # per-step log decay (b,c,H), <= 0
        F_ = torch.cumsum(la, dim=1)
        E = F_ - la
        inter = torch.einsum("bchn,bhnp->bchp", Cb * torch.exp(E)[..., None], S)
        Dlog = E[:, :, None] - F_[:, None, :]  # (b,c,c,H)
        D = torch.where(maskl, torch.exp(torch.clamp_max(Dlog, 0.0)),
                        torch.zeros((), device=xh.device))
        scores = torch.einsum("bthn,bshn,btsh->btsh", Cb, Bb, D) * db[:, None, :, :]
        intra = torch.einsum("btsh,bshp->bthp", scores, xb)
        diag = torch.einsum("bthn,bthn->bth", Cb, Bb) * db
        intra = intra + diag[..., None] * xb
        Ftot = F_[:, -1]  # (b,H)
        S = torch.exp(Ftot)[..., None, None] * S + torch.einsum(
            "bshn,bshp->bhnp", Bb * (torch.exp(Ftot[:, None] - F_) * db)[..., None], xb)
        ys.append(inter + intra)
    return torch.cat(ys, dim=1)[:, :t], S


def ssd_step(xh, B, C, dt, a, S):
    """Recurrent decode step. xh: (b,H,P); B,C: (b,H,N); dt: (b,H)."""
    la = (a[None, :] * dt).to(torch.float32)
    Bx = torch.einsum("bhn,bhp->bhnp", B, xh) * dt[..., None, None]
    S_new = torch.exp(la)[..., None, None] * S + Bx
    y = torch.einsum("bhn,bhnp->bhp", C, S_new)
    return y, S_new


_SSD_HEADS = ("w_in", "w_bc", "w_dt", "dt_bias", "a_log", "skip", "w_out")  # split alike


def _ssd_inputs(p: dict, c: ArchConfig, x: torch.Tensor):
    """xh (x's dtype), B, C, dt (f32) and the decay a of ``x`` (b, s, d)."""
    n = c.ssm_state
    f32 = torch.float32
    xh = L._proj_heads(x, p["w_in"])
    bc = L._proj_heads(x, p["w_bc"]).to(f32)
    dt = F.softplus((x @ p["w_dt"].to(x.dtype)).to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"].to(f32))
    return xh, bc[..., :n], bc[..., n:], dt, a


def ssd_apply(p: dict, c: ArchConfig, x: torch.Tensor, state0=None):
    """The SSD branch over ``x`` (b, s, d): its output and final state (of
    this rank's heads where they split over ``model``: column-parallel
    inputs, the row-parallel ``w_out`` reduced over ``model``)."""
    dt_ = x.dtype
    split = spmd.model_split(*(p[k] for k in _SSD_HEADS))
    if split is not None:
        x = spmd.to_model(x)
    xh, B, C, dt, a = _ssd_inputs(p, c, x)
    y32, S = ssd_chunked(xh.to(torch.float32), B, C, dt, a, state0)
    y = y32.to(dt_) + xh * p["skip"].to(dt_)[None, None]
    out = L._out_proj(y, p["w_out"])
    return (out if split is None else spmd.from_model(out)), S


class HymbaLM:
    """Parallel attention+SSD heads, meta tokens, mixed global/SWA layers."""

    supports_paged_kv = False
    supports_fused_attention = False

    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)

    def _windows(self) -> list[int]:
        c = self.cfg
        w = [c.window or 1024] * c.n_layers
        for i in (0, c.n_layers // 2, c.n_layers - 1):
            w[i] = GLOBAL_WINDOW
        return w

    def _attn_config(self) -> L.AttnConfig:
        c = self.cfg
        return L.AttnConfig(d_model=c.d_model, n_heads=c.n_heads, n_kv_heads=c.n_kv_heads,
                            head_dim=c.hd, rope_theta=c.rope_theta, window=None)

    def layer_spec(self) -> dict:
        c = self.cfg
        return {
            "norm": L.rmsnorm_spec(c.d_model),
            "attn": L.attention_spec(c.attn()),
            "ssd": ssd_spec(c),
            "attn_out_norm": L.rmsnorm_spec(c.d_model),
            "ssd_out_norm": L.rmsnorm_spec(c.d_model),
            "beta_attn": P((1,), (None,), "ones"),
            "beta_ssd": P((1,), (None,), "ones"),
            "mlp_norm": L.rmsnorm_spec(c.d_model),
            "mlp": L.mlp_spec(c.d_model, c.d_ff, c.mlp_kind),
        }

    def specs(self) -> dict:
        c = self.cfg
        return {
            "embed": L.embedding_spec(c.padded_vocab, c.d_model),
            "meta": P((c.n_meta_tokens, c.d_model), (None, "embed"), "small"),
            "layers": stack_specs(c.n_layers, self.layer_spec()),
            "final_norm": L.rmsnorm_spec(c.d_model),
            "unembed": {"table": P((c.padded_vocab, c.d_model), ("vocab", "embed"), "small")},
        }

    def _fuse(self, lp: dict, x, attn_out, ssd_out):
        dt = x.dtype
        fused = (lp["beta_attn"].to(dt) * L.rmsnorm(lp["attn_out_norm"], attn_out)
                 + lp["beta_ssd"].to(dt) * L.rmsnorm(lp["ssd_out_norm"], ssd_out)) * 0.5
        x = x + fused
        return x + L.mlp(lp["mlp"], L.rmsnorm(lp["mlp_norm"], x), self.cfg.mlp_kind)

    def _fused_layer(self, lp, window: int, x, positions):
        h = L.rmsnorm(lp["norm"], x)
        ac = dataclasses.replace(self._attn_config(), window=window)
        attn_out = L.attention(lp["attn"], ac, h, positions)
        ssd_out, _ = ssd_apply(lp["ssd"], self.cfg, h)
        return self._fuse(lp, x, attn_out, ssd_out)

    def forward(self, params, tokens, prefix: Optional[torch.Tensor] = None):
        """Differentiable; with gradients enabled each layer is recomputed in
        the backward pass (per-layer activation checkpointing)."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], tokens, self.dtype)
        meta = params["meta"].to(self.dtype)[None].expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = torch.is_grad_enabled()
        for lp, window in zip(unstack(params["layers"], c.n_layers), self._windows()):
            if remat:
                x = spmd.remat(self._fused_layer, lp, window, x, positions)
            else:
                x = self._fused_layer(spmd.gather(lp), window, x, positions)
        x = L.rmsnorm(params["final_norm"], x)
        skip = c.n_meta_tokens + (prefix.shape[1] if prefix is not None else 0)
        return L.unembed(params["unembed"], x[:, skip:, :])

    def loss(self, params, tokens, labels, prefix=None):
        return lm_loss(self.forward(params, tokens, prefix), labels)

    # ------------------------------------------------------------ decode --
    def cache_spec(self, batch: int, max_len: int, codec: L.KVCodecConfig) -> dict:
        c = self.cfg
        h = c.ssm_heads or c.n_heads
        attn_cache = L.cache_spec(c.attn(), batch, max_len, codec)
        out = {"attn_" + k: L.TensorSpec((c.n_layers,) + v.shape, v.dtype)
               for k, v in attn_cache.items()}
        out["ssd_state"] = L.TensorSpec((c.n_layers, batch, h, c.ssm_state, c.d_model // h),
                                        torch.float32)
        return out

    def init_cache(self, batch: int, max_len: int, codec: L.KVCodecConfig) -> dict:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_spec(batch, max_len, codec).items()}

    @torch.no_grad()
    def decode_step(self, params, cache, token, index, codec: L.KVCodecConfig,
                    attention: str = "xla"):
        """token: (B,) -> logits (B, vocab); writes the cache in place.
        ``index``: a scalar (homogeneous batch) or a (B,) per-slot position
        vector (-1 = free lane)."""
        if attention == "fused":
            raise ValueError("HymbaLM decodes with its own windowed attention: no K10 route")
        c = self.cfg
        dt = self.dtype
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], token[:, None], dt)
        ac = self._attn_config()
        n_rep = ac.n_heads // ac.n_kv_heads
        vector = index.ndim == 1
        pos = index[:, None] if vector else index.reshape(1)  # (B, 1) | (1,)
        idx = index.reshape(-1, 1) if vector else index  # (B, 1) | ()
        acaches = unstack({k[5:]: cache[k] for k in cache if k.startswith("attn_")},
                          c.n_layers)
        for i, (lp, window) in enumerate(zip(unstack(params["layers"], c.n_layers),
                                             self._windows())):
            lp = spmd.gather(lp)
            h = L.rmsnorm(lp["norm"], x)
            acache = acaches[i]
            q, k_new, v_new, hb = L.serve_qkv(lp["attn"], ac, h, pos)  # every head
            L.cache_update(acache, codec, k_new, v_new, index)
            blk = spmd.seq_block(next(iter(acache.values())))  # a split sequence's block
            kk, vv = L.cache_read(acache, codec, h.dtype)
            kk, vv = L._repeat_kv(kk, n_rep), L._repeat_kv(vv, n_rep)
            kpos = torch.arange(kk.shape[1], dtype=torch.int32, device=x.device)[None, :]
            if blk is not None:
                kpos = kpos + blk.offset
            logits = L._scores(q, kk) * ac.head_dim**-0.5
            mask = (kpos <= idx) & (kpos > idx - window)  # (B, S) | (1, S)
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
            if blk is None:
                probs = torch.softmax(logits, dim=-1).to(h.dtype)
                att = L._weighted(probs, vv)
            else:
                att = L._softmax_over(logits, vv, blk, h.dtype)
            a_out = L.serve_out(att, lp["attn"], hb)

            sp = lp["ssd"]
            split = spmd.model_split(*(sp[k] for k in _SSD_HEADS))
            xh, Bm, Cm, dtv, a = _ssd_inputs(sp, c, h)
            xh = xh[:, 0]
            S = cache["ssd_state"][i]  # every head's state, on every model rank
            lo = 0 if split is None else split[0] * xh.shape[1]
            y, S_new = ssd_step(xh.to(torch.float32), Bm[:, 0], Cm[:, 0], dtv[:, 0], a,
                                S[:, lo:lo + xh.shape[1]])
            if split is not None:  # every rank's heads of the new state
                S_new = spmd.gather_model(S_new, 1)
            cache["ssd_state"][i] = _keep_free_lanes(S_new, S, index)
            y = y.to(dt) + xh * sp["skip"].to(dt)[None]
            s_out = L._out_proj(y, sp["w_out"])[:, None]
            if split is not None:
                s_out = spmd.from_model(s_out)
            x = self._fuse(lp, x, a_out, s_out)
        x = L.rmsnorm(params["final_norm"], x)
        return L.unembed(params["unembed"], x)[:, 0, :], cache
