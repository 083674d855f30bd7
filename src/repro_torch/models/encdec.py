"""Whisper-style encoder-decoder backbone, audio frontend stubbed (the port
of ``repro.models.encdec``).

The conv1d + mel frontend is a stub: callers pass precomputed frame
embeddings (B, T_enc, d_model).  Encoder = bidirectional pre-LN blocks with
learned positions; decoder = causal self-attention + cross-attention with
learned positions (``dec_pos``).  GELU MLPs and LayerNorm throughout.

Decode runs the decoder's self-attention through ``layers.decode_attention``
over a dense (B, S) cache, so blockfloat8 decode with a (B,) per-slot index
and ``attention="fused"`` reads the cache through K10's dense entry; the
cross-attention reads ``mem_k``/``mem_v``, which ``init_cache(...,
params=, frames=)`` fills from the encoder.  There is no paged pool and no
prefill (the reference has neither for this family).

In the sharded train step the self- and cross-attention, the GELU MLPs and
the tied embedding compute on their ``model`` blocks through
``models.layers``' parallel forms (:func:`cross_block`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import P
from repro_torch.models.transformer import lm_loss, stack_specs, torch_dtype, unstack


def cross_attention_spec(c) -> dict:
    return {
        "wq": P((c.d_model, c.n_heads, c.head_dim), ("embed", "heads", "head_dim")),
        "wk": P((c.d_model, c.n_kv_heads, c.head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": P((c.d_model, c.n_kv_heads, c.head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": P((c.n_heads, c.head_dim, c.d_model), ("heads", "head_dim", "embed")),
    }


def cross_attention(p: dict, c, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, hb: Optional[L.HeadBlocks] = None) -> torch.Tensor:
    """x: (B,S,D); mem_k/mem_v: (B,T,H,K) precomputed from encoder output;
    with ``hb`` (the sharded step's heads, :func:`cross_block`) this rank's
    heads, reduced over ``model``."""
    q = L._proj_heads(x, p["wq"])
    k, v = L._kv_for_q(mem_k, c, hb), L._kv_for_q(mem_v, c, hb)
    logits = L._scores(q, k) * c.head_dim**-0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    return L._close_heads(L._out_proj(L._weighted(probs, v), p["wo"]), hb)


def cross_decode(p: dict, c, x: torch.Tensor, mem_k: torch.Tensor,
                 mem_v: torch.Tensor) -> torch.Tensor:
    """Decode cross-attention over the cached memory (every kv head): in
    the sharded serving step every query head is gathered over ``model``
    and the row-parallel ``wo`` runs on this rank's heads
    (``layers.serve_out``); elsewhere :func:`cross_attention`."""
    hb = L.head_blocks(p, c, x.device)
    if hb is None:
        return cross_attention(p, c, x, mem_k, mem_v)
    q = spmd.gather_model(L._proj_heads(x, p["wq"]), 2)
    k, v = L._kv_for_q(mem_k, c, None), L._kv_for_q(mem_v, c, None)
    logits = L._scores(q, k) * c.head_dim**-0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    return L.serve_out(L._weighted(probs, v), p, hb)


def encode_memory(p: dict, c, enc_out: torch.Tensor):
    return L._proj_heads(enc_out, p["wk"]), L._proj_heads(enc_out, p["wv"])


def cross_block(p: dict, c, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Cross-attention of ``x`` over the encoder output ``enc`` (the
    training path): in the sharded step, on this rank's heads
    (``layers.head_blocks``), both inputs copied into the model region."""
    hb = L.head_blocks(p, c, x.device)
    if hb is not None:
        p, x, enc = hb.p, spmd.to_model(x), spmd.to_model(enc)
    mk, mv = encode_memory(p, c, enc)
    return cross_attention(p, c, x, mk, mv, hb)


class EncDecLM:
    supports_paged_kv = False
    # blockfloat8 decode self-attention reads its dense cache through K10
    supports_fused_attention = True

    def __init__(self, cfg: ArchConfig, device=None):
        if not (cfg.n_encoder_layers > 0 and cfg.encoder_len > 0):
            raise ValueError(f"{cfg.name}: an encoder-decoder needs encoder layers and length")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)

    def enc_layer_spec(self) -> dict:
        c = self.cfg
        return {
            "attn_norm": L.layernorm_spec(c.d_model),
            "attn": L.attention_spec(c.attn()),
            "mlp_norm": L.layernorm_spec(c.d_model),
            "mlp": L.mlp_spec(c.d_model, c.d_ff, "gelu"),
        }

    def dec_layer_spec(self) -> dict:
        c = self.cfg
        ac = c.attn()
        return {
            "self_norm": L.layernorm_spec(c.d_model),
            "self_attn": L.attention_spec(ac),
            "cross_norm": L.layernorm_spec(c.d_model),
            "cross_attn": cross_attention_spec(ac),
            "mlp_norm": L.layernorm_spec(c.d_model),
            "mlp": L.mlp_spec(c.d_model, c.d_ff, "gelu"),
        }

    def specs(self) -> dict:
        c = self.cfg
        return {
            "enc_pos": P((c.encoder_len, c.d_model), (None, "embed"), "small"),
            "enc_layers": stack_specs(c.n_encoder_layers, self.enc_layer_spec()),
            "enc_final": L.layernorm_spec(c.d_model),
            "embed": L.embedding_spec(c.padded_vocab, c.d_model),
            "dec_pos": P((c.max_seq, c.d_model), (None, "embed"), "small"),
            "dec_layers": stack_specs(c.n_layers, self.dec_layer_spec()),
            "dec_final": L.layernorm_spec(c.d_model),
        }

    def _enc_layer(self, lp, x, positions):
        c = self.cfg
        x = x + L.attention(lp["attn"], c.attn(), L.layernorm(lp["attn_norm"], x), positions,
                            causal=False)
        return x + L.mlp(lp["mlp"], L.layernorm(lp["mlp_norm"], x), "gelu")

    def _dec_layer(self, lp, x, enc, positions):
        c = self.cfg
        x = x + L.attention(lp["self_attn"], c.attn(), L.layernorm(lp["self_norm"], x), positions)
        x = x + cross_block(lp["cross_attn"], c.attn(), L.layernorm(lp["cross_norm"], x), enc)
        return x + L.mlp(lp["mlp"], L.layernorm(lp["mlp_norm"], x), "gelu")

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, d_model) precomputed embeddings (frontend stub)."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = frames.to(self.dtype) + params["enc_pos"].to(self.dtype)[None, : frames.shape[1]]
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = torch.is_grad_enabled()
        for lp in unstack(params["enc_layers"], c.n_encoder_layers):
            x = (spmd.remat(self._enc_layer, lp, x, positions) if remat
                 else self._enc_layer(spmd.gather(lp), x, positions))
        return L.layernorm(params["enc_final"], x)

    def forward(self, params: dict, tokens: torch.Tensor,
                frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Differentiable; with gradients enabled each layer is recomputed in
        the backward pass (per-layer activation checkpointing)."""
        c = self.cfg
        if frames is None:  # degenerate text-only path for smoke parity
            frames = torch.zeros((tokens.shape[0], c.encoder_len, c.d_model), dtype=self.dtype,
                                 device=tokens.device)
        params = spmd.gather_outer(params)
        enc = self.encode(params, frames)
        x = L.embed(params["embed"], tokens, self.dtype)
        x = x + params["dec_pos"].to(self.dtype)[None, : x.shape[1]]
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = torch.is_grad_enabled()
        for lp in unstack(params["dec_layers"], c.n_layers):
            x = (spmd.remat(self._dec_layer, lp, x, enc, positions) if remat
                 else self._dec_layer(spmd.gather(lp), x, enc, positions))
        x = L.layernorm(params["dec_final"], x)
        return L.unembed(params["embed"], x)  # whisper ties embeddings

    def loss(self, params, tokens, labels, frames=None):
        return lm_loss(self.forward(params, tokens, frames), labels)

    # ------------------------------------------------------------ decode --
    def cache_spec(self, batch: int, max_len: int, codec: L.KVCodecConfig) -> dict:
        c = self.cfg
        per_layer = L.cache_spec(c.attn(), batch, max_len, codec)
        out = {"self_" + k: L.TensorSpec((c.n_layers,) + v.shape, v.dtype)
               for k, v in per_layer.items()}
        mem = (c.n_layers, batch, c.encoder_len, c.n_kv_heads, c.hd)
        out["mem_k"] = L.TensorSpec(mem, self.dtype)
        out["mem_v"] = L.TensorSpec(mem, self.dtype)
        return out

    @torch.no_grad()
    def init_cache(self, batch: int, max_len: int, codec: L.KVCodecConfig,
                   params: Optional[dict] = None,
                   frames: Optional[torch.Tensor] = None) -> dict:
        """Zeroed caches; with ``params`` and ``frames`` the cross-attention
        memory holds every decoder layer's K/V of the encoded frames."""
        cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                 for k, s in self.cache_spec(batch, max_len, codec).items()}
        if params is not None and frames is not None:
            enc = self.encode(params, frames)
            for i, lp in enumerate(unstack(params["dec_layers"], self.cfg.n_layers)):
                cache["mem_k"][i], cache["mem_v"][i] = encode_memory(
                    lp["cross_attn"], self.cfg.attn(), enc)
        return cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor, index,
                    codec: L.KVCodecConfig, attention: str = "xla"):
        """token: (B,) -> logits (B, vocab); writes the self-attention cache
        in place.  ``index``: a scalar (homogeneous batch) or a (B,) per-slot
        position vector (-1 = free lane).  ``attention="fused"`` sends
        blockfloat8 self-attention with a (B,) index through K10."""
        c = self.cfg
        dt = self.dtype
        if spmd.seq_block(cache["mem_k"]) is not None:
            raise ValueError("the cross-attention memory's positions are not split over ranks")
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], token[:, None], dt)
        self_names = [k for k in cache if k.startswith("self_")]
        plan = None
        if index.ndim == 1:  # (B,) per-slot positions (continuous batching)
            rows = torch.clamp(index.to(torch.int64), 0, params["dec_pos"].shape[0] - 1)
            x = x + params["dec_pos"][rows][:, None].to(dt)
            leaf = cache[self_names[0]]
            plan = L.attend_plan(index, (index >= 0).to(torch.int32), 1, leaf.shape[1:],
                                 L.seq_offset(leaf))
        else:  # dynamic_slice_in_dim clamps the start into range
            i = min(max(int(index), 0), params["dec_pos"].shape[0] - 1)
            x = x + params["dec_pos"][i:i + 1].to(dt)[None]
        scaches = unstack({k[5:]: cache[k] for k in self_names}, c.n_layers)
        for li, lp in enumerate(unstack(params["dec_layers"], c.n_layers)):
            lp = spmd.gather(lp)
            h = L.layernorm(lp["self_norm"], x)
            a, _ = L.decode_attention(lp["self_attn"], c.attn(), h, scaches[li], codec, index,
                                      attention, plan)
            x = x + a
            h = L.layernorm(lp["cross_norm"], x)
            x = x + cross_decode(lp["cross_attn"], c.attn(), h, cache["mem_k"][li],
                                 cache["mem_v"][li])
            x = x + L.mlp(lp["mlp"], L.layernorm(lp["mlp_norm"], x), "gelu")
        x = L.layernorm(params["dec_final"], x)
        return L.unembed(params["embed"], x)[:, 0, :], cache
