"""Dense decoder-only transformer (llama family): GQA + RoPE + SwiGLU/GELU,
optional QKV bias, optional sliding window, optional multimodal prefix
embeddings (the port of ``repro.models.transformer``).

Per-layer parameters are stacked along a leading "layers" axis, as in the
reference, so parameter trees carry across between the packages leaf for
leaf; a Python loop over the layers replaces ``jax.lax.scan``.  The model
holds no parameters itself: like the reference, every method takes the
parameter tree.  It carries the device its caches are made on.

``forward`` / ``loss`` differentiate (the trainer's path): with gradients
enabled each layer runs under ``torch.utils.checkpoint`` (non-reentrant,
through ``dist.spmd.remat``), the counterpart of the reference's per-layer
``jax.checkpoint``, so only a layer's input is kept for the backward pass.
Inside the sharded train and serving steps (``dist.spmd.use``) the
parameters arrive as this rank's blocks and are gathered where they are
used: the outer leaves at the top of ``forward`` and ``decode_step``, a
layer's inside its checkpoint (or, without gradients, as the layer runs).  Attention, the
MLPs, the embedding, the unembedding and :func:`lm_loss` compute on their
``model`` blocks (``models.layers``), as every family's do.  ``decode_step``
and ``prefill`` (the serving path) run without gradients.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from repro_torch.device import resolve_device
from repro_torch.dist import spmd
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.spec import P, map_specs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def stack_specs(n: int, tree: Any) -> Any:
    """Prepend a 'layers' axis to every spec leaf."""
    return map_specs(lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale), tree)


def unstack(tree: Any, n: int) -> list:
    """The per-layer views of a stacked parameter tree or cache (a sharded
    step's tagged blocks stay tagged: ``dist.spmd.unbind``)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return spmd.unbind(tree)


class DenseLM(nn.Module):
    # decode routes every KV access through layers.decode_attention, so the
    # serving tier can swap the dense (B, S) cache for a paged pool
    supports_paged_kv = True
    # blockfloat8 decode attention has a K10 route (``attention="fused"``)
    supports_fused_attention = True

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.norm = L.rmsnorm if cfg.norm_kind == "rms" else L.layernorm
        self.norm_spec = L.rmsnorm_spec if cfg.norm_kind == "rms" else L.layernorm_spec

    # ------------------------------------------------------------ specs --
    def layer_spec(self) -> dict:
        c = self.cfg
        return {
            "attn_norm": self.norm_spec(c.d_model),
            "attn": L.attention_spec(c.attn()),
            "mlp_norm": self.norm_spec(c.d_model),
            "mlp": L.mlp_spec(c.d_model, c.d_ff, c.mlp_kind),
        }

    def specs(self) -> dict:
        c = self.cfg
        s = {
            "embed": L.embedding_spec(c.padded_vocab, c.d_model),
            "layers": stack_specs(c.n_layers, self.layer_spec()),
            "final_norm": self.norm_spec(c.d_model),
        }
        if not c.tie_embeddings:
            s["unembed"] = {"table": P((c.padded_vocab, c.d_model), ("vocab", "embed"), "small")}
        return s

    def _table(self, params: dict) -> dict:
        return params["embed"] if self.cfg.tie_embeddings else params["unembed"]

    def _mlp_block(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        return x + L.mlp(lp["mlp"], self.norm(lp["mlp_norm"], x), self.cfg.mlp_kind)

    def _layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + L.attention(lp["attn"], self.cfg.attn(), self.norm(lp["attn_norm"], x), positions)
        return self._mlp_block(lp, x)

    # ---------------------------------------------------------- forward --
    def forward(self, params: dict, tokens: torch.Tensor,
                prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: (B, S) int32; prefix: (B, P, d) precomputed embeddings.
        Differentiable; with gradients enabled each layer is recomputed in
        the backward pass (per-layer activation checkpointing)."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], tokens, self.dtype)
        if prefix is not None:
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = torch.is_grad_enabled()
        for lp in unstack(params["layers"], c.n_layers):
            if remat:
                x = spmd.remat(self._layer, lp, x, positions)
            else:
                x = self._layer(spmd.gather(lp), x, positions)
        x = self.norm(params["final_norm"], x)
        if prefix is not None:
            x = x[:, prefix.shape[1]:, :]
        return L.unembed(self._table(params), x)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        return lm_loss(self.forward(params, tokens, prefix), labels)

    # ------------------------------------------------------------ decode --
    def cache_spec(self, batch: int, max_len: int, codec: L.KVCodecConfig) -> dict:
        c = self.cfg
        per_layer = L.cache_spec(c.attn(), batch, max_len, codec)
        return {k: L.TensorSpec((c.n_layers,) + v.shape, v.dtype) for k, v in per_layer.items()}

    def init_cache(self, batch: int, max_len: int, codec: L.KVCodecConfig) -> dict:
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in self.cache_spec(batch, max_len, codec).items()}

    def _cached_layers(self, params: dict, cache: dict, x: torch.Tensor, attend) -> torch.Tensor:
        """Run the layers over ``x``; ``attend(layer_params, h, layer_cache)``
        writes the layer's cache slice in place and returns its output."""
        c = self.cfg
        caches = unstack(cache, c.n_layers)
        for lp, lc in zip(unstack(params["layers"], c.n_layers), caches):
            lp = spmd.gather(lp)
            x = x + attend(lp["attn"], self.norm(lp["attn_norm"], x), lc)
            x = self._mlp_block(lp, x)
        return self.norm(params["final_norm"], x)

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    index, codec: L.KVCodecConfig, attention: str = "xla"
                    ) -> tuple[torch.Tensor, dict]:
        """token: (B,) int32 -> logits (B, vocab); writes the KV cache in
        place (and returns it).  ``attention="fused"`` sends blockfloat8
        decode attention through K10."""
        c = self.cfg
        params = spmd.gather_outer(params)
        x = L.embed(params["embed"], token[:, None], self.dtype)
        plan = None
        if L._is_vector_index(index):
            pos = index.pos if isinstance(index, L.PagedKV) else index
            leaf = next(iter(cache.values()))
            plan = L.attend_plan(index, (pos >= 0).to(torch.int32), 1, leaf.shape[1:],
                                 L.seq_offset(leaf))

        def attend(ap, h, lc):
            return L.decode_attention(ap, c.attn(), h, lc, codec, index, attention, plan)[0]

        x = self._cached_layers(params, cache, x, attend)
        return L.unembed(self._table(params), x)[:, 0, :], cache

    @torch.no_grad()
    def prefill(self, params: dict, cache: dict, tokens: torch.Tensor, index,
                length: torch.Tensor, codec: L.KVCodecConfig, attention: str = "xla"
                ) -> tuple[torch.Tensor, dict]:
        """Chunked prompt prefill: tokens (B, T) land in the cache in one
        call.  ``index`` carries per-lane start positions ((B,) vector or
        PagedKV); ``length`` (B,) = valid tokens per lane (0 = lane not
        being prefilled; its writes are dropped).  Returns logits at each
        lane's last valid token (B, vocab)."""
        c = self.cfg
        x = L.embed(params["embed"], tokens, self.dtype)
        plan = L.attend_plan(index, length, tokens.shape[1],
                             next(iter(cache.values())).shape[1:])

        def attend(ap, h, lc):
            return L.prefill_attention(ap, c.attn(), h, lc, codec, index, length,
                                       attention, plan)[0]

        x = self._cached_layers(params, cache, x, attend)
        last = torch.clamp(length.to(torch.int64) - 1, 0, tokens.shape[1] - 1)  # (B,)
        xl = torch.take_along_dim(x, last[:, None, None], dim=1)
        return L.unembed(self._table(params), xl)[:, 0, :], cache


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Cross entropy in f32 with optional z-loss (stability at scale).
    Vocab-parallel where ``logits`` is this rank's vocab block
    (``layers.unembed`` in the sharded step): the global max, the sum of
    exponents and the target logit are each reduced over ``model``; the
    padded vocab counts, as the reference's ``logsumexp`` counts it."""
    split = spmd.model_split(logits)
    logits = logits.to(torch.float32)
    labels = labels.to(torch.int64)
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    else:
        width = logits.shape[-1]
        m = spmd.max_over_model(logits.detach().amax(dim=-1))
        lse = m + torch.log(spmd.from_model(torch.exp(logits - m[..., None]).sum(dim=-1)))
        local = labels - split[0] * width
        inside = (local >= 0) & (local < width)
        ll = torch.take_along_dim(logits, torch.where(inside, local, 0)[..., None], dim=-1)[..., 0]
        ll = spmd.from_model(torch.where(inside, ll, 0.0))
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse**2).mean()
    return loss
