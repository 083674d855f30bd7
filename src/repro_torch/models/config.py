"""Unified architecture config consumed by every model family (the port of
``repro.models.config``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    mlp_kind: str = "swiglu"  # swiglu | gelu
    norm_kind: str = "rms"  # rms | layer
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    window: Optional[int] = None  # sliding-window attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    n_meta_tokens: int = 0  # hymba learnable prefix
    # enc-dec
    n_encoder_layers: int = 0
    encoder_len: int = 0  # fixed encoder memory length (whisper: 1500)
    # multimodal frontend stub
    prefix_len: int = 0  # precomputed patch/frame embeddings fed via inputs
    # training
    max_seq: int = 8192
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the 'vocab' axis shards
        cleanly on a 16-way model axis (e.g. whisper's 51865 -> 51968)."""
        return -(-self.vocab // 256) * 256

    def attn(self, window: Optional[int] = None):
        from repro_torch.models.layers import AttnConfig

        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.hd,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            use_rope=self.use_rope,
            window=window if window is not None else self.window,
        )

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)
