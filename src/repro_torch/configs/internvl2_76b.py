"""internvl2-76b [vlm]: InternLM2-78B-like backbone; InternViT-6B frontend
is a stub — input_specs() supplies 256 precomputed patch embeddings per
image. [arXiv:2404.16821; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128_256,
    prefix_len=256,  # ViT patch embeddings per image (stub frontend)
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, prefix_len=8, max_seq=128)
