"""starcoder2-3b [dense]: GQA (kv=2), RoPE, LayerNorm + GELU MLP.
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49_152,
    mlp_kind="gelu",
    norm_kind="layer",
    qkv_bias=True,
    rope_theta=999_999.44,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, max_seq=128)
