"""qwen1.5-110b [dense]: QKV bias (qwen1.5 family trait).
[hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
                      vocab=256, max_seq=128)
