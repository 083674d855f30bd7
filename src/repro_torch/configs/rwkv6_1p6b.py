"""rwkv6-1.6b "Finch" [ssm]: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # 64-dim wkv heads
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    use_rope=False,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
                      vocab=256, max_seq=128)
