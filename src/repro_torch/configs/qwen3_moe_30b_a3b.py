"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, per-expert d_ff=768.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per expert
    vocab=151_936,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                      d_ff=32, vocab=256, n_experts=8, top_k=2, max_seq=128)
