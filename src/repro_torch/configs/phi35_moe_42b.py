"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,  # per expert
    vocab=32_064,
    n_experts=16,
    top_k=2,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
                      vocab=256, n_experts=4, top_k=2, max_seq=128)
