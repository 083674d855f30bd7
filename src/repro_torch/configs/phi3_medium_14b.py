"""phi3-medium-14b [dense]: RoPE, SwiGLU, GQA kv=10.
[arXiv:2404.14219; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100_352,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
                      vocab=256, max_seq=128)
