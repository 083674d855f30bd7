"""hymba-1.5b [hybrid]: parallel attention + SSM heads per layer, 128 meta
tokens, sliding-window attention except first/middle/last global layers.
[arXiv:2411.13676; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32_001,
    ssm_state=16,
    ssm_heads=25,
    n_meta_tokens=128,
    window=1024,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab=256, ssm_heads=4, n_meta_tokens=8, window=32, max_seq=128)
