"""minicpm-2b [dense]: llama-like with tied embeddings; trained with the WSD
(warmup-stable-decay) schedule — wired to optim.schedules.wsd in its train
recipe. [arXiv:2404.06395; hf]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122_753,
    tie_embeddings=True,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                      vocab=256, max_seq=128)

TRAIN_SCHEDULE = "wsd"  # the paper-documented trait of this arch
