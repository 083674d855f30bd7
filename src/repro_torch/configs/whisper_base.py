"""whisper-base [audio]: enc-dec, conv frontend stubbed (precomputed frame
embeddings via input_specs). [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder
    n_encoder_layers=6,
    encoder_len=1500,  # 30 s of mel frames after the conv stride-2 stub
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_kind="gelu",
    norm_kind="layer",
    use_rope=False,  # learned positions
    tie_embeddings=True,
    max_seq=524_288,
)

SMOKE = CONFIG.scaled(n_layers=2, n_encoder_layers=2, encoder_len=32, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, max_seq=128)
