"""llama3-8b [dense] — GQA, 128k vocab.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[arXiv:2407.21783; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=448,
    vocab_size=512,
    tie_embeddings=False,
    remat="none",
)
