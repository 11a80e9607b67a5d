"""granite-3-8b [dense] — GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=4,
    d_ff=320,
    vocab_size=512,
    remat="none",
)
