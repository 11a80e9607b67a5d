"""qwen3-8b [dense] — qk_norm, GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
[hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke",
    family="dense",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=False,
    remat="none",
)
