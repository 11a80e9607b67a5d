"""qwen3-1.7b [dense] — qk_norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
[hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-1.7b-smoke",
    family="dense",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    qk_norm=True,
    remat="none",
)
