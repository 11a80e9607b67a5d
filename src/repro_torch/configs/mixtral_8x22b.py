"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA
[arXiv:2401.04088; hf].  The full depth (141e9 parameters, 282 GB in
bf16) does not fit one 80 GB card; ``get_config("mixtral-8x22b",
n_layers=12)`` keeps the full width at a depth that does (about 61 GB).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    n_experts=8,
    top_k=2,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    sliding_window=32,
    tie_embeddings=False,
    n_experts=4,
    top_k=2,
    capacity_factor=8.0,
    remat="none",
)
