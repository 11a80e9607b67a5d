"""llama-3.2-vision-11b [vlm] — cross-attn image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: the ViT frontend is a stub supplying
precomputed patch embeddings (1601 tokens, padded to 1664 for clean
sharding).  8 gated cross-attention layers interleave with a period of 5
(one per period), matching the reference model's 8-in-40 layout.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    tie_embeddings=False,
    cross_attn_period=5,
    num_image_tokens=1664,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    tie_embeddings=False,
    cross_attn_period=2,
    num_image_tokens=16,
    remat="none",
)
