"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Period of 8 (attn at offset 4, Jamba's attn_layer_period/offset); MoE on
odd positions (expert_layer_period=2, offset=1).  Mamba mixers use the
SSD form (state 16 as in Jamba's Mamba blocks, headdim 64 -> 128 heads).
The full depth (51.5e9 parameters, 103 GB in bf16) does not fit one 80 GB
card; ``get_config("jamba-v0.1-52b", n_layers=8)`` keeps the full width
and one whole period (1 attention and 7 Mamba layers, 4 MoE and 4 dense
FFNs; 13.3e9 parameters, 26.5 GB).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    tie_embeddings=False,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    tie_embeddings=False,
    n_experts=4,
    top_k=2,
    capacity_factor=8.0,
    moe_period=2,
    moe_offset=1,
    attn_period=4,
    attn_offset=2,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=8,
    remat="none",
)
