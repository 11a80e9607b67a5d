"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840,
MoE 384e top-8 [arXiv:2501.kimi2; unverified paper-table].

Analytic check: 61·384·3·7168·2048 ≈ 1.03e12 total params; active
(top-8) ≈ 3.0e10 + attention/embedding ≈ 32B — matches "1t-a32b".

The full config registers but does not fit one card (about 2 TB of bf16
weights, against 80 GB): serving it needs the weights sharded across
cards, which is ROADMAP slice 8.  Its SMOKE config runs the same ``moe``
code on the CPU.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=5e6,
    tie_embeddings=False,
    n_experts=384,
    top_k=8,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    n_layers=3,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    tie_embeddings=False,
    n_experts=16,
    top_k=8,
    capacity_factor=8.0,
    remat="none",
)
