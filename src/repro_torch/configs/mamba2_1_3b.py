"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified].  expand=2 -> d_inner=4096, headdim=64 ->
64 SSD heads, 1 B/C group, conv width 4.  On one H100 the whole model
serves: 1.344e9 parameters, 2.69 GB in bf16.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=96,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=24,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=8,
    remat="none",
)
