"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf].  Backbone only: the speech frontend is a stub
supplying precomputed frame embeddings; we model
24 encoder + 24 decoder layers with per-layer cross attention.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    tie_embeddings=False,
    frontend_frames=4096,  # overridden per shape
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=6,
    d_ff=192,
    vocab_size=512,
    tie_embeddings=False,
    frontend_frames=24,
    remat="none",
)
