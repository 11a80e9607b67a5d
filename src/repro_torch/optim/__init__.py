"""Optimizers and schedules of the port (``repro/optim/``): AdamW and
Adafactor updated in place, and the learning-rate schedules.  The int8
error-feedback ``compress.py`` waits for sharding (ROADMAP slice 8)."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptConfig,
    OptState,
    adafactor_init,
    adamw_init,
    apply_updates,
    global_norm,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup  # noqa: F401
