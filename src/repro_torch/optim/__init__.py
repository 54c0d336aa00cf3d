"""Optimizers (AdamW, Adafactor) and LR schedules (port of `repro/optim`).

Like the reference's package, it exports the names of its two modules;
they import only torch and `models.spec`.
"""

from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = [
    "OptState",
    "Optimizer",
    "adafactor",
    "adamw",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "make_optimizer",
]
