"""Learning-rate schedules (port of `repro/optim/schedules.py`): step → lr.

The reference computes in float32 jnp; Python floats are float64, so here
every quantity is a float32 tensor on the step's device, each operation in
the reference's order, with Python constants taking part as float32 (as
JAX's weakly typed constants do).  ``step`` is an int tensor or an int.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]

_F32 = torch.float32


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=_F32, device=like.device)


def _step(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.tensor(step, dtype=torch.int32)


def cosine_schedule(step, base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    t = torch.clamp(step.to(_F32) / _f32(max(total_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1.0 - final_frac) * cos)


def linear_warmup_cosine(step, base_lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = base_lr * torch.clamp_max(step.to(_F32) / _f32(max(warmup_steps, 1), step), 1.0)
    decay = cosine_schedule(torch.clamp_min(step - warmup_steps, 0), base_lr,
                            max(total_steps - warmup_steps, 1), final_frac)
    return torch.where(step < warmup_steps, warm, decay)
