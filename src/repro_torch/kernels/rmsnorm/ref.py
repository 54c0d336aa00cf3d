"""Plain oracle for fused RMSNorm (port of `repro/kernels/rmsnorm/ref.py`).

It is the function the kernel's plain version and the kernel are held
against, and the function whose autograd gives the op its backward.
"""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); scale: (D,).  f32 statistics, output in x.dtype."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)).to(x.dtype)
