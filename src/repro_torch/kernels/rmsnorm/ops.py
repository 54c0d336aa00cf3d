"""Public fused-RMSNorm op: CUDA kernel on the card, plain version on the CPU, autograd.

Port of `repro/kernels/rmsnorm/ops.py`.  ``rmsnorm(x, scale, eps)``
flattens ``(..., D)`` to rows, as the reference does for its kernel:

  * A CUDA tensor launches the hand-written kernel (`kernel.rmsnorm_cuda`)
    or raises.  The kernel takes any row count, so nothing is padded: the
    reference pads rows to its ``block_rows`` tile, and the real rows of
    its result are these.  The scale reaches the kernel in float32.
  * A CPU tensor takes `rmsnorm_plain`: the kernel's arithmetic per row in
    torch (sum of squares over D, ``1 / sqrt(ms + eps)``, then
    ``x · inv · scale``), in float32, stored in x's dtype.
  * The backward is autograd through `ref.rmsnorm_ref`, as the
    reference's custom VJP is the oracle's.

The reference's ``block_rows`` (its tile) and ``interpret`` (its Pallas
interpreter) have no counterpart: the kernel owns a row with a warp or a
block, and the plain version works on all rows at once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_plain"]


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: (..., D) in x's dtype."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(torch.float32)
    ms = xf.square().sum(-1, keepdim=True) / d
    inv = torch.sqrt(ms + eps).reciprocal()
    return (xf * inv * scale.to(torch.float32)).to(x.dtype).reshape(x.shape)


def _forward(x, scale, eps):
    if x.device.type == "cuda":
        d = x.shape[-1]
        out = rmsnorm_cuda(x.reshape(-1, d).contiguous(),
                           scale.to(torch.float32).contiguous(), eps)
        return out.reshape(x.shape)
    if x.device.type != "cpu":
        raise ValueError(f"rmsnorm runs on cuda or cpu, got {x.device}")
    return rmsnorm_plain(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_() for a in ctx.saved_tensors]
            out = rmsnorm_ref(*leaves, ctx.eps)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: (..., D) in x's dtype; differentiable in x and scale."""
    return _RMSNorm.apply(x, scale, eps)
